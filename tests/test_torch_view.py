"""Port parity of live reconfiguration's in-process surface
(round_tpu_torch/runtime/view.py).

The stub-transport tests of tests/test_view.py run through both packages:
the op encoding, View.apply's contiguous renames, the wire form and its
garbage handling, the mod-256 epoch guard, the view-change script, and
ViewManager's apply_op / observers / epoch guard / adopt_wire / farewells,
with every send and rewire the stub records compared between the two
(FLAG_VIEW payloads byte for byte: ``pickle.dumps(view.wire())`` is plain
builtins).  ``propose`` runs over the host runner; its consensus over
sockets is held in tests/test_torch_host.py.  The socket tests of
tests/test_view.py have no other counterpart here."""

import pickle

import pytest
import torch

from round_tpu.runtime import view as jview
from round_tpu.runtime.membership import Group as JGroup
from round_tpu.runtime.membership import Replica as JReplica
from round_tpu.runtime.transport import wire_loads
from round_tpu_torch.runtime import view as tview
from round_tpu_torch.runtime.membership import Group as TGroup
from round_tpu_torch.runtime.membership import Replica as TReplica
from round_tpu_torch.runtime.oob import FLAG_VIEW, Tag

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

PKGS = ((jview, JGroup, JReplica), (tview, TGroup, TReplica))


def _local_group(pkg, ports):
    _, Group, Replica = pkg
    return Group([Replica(i, "127.0.0.1", p) for i, p in enumerate(ports)])


class _StubTransport:
    def __init__(self, my_id=0):
        self.id = my_id
        self.sent = []
        self.rewired = []

    def send(self, to, tag, payload=b""):
        self.sent.append((to, tag.pack(), payload))
        return True

    def rewire(self, peers, my_id=None):
        self.rewired.append((dict(peers), my_id))
        if my_id is not None:
            self.id = my_id
        return {}


def _both(scenario):
    outs = [scenario(pkg) for pkg in PKGS]
    assert outs[0] == outs[1], outs
    return outs[1]


def _view_key(v):
    return None if v is None else (v.epoch, [(r.id, r.address, r.port)
                                             for r in v.group.replicas])


def test_op_encoding_roundtrip_and_range():
    for view, _, _ in PKGS:
        assert view.decode(view.encode(view.ADD, 7004)) == (view.ADD, 7004)
        assert view.decode(view.encode(view.REMOVE, 3)) == (view.REMOVE, 3)
        with pytest.raises(ValueError):
            view.encode(view.ADD, 1 << 24)
    assert (tview.ADD, tview.REMOVE) == (jview.ADD, jview.REMOVE)
    for op in (0, 1, 5, (1 << 24) + 9, (2 << 24) + 77, (1 << 31) - 1):
        assert tview.decode(op) == jview.decode(op)


def test_view_apply_add_remove_renames_contiguously():
    def scenario(pkg):
        view = pkg[0]
        v = view.View(0, _local_group(pkg, [7000, 7001, 7002, 7003]))
        v1 = v.apply(view.ADD, 7004)
        v2 = v1.apply(view.REMOVE, 1)
        with pytest.raises(ValueError):
            v.apply(9, 0)
        return (_view_key(v1), _view_key(v2), v2.group.renaming_from(
            v1.group), v2.peers(), v2.epoch_byte, v2.n)

    out = _both(scenario)
    assert out[2] == {0: 0, 1: None, 2: 1, 3: 2, 4: 3}


def test_view_wire_bytes_roundtrip_and_garbage():
    def scenario(pkg):
        v = pkg[0].View(3, _local_group(pkg, [7000, 7001]))
        wire = pickle.dumps(v.wire())
        back = pkg[0].View.from_wire(wire_loads(wire))
        junk = [pkg[0].View.from_wire(x) for x in (
            None, 42, "x", (1,), (-1, ()), (1, ((1, 2, 3),)))]
        return wire, _view_key(back), junk

    wire, back, junk = _both(scenario)
    assert back[0] == 3 and junk == [None] * 6


def test_epoch_behind_mod256():
    for a in range(0, 256, 3):
        for b in range(0, 256, 5):
            assert tview.epoch_behind(a, b) == jview.epoch_behind(a, b)
    assert tview.epoch_behind(255, 1) and not tview.epoch_behind(2, 1)


def test_parse_view_schedule():
    assert tview.parse_view_schedule("2:add=7005, 4:remove=1") == \
        jview.parse_view_schedule("2:add=7005, 4:remove=1")
    for bad, match in (("2:grow=1", "bad --view-change"),
                       ("2:add=1,2:remove=0", "duplicate")):
        for view in (jview, tview):
            with pytest.raises(ValueError, match=match):
                view.parse_view_schedule(bad)
    for e in range(0, 300, 7):
        assert tview.view_instance(e) == jview.view_instance(e)


def _manager(pkg, my_id, epoch, ports):
    tr = _StubTransport(my_id)
    mgr = pkg[0].ViewManager(my_id, pkg[0].View(
        epoch, _local_group(pkg, ports)), tr)
    return mgr, tr


def _state(mgr, tr):
    return (mgr.epoch, mgr.my_id, mgr.removed, mgr.stale, mgr.history,
            _view_key(mgr.view), tr.sent, tr.rewired)


def test_manager_apply_op_renames_and_rewires():
    def scenario(pkg):
        mgr, tr = _manager(pkg, 2, 0, [7000, 7001, 7002])
        mgr.apply_op(pkg[0].REMOVE, 1)
        mgr.apply_op(pkg[0].ADD, 7009)
        return _state(mgr, tr)

    out = _both(scenario)
    assert out[:2] == (2, 1)


def test_manager_observer_fanout_and_isolation():
    def scenario(pkg):
        mgr, tr = _manager(pkg, 0, 0, [7000, 7001, 7002])
        calls = []
        mgr.on_change = lambda ren, n: calls.append(("legacy", ren, n))

        def boom(ren, n):
            calls.append(("boom", ren, n))
            raise RuntimeError("observer crash")

        mgr.add_observer(boom)
        mgr.add_observer(lambda ren, n: calls.append(("fleet", ren, n)))
        mgr.apply_op(pkg[0].REMOVE, 1)
        return calls, _state(mgr, tr)

    calls, _ = _both(scenario)
    assert [c[0] for c in calls] == ["legacy", "boom", "fleet"]


def test_manager_removal_quiesces_wire():
    def scenario(pkg):
        mgr, tr = _manager(pkg, 1, 0, [7000, 7001])
        mgr.apply_op(pkg[0].REMOVE, 1)
        return _state(mgr, tr)

    out = _both(scenario)
    assert out[2] and out[1] is None and out[-1][-1] == ({}, None)


def test_manager_epoch_guard_replies_and_flags(monkeypatch):
    class Clock:
        t = 50.0

        def monotonic(self):
            return self.t

    def scenario(pkg):
        clock = Clock()
        monkeypatch.setattr(pkg[0], "_time", clock)
        mgr, tr = _manager(pkg, 0, 2, [7000, 7001])
        out = [mgr.check_epoch(1, Tag(instance=1, call_stack=2)),
               mgr.check_epoch(1, Tag(instance=1, call_stack=1)),
               mgr.check_epoch(1, Tag(instance=1, call_stack=1))]
        clock.t += 1.0
        out.append(mgr.check_epoch(1, Tag(instance=1, call_stack=1)))
        out.append(mgr.check_epoch(1, Tag(instance=1, call_stack=3)))
        return out, _state(mgr, tr)

    out, state = _both(scenario)
    assert out == [True, False, False, False, False] and state[3]
    sent = state[6]
    assert len(sent) == 2 and Tag.unpack(sent[0][1]).flag == FLAG_VIEW
    assert tview.View.from_wire(wire_loads(sent[0][2])).epoch == 2


def test_manager_adopt_wire_moves_and_detects_removal():
    def scenario(pkg):
        mgr, tr = _manager(pkg, 1, 0, [7000, 7001, 7002])
        seen = []
        mgr.add_observer(lambda ren, n: seen.append((ren, n)))
        v0 = pkg[0].View(0, _local_group(pkg, [7000, 7001]))
        out = [mgr.adopt_wire(v0.wire()),
               mgr.adopt_wire((1, (("127.0.0.1", 7000),
                                   ("127.0.0.1", 7001)))),
               mgr.adopt_wire((2, (("127.0.0.1", 7000),))),
               mgr.adopt_wire((3, (("127.0.0.1", 7000),)))]
        return out, seen, _state(mgr, tr)

    out, seen, state = _both(scenario)
    assert out == [False, True, True, False] and state[2]


def test_manager_apply_op_farewells_removed_pid():
    def scenario(pkg):
        mgr, tr = _manager(pkg, 0, 0, [7000, 7001, 7002])
        mgr.apply_op(pkg[0].REMOVE, 2)
        return _state(mgr, tr)

    state = _both(scenario)
    to, word, payload = state[6][0]
    assert to == 2 and Tag.unpack(word).flag == FLAG_VIEW
    assert tview.View.from_wire(wire_loads(payload)).epoch == 1


def test_propose_waits_for_the_host_runner():
    """propose runs its consensus through the host runner
    (runtime/host.py::HostRunner, tests/test_torch_host.py decides one),
    on the card by default: with no card it raises before the view
    moves, and a removed replica returns None without running."""
    import torch

    from round_tpu_torch.apps.selector import select

    mgr, _ = _manager(PKGS[1], 0, 0, [7000, 7001, 7002])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mgr.propose(select("otr"), tview.ADD, 7003)
    assert mgr.epoch == 0 and mgr.history == []
    mgr.removed = True
    assert mgr.propose(select("otr"), tview.ADD, 7003, device="cpu") is None
