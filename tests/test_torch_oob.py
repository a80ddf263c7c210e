"""Port parity of out-of-band messaging (round_tpu_torch/runtime/oob.py).

The six tests of tests/test_oob.py run through both packages on the same
inputs: the message choreography (decision replay, TooLate, lazy join,
the decision callback, an undecided finish) and what each node's pool
holds afterwards are compared result by result.  ``Tag.pack`` gives
round_tpu's 64-bit words over a hypothesis sweep of the fields, and the
flag values are round_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from round_tpu.engine import scenarios as jscen
from round_tpu.models.common import consensus_io as jio
from round_tpu.models.otr import OTR as JOTR
from round_tpu.runtime import oob as joob
from round_tpu.runtime.instances import InstancePool as JPool
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.models.common import consensus_io as tio
from round_tpu_torch.models.otr import OTR as TOTR
from round_tpu_torch.runtime import oob as toob
from round_tpu_torch.runtime.instances import InstancePool as TPool

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")


class _Pkg:
    """One package's side of a test: its pool, io, oob module and key."""

    def __init__(self, which):
        self.jax = which == "jax"
        self.oob = joob if self.jax else toob

    def pool(self, n=4, window=4, schedule=None):
        if self.jax:
            s = (jscen.full(n) if schedule is None
                 else jscen.from_schedule(jnp.asarray(schedule)))
            return JPool(JOTR(), n, s, max_phases=4, window=window)
        s = (tscen.full(n, device=CPU) if schedule is None
             else tscen.from_schedule(torch.as_tensor(schedule)))
        return TPool(TOTR(), n, s, max_phases=4, window=window, device=CPU)

    def io(self, n, v0):
        if self.jax:
            return jio(jnp.full((n,), v0, dtype=jnp.int32))
        return tio(torch.full((n,), v0, dtype=torch.int32))

    def key(self, k):
        return jax.random.PRNGKey(k) if self.jax else (0, k)


PKGS = (_Pkg("jax"), _Pkg("torch"))


def _snapshot(pool, ids):
    """What a pool holds for ``ids``: per id None or (decided, decision,
    decided_round, value), and which are running."""
    out = []
    for i in ids:
        res = pool.get_decision(i)
        out.append((pool.is_running(i), None if res is None else (
            np.asarray(res.decided).tolist(),
            np.asarray(res.decision).tolist(),
            np.asarray(res.decided_round).tolist(),
            None if res.value is None else int(res.value))))
    return out


def _both(scenario):
    outs = [scenario(p) for p in PKGS]
    assert outs[0] == outs[1], outs
    return outs[1]


def test_flags_are_round_tpus():
    names = [k for k in dir(joob) if k.startswith("FLAG_")
             or k.startswith("FLEET_")]
    assert names and all(getattr(toob, k) == getattr(joob, k) for k in names)


def test_tag_wire_layout_roundtrip():
    t = toob.Tag(instance=0xBEEF, round=0x12345678, flag=5, call_stack=2)
    w = t.pack()
    assert w == joob.Tag(instance=0xBEEF, round=0x12345678, flag=5,
                         call_stack=2).pack()
    assert w & 0xFF == 5 and (w >> 8) & 0xFF == 2
    assert (w >> 16) & 0xFFFF == 0xBEEF and (w >> 32) == 0x12345678
    assert toob.Tag.unpack(w) == t


@settings(max_examples=200, deadline=None)
@given(instance=st.integers(-(1 << 20), 1 << 20),
       round_=st.integers(-(1 << 40), 1 << 40),
       flag=st.integers(0, 1 << 10), call_stack=st.integers(-300, 300),
       word=st.integers(0, (1 << 64) - 1))
def test_tag_words_match_round_tpu(instance, round_, flag, call_stack, word):
    kw = dict(instance=instance, round=round_, flag=flag,
              call_stack=call_stack)
    assert toob.Tag(**kw).pack() == joob.Tag(**kw).pack()
    j, t = joob.Tag.unpack(word), toob.Tag.unpack(word)
    assert (t.instance, t.round, t.flag, t.call_stack) == \
        (j.instance, j.round, j.flag, j.call_stack)
    assert t.pack() == word == j.pack()


def test_laggard_recovers_gap_via_messages():
    def scenario(p):
        n = 4
        bus = p.oob.LocalBus()
        a_pool, b_pool = p.pool(n), p.pool(n)
        a = p.oob.PoolNode(1, a_pool, bus)
        b = p.oob.PoolNode(2, b_pool, bus)
        for iid, v in [(1, 7), (2, 9)]:
            a_pool.submit(iid, p.io(n, v))
            a.note_opened(iid)
        a_pool.run_all(p.key(0))
        b.probe(peer=1, instance_id=1)
        b.ask_decision(peer=1, instance_id=2)
        before = b_pool.get_decision(1)
        delivered = bus.deliver_all()
        return (before, delivered, _snapshot(b_pool, [1, 2]),
                b_pool.adopt_decision(1, 7))

    before, delivered, snap, again = _both(scenario)
    assert before is None and not again
    assert [s[1][3] for s in snap] == [7, 9]


def test_too_late_stops_the_asker():
    def scenario(p):
        n = 4
        bus = p.oob.LocalBus()
        a_pool, b_pool = p.pool(n), p.pool(n)
        a = p.oob.PoolNode(1, a_pool, bus)
        b = p.oob.PoolNode(2, b_pool, bus)
        a.note_opened(10)
        b_pool.submit(3, p.io(n, 5))
        b.probe(peer=1, instance_id=3)
        return bus.deliver_all(), _snapshot(b_pool, [3])

    assert _both(scenario)[1] == [(False, None)]


def test_lazy_join_on_unknown_future_instance():
    def scenario(p):
        n = 4
        bus = p.oob.LocalBus()
        a_pool, b_pool = p.pool(n), p.pool(n)
        started = []

        def lazy_start(iid):
            b_pool.submit(iid, p.io(n, 3))
            started.append(iid)

        a = p.oob.PoolNode(1, a_pool, bus)
        b = p.oob.PoolNode(2, b_pool, bus, on_unknown_instance=lazy_start)
        a.note_opened(5)
        a.probe(peer=2, instance_id=5, round_=1)
        bus.deliver_all()
        running = b_pool.is_running(5)
        b_pool.run_all(p.key(1))
        return started, running, int(b.version), _snapshot(b_pool, [5])

    started, running, version, snap = _both(scenario)
    assert started == [5] and running and version == 5
    assert snap[0][1][3] == 3


def test_decision_callback_fires():
    def scenario(p):
        n = 4
        bus = p.oob.LocalBus()
        a_pool, b_pool = p.pool(n), p.pool(n)
        seen = []
        a = p.oob.PoolNode(1, a_pool, bus)
        b = p.oob.PoolNode(2, b_pool, bus,
                           on_decision=lambda i, v: seen.append((i, int(v))))
        a_pool.submit(4, p.io(n, 11))
        a.note_opened(4)
        a_pool.run_all(p.key(2))
        b.ask_decision(peer=1, instance_id=4)
        bus.deliver_all()
        return seen, _snapshot(b_pool, [4])

    seen, snap = _both(scenario)
    assert seen == [(4, 11)]


def test_undecided_finish_replies_too_late_not_decision():
    def scenario(p):
        n = 4
        lonely = np.broadcast_to(np.eye(n, dtype=bool), (4, n, n)).copy()
        bus = p.oob.LocalBus()
        a_pool, b_pool = p.pool(n, schedule=lonely), p.pool(n)
        a = p.oob.PoolNode(1, a_pool, bus)
        b = p.oob.PoolNode(2, b_pool, bus)
        a_pool.submit(7, p.io(n, 3))
        a.note_opened(7)
        a_pool.run_all(p.key(0))
        after_a = _snapshot(a_pool, [7])
        b_pool.submit(7, p.io(n, 3))
        b.probe(peer=1, instance_id=7)
        bus.deliver_all()
        return after_a, _snapshot(b_pool, [7])

    after_a, after_b = _both(scenario)
    assert after_a[0][1][3] is None
    assert after_b == [(False, None)]


def test_unknown_flag_raises_after_delivering_the_rest():
    def scenario(p):
        bus = p.oob.LocalBus()
        pool = p.pool()
        node = p.oob.PoolNode(1, pool, bus)
        pool.submit(3, p.io(4, 1))
        bus.send(1, p.oob.Message(2, p.oob.Tag(9, flag=p.oob.FLAG_ERROR)))
        bus.send(1, p.oob.Message(2, p.oob.Tag(3, flag=p.oob.FLAG_TOO_LATE)))
        with pytest.raises(ValueError, match="unknown or error flag"):
            bus.deliver(node.node_id)
        return _snapshot(pool, [3])

    assert _both(scenario) == [(False, None)]
