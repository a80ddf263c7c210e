"""The port's native transport (round_tpu_torch/runtime/transport.py over
its own copy of native/transport.cpp) against round_tpu's: the C++ source
is byte-identical, the port builds it into round_tpu_torch/_build/ with
g++ here, each package loads its own library, the two packages' nodes
exchange tagged frames both ways over TCP, UDP and TLS, and the wire
unpickler refuses round_tpu's gadgets."""

import os
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from round_tpu.runtime import transport as rt
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime import codec as pc
from round_tpu_torch.runtime import transport as pt
from round_tpu_torch.runtime.chaos import alloc_ports
from round_tpu_torch.runtime.oob import FLAG_BATCH, FLAG_DECISION, Message, Tag

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_native_source_is_round_tpus():
    """The two wires cannot drift apart unseen: the port's C++ is
    round_tpu's, byte for byte."""
    mine = (REPO / "round_tpu_torch/native/transport.cpp").read_bytes()
    assert mine == (REPO / "round_tpu/native/transport.cpp").read_bytes()


def test_library_builds_into_the_ports_build_dir():
    so = Path(pt._build_native())
    assert so == REPO / "round_tpu_torch/_build/libroundnet.so"
    assert so.stat().st_mtime >= (
        REPO / "round_tpu_torch/native/transport.cpp").stat().st_mtime
    # ctypes loads each package's own library (RTLD_LOCAL)
    assert Path(pt._load()._name) == so
    assert Path(rt._load()._name) != so


def test_native_so_override_is_honoured(tmp_path, monkeypatch):
    alt = tmp_path / "libroundnet-alt.so"
    shutil.copy(pt._build_native(), alt)
    monkeypatch.setenv("ROUND_TPU_NATIVE_SO", str(alt))
    monkeypatch.setattr(pt, "_lib", None)
    assert Path(pt._load()._name) == alt
    with pt.HostTransport(0) as a:
        assert a.port > 0


def _recv(tr, k, timeout_s=10.0):
    out = []
    t_end = time.monotonic() + timeout_s
    while len(out) < k and time.monotonic() < t_end:
        out.extend(tr.recv_many(200))
    return out


@pytest.mark.parametrize("proto", ["tcp", "udp", "tls"])
def test_frames_cross_between_packages_both_ways(proto):
    """A port node and a round_tpu node exchange tagged frames, plain and
    batched, in both directions; each side decodes the other's codec
    payloads."""
    ports = alloc_ports(2)
    with pt.HostTransport(0, ports[0], proto=proto) as a, \
            rt.HostTransport(1, ports[1], proto=proto) as b:
        a.add_peer(1, "127.0.0.1", ports[1])
        b.add_peer(0, "127.0.0.1", ports[0])
        for src, dst, me in ((a, b, 0), (b, a, 1)):
            assert src.send(1 - me, Tag(instance=3, round=9),
                            pc.encode(np.int32(me)))
            for r in range(5):
                src.send_buffered(1 - me, Tag(instance=4, round=r),
                                  pc.encode({"v": np.arange(r, dtype=np.int64)}))
            assert src.flush() == 5
            got = _recv(dst, 6)
            assert [(f[0], f[1].instance, f[1].round) for f in got] == \
                [(me, 3, 9)] + [(me, 4, r) for r in range(5)]
            assert int(pc.loads(got[0][2])) == me
            for r, f in enumerate(got[1:]):
                assert np.array_equal(pc.loads(f[2])["v"], np.arange(r))


def test_batch_framing_and_malformed_container():
    with pt.HostTransport(0) as a, pt.HostTransport(1) as b:
        a.add_peer(1, "127.0.0.1", b.port)
        batches = METRICS.counter("wire.batches").value
        a.send_buffered(1, Tag(instance=1, round=0), b"solo")
        assert a.flush() == 1
        assert METRICS.counter("wire.batches").value == batches  # plain
        assert bytes(_recv(b, 1)[0][2]) == b"solo"
        a.batch_cap = 1024
        for r in range(6):  # 6 x 412 bytes: two containers
            a.send_buffered(1, Tag(instance=1, round=r), b"x" * 400)
        a.flush()
        assert [f[1].round for f in _recv(b, 6)] == list(range(6))
        good = pt._BATCH_HDR.pack(Tag(instance=5, round=1).pack(), 2) + b"ok"
        junk = pt._BATCH_HDR.pack(Tag(instance=5, round=2).pack(),
                                  9999) + b"short"
        bad = METRICS.counter("wire.batch_malformed").value
        assert a.send(1, Tag(instance=0, round=2, flag=FLAG_BATCH),
                      good + junk)
        got = _recv(b, 1)
        assert bytes(got[0][2]) == b"ok" and got[0][1].instance == 5
        assert METRICS.counter("wire.batch_malformed").value == bad + 1


def test_wire_unpickler_refuses_gadgets():
    """round_tpu's gadget set: an exec/eval reduce, a gadget inside the
    numpy namespace and the buffer-building opcodes are refused; the
    legitimate payload vocabulary round-trips — as round_tpu's does."""
    class Evil:
        def __reduce__(self):
            return (print, ("pwned",))

    import numpy.testing._private.utils as _nptu

    gadgets = [pickle.dumps(Evil()),
               pickle.dumps(bytearray(b"abc"), protocol=5)]
    if hasattr(_nptu, "runstring"):
        class EvilNp:
            def __reduce__(self):
                return (_nptu.runstring, ("x = 1", {}))

        gadgets.append(pickle.dumps(EvilNp()))
    for raw in gadgets:
        with pytest.raises(pickle.UnpicklingError):
            pt.wire_loads(raw)
        with pytest.raises(pickle.UnpicklingError):
            rt.wire_loads(raw)
    assert pt._WireUnpickler._ALLOWED == rt._WireUnpickler._ALLOWED
    for obj in (np.int32(7), np.arange(5), {"a": (1, "x")}, [True, 2.5],
                np.float32(1.5), None, frozenset({1}), complex(1, 2)):
        got = pt.wire_loads(pickle.dumps(obj))
        if isinstance(obj, np.ndarray):
            np.testing.assert_array_equal(got, obj)
        else:
            assert got == obj


def test_host_bus_between_packages():
    """Control-plane Messages: a port HostBus delivers a round_tpu
    HostBus's message to its node's handler, and the other way."""
    class Sink:
        def __init__(self):
            self.got = []

        def default_handler(self, msg):
            self.got.append(msg)

    ports = alloc_ports(2)
    with pt.HostTransport(0, ports[0]) as a, \
            rt.HostTransport(1, ports[1]) as b:
        a.add_peer(1, "127.0.0.1", ports[1])
        b.add_peer(0, "127.0.0.1", ports[0])
        pa, ra = pt.HostBus(a), rt.HostBus(b)
        sa, sb = Sink(), Sink()
        pa.register(sa)
        ra.register(sb)
        from round_tpu.runtime.oob import Message as RMessage
        from round_tpu.runtime.oob import Tag as RTag

        pa.send(1, Message(tag=Tag(instance=2, flag=FLAG_DECISION),
                           sender=0, payload=(7, np.int32(3))))
        ra.send(0, RMessage(tag=RTag(instance=2, flag=FLAG_DECISION),
                            sender=1, payload=np.arange(3)))
        t_end = time.monotonic() + 10
        while (not sa.got or not sb.got) and time.monotonic() < t_end:
            pa.deliver(timeout_ms=100)
            ra.deliver(timeout_ms=100)
        assert np.array_equal(sa.got[0].payload, np.arange(3))
        assert sb.got[0].payload[0] == 7 and int(sb.got[0].payload[1]) == 3


def test_round_pump_attaches():
    with pt.HostTransport(0) as a:
        pump = a.enable_pump(1, 3, 2)
        assert isinstance(pump, pt.RoundPump) and a.pump_send_ok
        a.disable_pump()


def test_pump_env_kill_switch(monkeypatch):
    monkeypatch.setenv("ROUND_TPU_PUMP", "0")
    with pt.HostTransport(0) as a:
        assert a.enable_pump(1, 3, 2) is None


def test_native_available():
    assert pt.native_available()
    assert os.path.exists(pt._NATIVE_SO)
