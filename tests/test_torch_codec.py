"""The port's wire codec (round_tpu_torch/runtime/codec.py) against
round_tpu's, byte for byte: the reference's payload strategies and the
model suite encode to round_tpu's bytes, each package decodes the other's
frames, the golden tag, dtype, payload and batch-framing bytes are pinned
to tests/test_codec.py's values, and adversarial or fuzzed bytes are
refused as round_tpu refuses them.  Payload tensors reach the codec
through runtime/host.py::to_numpy, so the tests hold that too."""

import pickle
import struct

import jax
import numpy as np
import pytest
import torch

from round_tpu.runtime import codec as rc
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime import codec as pc
from round_tpu_torch.runtime import host as ph

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

WIRE_PAYLOADS = [
    None,
    True,
    False,
    0,
    -1,
    (1 << 62),
    2.5,
    float("inf"),
    "payload-label",
    b"\x00\x80\xff",
    np.int32(7),
    np.zeros((), np.int64),
    np.float32(1.5),
    np.bool_(True),
    np.ones((5,), bool),
    np.arange(12, dtype=np.int32).reshape(3, 4),
    np.arange(4, dtype=np.int64),
    np.array([], dtype=np.float64),
    np.zeros((2, 0, 3), np.uint8),
    np.arange(6, dtype=np.uint16),
    np.linspace(0, 1, 7, dtype=np.float16),
    np.array([1 + 2j], np.complex64),
    np.arange(6, dtype=np.int32)[::2],          # not C-contiguous
    (1, 2),
    (np.int32(3), [np.ones(2, bool), None]),
    {"x": np.int32(1), "vote": np.ones(3, bool)},
    [],
    {},
    (),
    # outside the binary vocabulary: the tagged pickle fallback
    {1: "a"},
    1 << 80,
]


def _same(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        xa, ya = np.asarray(x), np.asarray(y)
        assert xa.dtype == ya.dtype and xa.shape == ya.shape
        if xa.dtype == object:  # a big int or a str: compare values
            assert xa.tolist() == ya.tolist()
        else:
            assert xa.tobytes() == ya.tobytes()
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)


@pytest.mark.parametrize("obj", WIRE_PAYLOADS,
                         ids=[repr(o)[:40] for o in WIRE_PAYLOADS])
def test_codec_bytes_equal_round_tpus(obj):
    raw = pc.encode(obj)
    assert raw == rc.encode(obj)
    _same(pc.decode(raw), rc.decode(raw))
    _same(pc.loads(raw), obj)


def test_golden_tag_bytes_pinned():
    assert (pc.T_NONE, pc.T_TRUE, pc.T_FALSE) == (0xA0, 0xA1, 0xA2)
    assert (pc.T_INT, pc.T_FLOAT, pc.T_ARRAY) == (0xA3, 0xA4, 0xA5)
    assert (pc.T_TUPLE, pc.T_LIST, pc.T_DICT) == (0xA6, 0xA7, 0xA8)
    assert (pc.T_STR, pc.T_BYTES, pc.T_PICKLE) == (0xA9, 0xAA, 0xAF)


def test_golden_dtype_vocabulary_pinned():
    want = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
            "uint32", "uint64", "float16", "float32", "float64",
            "complex64", "complex128"]
    names = [dt.name for dt in pc._DTYPES]
    assert names[:14] == want, names
    # bf16 last, only where ml_dtypes imports — round_tpu's table exactly
    assert pc._DTYPES == rc._DTYPES
    assert len(pc._DTYPES) <= 16


def test_golden_payload_bytes_pinned():
    payload = {"x": np.arange(2, dtype=np.int32), "y": np.float64(2.5)}
    want = bytes(
        [0xA8, 2, 0, 0, 0]
        + [1, 0] + list(b"x")
        + [0xA5, 3, 1, 2, 0, 0, 0]
        + list(np.arange(2, dtype="<i4").tobytes())
        + [1, 0] + list(b"y")
        + [0xA5, 11, 0]
        + list(np.float64(2.5).tobytes()))
    assert pc.encode(payload) == want
    tmpl, holes = pc.array_layout(payload)
    assert tmpl == want and holes == [(15, 8, 0), (29, 8, 1)]
    assert pc.array_layout(payload) == rc.array_layout(payload)


def test_golden_batch_framing_pinned():
    from round_tpu_torch.runtime.oob import FLAG_BATCH, Tag
    from round_tpu_torch.runtime.transport import _BATCH_HDR, _RECV_HDR

    assert FLAG_BATCH == 0xB7
    assert _BATCH_HDR.format == "<QI" and _BATCH_HDR.size == 12
    assert _RECV_HDR.format == "<iQI" and _RECV_HDR.size == 16
    assert Tag(instance=0, round=3, flag=FLAG_BATCH).pack() \
        == (3 << 32) | 0xB7
    sub = _BATCH_HDR.pack(Tag(instance=7, round=1).pack(), 4) + b"\1\2\3\4"
    assert sub[:12] == Tag(instance=7, round=1).pack().to_bytes(
        8, "little") + (4).to_bytes(4, "little")


ADVERSARIAL = [
    b"",
    bytes([pc.T_INT]),
    bytes([pc.T_ARRAY, 0, 1]),
    bytes([pc.T_ARRAY, 200, 1, 0, 0, 0, 0]),
    bytes([pc.T_ARRAY, 3, 12]),
    bytes([pc.T_ARRAY, 3, 2]) + struct.pack("<II", 1 << 30, 1 << 30),
    bytes([pc.T_TUPLE]) + struct.pack("<I", 0xFFFFFFFF),
    bytes([pc.T_DICT]) + struct.pack("<I", 2) + b"\x01\x00a",
    bytes([pc.T_STR]) + struct.pack("<I", 4) + b"\xff\xff\xff\xff",
    bytes([pc.T_NONE, 0x00]),
    bytes([0x9C, 1, 2, 3]),
]


def _outcome(loads, raw):
    try:
        return "ok", loads(raw)
    except Exception as e:  # noqa: BLE001 — the refusal class is compared
        return type(e).__name__, None


@pytest.mark.parametrize("raw", ADVERSARIAL, ids=lambda r: r[:8].hex())
def test_adversarial_bytes_refused_alike(raw):
    got, want = _outcome(pc.loads, raw), _outcome(rc.loads, raw)
    assert got[0] == want[0] and got[0] != "ok"


def test_fuzzed_bytes_refused_alike():
    """Random and mutated frames: the port accepts exactly what round_tpu
    accepts, with the same value, and refuses the rest with the same
    error class."""
    rng = np.random.default_rng(0)
    seeds = [pc.encode(p) for p in WIRE_PAYLOADS[:24]]
    for k in range(600):
        if k % 2:
            raw = bytes(rng.integers(0, 256, size=int(rng.integers(0, 48)),
                                     dtype=np.uint8))
        else:
            b = bytearray(seeds[k % len(seeds)])
            if b:
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
            raw = bytes(b[:int(rng.integers(0, len(b) + 1))])
        got, want = _outcome(pc.loads, raw), _outcome(rc.loads, raw)
        assert got[0] == want[0], (raw.hex(), got, want)
        if got[0] == "ok":
            _same(got[1], want[1])


def test_gadgets_refused_through_both_paths():
    class Evil:
        def __reduce__(self):
            return (eval, ("1+1",))

    with pytest.raises(pickle.UnpicklingError):
        pc.loads(pickle.dumps(Evil()))
    with pytest.raises(pickle.UnpicklingError):
        pc.decode(bytes([pc.T_PICKLE]) + pickle.dumps(Evil()))
    legacy = pickle.dumps(np.arange(3, dtype=np.int32))
    assert np.array_equal(pc.loads(legacy), np.arange(3))


def test_fallback_counts_and_decode_is_zero_copy():
    c = METRICS.counter("wire.codec_fallbacks")
    for obj in ({1: "a"}, 1 << 80, {"k" * 70000: 1}):
        before = c.value
        assert pc.decode(pc.encode(obj)) == obj
        assert c.value == before + 1
    dec = pc.decode(pc.encode(np.arange(1000, dtype=np.int32)))
    assert not dec.flags.writeable and dec.base is not None


def test_scratch_reuse_and_release():
    sc = pc.Scratch()
    v1 = sc.encode(np.arange(4, dtype=np.int32))
    b1 = bytes(v1)
    v2 = sc.encode(np.arange(8, dtype=np.int64))
    assert bytes(v2) == rc.encode(np.arange(8, dtype=np.int64))
    assert b1 == rc.encode(np.arange(4, dtype=np.int32))
    with pytest.raises(ValueError):
        bytes(v1)


# -- tensors to the wire ------------------------------------------------------


def test_to_numpy_flattens_as_jax_does():
    """Dict keys sorted and None an empty node (torch's pytree keeps
    insertion order and takes None for a leaf): the leaves, their order
    and the bytes are round_tpu's for the same values."""
    tree = {"z": torch.tensor([1, 2], dtype=torch.int32),
            "a": (torch.tensor(True), None, [torch.tensor(2.5)]),
            "m": torch.zeros((2, 0), dtype=torch.uint8)}
    got = ph.to_numpy(tree)
    want = jax.tree_util.tree_map(
        np.asarray, {"z": np.array([1, 2], np.int32),
                     "a": (np.bool_(True), None, [np.float32(2.5)]),
                     "m": np.zeros((2, 0), np.uint8)})
    assert list(got) == ["a", "m", "z"]
    _same(got, want)
    assert pc.encode(got) == rc.encode(want)
    leaves, _ = ph._flatten(tree)
    assert len(leaves) == len(jax.tree_util.tree_leaves(want))


def test_to_device_round_trips_without_aliasing():
    vals = {"b": np.arange(6, dtype=np.int64).reshape(2, 3),
            "a": (np.ones(3, bool), np.float64(4.5),
                  np.array([1 + 1j], np.complex128))}
    got = ph.to_device(vals, "cpu")
    _same(ph.to_numpy(got), vals)
    vals["b"][0, 0] = 99  # the device copy does not see host writes
    assert int(got["b"][0, 0]) == 0


def test_bf16_leaf_is_never_cast(monkeypatch):
    """A bfloat16 leaf crosses as ml_dtypes' bfloat16, the dtype a jax bf16
    payload has (code 14, as round_tpu encodes it); with no ml_dtypes it
    has no numpy form and raises — never a silent cast."""
    ml = pytest.importorskip("ml_dtypes")
    t = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    got = ph.to_numpy(t)
    assert got.dtype == np.dtype(ml.bfloat16)
    assert pc.encode(got) == rc.encode(np.asarray(jax.numpy.asarray(
        [1.5, -2.0, 3.25], dtype=jax.numpy.bfloat16)))
    back = ph.to_device(got, "cpu")
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)
    monkeypatch.setitem(__import__("sys").modules, "ml_dtypes", None)
    with pytest.raises(TypeError):
        ph.to_numpy(t)


# -- the model suite ----------------------------------------------------------


def _lane_io(name, n, lane, pkg):
    """One lane's io for a selector model (round_tpu's analysis registry
    io for MultiLastVoting and TwoPhaseCommit, PerfTest2's value else)."""
    if name == "mlv":
        from round_tpu.models.lastvoting_variants import mlv_io

        io = mlv_io(n, {0: 5, 3: 9}, {1: 0})
    elif name == "tpc":
        from round_tpu.models.tpc import tpc_io

        io = tpc_io(0, np.ones(n, dtype=bool))
    else:
        return pkg.instance_io(pkg_select(pkg, name), 3)
    return {k: np.asarray(v)[lane] for k, v in io.items()}


def pkg_select(pkg, name):
    if pkg is ph:
        from round_tpu_torch.apps.selector import select
    else:
        from round_tpu.apps.selector import select
    return select(name)


def _names():
    from round_tpu_torch.apps.selector import NAMES

    return NAMES


@pytest.mark.parametrize("name", _names())
def test_model_suite_payload_bytes_equal(name):
    """Every selector model's round payloads, sent from the port's state
    by the host runner's send, encode to round_tpu's bytes with zero
    pickle fallbacks; their native-pump templates are round_tpu's."""
    from round_tpu.core.rounds import RoundCtx
    from round_tpu.engine.executor import make_host_round_fns as r_fns
    from round_tpu.runtime import host as rh
    from round_tpu_torch.engine.executor import make_host_round_fns

    n, lane = 4, 1
    algo, ralgo = pkg_select(ph, name), pkg_select(rh, name)
    st = ph.lane_init_state(algo, lane, n, _lane_io(name, n, lane, ph), "cpu")
    rst = ralgo.make_init_state(RoundCtx(id=np.int32(lane), n=n,
                                         r=np.int32(0)),
                                _lane_io(name, n, lane, rh))
    c = METRICS.counter("wire.codec_fallbacks")
    before = c.value
    for k, (rnd, rrnd) in enumerate(zip(algo.rounds, ralgo.rounds)):
        _st, payload, dest = make_host_round_fns(rnd, n, "cpu")[0](
            k, lane, 0, st)
        _rs, rpayload, rdest = r_fns(rrnd, n)[0](
            np.int32(k), np.int32(lane), np.uint32(0), rst)
        got = ph.to_numpy(payload)
        want = jax.tree_util.tree_map(np.asarray, rpayload)
        assert pc.encode(got) == rc.encode(want), (name, k)
        assert pc.array_layout(got) == rc.array_layout(want)
        assert np.array_equal(ph.to_numpy(dest), np.asarray(rdest))
    assert c.value == before, f"{name}: a payload took the pickle fallback"
