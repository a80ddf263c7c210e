"""Port checks of the hw-mode generator and the two bisect probes.

The plain Philox4x32-10 twin (ops.fused.philox4x32_10) is held against
Random123's known-answer vectors and against an independent Python-integer
version; P2 (`philox_bits`) against its stream layout; P1 (`probe_double`)
against tools/tpu_bisect.py's Pallas kernel body in interpret mode.  All
comparisons are exact (tolerance 0).  round_tpu's own PRNG stage cannot run
here: the CPU has no lowering for `prng_seed`."""

import contextlib
import functools
import importlib.util
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from round_tpu_torch.ops import fused as tfused

REPO = Path(__file__).resolve().parent.parent
M32 = 0xFFFFFFFF
# Random123's Philox4x32-10 known-answer vectors: counter, key, output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _philox_ints(counter, key):
    """Philox4x32-10 on Python integers (exact 64-bit products)."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & M32
            k1 = (k1 + 0xBB67AE85) & M32
        p0 = 0xD2511F53 * c0
        p1 = 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & M32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & M32)
    return c0, c1, c2, c3


@pytest.mark.parametrize("counter,key,words", KAT)
def test_philox_known_answers(counter, key, words):
    assert _philox_ints(counter, key) == words
    got = tfused.philox4x32_10(counter, key)
    assert [int(w) for w in got] == list(words)
    # and through P2's plain version, whose counter base is `counter`
    seed = tfused._i32(torch.tensor(key))
    bits = tfused.philox_bits(seed, (4,), counter=counter)
    assert bits.dtype == torch.int32
    assert [w & M32 for w in bits.tolist()] == list(words)


def test_philox_twin_matches_python_integers():
    """The int64 twin splits each 32x32-bit product into 16-bit halves; it
    agrees with exact integer arithmetic on counters and keys that set the
    top bits."""
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 2**32, (4, 64), dtype=np.uint64)
    ctr[:, :4] = M32
    key = rng.integers(0, 2**32, (2, 64), dtype=np.uint64)
    got = tfused.philox4x32_10(
        [torch.as_tensor(c.astype(np.int64)) for c in ctr],
        [torch.as_tensor(k.astype(np.int64)) for k in key])
    for e in range(64):
        want = _philox_ints(tuple(int(c[e]) for c in ctr),
                            tuple(int(k[e]) for k in key))
        assert tuple(int(w[e]) for w in got) == want


def test_philox_bits_layout():
    """Element e (row-major) is word e & 3 of counter e >> 2, as int32."""
    seed = torch.tensor([1, 2], dtype=torch.int32)
    bits = tfused.philox_bits(seed, (6, 10))
    assert bits.shape == (6, 10) and bits.dtype == torch.int32
    flat = [w & M32 for w in bits.reshape(-1).tolist()]
    for e in range(60):
        assert flat[e] == _philox_ints((e >> 2, 0, 0, 0), (1, 2))[e & 3]
    # the bisect stage's check: more than 100 distinct words in 128 x 128
    big = tfused.philox_bits(seed, (128, 128))
    assert torch.unique(big).numel() > 100
    # a counter base shifts the stream by whole counters
    base = tfused.philox_bits(seed, (8,), counter=(3, 0, 0, 0))
    assert torch.equal(base, bits.reshape(-1)[12:20])
    # negative key words are the same uint32 keys
    neg = tfused.philox_bits(torch.tensor([-1, -2], dtype=torch.int32), (4,))
    assert [w & M32 for w in neg.tolist()] == list(
        _philox_ints((0, 0, 0, 0), (M32, M32 - 1)))


def test_philox_bits_refuses_a_bad_seed():
    with pytest.raises(ValueError, match="seed of shape"):
        tfused.philox_bits(torch.tensor([1, 2, 3]), (4,))


def test_probe_double_matches_pallas_interpret():
    """P1's plain version against tools/tpu_bisect.py's kernel body
    (`o_ref[...] = x_ref[...] * 2.0`, :36-37) in interpret mode."""
    def k(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    x = np.random.default_rng(1).standard_normal((128, 128)).astype(
        np.float32)
    want = pl.pallas_call(
        k, out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
        interpret=True)(jnp.asarray(x))
    got = tfused.probe_double(torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="float32"):
        tfused.probe_double(torch.ones((2, 2), dtype=torch.float64))


def test_probe_double_matches_the_tool_stage(monkeypatch):
    """tools/tpu_bisect.py::stage_pallas_min itself, its pallas_call forced
    into interpret mode, prints the sum the port's kernel_min stage
    prints."""
    spec = importlib.util.spec_from_file_location(
        "tpu_bisect", REPO / "tools" / "tpu_bisect.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tool.stage_pallas_min()
    y = tfused.probe_double(torch.ones((128, 128), dtype=torch.float32))
    assert out.getvalue().strip() == f"pallas_min: {float(y.sum())}"
