"""The reference's link streams and coin: Random123's known answers for
Philox4x32-10, and agreement with the program's plain twins (which the
reference itself never imports)."""

import pytest
import torch

from hobench.reference import links
from round_tpu_torch.ops import fused

torch.set_num_threads(1)

# Random123 kat_vectors: philox4x32 10 rounds, (counter, key) -> output
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = links.philox4x32(*counter, *key)
    assert tuple(int(w) for w in got) == want


def test_philox_seven_rounds_differs():
    got = links.philox4x32(0, 0, 0, 0, 0, 0, rounds=7)
    assert tuple(int(w) for w in got) != KAT[0][2]


@pytest.mark.parametrize("mode", ["hw", "hash"])
@pytest.mark.parametrize("n", [5, 16, 33])
def test_keep_matches_the_programs_plain_stream(mode, n):
    g = torch.Generator().manual_seed(n)
    c = 4
    salt0 = torch.randint(-2**31, 2**31, (c,), generator=g,
                          dtype=torch.int64).to(torch.int32)
    salt1r = torch.randint(0, 2**32, (c,), generator=g, dtype=torch.int64)
    p8 = torch.tensor([0, 13, 64, 255])
    want = fused._keep_mask(n, mode, salt0, salt1r, p8)
    got = links.keep(n, mode, salt0, salt1r, p8)
    off = ~torch.eye(n, dtype=torch.bool)[None]
    assert torch.equal(got & off, want)


def test_coin_matches_the_programs_plain_coin():
    g = torch.Generator().manual_seed(7)
    salt0 = torch.randint(0, 2**32, (5,), generator=g, dtype=torch.int64)
    salt1 = torch.randint(0, 2**32, (5,), generator=g, dtype=torch.int64)
    lane = torch.arange(40)
    for r in (0, 1, 17):
        want = fused.hash_coin(salt0[:, None], salt1[:, None], r,
                               lane[None, :])
        assert torch.equal(links.coin(salt0, salt1, r, 40), want)
