"""The one traffic generator: fault scenarios from a traffic file's
families, drawn from the run's seed on the device.

A traffic file (hobench/traffic/<name>.json) lists `families`; scenario s
of a batch belongs to family s mod len(families).  Each family sets any of

  p8              iid drop threshold of every link (p = p8/256)
  crash_fraction  this share of the n processes (at least one) crash ...
  crash_round     ... at this round
  sides           processes split uniformly over this many sides ...
  heal_round      ... until this round
  rotate_period   k > 0: process (r // k) mod n is silent in round r

and the rest is 0.  This is the recipe of the four-family flagship mix and
of the Ben-Or rung's omission mix, written as data.

The structures (crash sets, sides, per-scenario parameters) of `pool`
batches are drawn once in set-up; every batch takes the next one of the
pool and draws fresh link salts and initial values (`draw_batch`).
"""

from __future__ import annotations

import torch

FAMILY_KEYS = ("p8", "crash_fraction", "crash_round", "sides", "heal_round",
               "rotate_period")
STRUCTURE = ("crashed", "side", "crash_round", "heal_round", "rotate_down",
             "p8")


def generator(seed: int, device) -> torch.Generator:
    """The run's generator; any whole number is a seed."""
    return torch.Generator(device=device).manual_seed(seed % (1 << 64))


def _family_table(families, key, n, device) -> torch.Tensor:
    vals = []
    for fam in families:
        unknown = set(fam) - set(FAMILY_KEYS) - {"name"}
        if unknown:
            raise ValueError(f"unknown family keys {sorted(unknown)}")
        if key == "crash_fraction":
            frac = fam.get(key, 0)
            vals.append(max(1, int(n * frac)) if frac > 0 else 0)
        else:
            vals.append(int(fam.get(key, 0)))
    return torch.tensor(vals, dtype=torch.int32, device=device)


def draw_structure(gen: torch.Generator, families, S: int, n: int,
                   device) -> dict:
    """One batch's fault structure: {crashed [S, n] bool, side [S, n]
    int32, crash_round, heal_round, rotate_down, p8: [S] int32}."""
    fam = (torch.arange(S, device=device) % len(families)).long()

    def per_scenario(key):
        return _family_table(families, key, n, device)[fam]

    crash_f = per_scenario("crash_fraction")
    sides = per_scenario("sides")
    # a uniform permutation per scenario: its first f processes crash
    perm = torch.argsort(torch.rand((S, n), generator=gen, device=device),
                         dim=1)
    crashed = perm < crash_f[:, None]
    u = torch.rand((S, n), generator=gen, device=device)
    side = torch.where(sides[:, None] > 1,
                       (u * sides[:, None]).to(torch.int32), 0)
    return {
        "crashed": crashed,
        "side": side.to(torch.int32),
        "crash_round": per_scenario("crash_round"),
        "heal_round": per_scenario("heal_round"),
        "rotate_down": per_scenario("rotate_period"),
        "p8": per_scenario("p8"),
    }


def _salts(gen, S, device) -> torch.Tensor:
    bits = torch.randint(0, 1 << 32, (S,), generator=gen, dtype=torch.int64,
                         device=device)
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
        torch.int32)


def draw_batch(gen: torch.Generator, S: int, n: int, init: dict,
               device) -> dict:
    """A batch's fresh draws: salt0, salt1 [S] int32 (uint32 bit
    patterns) and the initial values [S, n] int32, uniform over
    [0, init["values"])."""
    salt0 = _salts(gen, S, device)
    salt1 = _salts(gen, S, device)
    x0 = torch.randint(0, int(init["values"]), (S, n), generator=gen,
                       dtype=torch.int32, device=device)
    return {"salt0": salt0, "salt1": salt1, "init": x0}


def round_colmask(structure: dict, r: int) -> torch.Tensor:
    """[S, n] bool: the processes not silenced by a crash or the rotation in
    round r (the link count's senders, before exits)."""
    crashed = structure["crashed"]
    n = crashed.shape[1]
    alive = ~(crashed & (r >= structure["crash_round"])[:, None])
    period = structure["rotate_down"]
    victim = (r // torch.clamp(period, min=1)) % n
    lane = torch.arange(n, device=crashed.device)
    rotated = (lane[None, :] == victim[:, None]) & (period > 0)[:, None]
    return alive & ~rotated
