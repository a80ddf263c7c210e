"""The comparison that decides `correct`.

While the window runs, a uniform sample of its batches is drawn from the
seed (`Sample`: reservoir sampling, so a batch late in the window is as
likely to be checked as the first), and of each sampled batch the
`per_family` scenarios of every family, also drawn from the seed.  Only
those scenarios' inputs (the pool's fault structure, the batch's salts and
initial values) and outputs are kept, gathered on the device when their
batch is done.  Once the window has closed they are run again by the plain
reference (hobench/reference/<algorithm>.py) from the same inputs, and
every output the program returned is compared with the reference's, lane
by lane, exactly.

One number is compared, with its limit: `lanes_differing`, the lanes
(process of a sampled scenario) where any returned field (the state, done,
decided round) differs from the reference's.  A weaker link stream in the
program's place moves decisions and decided rounds; the final estimates
often converge all the same, so only the whole lane separates it.
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

LIMITS = {"lanes_differing": 0}
# batches of the window that are checked; the window runs at least these
SAMPLE_BATCHES = 4


class Sample:
    """A uniform sample of SAMPLE_BATCHES of the window's batches
    (Algorithm R), and in each `per_family` scenario rows of every family,
    all drawn from the seed.  `offer` every batch of the window in order."""

    def __init__(self, seed: int, per_family: int, families: int):
        self.rng = random.Random(f"hobench-check-{seed}")
        self.per_family = per_family
        self.families = families
        self.seen = 0
        self.slots: Dict[int, dict] = {}  # slot -> the kept rows

    def offer(self, got: dict) -> None:
        i = self.seen
        self.seen += 1
        slot = i if i < SAMPLE_BATCHES else self.rng.randrange(i + 1)
        if slot < SAMPLE_BATCHES:
            self.slots[slot] = dict(_take(got, self._rows(got)), ordinal=i)

    def ordinals(self) -> List[int]:
        return sorted(k["ordinal"] for k in self.slots.values())

    def _rows(self, got: dict) -> List[int]:
        S = got["init"].shape[0]
        rows = []
        for f in range(self.families):
            members = range(f, S, self.families)
            rows += self.rng.sample(members,
                                    min(self.per_family, len(members)))
        return sorted(rows)

    def gather(self):
        """(reference inputs, initial values, the program's outputs), the
        kept batches' rows concatenated in window order."""
        kept = sorted(self.slots.values(), key=lambda k: k["ordinal"])
        cat = lambda parts: {k: torch.cat([p[k] for p in parts])  # noqa: E731
                             for k in parts[0]}
        return (cat([k["rows"] for k in kept]),
                torch.cat([k["init"] for k in kept]),
                cat([k["out"] for k in kept]))


def _take(got: dict, rows: List[int]) -> dict:
    """The rows of one batch: its inputs and its outputs as int64."""
    idx = torch.tensor(rows, dtype=torch.long, device=got["init"].device)
    r = {name: t[idx] for name, t in got["structure"].items()}
    r["salt0"], r["salt1"] = got["salt0"][idx], got["salt1"][idx]
    return {"rows": r, "init": got["init"][idx],
            "out": {name: t[idx].to(torch.int64)
                    for name, t in got["out"].items()}}


def compare(got: dict, want: dict, fields) -> dict:
    """The numbers compared: lanes where any of `fields` differs."""
    bad = torch.zeros_like(want[fields[0]], dtype=torch.bool)
    for name in fields:
        bad |= got[name].to(want[name].device) != want[name]
    return {"lanes_differing": int(bad.sum())}


def passed(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
