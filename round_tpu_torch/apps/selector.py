"""Consensus algorithm selection by name.

Port of round_tpu/apps/selector.py (example/ConsensusSelector.scala:14-31:
otr | lv | lve | slv by name, with per-algorithm option handling).  Every
name round_tpu's selector takes, with the same options and defaults.  Its
runtime-verification and snapshot-audit test fixtures (``rv-broken-*``,
``snap-broken-*``) load from ``rv/fixtures.py`` and ``snap/fixtures.py``
as round_tpu's do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from round_tpu_torch.core.algorithm import Algorithm

NAMES = ("otr", "lv", "lvb", "lve", "slv", "mlv", "benor", "floodmin",
         "kset", "tpc", "pbft", "pbft-vc")


def select(name: str, options: Optional[Dict[str, Any]] = None) -> Algorithm:
    """otr / lv / lvb / lve / slv / mlv / benor / floodmin / kset / tpc /
    pbft / pbft-vc → Algorithm (round_tpu/apps/selector.py::select)."""
    options = options or {}
    name = name.lower()
    if name == "otr":
        from round_tpu_torch.models.otr import OTR

        return OTR(after_decision=options.get("after_decision", 2))
    if name in ("lv", "lastvoting"):
        from round_tpu_torch.models.lastvoting import LastVoting

        return LastVoting()
    if name in ("lvb", "lastvoting-bytes", "lastvotingbytes"):
        # the KB-scale-payload workload: consensus on opaque
        # uint8[payload_bytes] vectors
        from round_tpu_torch.models.lastvoting import LastVotingBytes

        return LastVotingBytes(
            payload_bytes=options.get("payload_bytes", 1024))
    if name in ("lve", "lastvotingevent"):
        from round_tpu_torch.models.lastvoting_event import LastVotingEvent

        return LastVotingEvent()
    if name in ("slv", "short"):
        from round_tpu_torch.models.lastvoting_variants import (
            ShortLastVoting,
        )

        return ShortLastVoting()
    if name in ("mlv", "multi"):
        from round_tpu_torch.models.lastvoting_variants import (
            MultiLastVoting,
        )

        return MultiLastVoting()
    if name == "benor":
        from round_tpu_torch.models.benor import BenOr

        return BenOr()
    if name == "floodmin":
        from round_tpu_torch.models.floodmin import FloodMin

        return FloodMin(f=options.get("f", 1))
    if name == "kset":
        from round_tpu_torch.models.kset import KSetAgreement

        return KSetAgreement(k=options.get("k", 2))
    if name == "tpc":
        from round_tpu_torch.models.tpc import TwoPhaseCommit

        return TwoPhaseCommit()
    if name == "pbft":
        from round_tpu_torch.models.pbft import PbftConsensus

        return PbftConsensus(
            synchronized=options.get("synchronized", False))
    if name in ("pbft-vc", "pbftvc"):
        from round_tpu_torch.models.pbft import PbftViewChange

        return PbftViewChange()
    if name.startswith("rv-broken-"):
        # runtime-verification test fixtures: deliberately broken rounds
        # whose violation dumps replay through fuzz_cli; never deployed
        from round_tpu_torch.rv.fixtures import FIXTURES, select_fixture

        if name in FIXTURES:
            return select_fixture(name)
    if name.startswith("snap-broken-"):
        # snapshot-audit test fixtures: full-state invariant breaches
        # invisible to every per-lane monitor
        from round_tpu_torch.snap.fixtures import FIXTURES, select_fixture

        if name in FIXTURES:
            return select_fixture(name)
    raise ValueError(
        f"unknown algorithm {name!r} (expected {'|'.join(NAMES)})")
