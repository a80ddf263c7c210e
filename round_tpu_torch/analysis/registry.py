"""The lintable-model registry: every algorithm in round_tpu_torch/models,
paired with a representative (algorithm, io) constructor at a small static n.

Port of round_tpu/analysis/registry.py, the constructors pointing at the
port's models.  The linter never *runs* a model's protocol — the io built
here only seeds the state whose round functions are traced (make_fx over
the engine's vmap).  The n is deliberately tiny: every shape in round code
is a function of n, so n=8 exercises the same aten graph structure as the
flagship n=1024 without the cost.

Adding a model to ``round_tpu_torch/models`` without registering it here is
itself caught: ``tests/test_torch_analysis.py`` cross-checks the registry
against the package's exported Algorithm subclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One registered model.

    name:  registry key (CLI argument, baseline `model` field).
    build: () -> (Algorithm, io pytree) at n = entry.n.
    n:     static group size used for abstract tracing.
    note:  one-liner shown by ``lint --list``.
    build_at: optional (n) -> (Algorithm, io) constructor at an ARBITRARY
      group size.  Threshold-automaton extraction (analysis/threshold.py)
      traces the same round code at several n samples and fits the quorum
      constants as affine functions of n — impossible from one fixed-n
      trace, where ``(2*n)//3`` is just the literal 5.  Models whose io
      shape is not parametric in n (the fixed-grid cgol) or whose value
      domain is outside the int/bool threshold fragment (epsilon's reals)
      leave it None and are out of the parameterized pass's scope.
    """

    name: str
    build: Callable[[], Tuple[Any, Any]]
    n: int = 8
    note: str = ""
    build_at: Optional[Callable[[int], Tuple[Any, Any]]] = None


def _consensus_int(n, v=4):
    from round_tpu_torch.models.common import consensus_io

    return consensus_io(np.arange(n, dtype=np.int32) % v)


def _otr(n=8):
    from round_tpu_torch.models.otr import OTR

    return OTR(), _consensus_int(n)


def _otr_hist(n=8):
    from round_tpu_torch.models.otr import OTR

    return OTR(n_values=4), _consensus_int(n)


def _floodmin(n=8):
    from round_tpu_torch.models.floodmin import FloodMin

    return FloodMin(f=2), _consensus_int(n)


def _benor(n=8):
    from round_tpu_torch.models.benor import BenOr
    from round_tpu_torch.models.common import consensus_io

    return BenOr(), consensus_io(np.arange(n) % 2 == 0)


def _lastvoting(n=8):
    from round_tpu_torch.models.lastvoting import LastVoting

    return LastVoting(), _consensus_int(n)


def _lastvoting_bytes(n=8):
    from round_tpu_torch.models.lastvoting import LastVotingBytes

    algo = LastVotingBytes(payload_bytes=16)
    io = {"initial_value": np.zeros((n, 16), dtype=np.uint8)}
    return algo, io


def _slv(n=8):
    from round_tpu_torch.models.lastvoting_variants import ShortLastVoting

    return ShortLastVoting(), _consensus_int(n)


def _mlv(n=8):
    from round_tpu_torch.models.lastvoting_variants import MultiLastVoting, mlv_io

    return MultiLastVoting(), mlv_io(n, {0: 5, 3: 9}, {1: 0})


def _lv_event(n=8):
    from round_tpu_torch.models.lastvoting_event import LastVotingEvent

    return LastVotingEvent(), _consensus_int(n)


def _tpc(n=8):
    from round_tpu_torch.models.tpc import TwoPhaseCommit, tpc_io

    return TwoPhaseCommit(), tpc_io(0, np.ones(n, dtype=bool))


def _tpc_event(n=8):
    from round_tpu_torch.models.tpc_event import TwoPhaseCommitEvent
    from round_tpu_torch.models.tpc import tpc_io

    return TwoPhaseCommitEvent(), tpc_io(0, np.ones(n, dtype=bool))


def _kset(n=8):
    from round_tpu_torch.models.kset import KSetAgreement

    return KSetAgreement(k=2), _consensus_int(n)


def _kset_es(n=8):
    from round_tpu_torch.models.kset import KSetEarlyStopping

    return KSetEarlyStopping(t=2, k=2), _consensus_int(n)


def _epsilon():
    from round_tpu_torch.models.epsilon import EpsilonConsensus, real_consensus_io

    n = 8
    return (EpsilonConsensus(n, f=1, epsilon=0.5),
            real_consensus_io(np.linspace(0.0, 10.0, n)))


def _lattice():
    from round_tpu_torch.models.lattice import LatticeAgreement, lattice_io

    return (LatticeAgreement(universe=6),
            lattice_io([[i % 6] for i in range(8)], 6))


def _erb(n=8):
    from round_tpu_torch.models.erb import EagerReliableBroadcast, broadcast_io

    return EagerReliableBroadcast(), broadcast_io(0, 3, n)


def _esfd(n=8):
    from round_tpu_torch.models.failure_detector import Esfd

    return Esfd(hysteresis=5), {}


def _mutex(n=8):
    from round_tpu_torch.models.mutex import SelfStabilizingMutualExclusion, mutex_io

    return (SelfStabilizingMutualExclusion(),
            mutex_io(np.arange(n, dtype=np.int32) % (n + 1)))


def _cgol():
    from round_tpu_torch.models.gameoflife import ConwayGameOfLife, cgol_io

    grid = np.zeros((2, 4), dtype=bool)
    grid[0, 1] = grid[1, 2] = True
    return ConwayGameOfLife(rows=2, cols=4), cgol_io(grid)


def _theta(n=8):
    from round_tpu_torch.models.theta import ThetaModel

    return ThetaModel(f=1, theta=2.0), {}


def _pbft(n=8):
    from round_tpu_torch.models.pbft import PbftConsensus

    return PbftConsensus(), {"initial_value": np.arange(n, dtype=np.int32)}


def _pbft_vc(n=8):
    from round_tpu_torch.models.pbft import PbftViewChange

    return PbftViewChange(), {"initial_value": np.arange(n, dtype=np.int32)}


REGISTRY: Tuple[ModelEntry, ...] = (
    ModelEntry("otr", _otr, note="one-third-rule consensus (generic mmor path)", build_at=_otr),
    ModelEntry("otr-hist", _otr_hist, note="OTR with the static value-domain histogram path", build_at=_otr_hist),
    ModelEntry("floodmin", _floodmin, note="FloodMin f-crash consensus", build_at=_floodmin),
    ModelEntry("benor", _benor, note="Ben-Or randomized binary consensus", build_at=_benor),
    ModelEntry("lastvoting", _lastvoting, note="LastVoting (Paxos in HO), 4-round phases", build_at=_lastvoting),
    ModelEntry("lastvoting-bytes", _lastvoting_bytes, note="LastVoting over opaque byte payloads", build_at=_lastvoting_bytes),
    ModelEntry("slv", _slv, note="ShortLastVoting variant", build_at=_slv),
    ModelEntry("mlv", _mlv, note="MultiLastVoting (proposer/acceptor split)", build_at=_mlv),
    ModelEntry("lastvoting-event", _lv_event, note="LastVoting as FoldRounds (OOPSLA'20 event rounds)", build_at=_lv_event),
    ModelEntry("tpc", _tpc, note="Two-phase commit", build_at=_tpc),
    ModelEntry("tpc-event", _tpc_event, note="Two-phase commit as FoldRounds", build_at=_tpc_event),
    ModelEntry("kset", _kset, note="k-set agreement by map merging", build_at=_kset),
    ModelEntry("kset-es", _kset_es, note="early-stopping k-set agreement", build_at=_kset_es),
    ModelEntry("epsilon", _epsilon, note="approximate (epsilon) real-valued consensus"),
    ModelEntry("lattice", _lattice, note="lattice agreement over bitset joins"),
    ModelEntry("erb", _erb, note="eager reliable broadcast", build_at=_erb),
    ModelEntry("esfd", _esfd, note="eventually-strong failure detector", build_at=_esfd),
    ModelEntry("mutex", _mutex, note="Dijkstra self-stabilizing token ring (EventRound)", build_at=_mutex),
    ModelEntry("cgol", _cgol, note="Conway life on the torus wire (stress model)"),
    ModelEntry("theta", _theta, note="Theta-model round synchronizer", build_at=_theta),
    ModelEntry("pbft", _pbft, note="PBFT agreement rounds (benign-execution slice)", build_at=_pbft),
    ModelEntry("pbft-vc", _pbft_vc, note="PBFT view-change selection rounds", build_at=_pbft_vc),
)

BY_NAME = {e.name: e for e in REGISTRY}


def get(name: str) -> ModelEntry:
    if name not in BY_NAME:
        raise KeyError(
            f"unknown model {name!r}; registered: {', '.join(sorted(BY_NAME))}"
        )
    return BY_NAME[name]
