"""Port parity: EventRound, the event-round models (LastVotingEvent,
TwoPhaseCommitEvent), the LastVoting variants (ShortLastVoting,
MultiLastVoting) and LastVotingBytes.

Each model runs through both general engines on the same numpy-made HO
schedules and inputs (round_tpu's ``from_schedule``, the port's
``from_schedule``) and must agree on every state field, ``done`` and
``decided_round`` (tolerance 0).  EventRound is held the same way through
a receive-per-message LastVotingEvent written in both packages.  The
port's own tests mirror round_tpu's tests/test_event_models.py (the
FoldRound-vs-EventRound differential, the `>=` tie-break, the 2PC modes,
fold_reduced against the tree fold) and tests/test_models_wave2.py's
Short/Multi LastVoting cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.core import rounds as jrounds
from round_tpu.core.algorithm import Algorithm as JAlgorithm
from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import run_instance as jrun_instance
from round_tpu.models import lastvoting as jlv
from round_tpu.models import lastvoting_event as jlve
from round_tpu.models import lastvoting_variants as jvar
from round_tpu.models import tpc_event as jtpce
from round_tpu.models.common import consensus_io as jconsensus_io
from round_tpu.models.tpc import tpc_io as jtpc_io
from round_tpu_torch.core import rounds as trounds
from round_tpu_torch.core.algorithm import Algorithm as TAlgorithm
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.engine.executor import run_instance as trun_instance
from round_tpu_torch.models import lastvoting as tlv
from round_tpu_torch.models import lastvoting_event as tlve
from round_tpu_torch.models import lastvoting_variants as tvar
from round_tpu_torch.models import tpc_event as ttpce
from round_tpu_torch.models.common import consensus_io as tconsensus_io
from round_tpu_torch.models.tpc import TwoPhaseCommit as TTpc
from round_tpu_torch.models.tpc import tpc_io as ttpc_io
from round_tpu_torch.ops.mailbox import Mailbox as TMailbox

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
LV_FIELDS = ("x", "ts", "ready", "commit", "vote", "decided", "decision")


def _schedule(rng, T, n, p):
    ho = rng.random((T, n, n)) < p
    for t in range(T):
        np.fill_diagonal(ho[t], True)
    return ho


def _run_t(algo, io, n, ho, phases):
    return trun_instance(algo, io, n, (0, 0),
                         tscen.from_schedule(torch.from_numpy(ho.copy())),
                         phases, device=CPU)


def _run_j(algo, io, n, ho, phases):
    return jrun_instance(algo, io, n, jax.random.PRNGKey(0),
                         jscen.from_schedule(jnp.asarray(ho)),
                         max_phases=phases)


def _assert_same(got, want, fields):
    for name in fields:
        np.testing.assert_array_equal(
            getattr(got.state, name).numpy(),
            np.asarray(getattr(want.state, name)), err_msg=name)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(got.decided_round.numpy(),
                                  np.asarray(want.decided_round))


# -- a receive-per-message LastVotingEvent, in both packages ---------------

def _event_lve(R, where, as_i32, lvstate_rounds):
    """LastVotingEvent's four rounds as EventRound receive handlers (the
    reference's receive code 1:1, LastVotingEvent.scala:52-193) for either
    package: R the rounds module, where/as_i32 its array helpers."""
    Collect, Propose, Ack, Decide = lvstate_rounds

    def coord(ctx):
        return (ctx.r // 4) % ctx.n

    class SeqCollect(R.EventRound):
        send = Collect.send

        def pre(self, ctx, s):
            # round variables: running max ts, its value, message count
            return {**s, "mts": as_i32(-1, s["x"]), "mval": s["x"],
                    "nmsg": as_i32(0, s["x"])}

        def receive(self, ctx, s, sender, payload):
            takes = payload["ts"] >= s["mts"]
            s = {**s, "mts": where(takes, payload["ts"], s["mts"]),
                 "mval": where(takes, payload["x"], s["mval"]),
                 "nmsg": s["nmsg"] + 1}
            go = (ctx.r == 0) | (ctx.id != coord(ctx)) | (
                s["nmsg"] > ctx.n // 2)
            return s, go

        def finish_round(self, ctx, s, did_timeout):
            go = ((ctx.r == 0) | (ctx.id != coord(ctx))) | ~did_timeout
            act = (ctx.id == coord(ctx)) & go
            return {**s, "commit": s["commit"] | act,
                    "vote": where(act, s["mval"], s["vote"])}

    class SeqPropose(R.EventRound):
        send = Propose.send

        def pre(self, ctx, s):
            return {**s, "got": s["ready"] & False, "v": s["vote"] * 0}

        def receive(self, ctx, s, sender, payload):
            fc = sender == coord(ctx)
            return ({**s, "got": s["got"] | fc,
                     "v": where(fc, payload, s["v"])}, fc)

        def finish_round(self, ctx, s, did_timeout):
            return {**s, "x": where(s["got"], s["v"], s["x"]),
                    "ts": where(s["got"], ctx.r // 4, s["ts"])}

    class SeqAck(R.EventRound):
        send = Ack.send

        def pre(self, ctx, s):
            return {**s, "nmsg": as_i32(0, s["x"])}

        def receive(self, ctx, s, sender, payload):
            s = {**s, "nmsg": s["nmsg"] + 1}
            return s, (ctx.id != coord(ctx)) | (s["nmsg"] > ctx.n // 2)

        def finish_round(self, ctx, s, did_timeout):
            return {**s, "ready": (ctx.id == coord(ctx)) & ~did_timeout}

    class SeqDecide(SeqPropose):
        send = Decide.send

        def finish_round(self, ctx, s, did_timeout):
            newly = s["got"] & ~s["decided"]
            s = {**s, "decided": s["decided"] | s["got"],
                 "decision": where(newly, s["v"], s["decision"])}
            ctx.exit_at_end_of_round(s["decided"])
            return {**s, "ready": s["ready"] & False,
                    "commit": s["commit"] & False}

    return SeqCollect(), SeqPropose(), SeqAck(), SeqDecide()


def _dict_state_sends(mod):
    """LastVotingEvent's round classes with sends reading a dict state."""
    class S(dict):
        __getattr__ = dict.__getitem__

    def wrap(cls):
        class W(cls):
            def send(self, ctx, s):
                return cls.send(self, ctx, S(s))
        return W

    return tuple(wrap(c) for c in (mod.LVECollect, mod.LVEPropose,
                                   mod.LVEAck, mod.LVEDecide))


def _j_event_lve():
    rounds = _event_lve(
        jrounds, jnp.where, lambda v, like: jnp.asarray(v, jnp.int32),
        _dict_state_sends(jlve))

    class Algo(JAlgorithm):
        def __init__(self):
            self.rounds = rounds

        def make_init_state(self, ctx, io):
            x = jnp.asarray(io["initial_value"], jnp.int32)
            i = jnp.asarray(0, jnp.int32)
            return {"x": x, "ts": i - 1, "ready": jnp.asarray(False),
                    "commit": jnp.asarray(False), "vote": i,
                    "decided": jnp.asarray(False), "decision": i - 1,
                    "mts": i, "mval": i, "nmsg": i, "got": jnp.asarray(False),
                    "v": i}

        def decided(self, s):
            return s["decided"]

    return Algo()


def _t_event_lve():
    rounds = _event_lve(
        trounds, torch.where,
        lambda v, like: torch.full((), v, dtype=torch.int32,
                                   device=like.device),
        _dict_state_sends(tlve))

    class Algo(TAlgorithm):
        def __init__(self):
            self.rounds = rounds

        def make_init_state(self, ctx, io):
            x = torch.as_tensor(io["initial_value"]).to(torch.int32)
            z = torch.zeros_like(x)
            return {"x": x, "ts": z - 1, "ready": z != 0, "commit": z != 0,
                    "vote": z, "decided": z != 0, "decision": z - 1,
                    "mts": z, "mval": z, "nmsg": z, "got": z != 0, "v": z}

        def decided(self, s):
            return s["decided"]

    return Algo()


class _Wrap:
    def __init__(self, res):
        self.state = type("S", (), dict(res.state))
        self.done = res.done
        self.decided_round = res.decided_round


def test_event_round_matches_jax():
    """EventRound's per-message fold, bit for bit against round_tpu's
    EventRound adapter on random lossy schedules (ts ties included)."""
    rng = np.random.default_rng(3)
    for trial, (n, p) in enumerate(((5, 0.45), (7, 0.8), (4, 1.0))):
        ho = _schedule(rng, 8, n, p)
        init = rng.integers(0, 40, n).astype(np.int32)
        got = _run_t(_t_event_lve(), tconsensus_io(torch.from_numpy(init)),
                     n, ho, 2)
        want = _run_j(_j_event_lve(), jconsensus_io(init), n, ho, 2)
        _assert_same(_Wrap(got), _Wrap(want), LV_FIELDS)


def test_foldround_matches_event_round():
    """LastVotingEvent (FoldRound) == the same protocol on EventRound's
    sequential fold, bit for bit, over random lossy schedules."""
    rng = np.random.default_rng(5)
    for trial in range(4):
        n = int(rng.integers(3, 9))
        ho = _schedule(rng, 12, n, rng.choice([0.45, 0.8, 1.0]))
        init = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32))
        a = _run_t(tlve.LastVotingEvent(), tconsensus_io(init), n, ho, 3)
        b = _run_t(_t_event_lve(), tconsensus_io(init), n, ho, 3)
        for name in LV_FIELDS:
            assert torch.equal(getattr(a.state, name), b.state[name]), (
                trial, name)
        assert torch.equal(a.done, b.done)


# -- the models against round_tpu -----------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_lastvoting_event_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    n = 7
    ho = _schedule(rng, 12, n, 0.75)
    init = rng.integers(0, 50, n).astype(np.int32)
    got = _run_t(tlve.LastVotingEvent(), tconsensus_io(torch.from_numpy(init)),
                 n, ho, 3)
    want = _run_j(jlve.LastVotingEvent(), jconsensus_io(init), n, ho, 3)
    _assert_same(got, want, LV_FIELDS)


TPC_FIELDS = ("coord", "vote", "decision", "decided", "blocked")


@pytest.mark.parametrize("blocking,all_votes", [(False, False), (True, False),
                                                (False, True), (True, True)])
def test_tpc_event_matches_jax(blocking, all_votes):
    rng = np.random.default_rng(20 + 2 * blocking + all_votes)
    n = 6
    for p in (0.6, 1.0):
        ho = _schedule(rng, 3, n, p)
        votes = rng.random(n) < 0.8
        got = _run_t(ttpce.TwoPhaseCommitEvent(blocking, all_votes),
                     ttpc_io(0, torch.from_numpy(votes)), n, ho, 1)
        want = _run_j(jtpce.TwoPhaseCommitEvent(blocking, all_votes),
                      jtpc_io(0, votes.tolist()), n, ho, 1)
        _assert_same(got, want, TPC_FIELDS)


SLV_FIELDS = ("x", "ts", "commit", "vote", "decided", "decision")
MLV_FIELDS = ("x_val", "x_def", "coord_val", "coord_def", "ready", "decided",
              "decision")


def test_short_lastvoting_matches_jax():
    rng = np.random.default_rng(30)
    n = 7
    ho = _schedule(rng, 12, n, 0.8)
    init = rng.integers(0, 50, n).astype(np.int32)
    got = _run_t(tvar.ShortLastVoting(), tconsensus_io(torch.from_numpy(init)),
                 n, ho, 4)
    want = _run_j(jvar.ShortLastVoting(), jconsensus_io(init), n, ho, 4)
    _assert_same(got, want, SLV_FIELDS)


def test_multi_lastvoting_matches_jax():
    rng = np.random.default_rng(31)
    n = 6
    ho = _schedule(rng, 36, n, 0.7)
    props, hints = {1: 17, 4: 9}, {0: 4, 2: 3, 5: 1}
    got = _run_t(tvar.MultiLastVoting(), tvar.mlv_io(n, props, hints), n, ho,
                 12)
    want = _run_j(jvar.MultiLastVoting(), jvar.mlv_io(n, props, hints), n, ho,
                  12)
    _assert_same(got, want, MLV_FIELDS)


def test_lastvoting_bytes_matches_jax():
    rng = np.random.default_rng(32)
    n, B = 5, 8
    ho = _schedule(rng, 12, n, 0.8)
    init = rng.integers(0, 256, (n, B)).astype(np.uint8)
    got = _run_t(tlv.LastVotingBytes(B), tconsensus_io(torch.from_numpy(init)),
                 n, ho, 3)
    want = _run_j(jlv.LastVotingBytes(B), jconsensus_io(init), n, ho, 3)
    _assert_same(got, want, LV_FIELDS)
    assert got.state.x.dtype == torch.uint8 and got.state.x.shape == (n, B)


# -- the port's own tests, mirroring round_tpu's ---------------------------

def test_lve_full_network_decides_first_phase():
    """Full network: phase-0 coordinator proposes its OWN value and everyone
    decides it in round 4 (LastVotingEvent.scala:58-62)."""
    n = 5
    init = [7, 3, 9, 5, 4]
    res = _run_t(tlve.LastVotingEvent(), tconsensus_io(init), n,
                 np.ones((4, n, n), dtype=bool), 1)
    assert bool(res.state.decided.all())
    assert res.state.decision.tolist() == [init[0]] * n
    assert bool(res.done.all())


def test_lve_agreement_validity_under_faults():
    rng = np.random.default_rng(11)
    for trial in range(4):
        n = int(rng.integers(4, 10))
        ho = _schedule(rng, 16, n, 0.75)
        init = rng.integers(0, 50, n).tolist()
        res = _run_t(tlve.LastVotingEvent(), tconsensus_io(init), n, ho, 4)
        dec, got = res.state.decision.numpy(), res.state.decided.numpy()
        if got.any():
            assert len(set(dec[got].tolist())) == 1, trial  # agreement
            assert set(dec[got].tolist()) <= set(init), trial  # validity


def test_tpce_timeout_mode_matches_closed_tpc():
    """Timeout mode on schedules where every vote reaches the coordinator:
    decision parity with the closed TwoPhaseCommit."""
    rng = np.random.default_rng(5)
    for trial in range(6):
        n = int(rng.integers(3, 8))
        votes = torch.from_numpy(rng.random(n) < 0.7)
        ho = np.ones((3, n, n), dtype=bool)
        if trial % 2:  # receivers that hear nothing decide None in both
            ho[2, 1:, :] = rng.random((n - 1, n)) < 0.6
            np.fill_diagonal(ho[2], True)
        io = ttpc_io(0, votes)
        a = _run_t(ttpce.TwoPhaseCommitEvent(blocking=False), io, n, ho, 1)
        b = _run_t(TTpc(), io, n, ho, 1)
        assert torch.equal(a.state.decision, b.state.decision), trial
        assert bool(a.state.decided.all())


def test_tpce_early_abort_short_circuit():
    """all_votes=False: one NO aborts even if other votes are lost."""
    n = 4
    ho = np.ones((3, n, n), dtype=bool)
    ho[1, 0, 2:] = False  # coord misses two YES votes; the NO arrives
    res = _run_t(ttpce.TwoPhaseCommitEvent(blocking=False),
                 ttpc_io(0, [True, False, True, True]), n, ho, 1)
    assert res.state.decision.tolist() == [0] * n  # abort


def test_tpce_blocking_mode_freezes_on_silent_coordinator():
    n = 4
    ho = np.ones((3, n, n), dtype=bool)
    ho[:, :, 0] = False  # nobody ever hears the coordinator
    for t in range(3):
        np.fill_diagonal(ho[t], True)
    res = _run_t(ttpce.TwoPhaseCommitEvent(blocking=True),
                 ttpc_io(0, [True] * n), n, ho, 1)
    blocked = res.state.blocked
    assert bool(blocked[1:].all()) and bool(blocked[0])
    assert not bool(res.state.decided.any())
    assert bool(res.done.all())


def test_tpce_blocking_mode_full_network_commits():
    n = 5
    res = _run_t(ttpce.TwoPhaseCommitEvent(blocking=True, all_votes=True),
                 ttpc_io(0, [True] * n), n, np.ones((3, n, n), dtype=bool), 1)
    assert bool(res.state.decided.all())
    assert res.state.decision.tolist() == [1] * n


def test_tpce_blocking_round3_freeze_on_missed_decision():
    n = 4
    ho = np.ones((3, n, n), dtype=bool)
    ho[2, 3, 0] = False  # lane 3 misses the coord's decision
    res = _run_t(ttpce.TwoPhaseCommitEvent(blocking=True),
                 ttpc_io(0, [True] * n), n, ho, 1)
    assert bool(res.state.decided[:3].all())
    assert res.state.decision[:3].tolist() == [1] * 3
    assert bool(res.state.blocked[3]) and not bool(res.state.decided[3])


def test_fold_reduced_matches_tree_fold():
    """Every FoldRound with a `reduce` form gives the same (m, count) as
    the pairwise tree fold on random mailboxes."""
    n = 7
    rng = np.random.default_rng(4)

    def tpce_state():
        return ttpce.TpcEState(
            coord=torch.tensor(2, dtype=torch.int32),
            vote=torch.tensor(True), decision=torch.tensor(-1,
                                                           dtype=torch.int32),
            decided=torch.tensor(False), blocked=torch.tensor(False))

    def lv_state():
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
        return tlv.LVState(x=i32(9), ts=i32(-1), ready=torch.tensor(False),
                           commit=torch.tensor(False), vote=i32(0),
                           decided=torch.tensor(False), decision=i32(-1))

    cases = [
        (ttpce.TpcEPrepare(False, False), tpce_state(),
         lambda: torch.from_numpy(rng.random(n) < 0.7)),
        (ttpce.TpcEVote(False, True), tpce_state(),
         lambda: torch.from_numpy(rng.random(n) < 0.6)),
        (ttpce.TpcECommit(False, False), tpce_state(),
         lambda: torch.from_numpy(rng.random(n) < 0.5)),
        (tlve.LVECollect(), lv_state(),
         lambda: {"x": torch.from_numpy(rng.integers(0, 50, n).astype(
                      np.int32)),
                  "ts": torch.from_numpy(rng.integers(-1, 4, n).astype(
                      np.int32))}),
    ]
    for rnd, state, payload_fn in cases:
        for trial in range(12):
            mask = rng.random(n) < 0.55
            if trial == 0:
                mask[:] = False  # empty mailbox edge case
            if trial == 1:
                mask[:] = True
            ctx = trounds.RoundCtx(id=torch.tensor(2, dtype=torch.int32),
                                   n=n, r=torch.tensor(5, dtype=torch.int32))
            mbox = TMailbox(payload_fn(), torch.from_numpy(mask))
            m1, c1 = rnd.fold(ctx, state, mbox)
            m2, c2 = rnd.fold_reduced(ctx, state, mbox)
            assert int(c1) == int(c2)
            for a, b in zip(torch.utils._pytree.tree_leaves(m1),
                            torch.utils._pytree.tree_leaves(m2)):
                assert torch.equal(a, b), (type(rnd).__name__, trial)


def test_short_lastvoting_decides_first_phase():
    n = 4
    res = trun_instance(tvar.ShortLastVoting(), tconsensus_io([8, 3, 5, 9]),
                        n, (0, 0), tscen.full(n, device=CPU), 1, device=CPU)
    assert bool(res.state.decided.all())
    assert res.state.decision.tolist() == [8] * n  # coord 0's own value


def test_multi_lastvoting_single_proposer():
    n = 5
    res = trun_instance(tvar.MultiLastVoting(),
                        tvar.mlv_io(n, proposers={2: 44}), n, (0, 0),
                        tscen.full(n, device=CPU), 2, device=CPU)
    assert bool(res.state.decided.all())
    assert res.state.decision.tolist() == [44] * n


def test_multi_lastvoting_gives_up_without_proposer():
    n = 4
    res = trun_instance(tvar.MultiLastVoting(), tvar.mlv_io(n, proposers={}),
                        n, (0, 0), tscen.full(n, device=CPU), 12, device=CPU)
    assert bool(res.state.decided.all())
    assert res.state.decision.tolist() == [-1] * n  # give-up needs r > 30
