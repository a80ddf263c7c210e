"""Protocol specifications for the verifier, in the formula DSL.

These mirror the reference's hand-translated VC suites
(logic/TpcExample.scala, logic/OtrExample.scala, logic/LvExample.scala):
each protocol's rounds are written as transition relations over localized
state functions, with the communication assumption as the safety predicate,
and the invariants/properties from the runtime examples
(example/TwoPhaseCommit.scala, example/Otr.scala:95-120,
example/LastVoting.scala:19-70).

Port of round_tpu/verify/protocols.py.  The hand proofs are round_tpu's as
they are.  The nine extracted builders (``*_extracted_tr`` and
``pbft_vc_selection_extracted``) trace the port's own torch round code —
its ``ops/mailbox.py`` and models — through ``verify/extract.py``, on
``device`` (the CUDA device unless the caller names one); every function
that calls a builder passes ``device`` on.
"""

from __future__ import annotations

from typing import List

from round_tpu_torch.verify.cl import ClConfig
from round_tpu_torch.verify.formula import (
    And, Application, Binding, Bool, Card, Comprehension, Eq, Exists, FORALL,
    ForAll, FSet, Formula, FunT, Geq, Gt, Implies, In, Int, IntLit, Leq,
    Literal, Lt, Minus, Not, OR, Or, Plus, TRUE, Times, UnInterpretedFct,
    Variable,
    procType,
)
from round_tpu_torch.verify.futils import get_conjuncts
from round_tpu_torch.verify.tr import HO_FN, Mailbox, RoundTR, StateSig, ho_of
from round_tpu_torch.verify.venn import N_VAR as N
from round_tpu_torch.verify.verifier import ProtocolSpec, StagedChain


def _i32(v):
    """A 0-d int32 example tensor for a trace (``jnp.int32(v)``)."""
    import torch
    return torch.tensor(v, dtype=torch.int32)


def _b(v):
    """A 0-d bool example tensor for a trace (``jnp.bool_(v)``)."""
    import torch
    return torch.tensor(bool(v))


def _zeros(ne, dtype="int32"):
    """A [ne] example tensor of zeros (``jnp.zeros((ne,), dtype)``)."""
    import torch
    return torch.zeros(ne, dtype=getattr(torch, dtype))


# ---------------------------------------------------------------------------
# Two-Phase Commit (example/TwoPhaseCommit.scala, logic/TpcExample.scala)
# ---------------------------------------------------------------------------

def tpc_spec() -> ProtocolSpec:
    """2PC with coordinator: everyone sends its vote to the coordinator,
    which commits iff it heard ALL n yes-votes; round 2 broadcasts the
    outcome.  Agreement: any two processes that decided agree.

    BOTH rounds are verified (TpcExample.scala:142-178 proves round 1a/1b
    AND 2a/2b entailments), via the roundInvariants route: F0 (fresh
    state) ∧ TR₁ ⊨ F1′ (the vote round establishes the commit rule —
    commit(coord) only under unanimous yes, nobody decided), and
    F1 ∧ TR₂ ⊨ SC′ (the broadcast pins every decision to the
    coordinator's outcome).  Agreement AND the atomic-commit validity
    (a committed decision means everyone voted yes) follow from SC."""
    sig = StateSig({
        "vote": Bool,        # this process's yes/no vote (input)
        "decided": Bool,
        "commit": Bool,      # the decision value once decided
    })
    coord = Variable("coord", procType)

    i = Variable("i", procType)
    j = Variable("j", procType)
    k = Variable("k", procType)

    # Round 1 of TPC: vote collection into the coordinator
    # (TwoPhaseCommit.scala round 1: dest = coordinator; the coordinator
    # commits iff its mailbox holds ALL n votes and every one is yes)
    def r1_update(mb: Mailbox, jj, s: StateSig):
        all_heard = Eq(mb.size(), N)
        kk = Variable("tpk", procType)
        all_yes = ForAll(
            [kk], Implies(In(kk, mb.senders()), mb.payload("v", kk))
        )
        return And(
            Eq(
                s.get_primed("commit", jj),
                And(Eq(jj, coord), all_heard, all_yes),
            ),
            s.frame_equal(["vote", "decided"], jj),
        )

    r1 = RoundTR(
        sig=sig,
        payload_defs={"v": (Bool, lambda ii: sig.get("vote", ii))},
        dest_fn=lambda ii, jj: Eq(jj, coord),
        update_fn=r1_update,
    )

    # Round 2 of TPC: outcome broadcast from the coordinator.
    def r2_update(mb: Mailbox, jj, s: StateSig):
        heard_coord = In(coord, mb.senders())
        return And(
            Implies(
                heard_coord,
                And(
                    # the received payload is what the coordinator sent
                    Eq(s.get_primed("commit", jj), mb.payload("d", coord)),
                    s.get_primed("decided", jj),
                ),
            ),
            Implies(
                Not(heard_coord),
                And(
                    Eq(s.get_primed("commit", jj), s.get("commit", jj)),
                    Eq(s.get_primed("decided", jj), s.get("decided", jj)),
                ),
            ),
            s.frame_equal(["vote"], jj),
        )

    r2 = RoundTR(
        sig=sig,
        payload_defs={"d": (Bool, lambda ii: sig.get("commit", ii))},
        dest_fn=lambda ii, jj: Eq(ii, coord),
        update_fn=r2_update,
    )

    # Safety core: everyone who decided carries the coordinator's commit
    # value (the agreement core), and a commit can only mean unanimous yes
    # (the atomic-commit validity rule, established by round 1).
    commit_rule = Implies(
        sig.get("commit", coord), ForAll([k], sig.get("vote", k))
    )
    inv = ForAll(
        [i],
        Implies(
            sig.get("decided", i),
            Eq(sig.get("commit", i), sig.get("commit", coord)),
        ),
    )
    sc = And(inv, commit_rule)
    agreement = ForAll(
        [i, j],
        Implies(
            And(sig.get("decided", i), sig.get("decided", j)),
            Eq(sig.get("commit", i), sig.get("commit", j)),
        ),
    )
    validity = ForAll(
        [i],
        Implies(
            And(sig.get("decided", i), sig.get("commit", i)),
            ForAll([k], sig.get("vote", k)),
        ),
    )

    nobody_decided = ForAll([i], Not(sig.get("decided", i)))
    f0 = And(nobody_decided, ForAll([i], Not(sig.get("commit", i))))
    f1 = And(nobody_decided, commit_rule)
    init = f0

    # -- phase liveness walk (no upstream analogue: TpcExample.scala has
    # no progress obligations at all).  Under the good-phase environment —
    # the coordinator hears everyone and everyone hears the coordinator —
    # one phase decides EVERYWHERE with the exact atomic-commit outcome:
    #   live ∧ TR₁ ⊨ (commit(coord) ↔ unanimous yes)′   (collect)
    #   that ∧ live ∧ TR₂ ⊨ (∀i decided ∧ commit(i) ↔ unanimous)′
    # The ↔ is liveness-dependent: without all votes heard, a unanimous-yes
    # run still aborts (the ← direction fails — the negative control in
    # tests/test_tpc.py).
    vote_all = ForAll([k], sig.get("vote", k))
    live = And(
        ForAll([i], In(i, ho_of(coord))),
        ForAll([i], In(coord, ho_of(i))),
    )
    c1 = Eq(sig.get("commit", coord), vote_all)
    c2 = ForAll([i], And(
        sig.get("decided", i),
        Eq(sig.get("commit", i), vote_all),
    ))
    walk = [
        ("progress: collect — the outcome is exactly the unanimity test",
         live, r1.full_tr(), sig.prime(c1)),
        ("progress: broadcast — everyone decides the atomic outcome",
         And(c1, live), r2.full_tr(), sig.prime(c2)),
    ]

    return ProtocolSpec(
        sig=sig,
        rounds=[r1, r2],
        init=init,
        invariants=[sc],
        properties=[
            ("agreement", agreement),
            ("validity (commit => unanimous yes)", validity,
             ClConfig(venn_bound=1, inst_depth=2)),
        ],
        round_staged_inductiveness=[
            ("vote collection (round 1a/1b): commit rule established",
             f0, r1.full_tr(), sig.prime(f1)),
            ("outcome broadcast (round 2a/2b): decisions pin to the "
             "coordinator", f1, r2.full_tr(), sig.prime(sc)),
        ],
        round_staged_init=f0,
        phase_progress=walk,
    )


# ---------------------------------------------------------------------------
# OTR / One-Third-Rule (example/Otr.scala, logic/OtrExample.scala)
# ---------------------------------------------------------------------------

def otr_spec() -> ProtocolSpec:
    """The one-third-rule consensus round.

    State: x (current estimate), decided, dec.  Everyone broadcasts x; a
    receiver whose mailbox holds more than 2n/3 payloads (for a broadcast
    round |mb(j)| = |HO(j)| by mailboxLink) sets x′ = the most-often-received
    value (axiomatized function mor(j)) and decides when some value fills
    more than 2n/3 of its mailbox; a receiver WITHOUT the quorum keeps its
    state unchanged — the guard of Otr.scala's update (the round-4 spec
    baked the quorum into a standing safety predicate instead; the guard
    restores the faithful model, which is what makes the liveness ladder's
    no-magic negative control meaningful).

    Invariant (Otr.scala:95-120): ∃v with 3·|{i | x(i)=v}| > 2n and every
    decided process carries v.  Preservation is the one-third-rule argument:
    under the invariant every receiver that updates adopts v, so v's
    support never shrinks.

    LIVENESS (the magic-round ladder, logic/OtrExample.scala:50-57 +
    verification/Verifier.scala:144-157): invariants[1] = invariantProgress1
    (a value held unanimously, decisions pinned), invariants[2] =
    invariantProgress2 (everyone decided, one value).  The liveness
    predicate for both steps is the magic-round HO assumption — here the
    per-receiver cardinality form ∀j. 3|HO(j)| > 2n, the exact hypothesis
    the one-third-rule argument consumes (the reference's ∃A common-set
    form implies it; the common set is not needed).  The reference
    `ignore`s its magic-round tests ("z3 takes quite a bit of memory",
    OtrExample.scala:155-174); here the progress VCs discharge through the
    staged-chain machinery.
    """
    sig = StateSig({
        "x": Int,
        "decided": Bool,
        "dec": Int,
    })
    i = Variable("i", procType)
    j = Variable("j", procType)
    v = Variable("v", Int)
    w = Variable("w", Int)

    # mor(j): the most-often-received value of receiver j this round
    mor = UnInterpretedFct("mor", FunT([procType], Int))

    def mor_of(jj):
        return Application(mor, [jj]).with_type(Int)

    def support(jj, val):
        """{ k ∈ HO(jj) | x(k) = val } — senders supporting val (broadcast
        round: every sender addresses everyone)."""
        kk = Variable("supk", procType)
        return Comprehension(
            [kk], And(In(kk, ho_of(jj)), Eq(sig.get("x", kk), val))
        )

    def quorum(jj):
        # the update guard: > 2n/3 payloads heard (Otr.scala's mailbox
        # check; |mb| = |HO| for a broadcast round)
        return Gt(Times(3, Card(ho_of(jj))), Times(2, N))

    def mor_axioms() -> List[Formula]:
        # mor(j) is most-often: its support in HO(j) is ≥ any value's support
        return [
            ForAll(
                [j, w],
                Geq(Card(support(j, mor_of(j))), Card(support(j, w))),
            )
        ]

    def update(mb: Mailbox, jj, s: StateSig):
        newx = Eq(s.get_primed("x", jj), mor_of(jj))
        # decide when mor's support exceeds 2n/3 (Otr.scala decision rule)
        decide_cond = Gt(Times(3, Card(support(jj, mor_of(jj)))), Times(2, N))
        act = And(
            newx,
            Implies(
                decide_cond,
                And(
                    s.get_primed("decided", jj),
                    Eq(s.get_primed("dec", jj), mor_of(jj)),
                ),
            ),
            Implies(
                Not(decide_cond),
                And(
                    Eq(s.get_primed("decided", jj), s.get("decided", jj)),
                    Eq(s.get_primed("dec", jj), s.get("dec", jj)),
                ),
            ),
        )
        return And(
            Implies(quorum(jj), act),
            Implies(Not(quorum(jj)),
                    s.frame_equal(["x", "decided", "dec"], jj)),
        )

    rnd = RoundTR(
        sig=sig,
        payload_defs={"x": (Int, lambda ii: sig.get("x", ii))},
        dest_fn=None,  # broadcast
        update_fn=update,
        aux=mor_axioms,
    )

    # no standing communication assumption: quorums are per-receiver (the
    # update guard) and, for progress, supplied by the magic round
    safety = TRUE
    magic = ForAll([j], quorum(j))

    # the invariant: ∃v. 3|{i | x(i)=v}| > 2n ∧ ∀i. decided(i) → dec(i)=v
    def support_global(val):
        kk = Variable("invk", procType)
        return Comprehension([kk], Eq(sig.get("x", kk), val))

    inv = Exists(
        [v],
        And(
            Gt(Times(3, Card(support_global(v))), Times(2, N)),
            ForAll([i], Implies(sig.get("decided", i),
                                Eq(sig.get("dec", i), v))),
        ),
    )

    agreement = ForAll(
        [i, j],
        Implies(
            And(sig.get("decided", i), sig.get("decided", j)),
            Eq(sig.get("dec", i), sig.get("dec", j)),
        ),
    )

    init = And(
        ForAll([i], Not(sig.get("decided", i))),
        # all processes start with the same input → unanimity majority
        Exists([v], ForAll([i], Eq(sig.get("x", i), v))),
    )

    # -- the liveness ladder invariants (OtrExample.scala:50-57) ----------
    # invariantProgress1: one value held unanimously, decisions pinned.
    # Stated pointwise (∀i x=v) rather than via Card(A)=n — equivalent on
    # the process universe and what the reducer's instantiation consumes.
    p1 = Exists([v], And(
        ForAll([i], Eq(sig.get("x", i), v)),
        ForAll([i], Implies(sig.get("decided", i),
                            Eq(sig.get("dec", i), v))),
    ))
    # invariantProgress2: everyone decided one value (x pinned too — the
    # update keeps rewriting x, so stability needs it in the rung)
    p2 = Exists([v], ForAll([i], And(
        sig.get("decided", i),
        Eq(sig.get("dec", i), v),
        Eq(sig.get("x", i), v),
    )))
    termination = ForAll([i], sig.get("decided", i))

    # -- staged chains (the monolithic VCs blow up, exactly as the
    # reference notes for its suites; each chain below is one argument as
    # ∃-elimination with machine-checked composition).
    # Composition: v is the rung's skolemized witness, j0 an arbitrary
    # receiver whose quorum guard is an ASSUMPTION-SCOPED stage (∨-elim on
    # the per-receiver guard happens at the consuming stages), and the
    # hypotheses of later stages are subformulas of the TR plus ∀-closed
    # earlier conclusions.
    vfree = Variable("v!w", Int)
    j0 = Variable("j0", procType)
    maj_Sv = Gt(Times(3, Card(support_global(vfree))), Times(2, N))
    q_j0 = quorum(j0)
    # same bound-variable name as support_global so the final composition
    # VC's card terms line up with inv′'s comprehension syntactically
    sup_prime = Comprehension(
        [Variable("invk", procType)],
        Eq(sig.get_primed("x", Variable("invk", procType)), vfree),
    )
    c31 = ClConfig(venn_bound=3, inst_depth=1)
    c21 = ClConfig(venn_bound=2, inst_depth=1)
    c02 = ClConfig(venn_bound=0, inst_depth=2)
    c01 = ClConfig(venn_bound=0, inst_depth=1)

    pinned_v = ForAll([i], Implies(sig.get("decided", i),
                                   Eq(sig.get("dec", i), vfree)))
    pinned_v_prime = ForAll([i], Implies(sig.get_primed("decided", i),
                                         Eq(sig.get_primed("dec", i), vfree)))
    x_all_v = ForAll([i], Eq(sig.get("x", i), vfree))
    x_all_v_prime = ForAll([i], Eq(sig.get_primed("x", i), vfree))
    # p2's body at the witness (shared by chain_p2_inductive and
    # chain_progress_12 — ONE construction so prune membership and final
    # ∧-elimination can never desynchronize)
    dec_all = ForAll([i], And(
        sig.get("decided", i),
        Eq(sig.get("dec", i), vfree),
        Eq(sig.get("x", i), vfree),
    ))
    dec_all_prime = ForAll([i], And(
        sig.get_primed("decided", i),
        Eq(sig.get_primed("dec", i), vfree),
        Eq(sig.get_primed("x", i), vfree),
    ))
    tr_parts = get_conjuncts(rnd.full_tr())
    payload_forall, update_forall, mor_ax = tr_parts
    mor_inst = Geq(Card(support(j0, mor_of(j0))), Card(support(j0, vfree)))

    # the scoped one-third-rule stage: under the receiver's quorum guard,
    # a 2n/3-supported v forces mor(j0) = v.  Closure (the machinery's
    # ∀-intro over the fresh j0 with the assumption as antecedent):
    nA = "A: mor(j0) = v (one-third rule)"
    stage_A = (nA, And(maj_Sv, mor_inst), Eq(mor_of(j0), vfree), c31)
    closure_A = ForAll([j0], Implies(q_j0, Eq(mor_of(j0), vfree)))

    # the unanimous twin: when EVERYONE holds v, a quorate receiver's mor
    # is v (support(j0, v) fills HO(j0), so mor's support is all of a
    # nonempty HO — attainment pins mor to a heard value)
    nE = "E: mor(j0) = v (unanimous senders)"
    stage_E = (nE, And(x_all_v, mor_inst), Eq(mor_of(j0), vfree), c31)
    closure_E = closure_A  # same closed formula shape

    def chain_inv0() -> StagedChain:
        """inv ∧ TR ⊨ inv′: the one-third-rule preservation argument under
        the guard — updaters adopt v (stage A), keepers keep x, so S_v
        only grows (stage C) and decisions stay pinned (stage D)."""
        nB = "B: updaters adopt v, keepers keep x"
        c_B = ForAll([i], And(
            Implies(quorum(i), Eq(sig.get_primed("x", i), vfree)),
            Implies(Not(quorum(i)),
                    Eq(sig.get_primed("x", i), sig.get("x", i))),
        ))
        nC = "C: v's support persists as a supermajority"
        c_C = Gt(Times(3, Card(sup_prime)), Times(2, N))
        nD = "D: decisions stay pinned to v"
        stages = [
            stage_A,
            (nB, And(closure_A, update_forall), c_B, c02),
            (nC, And(c_B, maj_Sv), c_C, c21),
            (nD, And(closure_A, pinned_v, update_forall),
             pinned_v_prime, c21),
        ]
        return StagedChain(
            stages=stages,
            intros=[([vfree], And(maj_Sv, pinned_v), c21)],
            assumes={nA: q_j0},
            prune={
                "intro:0": [inv],
                f"justify:{nA}#0": [maj_Sv],
                f"justify:{nA}#1": [mor_ax],
                f"justify:{nB}#0": [closure_A],
                f"justify:{nB}#1": [update_forall],
                f"justify:{nC}#0": [c_B],
                f"justify:{nC}#1": [maj_Sv],
                f"justify:{nD}#0": [closure_A],
                f"justify:{nD}#1": [pinned_v],
                f"justify:{nD}#2": [update_forall],
                "final": [c_C, pinned_v_prime],
            },
            just_configs={
                f"justify:{nA}#0": c01,
                f"justify:{nA}#1": c01,
            },
            final_config=c01,
        )

    def chain_p1_inductive() -> StagedChain:
        """p1 ∧ TR ⊨ p1′ (no liveness needed): updaters adopt v by the
        unanimity argument (stage E), keepers already hold v."""
        nB = "B: everyone still holds v"
        stages = [
            stage_E,
            (nB, And(closure_E, x_all_v, update_forall), x_all_v_prime,
             c02),
            ("D: decisions stay pinned to v",
             And(closure_E, pinned_v, update_forall), pinned_v_prime, c21),
        ]
        nD = stages[2][0]
        return StagedChain(
            stages=stages,
            intros=[([vfree], And(x_all_v, pinned_v), c21)],
            assumes={nE: q_j0},
            prune={
                "intro:0": [p1],
                f"justify:{nE}#0": [x_all_v],
                f"justify:{nE}#1": [mor_ax],
                f"justify:{nB}#0": [closure_E],
                f"justify:{nB}#1": [x_all_v],
                f"justify:{nB}#2": [update_forall],
                f"justify:{nD}#0": [closure_E],
                f"justify:{nD}#1": [pinned_v],
                f"justify:{nD}#2": [update_forall],
                "final": [x_all_v_prime, pinned_v_prime],
            },
            just_configs={
                f"justify:{nE}#0": c01,
                f"justify:{nE}#1": c01,
            },
            final_config=c01,
        )

    def chain_p2_inductive() -> StagedChain:
        """p2 ∧ TR ⊨ p2′: with everyone decided on v and holding v, a
        quorate update re-adopts v (stage E) and any re-decision re-pins
        v; keepers are framed."""
        nG = "G: everyone stays decided on v"
        stages = [
            stage_E,
            (nG, And(closure_E, dec_all, update_forall), dec_all_prime,
             c02),
        ]
        return StagedChain(
            stages=stages,
            intros=[([vfree], dec_all, c21)],
            assumes={nE: q_j0},
            prune={
                "intro:0": [p2],
                # E's x_all_v hypothesis is derived from dec_all (its x
                # conjunct), not pruned-verbatim — a real justification VC
                f"justify:{nE}#0": [dec_all],
                f"justify:{nE}#1": [mor_ax],
                f"justify:{nG}#0": [closure_E],
                f"justify:{nG}#1": [dec_all],
                f"justify:{nG}#2": [update_forall],
                "final": [dec_all_prime],
            },
            just_configs={
                f"justify:{nE}#0": c01,
                f"justify:{nE}#1": c01,
            },
            final_config=c01,
        )

    def chain_progress_01() -> StagedChain:
        """inv ∧ magic ∧ TR ⊨ p1′ — the reference's "1st magic round"
        (OtrExample.scala:155-165, `ignore`d there): with every receiver
        quorate, every receiver updates and the one-third rule makes every
        update adopt v."""
        nB = "B: everyone adopts v under the magic round"
        stages = [
            stage_A,
            (nB, And(closure_A, magic, update_forall), x_all_v_prime, c02),
            ("D: decisions stay pinned to v",
             And(closure_A, pinned_v, update_forall), pinned_v_prime, c21),
        ]
        nD = stages[2][0]
        return StagedChain(
            stages=stages,
            intros=[([vfree], And(maj_Sv, pinned_v), c21)],
            assumes={nA: q_j0},
            prune={
                "intro:0": [inv],
                f"justify:{nA}#0": [maj_Sv],
                f"justify:{nA}#1": [mor_ax],
                f"justify:{nB}#0": [closure_A],
                f"justify:{nB}#1": [magic],
                f"justify:{nB}#2": [update_forall],
                f"justify:{nD}#0": [closure_A],
                f"justify:{nD}#1": [pinned_v],
                f"justify:{nD}#2": [update_forall],
                "final": [x_all_v_prime, pinned_v_prime],
            },
            just_configs={
                f"justify:{nA}#0": c01,
                f"justify:{nA}#1": c01,
            },
            final_config=c01,
        )

    def chain_progress_12() -> StagedChain:
        """p1 ∧ magic ∧ TR ⊨ p2′ — the reference's "2nd magic round"
        (OtrExample.scala:174-182, `ignore`d there): with unanimity and
        every receiver quorate, every receiver's decide condition fires on
        v (its support fills the quorate mailbox)."""
        nF = "F: everyone decides v under the magic round"
        stages = [
            stage_E,
            (nF, And(closure_E, magic, x_all_v, update_forall),
             dec_all_prime, c31),
        ]
        return StagedChain(
            stages=stages,
            intros=[([vfree], And(x_all_v, pinned_v), c21)],
            assumes={nE: q_j0},
            prune={
                "intro:0": [p1],
                f"justify:{nE}#0": [x_all_v],
                f"justify:{nE}#1": [mor_ax],
                f"justify:{nF}#0": [closure_E],
                f"justify:{nF}#1": [magic],
                f"justify:{nF}#2": [x_all_v],
                f"justify:{nF}#3": [update_forall],
                "final": [dec_all_prime],
            },
            just_configs={
                f"justify:{nE}#0": c01,
                f"justify:{nE}#1": c01,
            },
            final_config=c01,
        )

    return ProtocolSpec(
        sig=sig,
        rounds=[rnd],
        init=init,
        invariants=[inv, p1, p2],
        properties=[
            # phase-indexed hypotheses (4th element): agreement must prove
            # from the always-inductive rung 0 ALONE; termination is what
            # rung 2 means (OtrExample.scala:119-121)
            ("agreement", agreement, None, 0),
            ("termination", termination, None, 2),
        ],
        safety_predicate=safety,
        liveness=[magic, magic],
        config=ClConfig(venn_bound=3, inst_depth=1),
        staged={
            "invariant 0 inductive at round 0": chain_inv0(),
            "invariant 1 inductive at round 0": chain_p1_inductive(),
            "invariant 2 inductive at round 0": chain_p2_inductive(),
            "progress 0→1 via round 0": chain_progress_01(),
            "progress 1→2 via round 0": chain_progress_12(),
        },
    )


def otr_extracted_tr(device=None):
    """OTR's transition relation extracted from the *executable* round code
    (the Mailbox mmor path of models/otr.py) via the aten-graph abstract
    interpreter — the macro-boundary capability (reference:
    macros/TrExtractor.scala:101-160 extracts the TR from the same Scala
    source the runtime executes; here the same torch source the port's
    engine runs; round_tpu/verify/protocols.py::otr_extracted_tr).

    Returns (sig, j, update_equations, site_axioms, payload_def, value_bound):
    conjoin ForAll([j], update_equations) ∧ site_axioms ∧ payload_def into a
    TR.  `value_bound` (estimates below the int32 sentinel) reflects the
    executable's actual domain and is required for the mmor sentinel
    reasoning."""
    import torch

    from round_tpu_torch.ops.mailbox import Mailbox as RtMailbox
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn
    from round_tpu_torch.verify.formula import IN, Lt as FLt

    sig = StateSig({"x": Int, "decided": Bool, "dec": Int})
    j = Variable("j", procType)
    snd = UnInterpretedFct("sndx", FunT([procType], Int))

    def upd(n, x, decided, dec, vals, mask):
        # models/otr.py OtrRound.update, generic (histogram-free) path
        m = RtMailbox(vals, mask)
        quorum = m.size() > (2 * n) // 3
        v = m.min_most_often_received()
        v_count = m.count(lambda vs: vs == v)
        super_q = quorum & (v_count > (2 * n) // 3)
        decided2 = decided | super_q
        dec2 = torch.where(super_q & ~decided, v, dec)
        x2 = torch.where(quorum, v, x)
        return x2, decided2, dec2

    ne = 5
    ex_args = [_i32(ne), _i32(0), _b(False), _i32(-1),
               _zeros(ne), _zeros(ne, "bool")]
    fargs = [
        Scalar(N),
        Scalar(sig.get("x", j)),
        Scalar(sig.get("decided", j)),
        Scalar(sig.get("dec", j)),
        Vec(lambda i: Application(snd, [i]).with_type(Int)),
        Vec(lambda i: Application(IN, [i, ho_of(j)]).with_type(Bool)),
    ]
    outs, axioms = extract_lane_fn(
        upd, ex_args, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    update_eqs = And(*[
        Eq(sig.get_primed(name, j), out.f)
        for name, out in zip(["x", "decided", "dec"], outs)
    ])
    i0 = Variable("i0", procType)
    payload_def = ForAll([i0], Eq(Application(snd, [i0]).with_type(Int),
                                  sig.get("x", i0)))
    kb = Variable("kb", procType)
    value_bound = ForAll([kb], FLt(sig.get("x", kb), IntLit(2**31 - 1)))
    return sig, j, update_eqs, axioms, payload_def, value_bound


# ---------------------------------------------------------------------------
# LastVoting / Paxos-as-HO (example/LastVoting.scala, logic/LvExample.scala)
# ---------------------------------------------------------------------------

def lv_spec():
    """LastVoting: the Charron-Bost/Schiper Paxos-as-HO protocol — 4 rounds
    per phase with a rotating coordinator, timestamps, commit/ready flags
    (example/LastVoting.scala:83-212).

    The formula model mirrors the hand-translated suite
    logic/LvExample.scala:77-215 but localizes mailboxes as sender-set
    comprehensions + payload functions (no FMap theory needed):

      round 1: everyone sends (x, ts) to coord; with a majority mailbox the
               coordinator votes the max-timestamp value and commits.
      round 2: a committed coordinator broadcasts vote; receivers adopt it
               as x and stamp ts := phase.
      round 3: processes with ts = phase ack to coord; a majority makes the
               coordinator ready.
      round 4: a ready coordinator broadcasts vote; receivers decide it.
               commit/ready reset; the phase number advances.

    The invariant is LvExample's invariant1 (:222-239): either nobody has
    decided/committed/readied, or a majority set A = {i | ts(i) >= t}
    anchors a value v carried by every decided/committed/ready process.

    Returns (spec, lv) where `lv` carries the pieces the staged tests use
    (per-round TRs, the invariant, the phase variable).  Note the reference
    marks all four inductiveness VCs `ignore` ("those completely blow-up",
    LvExample.scala:262-264); the staged VCs here are discharged by the
    native reducer in tests/test_verifier.py.
    """
    sig = StateSig({
        "x": Int,
        "ts": Int,       # Time erased to Int (ReduceTime.scala:8-46)
        "ready": Bool,
        "commit": Bool,
        "vote": Int,
        "decided": Bool,
        "dec": Int,
    })
    coord = Variable("coord", procType)
    r = Variable("phase", Int)   # current phase number (r/4 in the runtime)

    i = Variable("i", procType)
    j = Variable("j", procType)
    v = Variable("v", Int)
    t = Variable("t", Int)

    # ghost: initial values (SpecHelper.init, verification/Utils.scala:24-39)
    x0 = UnInterpretedFct("x!init", FunT([procType], Int))

    def x0_of(ii):
        return Application(x0, [ii]).with_type(Int)

    def majority(card_term):
        return Gt(Times(2, card_term), N)

    # -- round 1: (x, ts) -> coord; coordinator votes max-ts value ---------
    maxx = UnInterpretedFct("lv!maxx", FunT([procType], Int))

    def maxx_of(jj):
        return Application(maxx, [jj]).with_type(Int)

    r1 = RoundTR(
        sig=sig,
        payload_defs={
            "x": (Int, lambda ii: sig.get("x", ii)),
            "ts": (Int, lambda ii: sig.get("ts", ii)),
        },
        dest_fn=lambda ii, jj: Eq(jj, coord),
        update_fn=lambda mb, jj, s: And(
            Implies(
                And(Eq(jj, coord), majority(mb.size())),
                And(
                    Eq(s.get_primed("vote", jj), maxx_of(jj)),
                    s.get_primed("commit", jj),
                ),
            ),
            Implies(
                Not(And(Eq(jj, coord), majority(mb.size()))),
                And(
                    Not(s.get_primed("commit", jj)),
                    Eq(s.get_primed("vote", jj), s.get("vote", jj)),
                ),
            ),
            s.frame_equal(["x", "ts", "ready", "decided", "dec"], jj),
        ),
        aux=lambda: [_lv_maxx_axiom(sig, coord, maxx)],
    )

    # -- round 2: committed coordinator broadcasts vote --------------------
    def r2_update(mb: Mailbox, jj, s: StateSig):
        heard = In(coord, mb.senders())
        return And(
            Implies(
                heard,
                And(
                    Eq(s.get_primed("x", jj), mb.payload("vote", coord)),
                    Eq(s.get_primed("ts", jj), r),
                ),
            ),
            Implies(
                Not(heard),
                And(
                    Eq(s.get_primed("x", jj), s.get("x", jj)),
                    Eq(s.get_primed("ts", jj), s.get("ts", jj)),
                ),
            ),
            s.frame_equal(["ready", "commit", "vote", "decided", "dec"], jj),
        )

    r2 = RoundTR(
        sig=sig,
        payload_defs={"vote": (Int, lambda ii: sig.get("vote", ii))},
        dest_fn=lambda ii, jj: And(Eq(ii, coord), sig.get("commit", ii)),
        update_fn=r2_update,
    )

    # -- round 3: ts = phase acks -> coord; majority makes coord ready ----
    r3 = RoundTR(
        sig=sig,
        payload_defs={"x": (Int, lambda ii: sig.get("x", ii))},
        dest_fn=lambda ii, jj: And(Eq(jj, coord), Eq(sig.get("ts", ii), r)),
        update_fn=lambda mb, jj, s: And(
            Eq(
                s.get_primed("ready", jj),
                And(Eq(jj, coord), majority(mb.size())),
            ),
            s.frame_equal(["x", "ts", "commit", "vote", "decided", "dec"], jj),
        ),
    )

    # -- round 4: ready coordinator broadcasts vote; receivers decide ------
    def r4_update(mb: Mailbox, jj, s: StateSig):
        heard = In(coord, mb.senders())
        return And(
            Implies(
                heard,
                And(
                    Eq(s.get_primed("x", jj), mb.payload("vote", coord)),
                    s.get_primed("decided", jj),
                    Eq(s.get_primed("dec", jj), mb.payload("vote", coord)),
                ),
            ),
            Implies(
                Not(heard),
                And(
                    Eq(s.get_primed("x", jj), s.get("x", jj)),
                    Eq(s.get_primed("decided", jj), s.get("decided", jj)),
                    Eq(s.get_primed("dec", jj), s.get("dec", jj)),
                ),
            ),
            # end-of-phase reset (LastVoting.scala:199-200)
            Not(s.get_primed("ready", jj)),
            Not(s.get_primed("commit", jj)),
            s.frame_equal(["ts", "vote"], jj),
        )

    r4 = RoundTR(
        sig=sig,
        payload_defs={"vote": (Int, lambda ii: sig.get("vote", ii))},
        dest_fn=lambda ii, jj: And(Eq(ii, coord), sig.get("ready", ii)),
        update_fn=r4_update,
    )

    # -- invariant (LvExample invariant1, :222-239) ------------------------
    def a_set(tt):
        kk = Variable("lva", procType)
        return Comprehension([kk], Geq(sig.get("ts", kk), tt))

    no_decision = ForAll(
        [i], And(Not(sig.get("decided", i)), Not(sig.get("ready", i)))
    )

    def anchored_body(vv, tt, ph=None):
        """The anchor at explicit witnesses (vv, tt) — the staged VCs use
        this skolemized form with chosen witnesses per round, which removes
        the ∃v,t search from every sub-VC (the reference-style ∃ form made
        the reducer enumerate v,t instantiations over all Int terms).
        `ph` is the phase term (default: the current phase variable); the
        round-4 VC passes phase+1 for the post-state."""
        ph = r if ph is None else ph
        return And(
            majority(Card(a_set(tt))),
            Leq(tt, ph),
            ForAll(
                [i],
                And(
                    Implies(Geq(sig.get("ts", i), tt), Eq(sig.get("x", i), vv)),
                    Implies(sig.get("decided", i), Eq(sig.get("dec", i), vv)),
                    Implies(sig.get("commit", i), Eq(sig.get("vote", i), vv)),
                    Implies(sig.get("ready", i), Eq(sig.get("vote", i), vv)),
                    Implies(Eq(sig.get("ts", i), ph), sig.get("commit", coord)),
                ),
            ),
        )

    anchored = Exists([v, t], anchored_body(v, t))
    keep_init = ForAll([i], Exists([j], Eq(sig.get("x", i), x0_of(j))))
    # committed votes and decisions also trace back to initial values —
    # needed to push keepInit through rounds 2/4 (x := vote(coord)) in the
    # noDecision world, where nothing anchors vote(coord) otherwise
    vote_init = ForAll(
        [i],
        And(
            Implies(
                sig.get("commit", i),
                Exists([j], Eq(sig.get("vote", i), x0_of(j))),
            ),
            Implies(
                sig.get("decided", i),
                Exists([j], Eq(sig.get("dec", i), x0_of(j))),
            ),
        ),
    )
    inv1 = And(Or(no_decision, anchored), keep_init, vote_init)

    agreement = ForAll(
        [i, j],
        Implies(
            And(sig.get("decided", i), sig.get("decided", j)),
            Eq(sig.get("dec", i), sig.get("dec", j)),
        ),
    )
    validity = ForAll(
        [i],
        Implies(
            sig.get("decided", i),
            Exists([j], Eq(sig.get("dec", i), x0_of(j))),
        ),
    )

    init = ForAll(
        [i],
        And(
            Not(sig.get("decided", i)),
            Not(sig.get("ready", i)),
            Not(sig.get("commit", i)),
            Eq(sig.get("x", i), x0_of(i)),
            Eq(sig.get("ts", i), IntLit(-1)),
        ),
    )

    # -- phase-staged invariants (the roundInvariants mechanism,
    #    LastVoting.scala:49-61 / Verifier round-staging) ------------------
    #
    # inv1 alone is NOT inductive round-by-round (the reference marks all
    # four inductiveness VCs ignore with "those completely blow-up",
    # LvExample.scala:262-291 — and semantically each round needs the
    # phase-internal facts below).  F_k holds before round k+1:
    def stamped(tt=None):
        kk = Variable("lvs", procType)
        return Comprehension([kk], Eq(sig.get("ts", kk), r))

    F = {}

    def stage0_at(ph):
        return ForAll(
            [i],
            And(
                Not(sig.get("commit", i)),
                Not(sig.get("ready", i)),
                Lt(sig.get("ts", i), ph),
            ),
        )

    F[0] = stage0_at(r)
    F[1] = ForAll(
        [i],
        And(
            Not(sig.get("ready", i)),
            Lt(sig.get("ts", i), r),
            Implies(sig.get("commit", i), Eq(i, coord)),
        ),
    )
    _stamp_fact = lambda ii: Implies(
        Eq(sig.get("ts", ii), r),
        And(
            sig.get("commit", coord),
            Eq(sig.get("x", ii), sig.get("vote", coord)),
        ),
    )
    F[2] = ForAll(
        [i],
        And(
            Not(sig.get("ready", i)),
            Implies(sig.get("commit", i), Eq(i, coord)),
            _stamp_fact(i),
            Leq(sig.get("ts", i), r),
        ),
    )
    F[3] = And(
        ForAll(
            [i],
            And(
                Implies(sig.get("commit", i), Eq(i, coord)),
                _stamp_fact(i),
                Leq(sig.get("ts", i), r),
                Implies(
                    sig.get("ready", i),
                    And(Eq(i, coord), sig.get("commit", i)),
                ),
            ),
        ),
        # a ready coordinator is backed by a majority of current-phase stamps
        Implies(
            Exists([i], sig.get("ready", i)),
            majority(Card(stamped())),
        ),
    )

    safety_core = And(Or(no_decision, anchored), keep_init, vote_init)

    spec = ProtocolSpec(
        sig=sig,
        rounds=[r1, r2, r3, r4],
        init=init,
        invariants=[inv1],
        properties=[("agreement", agreement), ("validity", validity)],
        config=ClConfig(venn_bound=2, inst_depth=1),
    )
    extras = {
        "coord": coord,
        "phase": r,
        "maxx": maxx,
        "x0": x0,
        "inv1": inv1,
        "no_decision": no_decision,
        "anchored": anchored,
        "anchored_body": anchored_body,
        "keep_init": keep_init,
        "vote_init": vote_init,
        "a_set": a_set,
        "stages": F,
        "stage0_at": stage0_at,
        "safety_core": safety_core,
        "rounds": (r1, r2, r3, r4),
    }
    return spec, extras


def lv_staged_vcs():
    """The LV phase-staged inductiveness VCs, in skolemized-anchor form:

       (SCsk(va, ta) ∧ F_k) ∧ TR_{k+1} ⇒ (SCsk′ with explicit witnesses)

    for k = 0..2, and round 4 with the phase bump.  (va, ta) are fresh
    constants naming the hypothesis anchor (sound: free constants are
    implicitly ∀-quantified, and ∃v,t anchored ⇒ body(va, ta) for the
    witnesses); each round's conclusion re-establishes the anchor at stated
    witnesses — rounds 1–3 keep (va, ta); round 4 either keeps it or, when
    the decision fires from the noDecision world, anchors at
    (vote(coord), phase).  Choosing witnesses up front removes the ∃v,t
    search that made the reducer enumerate tens of thousands of instances.

    Returns ([(name, hypothesis, tr_formula, conclusion)], spec, extras).
    Discharging these goes BEYOND the reference's logic suite, which ignores
    every LV inductiveness VC (LvExample.scala:262-291)."""
    from round_tpu_torch.verify.futils import subst_vars

    spec, lv = lv_spec()
    sig = spec.sig
    F = lv["stages"]
    r = lv["phase"]
    rounds = lv["rounds"]
    nd, ab = lv["no_decision"], lv["anchored_body"]
    ki, vi = lv["keep_init"], lv["vote_init"]
    coord = lv["coord"]

    va = Variable("va", Int)
    ta = Variable("ta", Int)

    def sc(anchor_options):
        return And(Or(nd, *anchor_options), ki, vi)

    hyp_sc = sc([ab(va, ta)])
    vc_anchor = ab(sig.get("vote", coord), r)

    vcs = []
    for k in range(2):
        hyp = And(hyp_sc, F[k])
        concl = sig.prime(And(sc([ab(va, ta)]), F[k + 1]))
        vcs.append(
            (f"stage {k} -> {k + 1} via round {k + 1}",
             hyp, rounds[k].full_tr(), concl)
        )
    # round 3 (ack): a coordinator that becomes ready from the noDecision
    # world RE-ANCHORS at (vote(coord), phase) — the majority of ts=phase
    # acks is the new anchor's majority (round-2 adoption history, F[2]'s
    # stamp fact).  The conclusion therefore allows that third option,
    # and round 4's hypothesis carries it.
    vcs.append((
        "stage 2 -> 3 via round 3",
        And(hyp_sc, F[2]), rounds[2].full_tr(),
        sig.prime(And(sc([ab(va, ta), vc_anchor]), F[3])),
    ))
    # round 4 wraps the phase: post-state facts hold at phase+1; a decision
    # fired from the noDecision world anchors at (vote(coord), phase)
    rnext = Plus(r, IntLit(1))
    post = sig.prime(
        And(
            Or(nd, ab(va, ta, rnext), ab(sig.get("vote", coord), r, rnext)),
            ki,
            vi,
            lv["stage0_at"](rnext),
        )
    )
    vcs.append(("stage 3 -> 0 via round 4 (phase bump)",
                And(sc([ab(va, ta), vc_anchor]), F[3]),
                rounds[3].full_tr(), post))
    return vcs, spec, lv


def _lv_matrix_and_pieces():
    """VC.decompose (VC.scala:76-96) applied to the two hard LV
    inductiveness stages: hypothesis-disjunct (noDecision vs anchored) ×
    conclusion-conjunct sub-VCs, with Hoare-style drill-down chains for the
    three cases whose monolithic forms blow up.  Since the
    template-congruence symbolization landed (quantifiers.py:
    _comprehension_template — ground comprehensions share the symbol family
    of the ∀-quantified comprehensions they instantiate), EVERY case is
    closed.  The monolithic forms of the three chained cases (collect-r1
    anchored, collect-r1 vote_init′, ack-r3 noDecision) are no longer
    carried as "(subsumed)" rows: their composition out of the chain rows
    below is MACHINE-CHECKED by lv_staged_chains() / the StagedChain
    machinery (verifier.py), which replaced the author-supplied subsumption
    argument those rows documented.

      stage 0 (collect, round 1):  keep_init′ / stage flag / noDecision
        case PROVED directly; the anchored case closes via the
        collect-r1/anchored chain (maxTS bridge → frame → majority+phase →
        the ∀-block split per conjunct, the commit′ piece consuming the
        bridge); vote_init′ closes via the collect-r1/vote_init chain
        (attainment witness → back-to-init → commit/decided parts).
      stage 2 (ack, round 3):  keep_init′ / vote_init′ / commit-ts /
        ready′-majority / anchored case PROVED directly (the conclusion now
        offers the re-anchor option ab(vote(coord), phase), which round 4's
        hypothesis carries); the noDecision case closes via the
        ack-r3/noDecision chain — the ready′ coordinator's ack majority
        (round-2 adoption history, F[2]'s stamp fact) builds the new anchor,
        the no-ready′ branch preserves noDecision.

    The reference proves NONE of these (LvExample.scala:262-291 ignores
    all four stages outright).  Returns ([(label, hyp, concl, cfg, proved,
    slow)], pieces) — `proved` is the pinned expectation, `slow` marks
    entries the CI skips without RUN_SLOW_VCS=1; `pieces` carries the
    formula handles lv_staged_chains() composes from."""
    vcs, spec, lv = lv_staged_vcs()
    cfg = spec.config
    sig = spec.sig
    out = []

    def split_hyp(h):
        """(nd_case, anchored_case, rest): unpack the staged hypothesis's
        noDecision-vs-anchored disjunction from its other conjuncts."""
        parts = list(h.args)
        disj = next(p for p in parts
                    if isinstance(p, Application) and p.fct == OR)
        rest = [p for p in parts if p is not disj]
        return disj.args[0], disj.args[1], rest

    for idx, stage_tag in ((0, "collect-r1"), (2, "ack-r3")):
        name, hyp, tr, concl = vcs[idx]
        nd_case, anchor_case, rest = split_hyp(hyp)
        conjs = list(concl.args)
        H = lambda case=None: And(*( [case] if case is not None else [] ),
                                  *rest, tr)
        if idx == 0:
            out += [
                (f"{stage_tag}: keep_init'", H(), conjs[1], cfg, True, False),
                (f"{stage_tag}: stage flag", H(), conjs[3], cfg, True, False),
                (f"{stage_tag}: anchor-disj, noDecision case",
                 H(nd_case), conjs[0], cfg, True, False),
            ]
        else:
            out += [
                (f"{stage_tag}: keep_init'", H(), conjs[1], cfg, True, False),
                (f"{stage_tag}: vote_init'", H(), conjs[2], cfg, True, False),
                (f"{stage_tag}: commit/ts obligations", H(), conjs[3], cfg,
                 True, False),
                (f"{stage_tag}: ready' => ts=phase majority", H(), conjs[4],
                 cfg, True, True),
                # the anchored case re-establishes the anchor DIRECTLY:
                # prove the single anchored-at-(va,ta)' disjunct — the
                # full disjunction follows by ∨-weakening at the final
                # composition.  A 2-option ∨ goal here made the reducer
                # refute both branches against the case's venn sets
                # (398 s measured); the single disjunct proves in ~12 s
                (f"{stage_tag}: anchor-disj, anchored case (re-anchor)",
                 H(anchor_case), conjs[0].args[1],
                 cfg, True, False),  # ~12 s: back in the default tier
            ]

    coord, maxx, x0 = lv["coord"], lv["maxx"], lv["x0"]
    r = lv["phase"]
    va = Variable("va", Int)
    k = Variable("k", procType)
    i = Variable("i", procType)
    kw = Variable("kw", procType)   # attainment witness (∃-elim)
    jw = Variable("jw", procType)   # keep_init witness (∃-elim)
    act = Gt(Times(2, Card(Comprehension([k], In(k, ho_of(coord))))), N)
    maxx_coord = Application(maxx, [coord]).with_type(Int)

    def x0_of(p):
        return Application(x0, [p]).with_type(Int)

    c01 = ClConfig(venn_bound=0, inst_depth=1)
    c02 = ClConfig(venn_bound=0, inst_depth=2)
    c12 = ClConfig(venn_bound=1, inst_depth=2)

    # ---- collect-r1 / anchored chain (round 1) ---------------------------
    name, hyp, tr, concl = vcs[0]
    _nd, anchor_case, rest = split_hyp(hyp)
    ki, vi = rest[0], rest[1]
    frame = ForAll([i], And(*[
        Eq(sig.get_primed(f, i), sig.get(f, i))
        for f in ("ts", "x", "decided", "dec", "ready")
    ]))
    anchored_post = concl.args[0].args[1]
    bridge = Implies(act, Eq(maxx_coord, va))
    fa_block = anchored_post.args[2]
    fa_conjs = list(fa_block.body.args)

    def fa(ci):
        return ForAll(list(fa_block.vars), fa_conjs[ci])

    out += [
        ("collect-r1/anchored: maxTS bridge (act => maxx = va)",
         And(anchor_case, *rest, tr, act), Eq(maxx_coord, va), cfg,
         True, True),
        ("collect-r1/anchored: frame extraction from the TR",
         tr, frame, c01, True, False),
        ("collect-r1/anchored: pruned majority transfer",
         And(anchor_case, frame), anchored_post.args[0], cfg, True, False),
        ("collect-r1/anchored: pruned phase bound",
         And(anchor_case, frame), anchored_post.args[1], cfg, True, False),
        # the ∀-block, split per conjunct (closing the old OPEN entry): the
        # commit′ piece consumes the maxTS bridge (sound: the bridge is the
        # first entry's conclusion under implication-intro on act)
        ("collect-r1/anchored: fa-block ts'>=ta => x'=va",
         And(anchor_case, *rest, frame), fa(0), cfg, True, False),
        ("collect-r1/anchored: fa-block decided' pins dec'",
         And(anchor_case, *rest, frame), fa(1), cfg, True, False),
        ("collect-r1/anchored: fa-block commit' => vote'=va",
         And(*rest, tr, bridge), fa(2), cfg, True, True),
        ("collect-r1/anchored: fa-block ready' => vote'=va",
         And(*rest, frame), fa(3), cfg, True, False),
        ("collect-r1/anchored: fa-block stamp => commit'(coord)",
         And(*rest, frame), fa(4), cfg, True, False),
    ]

    # ---- collect-r1 / vote_init chain (round 1) --------------------------
    vip = sig.prime(vi)
    vi_conjs = list(vip.body.args)
    out += [
        ("collect-r1/vote_init: attainment witness under act",
         And(*rest, tr, act),
         Exists([k], And(In(k, ho_of(coord)),
                         Eq(maxx_coord, sig.get("x", k)))),
         cfg, True, False),
        ("collect-r1/vote_init: witness value traces to init",
         And(Eq(maxx_coord, sig.get("x", kw)), In(kw, ho_of(coord)), ki),
         Exists([jw], Eq(maxx_coord, x0_of(jw))), c02, True, False),
        ("collect-r1/vote_init: commit' part from the traced vote",
         And(tr, Eq(maxx_coord, x0_of(jw))),
         ForAll(list(vip.vars), vi_conjs[0]), c12, True, False),
        ("collect-r1/vote_init: decided' part from the frame",
         And(vi, frame), ForAll(list(vip.vars), vi_conjs[1]), c01,
         True, False),
    ]

    # ---- ack-r3 / noDecision chain (round 3) -----------------------------
    name2, hyp2, tr2, concl2 = vcs[2]
    nd2, _anchor2, rest2 = split_hyp(hyp2)
    # round 3 frames everything except ready
    frame3 = ForAll([i], And(*[
        Eq(sig.get_primed(f, i), sig.get(f, i))
        for f in ("ts", "x", "decided", "dec", "commit", "vote")
    ]))
    acked = Comprehension(
        [k], And(In(k, ho_of(coord)), Eq(sig.get("ts", k), r))
    )
    vc_anchor_post = concl2.args[0].args[2]  # primed ab(vote(coord), r)
    iw = Variable("iw", procType)
    no_ready_p = ForAll([i], Not(sig.get_primed("ready", i)))
    out += [
        ("ack-r3/noDecision: frame extraction from the TR",
         tr2, frame3, c01, True, False),
        ("ack-r3/noDecision: no ready' preserves noDecision",
         And(nd2, frame3, no_ready_p), concl2.args[0].args[0], cfg,
         True, False),
        ("ack-r3/noDecision: ready' implies ack majority",
         And(tr2, sig.get_primed("ready", iw)),
         Gt(Times(2, Card(acked)), N), cfg, True, True),
        ("ack-r3/noDecision: ack majority anchors at phase",
         And(Gt(Times(2, Card(acked)), N), frame3),
         vc_anchor_post.args[0], cfg, True, False),
        ("ack-r3/noDecision: anchor phase bound",
         Literal(True), vc_anchor_post.args[1], c01, True, False),
        ("ack-r3/noDecision: fa-block at (vote(coord), phase)",
         And(nd2, *rest2, tr2, frame3), vc_anchor_post.args[2], cfg,
         True, True),
    ]

    pieces = {
        "vcs": vcs, "spec": spec, "lv": lv, "cfg": cfg, "sig": sig,
        "c01": c01, "c02": c02, "c12": c12,
        "c1": {
            "nd": _nd, "anchor": anchor_case, "rest": rest, "tr": tr,
            "conjs": list(concl.args), "frame": frame, "bridge": bridge,
            "act": act, "fa": fa, "anchored_post": anchored_post,
            "vip": vip, "vi_conjs": vi_conjs, "kw": kw, "jw": jw,
            "maxx_coord": maxx_coord, "x0_of": x0_of, "ki": ki, "vi": vi,
        },
        "a3": {
            "nd": nd2, "anchor": _anchor2, "rest": rest2, "tr": tr2,
            "conjs": list(concl2.args), "frame": frame3, "acked": acked,
            "vc_anchor_post": vc_anchor_post, "iw": iw,
            "no_ready_p": no_ready_p,
        },
    }
    return out, pieces


def lv_stage_subvcs():
    """The LV decomposition matrix (see _lv_matrix_and_pieces)."""
    return _lv_matrix_and_pieces()[0]


def lv_staged_chains():
    """The collect-r1 and ack-r3 decompositions as MACHINE-CHECKED
    StagedChains — every arrow of the old author-composed argument is its
    own VC (intro / stage / justification / final, verifier.py
    _composed_vc), so `verifier_cli lv` carries NO composition caveat.

    Shape of the argument (the assumption-scoped natural deduction the
    StagedChain.assumes field provides):

      collect-r1:  ∨-elim over H's noDecision-vs-anchored disjunction —
        the nd case is one scoped stage; the anchored case re-derives the
        anchor at (va, ta) piecewise (maxTS bridge under act, frame,
        majority/phase transfer, the ∀-block per conjunct) and a scoped
        assembly stage recombines them; vote_init′ goes through two
        CONDITIONAL skolem witnesses (kw: a max-ts sender, jw: the initial
        value it traces to — both exist only under the coordinator's
        majority `act`), the traced commit′ part under act, a NEW
        no-majority complement (¬act ⊨ nothing newly commits, and round 1
        resets commit — LastVoting.scala:123-137), and an assembly doing
        the excluded-middle split on act.  The final VC checks the ∨-elim.

      ack-r3:  the direct conjuncts are unscoped stages; the anchored case
        re-establishes the anchored-at-(va,ta) disjunct DIRECTLY
        (∨-weakening to the 3-option goal is the final VC's — a 2-option
        ∨ goal made the reducer refute both branches, 398 s vs ~12 s);
        the noDecision case derives the re-anchor at
        (vote(coord), phase) from a fresh ready′ witness (∀-closed over
        it), and a scoped assembly refutes ¬goal by case analysis on the
        skolemized ¬noDecision′ witness.

    The reference ignores all four of these VCs outright
    (LvExample.scala:262-291).  Returns ({vc name: StagedChain}, pieces):
    the TR payload symbols are gensym'd, so the chains only match a spec
    built from the SAME lv_staged_vcs instance — `pieces` carries it, and
    lv_verifier_spec is the one assembler (a chains-only accessor would
    invite pairing them with a foreign spec, which the prune membership
    checks would reject)."""
    from round_tpu_torch.verify.futils import get_conjuncts
    from round_tpu_torch.verify.verifier import StagedChain

    out, P = _lv_matrix_and_pieces()
    cfg, c01, c02, c12 = P["cfg"], P["c01"], P["c02"], P["c12"]
    sig = P["sig"]
    coord = P["lv"]["coord"]
    by_label = {row[0]: row for row in out}

    def row(label):
        _l, hyp, concl, rcfg, proved, _s = by_label[label]
        assert proved, label
        return hyp, concl, rcfg

    from round_tpu_torch.verify.futils import free_vars as free_vars_of

    def build(vc_index, intros, intro_assumes, intro_prunes, stages,
              assumes, manual_just, final_keep, final_cfg):
        """Assemble a StagedChain; prune every justification VC whose
        conjunct is VERBATIM available down to that single fact (cost: a
        syntactic entailment).  The context/freshness evolution here
        MIRRORS verifier._composed_vc exactly, so the closed facts
        referenced by later prune lists are structurally identical to the
        ones the verifier constructs.  Non-verbatim conjuncts must appear
        in manual_just[(stage name, conjunct index)] = (keep, config)."""
        _nm, vhyp, vtr, vconcl = P["vcs"][vc_index]
        H, G = And(vhyp, vtr), vconcl
        universe = list(get_conjuncts(H))
        seen = free_vars_of(H) | free_vars_of(G)
        prune: dict = dict(intro_prunes)
        just_configs: dict = {}
        for idx, (vars_, pf, _c) in enumerate(intros):
            a = intro_assumes.get(f"intro:{idx}")
            fact = pf if a is None else Implies(a, pf)
            universe.extend(get_conjuncts(fact))
            seen |= set(vars_) | free_vars_of(fact)
        for sname, hyp, concl, _scfg in stages:
            for ci, part in enumerate(get_conjuncts(hyp)):
                key = f"justify:{sname}#{ci}"
                manual = manual_just.get((sname, ci))
                if manual is not None:
                    prune[key], just_configs[key] = manual
                elif any(part == c for c in universe):
                    prune[key] = [part]
                    just_configs[key] = c01
                else:
                    raise AssertionError(
                        f"chain stage {sname!r} conjunct {ci} "
                        f"({part!r}) is neither verbatim in context nor "
                        "manually justified"
                    )
            a = assumes.get(sname)
            stage_fv = free_vars_of(hyp) | free_vars_of(concl)
            if a is not None:
                stage_fv |= free_vars_of(a)
            univ = sorted(stage_fv - seen, key=lambda v: v.name)
            closed = concl if a is None else Implies(a, concl)
            closed = ForAll(univ, closed) if univ else closed
            universe.extend(get_conjuncts(closed))
            seen |= set(univ)
        prune["final"] = final_keep
        return StagedChain(
            stages=stages,
            intros=intros,
            assumes={**intro_assumes, **assumes},
            prune=prune,
            just_configs=just_configs,
            final_config=final_cfg,
        )

    chains = {}

    # ------------------------------------------------------- collect-r1 --
    c1 = P["c1"]
    nd, anchor, rest, tr = c1["nd"], c1["anchor"], c1["rest"], c1["tr"]
    conjs, frame, bridge = c1["conjs"], c1["frame"], c1["bridge"]
    act, fa, ap = c1["act"], c1["fa"], c1["anchored_post"]
    vip, vi_conjs = c1["vip"], c1["vi_conjs"]
    kw, jw = c1["kw"], c1["jw"]
    maxx_coord, x0_of = c1["maxx_coord"], c1["x0_of"]
    ki, vi = c1["ki"], c1["vi"]
    base = And(*rest, tr)
    anchor_act = And(anchor, act)

    P1 = And(In(kw, ho_of(coord)), Eq(maxx_coord, sig.get("x", kw)))
    P2 = Eq(maxx_coord, x0_of(jw))
    fact1, fact2 = Implies(act, P1), Implies(act, P2)

    _h, br_concl, br_cfg = row(
        "collect-r1/anchored: maxTS bridge (act => maxx = va)")
    closed_bridge = Implies(anchor_act, br_concl)
    _h, c_kw, kw_cfg = row("collect-r1/vote_init: attainment witness under act")
    _h, vi0_concl, vi0_cfg = row(
        "collect-r1/vote_init: commit' part from the traced vote")
    _h, vi1_concl, vi1_cfg = row(
        "collect-r1/vote_init: decided' part from the frame")
    nci = Variable("nci", procType)
    no_commit_p = ForAll([nci], Not(sig.get_primed("commit", nci)))

    rf = And(*rest, frame)
    stages1 = [
        ("nd case", base, conjs[0], cfg),
        ("keep_init'", base, conjs[1], cfg),
        ("stage flag", base, conjs[3], cfg),
        ("frame", tr, frame, c01),
        ("maxTS bridge", base, br_concl, br_cfg),
        ("maj transfer", frame, ap.args[0], cfg),
        ("phase bound", frame, ap.args[1], cfg),
        ("fa0", rf, fa(0), cfg),
        ("fa1", rf, fa(1), cfg),
        # scoped under the bridge IMPLICATION itself (a derived fact, not a
        # case hypothesis): the stage VC is then verbatim the proven matrix
        # row; the assembly justification derives the bridge from
        # closed_bridge ∧ anchor and discharges the conditional
        ("fa2", And(*rest, tr), fa(2), cfg),
        ("fa3", rf, fa(3), cfg),
        ("fa4", rf, fa(4), cfg),
        ("anchored assembly",
         And(ap.args[0], ap.args[1], fa(0), fa(1), fa(2), fa(3), fa(4)),
         conjs[0], c02),
        ("vi commit part", And(tr, P2), vi0_concl, vi0_cfg),
        ("vi no-majority complement", tr, no_commit_p, cfg),
        ("vi decided part", And(vi, frame), vi1_concl, vi1_cfg),
        ("vi assembly",
         And(Implies(act, vi0_concl), Implies(Not(act), no_commit_p),
             vi1_concl),
         conjs[2], c02),
    ]
    assumes1 = {
        "nd case": nd,
        "maxTS bridge": anchor_act,
        "maj transfer": anchor,
        "phase bound": anchor,
        "fa0": anchor,
        "fa1": anchor,
        "fa2": bridge,
        "anchored assembly": anchor,
        "vi commit part": act,
        "vi no-majority complement": Not(act),
    }
    base_parts = get_conjuncts(base)
    manual1 = {
        # the traced equality under act, from the conditional intro fact
        ("vi commit part", len(get_conjuncts(tr))): ([fact2], c01),
        # assembly pieces: each from its conditional closed fact + anchor;
        # the fa(2) piece chains bridge out of closed_bridge first
        ("anchored assembly", 0): ([Implies(anchor, ap.args[0])], c01),
        ("anchored assembly", 1): ([Implies(anchor, ap.args[1])], c01),
        ("anchored assembly", 2): ([Implies(anchor, fa(0))], c01),
        ("anchored assembly", 3): ([Implies(anchor, fa(1))], c01),
        ("anchored assembly", 4): ([closed_bridge, Implies(bridge, fa(2))],
                                   c01),
    }
    chains["stage 0 -> 1 via round 1"] = build(
        0,
        intros=[([kw], P1, kw_cfg), ([jw], P2, c02)],
        intro_assumes={"intro:0": act, "intro:1": act},
        intro_prunes={
            "intro:0": base_parts,
            "intro:1": [fact1, ki],
        },
        stages=stages1,
        assumes=assumes1,
        manual_just=manual1,
        final_keep=[
            Or(nd, anchor),
            Implies(nd, conjs[0]),
            Implies(anchor, conjs[0]),
            conjs[1], conjs[2], conjs[3],
        ],
        final_cfg=c01,
    )

    # ---------------------------------------------------------- ack-r3 --
    a3 = P["a3"]
    nd3, anchor3, rest3, tr3 = a3["nd"], a3["anchor"], a3["rest"], a3["tr"]
    conjs3, frame3 = a3["conjs"], a3["frame"]
    vca, iw = a3["vc_anchor_post"], a3["iw"]
    no_ready_p = a3["no_ready_p"]
    base3 = And(*rest3, tr3)
    iw2 = Variable("iw2", procType)

    _h, maj_concl, maj_cfg = row(
        "ack-r3/noDecision: ready' implies ack majority")
    _h, anch_concl, anch_cfg = row(
        "ack-r3/noDecision: ack majority anchors at phase")
    _h, reanchor_concl, reanchor_cfg = row(
        "ack-r3: anchor-disj, anchored case (re-anchor)")
    ready_iw = sig.get_primed("ready", iw)
    ready_iw2 = sig.get_primed("ready", iw2)
    closed_ready_maj = ForAll([iw], Implies(ready_iw, maj_concl))
    closed_ready_anchor = ForAll([iw2], Implies(ready_iw2, anch_concl))
    nd_noready = And(nd3, no_ready_p)

    stages3 = [
        ("keep_init'", base3, conjs3[1], cfg),
        ("vote_init'", base3, conjs3[2], cfg),
        ("commit/ts obligations", base3, conjs3[3], cfg),
        ("ready' majority", base3, conjs3[4], cfg),
        ("anchored case (re-anchor)", base3, reanchor_concl, reanchor_cfg),
        ("frame", tr3, frame3, c01),
        ("no-ready preserves nd", frame3, conjs3[0].args[0], cfg),
        ("ready' => ack majority", tr3, maj_concl, maj_cfg),
        ("ack majority anchors", And(maj_concl, frame3), anch_concl,
         anch_cfg),
        # the bound is the tautology phase <= phase; any verbatim
        # hypothesis serves (the matrix row used Literal(True), which the
        # justification machinery cannot prune to)
        ("anchor phase bound", frame3, vca.args[1], c01),
        ("nd fa-block", And(*rest3, tr3, frame3), vca.args[2], cfg),
        ("nd assembly",
         And(closed_ready_anchor, vca.args[1], Implies(nd3, vca.args[2]),
             frame3),
         conjs3[0], c02),
    ]
    assumes3 = {
        "anchored case (re-anchor)": anchor3,
        "no-ready preserves nd": nd_noready,
        "ready' => ack majority": ready_iw,
        "ack majority anchors": ready_iw2,
        "nd fa-block": nd3,
        "nd assembly": nd3,
    }
    manual3 = {
        # the ack majority under a (fresh) ready' witness, ∀-closed earlier
        ("ack majority anchors", 0): ([closed_ready_maj], c01),
    }
    chains["stage 2 -> 3 via round 3"] = build(
        2,
        intros=[],
        intro_assumes={},
        intro_prunes={},
        stages=stages3,
        assumes=assumes3,
        manual_just=manual3,
        final_keep=[
            Or(nd3, anchor3),
            Implies(anchor3, reanchor_concl),
            Implies(nd3, conjs3[0]),
            conjs3[1], conjs3[2], conjs3[3], conjs3[4],
        ],
        # the surviving final conjunct is a pure ∨-elim over three big
        # opaque cases: expand it to per-branch trivialities (dnf_budget)
        # instead of one packed refutation (which blows the reducer)
        final_cfg=ClConfig(venn_bound=0, inst_depth=1, dnf_budget=64),
    )
    return chains, P


def _lv_maxx_axiom(sig: StateSig, coord, maxx) -> Formula:
    """maxx(j) is the x-payload of a max-timestamp sender in j's round-1
    mailbox (LvExample maxTSdef, :77-97, localized: no FMap needed)."""
    jj = Variable("mj", procType)
    kk = Variable("mk", procType)
    ii = Variable("mi", procType)

    def in_mb(pp):
        # round-1 mailbox of jj: senders heard, addressed to the coordinator
        return And(In(pp, ho_of(jj)), Eq(jj, coord))

    def maxx_of(p):
        return Application(maxx, [p]).with_type(Int)

    return ForAll(
        [jj],
        Implies(
            Gt(Card(Comprehension([kk], in_mb(kk))), IntLit(0)),
            Exists(
                [kk],
                And(
                    in_mb(kk),
                    Eq(maxx_of(jj), sig.get("x", kk)),
                    ForAll(
                        [ii],
                        Implies(
                            in_mb(ii),
                            Leq(sig.get("ts", ii), sig.get("ts", kk)),
                        ),
                    ),
                ),
            ),
        ),
    )


def lv_extracted_tr(device=None):
    """LastVoting round-1 (LVCollect: the coordinator's max-timestamp
    selection, LastVoting.scala:123-137) extracted from the *executable*
    round class models/lastvoting.py:LVCollect — ctx/state/mailbox and all.

    The trace runs the real `LVCollect().update` (not a re-written copy):
    Mailbox.best_by lowers to masked reduce_max + boolean argmax +
    dynamic_slice-gather, and the coordinator arithmetic (r // 4) % n
    lowers through the floor-div/mod shortcuts.  The returned pieces feed
    lv_extracted_stage_vcs, which proves the LvExample maxTS lemma from
    these EXTRACTED axioms (the hand-written twin is _lv_maxx_axiom).

    Returns (sig, j, r, update_eqs, axioms, payload_def):
      update_eqs  — vote′(j) = ⟨extracted Ite⟩ ∧ commit′(j) = ⟨extracted⟩
      axioms      — the max/argmax site axioms for j's mailbox
      payload_def — ∀i. sndts(i) = ts(i) ∧ sndx(i) = x(i)
    """
    from round_tpu_torch.core.rounds import RoundCtx
    from round_tpu_torch.models.lastvoting import LVCollect, LVState
    from round_tpu_torch.ops.mailbox import Mailbox as RtMailbox
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn
    from round_tpu_torch.verify.formula import IN

    sig = StateSig({"x": Int, "ts": Int, "ready": Bool, "commit": Bool,
                    "vote": Int, "decided": Bool, "dec": Int})
    j = Variable("lvj", procType)
    r = Variable("r", Int)
    sndx = UnInterpretedFct("lvsndx", FunT([procType], Int))
    sndts = UnInterpretedFct("lvsndts", FunT([procType], Int))

    def upd(n, r, jid, x, ts, ready, commit, vote, decided, decision,
            ts_p, x_p, mask):
        ctx = RoundCtx(id=jid, n=n, r=r)
        st = LVState(x=x, ts=ts, ready=ready, commit=commit, vote=vote,
                     decided=decided, decision=decision)
        st2 = LVCollect().update(ctx, st, RtMailbox({"x": x_p, "ts": ts_p},
                                                    mask))
        return st2.vote, st2.commit

    ne = 5
    ex = [_i32(ne), _i32(0), _i32(0), _i32(0),
          _i32(-1), _b(False), _b(False), _i32(0),
          _b(False), _i32(-1), _zeros(ne),
          _zeros(ne), _zeros(ne, "bool")]
    fargs = [
        Scalar(N), Scalar(r), Scalar(j),
        Scalar(sig.get("x", j)), Scalar(sig.get("ts", j)),
        Scalar(sig.get("ready", j)), Scalar(sig.get("commit", j)),
        Scalar(sig.get("vote", j)), Scalar(sig.get("decided", j)),
        Scalar(sig.get("dec", j)),
        Vec(lambda i: Application(sndts, [i]).with_type(Int)),
        Vec(lambda i: Application(sndx, [i]).with_type(Int)),
        Vec(lambda i: Application(IN, [i, ho_of(j)]).with_type(Bool)),
    ]
    outs, axioms = extract_lane_fn(
        upd, ex, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    update_eqs = And(
        Eq(sig.get_primed("vote", j), outs[0].f),
        Eq(sig.get_primed("commit", j), outs[1].f),
    )
    i0 = Variable("i0", procType)
    payload_def = ForAll([i0], And(
        Eq(Application(sndts, [i0]).with_type(Int), sig.get("ts", i0)),
        Eq(Application(sndx, [i0]).with_type(Int), sig.get("x", i0)),
    ))
    return sig, j, r, update_eqs, axioms, payload_def


def lv_extracted_stage_vcs(device=None):
    """The LvExample maxTS lemma (logic/LvExample.scala:268-284) proved from
    the EXTRACTED LVCollect transition relation, as a staged ∃-elimination
    chain (the same discipline as otr_extracted_stage_vcs):

      A. the two majorities (timestamp set, mailbox) intersect:
         ⊨ ∃k. k ∈ HO(j) ∧ ts(k) ≥ t
      B. ...hence the masked-max site is ≥ t (∀ site axiom at the witness)
      C. the attainment skolem must lie in the mailbox (t above the int32
         sentinel rules the empty-mask branch out):
         ⊨ ∃i. i ∈ HO(j) ∧ sndts(i) = max
      D. the argmax site inherits membership + max timestamp, so the
         property ∀i. ts(i) ≥ t → x(i) = v pins its payload:
         ⊨ sndx(a) = v
      E. the extracted Ite condition holds (j is the coordinator, the
         mailbox majority beats n div 2), so vote′(j) = sndx(a) = v.

    Every stage is entailment(hyp, concl, cfg); witnesses introduced by ∃
    stages enter later hyps as fresh free variables, so the chain composes
    by ∃-elimination into: extracted axioms ∧ payload ∧ majorities ∧
    ts-property ⊨ vote′(j) = v — the reference's maxTS test, but from the
    aten graph of the executable round instead of a hand-written axiom.

    Returns (stages, meta)."""
    sig, j, r, update_eqs, axioms, payload_def = lv_extracted_tr(device)

    t = Variable("t", Int)
    v = Variable("v", Int)
    kw = Variable("kw", procType)   # stage-A witness
    iw = Variable("iw", procType)   # stage-C witness
    k1 = Variable("k1", procType)
    k2 = Variable("k2", procType)
    i = Variable("i", procType)

    A_t = Comprehension([k1], Geq(sig.get("ts", k1), t))
    MB = Comprehension([k2], In(k2, ho_of(j)))

    # locate the extracted sites: vote′(j) = Ite(cond, sndx(argsite), vote(j))
    votep = update_eqs.args[0].args[1]
    cond, adopted = votep.args[0], votep.args[1]
    argsite = adopted.args[0]
    maxsite = _find_site(axioms, "ext!max!")
    assert maxsite is not None and "argmax" in argsite.fct.name

    arg_axs = [a for a in axioms
               if _is_forall(a) and _mentions_fct(a, argsite.fct)]
    max_forall = [a for a in axioms
                  if a not in arg_axs and _is_forall(a)
                  and _mentions_fct(a, maxsite.fct)]
    max_attain = [a for a in axioms
                  if not _is_forall(a) and _mentions_fct(a, maxsite.fct)]
    assert arg_axs and max_forall and max_attain

    maj = And(Gt(Times(2, Card(A_t)), N), Gt(Times(2, Card(MB)), N))
    prop = ForAll([i], Implies(Geq(sig.get("ts", i), t),
                               Eq(sig.get("x", i), v)))
    t_bound = Gt(t, IntLit(-(2 ** 31)))
    sndts_fct = _payload_fct(max_forall[0])

    def sndts_of(p):
        return Application(sndts_fct, [p]).with_type(Int)

    c21 = ClConfig(venn_bound=2, inst_depth=1)
    c22 = ClConfig(venn_bound=2, inst_depth=2)

    stages = [
        ("A: majorities intersect", maj,
         Exists([k1], And(In(k1, ho_of(j)), Geq(sig.get("ts", k1), t))),
         c21),
        ("B: max site >= t",
         And(In(kw, ho_of(j)), Geq(sig.get("ts", kw), t), payload_def,
             *max_forall),
         Geq(maxsite, t), c22),
        ("C: attainer in mailbox",
         And(Geq(maxsite, t), t_bound, *max_attain),
         Exists([k1], And(In(k1, ho_of(j)),
                          Eq(sndts_of(k1), maxsite))), c22),
        ("D: argmax payload = v",
         And(In(iw, ho_of(j)), Eq(sndts_of(iw), maxsite),
             Geq(maxsite, t), payload_def, prop, *arg_axs),
         Eq(adopted, v), c22),
        ("E: vote' = v under the extracted condition",
         And(Eq(j, cond.args[0].args[1]), Gt(Times(2, Card(MB)), N),
             Eq(adopted, v), update_eqs),
         Eq(sig.get_primed("vote", j), v), c22),
    ]
    meta = {
        "sig": sig, "j": j, "r": r, "t": t, "v": v, "kw": kw, "iw": iw,
        "cond": cond, "adopted": adopted, "argsite": argsite,
        "maxsite": maxsite, "update_eqs": update_eqs, "axioms": axioms,
        "payload_def": payload_def, "A_t": A_t, "MB": MB, "maj": maj,
        "prop": prop,
    }
    return stages, meta


def erb_spec() -> ProtocolSpec:
    """Eager reliable broadcast (EagerReliableBroadcast.scala:13-47,
    models/erb.py): the originator's value floods; everyone who knows it
    rebroadcasts once, delivers, exits.

    Safety core: every defined estimate and every delivery carries THE
    originator's value v0 (a ghost constant, SpecHelper-style) —
    uniform agreement and validity follow directly.  Inductiveness is the
    flooding argument: an adopted value is some heard sender's estimate,
    senders only send when defined, and defined estimates are v0.
    The mailbox pick (`Mailbox.any_value`) is axiomatized as SOME heard
    payload — the weakest possible site axiom, and enough."""
    sig = StateSig({
        "x_val": Int,
        "x_def": Bool,
        "delivered": Bool,
        "delivery": Int,
    })
    i = Variable("i", procType)
    j = Variable("j", procType)
    v0 = Application(
        UnInterpretedFct("erb!v0", FunT([], Int)), []
    ).with_type(Int)
    adopt = UnInterpretedFct("erb!adopt", FunT([procType], Int))

    def adopt_of(jj):
        return Application(adopt, [jj]).with_type(Int)

    def update(mb: Mailbox, jj, s: StateSig):
        got = Gt(mb.size(), IntLit(0))
        return And(
            Eq(s.get_primed("x_def", jj), Or(s.get("x_def", jj), got)),
            Implies(
                And(Not(s.get("x_def", jj)), got),
                Eq(s.get_primed("x_val", jj), adopt_of(jj)),
            ),
            Implies(
                Or(s.get("x_def", jj), Not(got)),
                Eq(s.get_primed("x_val", jj), s.get("x_val", jj)),
            ),
            Eq(s.get_primed("delivered", jj),
               Or(s.get("delivered", jj), s.get("x_def", jj))),
            Implies(
                And(s.get("x_def", jj), Not(s.get("delivered", jj))),
                Eq(s.get_primed("delivery", jj), s.get("x_val", jj)),
            ),
            Implies(
                Or(Not(s.get("x_def", jj)), s.get("delivered", jj)),
                Eq(s.get_primed("delivery", jj), s.get("delivery", jj)),
            ),
        )

    def adopt_axiom():
        # any_value: SOME heard payload (ops/mailbox.py any_value) — the
        # jj-mailbox senders are exactly the defined processes it heard
        kk = Variable("ek", procType)
        mb_sender = And(In(kk, ho_of(j)), sig.get("x_def", kk))
        return [ForAll(
            [j],
            Implies(
                Exists([kk], mb_sender),
                Exists([kk], And(mb_sender,
                                 Eq(adopt_of(j), sig.get("x_val", kk)))),
            ),
        )]

    rnd = RoundTR(
        sig=sig,
        payload_defs={"v": (Int, lambda ii: sig.get("x_val", ii))},
        dest_fn=lambda ii, jj: sig.get("x_def", ii),  # send guard: only
        # processes that KNOW the value broadcast (ErbRound.send's guard)
        update_fn=update,
        aux=adopt_axiom,
    )

    inv = ForAll(
        [i],
        And(
            Implies(sig.get("x_def", i), Eq(sig.get("x_val", i), v0)),
            Implies(sig.get("delivered", i),
                    Eq(sig.get("delivery", i), v0)),
        ),
    )
    agreement = ForAll(
        [i, j],
        Implies(
            And(sig.get("delivered", i), sig.get("delivered", j)),
            Eq(sig.get("delivery", i), sig.get("delivery", j)),
        ),
    )
    validity = ForAll(
        [i],
        Implies(sig.get("delivered", i), Eq(sig.get("delivery", i), v0)),
    )

    init = ForAll(
        [i],
        And(
            Not(sig.get("delivered", i)),
            Implies(sig.get("x_def", i), Eq(sig.get("x_val", i), v0)),
        ),
    )

    # -- flood-liveness walk (no upstream analogue): with someone defined
    # and every defined sender in everyone's HO, ONE round defines
    # everyone and the NEXT round delivers everywhere (delivery needs no
    # further communication — x_def'ed lanes deliver unconditionally, so
    # the second step carries no liveness hypothesis at all)
    k = Variable("k", procType)
    live = And(
        Exists([i], sig.get("x_def", i)),
        ForAll([i, k], Implies(sig.get("x_def", k), In(k, ho_of(i)))),
    )
    c1 = ForAll([i], sig.get("x_def", i))
    c2 = ForAll([i], sig.get("delivered", i))
    walk = [
        ("progress: flood — everyone learns the value",
         live, rnd.full_tr(), sig.prime(c1)),
        ("progress: deliver — everyone delivers",
         c1, rnd.full_tr(), sig.prime(c2)),
    ]

    return ProtocolSpec(
        sig=sig,
        rounds=[rnd],
        init=init,
        invariants=[inv],
        properties=[
            ("uniform agreement", agreement),
            ("validity (deliveries carry the originator's value)", validity),
        ],
        config=ClConfig(venn_bound=1, inst_depth=2),
        phase_progress=walk,
    )


def epsilon_extracted_tr(device=None):
    """ε-agreement's round (the sort/drop-2f/select order-statistics step,
    Epsilon.scala:34-62) extracted from the EXECUTABLE round class
    models/epsilon.py:EpsilonRound — `torch.sort` lowers through the
    DECLARED order-statistics primitive (verify/extract.py _sort_site:
    the sorted vector becomes a rank function ord(j, k) pinned by
    sortedness / attainment / rank-bound axioms over the mailbox∪halted
    multiset), not through @aux_method contracts — closing the last
    documented extraction boundary.  Float payloads abstract to their
    ORDER (Int-valued symbols; sound for the selection lemmas); the
    midpoint mean of later rounds stays an opaque site — its real
    arithmetic is genuinely outside the int/bool fragment, by design.

    Extraction covers the full x′ update: round 0 picks ord(2f) (the
    (2f+1)-smallest of mailbox ∪ halted, the Epsilon.scala:49 drop-2f
    head), deciding rounds freeze x, inner rounds take the (opaque)
    trimmed mean.

    Returns (sig, j, r, x_update_eq, axioms, pieces)."""
    from round_tpu_torch.core.rounds import RoundCtx
    from round_tpu_torch.models.epsilon import EpsilonRound, EpsilonState
    from round_tpu_torch.ops.mailbox import Mailbox as RtMailbox
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn

    ne, f = 11, 2
    sig = StateSig({"x": Int, "max_r": Int})
    j = Variable("epj", procType)
    r = Variable("r", Int)
    sndv = UnInterpretedFct("epsndv", FunT([procType], Int))
    sndh = UnInterpretedFct("epsndh", FunT([procType], Bool))

    def upd(nn, rr, jid, x, max_r, v_p, halt_p, mask):
        ctx = RoundCtx(id=jid, n=nn, r=rr)
        st = EpsilonState(
            x=x, max_r=max_r,
            halted_vals=_zeros(ne, "float32").to(x.device),
            halted_mask=_zeros(ne, "bool").to(x.device),
            decided=_b(False).to(x.device),
            decision=_zeros((), "float32").to(x.device),
        )
        st2 = EpsilonRound(ne, f, 0.5).update(
            ctx, st, RtMailbox({"v": v_p, "halt": halt_p}, mask)
        )
        return st2.x

    ex = [_i32(ne), _i32(0), _i32(0), _zeros((), "float32"),
          _i32(5), _zeros(ne, "float32"),
          _zeros(ne, "bool"), _zeros(ne, "bool")]
    fargs = [
        Scalar(N), Scalar(r), Scalar(j),
        Scalar(sig.get("x", j)), Scalar(sig.get("max_r", j)),
        Vec(lambda i: Application(sndv, [i]).with_type(Int)),
        Vec(lambda i: Application(sndh, [i]).with_type(Bool)),
        Vec(lambda i: In(i, ho_of(j))),
    ]
    outs, axioms = extract_lane_fn(
        upd, ex, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    x_update_eq = Eq(sig.get_primed("x", j), outs[0].f)
    # the round-0 branch's pick: ord(2f) of the sort site
    ord_2f = outs[0].f.args[1]
    pieces = {
        "f": f, "sndv": sndv, "sndh": sndh, "ord_2f": ord_2f,
        "sort_fct": ord_2f.fct,
    }
    return sig, j, r, x_update_eq, axioms, pieces


def epsilon_extracted_stage_vcs(device=None):
    """The round-0 selection lemmas of ε-agreement, proved from the
    EXTRACTED order-statistics TR (the validity core: the drop-2f pick
    lies weakly inside the heard values' range).  Axioms are instantiated
    at the ranks the argument uses — the OTR mor-axiom-instance
    discipline: the ∀-rank forms make the venn group explode, the
    instances are what the argument needs.

    The reference cannot verify ε-agreement at all (floats); these lemmas
    hold in the order abstraction and discharge sub-second.  Returns
    [(name, hyp, concl, cfg)]."""
    from round_tpu_torch.verify.futils import subst_vars

    sig, j, r, x_eq, axioms, P = epsilon_extracted_tr(device)
    s1, s2, s3a, s3b, dom = axioms
    f = P["f"]
    srt = P["sort_fct"]
    ord_2f = P["ord_2f"]
    sndv = P["sndv"]

    def inst(ax, *ks):
        vs = list(ax.vars)
        assert len(vs) == len(ks), (vs, ks)
        return subst_vars(
            ax.body.args[-1], {v: IntLit(k) for v, k in zip(vs, ks)}
        )

    def ord_at(k):
        return Application(srt, [j, IntLit(k)]).with_type(Int)

    def sndv_of(i):
        return Application(sndv, [i]).with_type(Int)

    kk = Variable("lk", procType)
    ho_card = Card(Comprehension([kk], In(kk, ho_of(j))))
    i2 = Variable("li", procType)
    n_big = Gt(N, IntLit(5 * f))   # the protocol's n > 5f assumption
    c11 = ClConfig(venn_bound=1, inst_depth=1)
    c21 = ClConfig(venn_bound=2, inst_depth=1)

    return [
        ("sortedness: ord(f) <= ord(2f)",
         And(inst(s1, f, 2 * f), n_big),
         Leq(ord_at(f), ord_2f), c11),
        ("trim witness: some heard value >= the round-0 pick",
         And(inst(s3b, 2 * f), n_big, Gt(ho_card, IntLit(2 * f))),
         Exists([i2], And(In(i2, ho_of(j)),
                          Geq(sndv_of(i2), ord_2f))), c21),
        ("lower witness: some heard value <= the round-0 pick",
         And(inst(s2, 2 * f), dom, n_big, Gt(ho_card, IntLit(0))),
         Exists([i2], And(In(i2, ho_of(j)),
                          Leq(sndv_of(i2), ord_2f))), c11),
    ]


def _mentions_fct(f: Formula, fct) -> bool:
    if isinstance(f, Application):
        return f.fct == fct or any(_mentions_fct(a, fct) for a in f.args)
    if isinstance(f, Binding):
        return _mentions_fct(f.body, fct)
    return False


def _is_forall(f: Formula) -> bool:
    return isinstance(f, Binding) and f.binder == FORALL


def _find_site(fs, prefix: str):
    """First extraction-site application (extract.py _site names sites
    ``ext!<tag>!<k>``) whose symbol name starts with `prefix`, searched
    across the formulas `fs`."""
    found = None

    def walk(f):
        nonlocal found
        if found is not None:
            return
        if isinstance(f, Application):
            if getattr(f.fct, "name", "").startswith(prefix):
                found = f
                return
            for a in f.args:
                walk(a)
        elif isinstance(f, Binding):
            walk(f.body)

    for f in fs:
        walk(f)
        if found is not None:
            break
    return found


def _payload_fct(max_forall_axiom: Formula):
    """The sndts payload symbol, recovered from the masked-max ∀ axiom
    Leq(Ite(In(i, HO(j)), sndts(i), MIN), max(j))."""
    f = max_forall_axiom
    while isinstance(f, Binding):
        f = f.body
    # Leq(Ite(cond, sndts(i), MIN), site)
    ite = f.args[0]
    return ite.args[1].fct


def otr_extracted_stage_vcs(device=None):
    """The extracted-TR mmor lemma as a STAGED proof chain (the VERDICT
    round-2 target: the verifier proves from the *extracted* transition
    relation what verify/protocols.py's hand-written OTR lemmas prove).

    The monolithic entailment (site axioms ∧ majorities ⊨ mmor-site = w)
    drowns the reducer; the chain below discharges it by ∃-elimination —
    every stage is an `entailment(hyp, concl, cfg)` call, and the chain
    composes soundly:

      A. majorities ⊨ ∃k. x(k) = w                 (introduce the witness pw)
      B. ... ∧ x(pw)=w ⊨ 3·|C_pw| > n              (pw's support is > n/3;
                                                     C_pw = the extraction's
                                                     per-candidate count set)
      Ci/Cii. max-site = |C_pw|                     (≥ via the ∀ site axiom
                                                     at pw + card transfer;
                                                     ≤ via the attainment
                                                     skolem: a non-w
                                                     attainer's support is
                                                     < n/3 < |C_pw|)
      Di/Dii. min-site (= the mmor value x' adopts) = w

    Since pw is fresh in A's conclusion and every later stage only assumes
    x(pw) = w plus previously-proven facts, ⊨-transitivity + ∃-elimination
    give: site axioms ∧ payload ∧ value-bound ∧ majorities ⊨ msite = w —
    exactly the hand-written mor lemma (tests/test_verifier.py) but with the
    sites and equations EXTRACTED from models/otr.py's executable update.

    Returns (stages, meta): stages = [(name, hyp, concl, ClConfig)],
    meta = dict with the sites and the x'-structure for shape assertions.
    """
    sig, j, update_eqs, axioms, payload_def, value_bound = \
        otr_extracted_tr(device)

    w = Variable("w", Int)
    pw = Variable("pw", procType)
    k1 = Variable("k1", procType)
    k2 = Variable("k2", procType)
    k3 = Variable("k3", procType)
    snd = UnInterpretedFct("sndx", FunT([procType], Int))
    sx = lambda p: Application(snd, [p]).with_type(Int)

    S_w = Comprehension([k1], Eq(sig.get("x", k1), w))
    HOset = Comprehension([k2], In(k2, ho_of(j)))
    C_pw = Comprehension([k3], And(In(k3, ho_of(j)), Eq(sx(pw), sx(k3))))

    # x'(j) = Ite(quorum, msite, x(j)); the sites are the extraction's
    # axiomatized reduction results (extract.py _site)
    xp = update_eqs.args[0].args[1]
    msite = xp.args[1]
    maxsite = _find_site(axioms, "ext!max!")

    assert maxsite is not None and msite is not None, "sites not found"

    # bucket by which SITE SYMBOL an axiom pins (structural: the min axioms
    # mention the max site inside their Ite conditions, so min wins)
    min_axs = [a for a in axioms if _mentions_fct(a, msite.fct)]
    max_axs = [a for a in axioms
               if a not in min_axs and _mentions_fct(a, maxsite.fct)]
    max_forall = [a for a in max_axs if _is_forall(a)]
    max_attain = [a for a in max_axs if not _is_forall(a)]
    min_forall = [a for a in min_axs if _is_forall(a)]
    min_attain = [a for a in min_axs if not _is_forall(a)]
    assert max_forall and max_attain and min_forall and min_attain

    majorities = And(
        Gt(Times(3, Card(S_w)), Times(2, N)),
        Gt(Times(3, Card(HOset)), Times(2, N)),
    )
    c21 = ClConfig(venn_bound=2, inst_depth=1)
    c32 = ClConfig(venn_bound=3, inst_depth=2)

    stages = [
        ("A: majority witness", majorities,
         Exists([k1], Eq(sig.get("x", k1), w)), c21),
        ("B: witness support > n/3",
         And(majorities, payload_def, Eq(sig.get("x", pw), w)),
         Gt(Times(3, Card(C_pw)), N), c32),
        ("Ci: max >= |C_pw|", And(*max_forall),
         Geq(maxsite, Card(C_pw)), c21),
        ("Cii: max <= |C_pw|",
         And(Gt(Times(3, Card(S_w)), Times(2, N)), payload_def,
             Eq(sig.get("x", pw), w), *max_attain,
             Gt(Times(3, Card(C_pw)), N)),
         Leq(maxsite, Card(C_pw)), c21),
        ("Di: msite <= w",
         And(payload_def, Eq(sig.get("x", pw), w), *min_forall,
             Eq(maxsite, Card(C_pw))),
         Leq(msite, w), c21),
        ("Dii: msite >= w",
         And(Gt(Times(3, Card(S_w)), Times(2, N)), payload_def, value_bound,
             Eq(sig.get("x", pw), w), *min_attain,
             Gt(Times(3, Card(C_pw)), N), Eq(maxsite, Card(C_pw)),
             Leq(msite, w)),
         Geq(msite, w), c21),
    ]
    meta = {
        "sig": sig, "j": j, "w": w, "pw": pw, "msite": msite,
        "maxsite": maxsite, "xp": xp, "update_eqs": update_eqs,
        "C_pw": C_pw, "S_w": S_w, "majorities": majorities,
        "payload_def": payload_def, "value_bound": value_bound,
    }
    return stages, meta


# ---------------------------------------------------------------------------
# Event-round TR extraction (BEYOND the reference: RoundRewrite.scala:48-50
# warns EventRound verification is unsupported and its event-round
# TransitionRelation.scala:156-174 is a ??? stub)
# ---------------------------------------------------------------------------

def tpce_extracted_tr(device=None):
    """TwoPhaseCommitEvent's vote fold (round 2,
    TwoPhaseCommitEvent.scala:54-75) extracted from the EXECUTABLE event
    round: the trace runs the real TpcEVote through its declared reduction
    form (FoldRound.fold_reduced — pinned to the pairwise tree fold by
    tests/test_event_models.py), go_ahead and post included, so the
    decision equation and its AND-fold/mailbox-count sites come from the
    same code the engine executes.

    Returns (sig, j, coord, update_eqs, axioms, payload_def):
      update_eqs — decision′(j) = ⟨extracted Ite chain⟩
      axioms     — the fold/count site axioms for j's mailbox
      payload_def — ∀i. sndv(i) = vote(i)
    """
    import torch

    from round_tpu_torch.core.rounds import RoundCtx
    from round_tpu_torch.models.tpc_event import TpcEState, TpcEVote
    from round_tpu_torch.ops.mailbox import Mailbox as RtMailbox
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn
    from round_tpu_torch.verify.formula import IN

    sig = StateSig({"vote": Bool, "decision": Int, "decided": Bool,
                    "blocked": Bool})
    j = Variable("tej", procType)
    coord = Variable("tecoord", procType)
    r = Variable("ter", Int)
    sndv = UnInterpretedFct("tesndv", FunT([procType], Bool))

    def upd(n, rr, jid, coordv, vote, decision, decided, blocked,
            votes_p, mask):
        ctx = RoundCtx(id=jid, n=n, r=rr)
        st = TpcEState(coord=coordv, vote=vote, decision=decision,
                       decided=decided, blocked=blocked)
        rnd = TpcEVote(blocking=False, all_votes=True)
        m, count = rnd.fold_reduced(ctx, st, RtMailbox(votes_p, mask))
        go = rnd.go_ahead(ctx, st, m, count)
        st2 = rnd.post(ctx, st, m, count, torch.logical_not(go))
        return st2.decision

    ne = 5
    ex = [_i32(ne), _i32(1), _i32(0), _i32(0),
          _b(True), _i32(-1), _b(False),
          _b(False), _zeros(ne, "bool"),
          _zeros(ne, "bool")]
    fargs = [
        Scalar(N), Scalar(r), Scalar(j), Scalar(coord),
        Scalar(sig.get("vote", j)), Scalar(sig.get("decision", j)),
        Scalar(sig.get("decided", j)), Scalar(sig.get("blocked", j)),
        Vec(lambda i: Application(sndv, [i]).with_type(Bool)),
        Vec(lambda i: Application(IN, [i, ho_of(j)]).with_type(Bool)),
    ]
    outs, axioms = extract_lane_fn(
        upd, ex, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    update_eqs = Eq(sig.get_primed("decision", j), outs[0].f)
    i0 = Variable("tei", procType)
    payload_def = ForAll([i0], Eq(
        Application(sndv, [i0]).with_type(Bool), sig.get("vote", i0)
    ))
    return sig, j, coord, update_eqs, axioms, payload_def


def tpce_extracted_vcs(device=None):
    """Lemmas proved from the EXTRACTED TwoPhaseCommitEvent round-2 TR —
    the event-round verification the reference cannot do at all:

      commit: a non-blocked coordinator that hears ALL n processes, all
        voting yes, stamps decision′ = COMMIT (1).
      abort: same full mailbox, but SOME heard process votes no ⇒
        decision′ = ABORT (0) — the all_votes mode never commits past a
        no-vote.

    Returns [(name, hyp, concl, cfg)]; discharged in
    tests/test_event_extract.py."""
    sig, j, coord, update_eqs, axioms, payload_def = tpce_extracted_tr(device)
    i = Variable("i", procType)
    kk = Variable("k", procType)

    full_mb = ForAll([i], In(i, ho_of(j)))
    base = And(update_eqs, *axioms, payload_def, full_mb,
               Eq(j, coord), Not(sig.get("blocked", j)))
    c11 = ClConfig(venn_bound=1, inst_depth=1)
    c12 = ClConfig(venn_bound=1, inst_depth=2)
    return [
        ("tpce: all-yes full mailbox commits",
         And(base, ForAll([i], sig.get("vote", i))),
         Eq(sig.get_primed("decision", j), IntLit(1)), c11),
        ("tpce: a no-vote in a full mailbox aborts",
         And(base, Exists([kk], Not(sig.get("vote", kk)))),
         Eq(sig.get_primed("decision", j), IntLit(0)), c12),
    ]


def lve_extracted_tr(device=None):
    """LastVotingEvent's collect round (the `>=`-running max-timestamp
    fold, LastVotingEvent.scala:52-86) extracted from the EXECUTABLE event
    round via its declared reduction form (LVECollect.reduce: masked
    ts-max + highest-id argmax + payload gather — pinned to the tree fold
    by tests/test_event_models.py).

    Returns (sig, j, r, update_eqs, axioms, payload_def):
      update_eqs — commit′(j) = ⟨extracted⟩ ∧ vote′(j) = ⟨extracted⟩
      axioms     — max/argmax/gather site axioms for j's mailbox
      payload_def — ∀i. lvesndts(i) = ts(i) ∧ lvesndx(i) = x(i)
    """
    import torch

    from round_tpu_torch.core.rounds import RoundCtx
    from round_tpu_torch.models.lastvoting import LVState
    from round_tpu_torch.models.lastvoting_event import LVECollect
    from round_tpu_torch.ops.mailbox import Mailbox as RtMailbox
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn
    from round_tpu_torch.verify.formula import IN

    sig = StateSig({"x": Int, "ts": Int, "ready": Bool, "commit": Bool,
                    "vote": Int, "decided": Bool, "dec": Int})
    j = Variable("lvej", procType)
    r = Variable("lver", Int)
    sndx = UnInterpretedFct("lvesndx", FunT([procType], Int))
    sndts = UnInterpretedFct("lvesndts", FunT([procType], Int))

    def upd(n, rr, jid, x, ts, ready, commit, vote, decided, decision,
            ts_p, x_p, mask):
        ctx = RoundCtx(id=jid, n=n, r=rr)
        st = LVState(x=x, ts=ts, ready=ready, commit=commit, vote=vote,
                     decided=decided, decision=decision)
        rnd = LVECollect()
        m, count = rnd.fold_reduced(
            ctx, st, RtMailbox({"x": x_p, "ts": ts_p}, mask)
        )
        go = rnd.go_ahead(ctx, st, m, count)
        st2 = rnd.post(ctx, st, m, count, torch.logical_not(go))
        return st2.commit, st2.vote

    ne = 5
    ex = [_i32(ne), _i32(4), _i32(0), _i32(0),
          _i32(-1), _b(False), _b(False), _i32(0),
          _b(False), _i32(-1), _zeros(ne),
          _zeros(ne), _zeros(ne, "bool")]
    fargs = [
        Scalar(N), Scalar(r), Scalar(j),
        Scalar(sig.get("x", j)), Scalar(sig.get("ts", j)),
        Scalar(sig.get("ready", j)), Scalar(sig.get("commit", j)),
        Scalar(sig.get("vote", j)), Scalar(sig.get("decided", j)),
        Scalar(sig.get("dec", j)),
        Vec(lambda i: Application(sndts, [i]).with_type(Int)),
        Vec(lambda i: Application(sndx, [i]).with_type(Int)),
        Vec(lambda i: Application(IN, [i, ho_of(j)]).with_type(Bool)),
    ]
    outs, axioms = extract_lane_fn(
        upd, ex, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    update_eqs = And(
        Eq(sig.get_primed("commit", j), outs[0].f),
        Eq(sig.get_primed("vote", j), outs[1].f),
    )
    i0 = Variable("lvei", procType)
    payload_def = ForAll([i0], And(
        Eq(Application(sndts, [i0]).with_type(Int), sig.get("ts", i0)),
        Eq(Application(sndx, [i0]).with_type(Int), sig.get("x", i0)),
    ))
    return sig, j, r, update_eqs, axioms, payload_def


def lve_extracted_stage_vcs(device=None):
    """The maxTS lemma (LvExample.scala:268-284) proved from the EVENT-round
    LastVoting collect — extracted via LVECollect's reduction form — as a
    staged ∃-elimination chain (the discipline of lv_extracted_stage_vcs,
    which proves the same lemma from the CLOSED round):

      A. the timestamp majority and the mailbox majority intersect:
         ⊨ ∃k ∈ HO(j). ts(k) ≥ t
      B. ...so the masked ts-max site is ≥ t (∀ bound at the witness)
      C. the max is attained IN the mailbox (t ≥ 0 rules out the -1
         sentinel branch): ∃i ∈ HO(j). sndts(i) = max
      D. the argmax site is an at-max mailbox sender, and the id-max site
         is ≥ 0 (the C witness's id bounds both)
      E. vote′(j) = sndx(argmax) = v: the extracted condition holds (j is
         the coordinator with a majority mailbox), the inner guard
         max-id ≥ 0 holds by D, and the at-max sender's payload is pinned
         by the ts-property.

    The reference cannot state ANY of this: event-round verification is
    declared unsupported (RoundRewrite.scala:48-50) and its event-round
    transition relation is a stub (TransitionRelation.scala:156-174).

    Returns (stages, meta); discharged in tests/test_event_extract.py."""
    sig, j, r, update_eqs, axioms, payload_def = lve_extracted_tr(device)

    t = Variable("t", Int)
    v = Variable("v", Int)
    kw = Variable("kw", procType)   # stage-A witness
    iw = Variable("iw", procType)   # stage-C witness
    k1 = Variable("k1", procType)
    k2 = Variable("k2", procType)
    i = Variable("i", procType)

    sndts = UnInterpretedFct("lvesndts", FunT([procType], Int))
    sndx = UnInterpretedFct("lvesndx", FunT([procType], Int))

    def ts_of(p):
        return Application(sndts, [p]).with_type(Int)

    A_t = Comprehension([k1], Geq(sig.get("ts", k1), t))
    MB = Comprehension([k2], In(k2, ho_of(j)))

    votep = update_eqs.args[1].args[1]           # Ite(cond, inner, vote(j))
    cond = votep.args[0]
    inner = votep.args[1]                        # Ite(max5 >= 0, sndx(arg), x(j))
    is_coord = cond.args[0]                      # Eq(j, idToP(...))
    maxsite = _find_site(axioms, "ext!max!1")
    argsite = _find_site([inner.args[1]], "ext!argmax!")
    idmax = inner.args[0].args[0]                # Geq(idmax, 0) LHS
    assert maxsite is not None and argsite is not None
    assert getattr(idmax, "fct", None) is not None and \
        idmax.fct.name.startswith("ext!max!"), repr(idmax)

    ts_prop = ForAll([i], Implies(Geq(sig.get("ts", i), t),
                                  Eq(sig.get("x", i), v)))
    majorities = And(
        Gt(Times(2, Card(A_t)), N),
        Gt(Times(2, Card(MB)), N),
        Geq(t, IntLit(0)),
    )
    base = And(*axioms, payload_def, ts_prop, majorities)

    c21 = ClConfig(venn_bound=2, inst_depth=1)
    c02 = ClConfig(venn_bound=0, inst_depth=2)
    c01 = ClConfig(venn_bound=0, inst_depth=1)

    stages = [
        ("A: the majorities intersect",
         base,
         Exists([k1], And(In(k1, ho_of(j)), Geq(sig.get("ts", k1), t))),
         c21),
        ("B: the ts-max site dominates the witness",
         And(base, In(kw, ho_of(j)), Geq(sig.get("ts", kw), t)),
         Geq(maxsite, t), c02),
        ("C: the max is attained in the mailbox",
         And(base, Geq(maxsite, t)),
         Exists([k1], And(In(k1, ho_of(j)), Eq(ts_of(k1), maxsite))),
         c02),
        ("D: the argmax site is an at-max mailbox sender",
         And(base, In(iw, ho_of(j)), Eq(ts_of(iw), maxsite)),
         And(In(argsite, ho_of(j)), Eq(ts_of(argsite), maxsite),
             Geq(idmax, IntLit(0))),
         c02),
        ("E: the adopted vote is the anchored value",
         And(base, is_coord, Geq(maxsite, t),
             In(argsite, ho_of(j)), Eq(ts_of(argsite), maxsite),
             Geq(idmax, IntLit(0)), update_eqs),
         Eq(sig.get_primed("vote", j), v), c21),
    ]
    meta = {"sig": sig, "j": j, "cond": cond, "maxsite": maxsite,
            "argsite": argsite, "idmax": idmax}
    return stages, meta


def lv_verifier_spec() -> ProtocolSpec:
    """LastVoting END-TO-END through the Verifier — the roundInvariants
    route (Specs.scala:20-24, LastVoting.scala:49-61):

      init (at phase 0) ⊨ safety core ∧ F_0,
      per-round VCs  SC ∧ F_k ∧ TR_{k+1} ⊨ (SC ∧ F_{k+1})′  (round 4 wraps
      the phase), and  SC ⊨ agreement / validity.

    Rounds 2 and 4 discharge monolithically; rounds 1 (collect) and 3
    (ack) attach their decompositions as MACHINE-CHECKED StagedChains
    (lv_staged_chains — intro/justification/final VCs, assumption-scoped
    case analysis), so the verdict carries no composition caveat.  The
    reference `ignore`s ALL FOUR of these inductiveness VCs
    ("those completely blow-up", LvExample.scala:262-291) — this spec
    discharges every one through the native reducer.

    LIVENESS (the phase walk): under the good-phase environment of
    example/LastVoting.scala:19-22 — the coordinator hears a majority and
    everyone hears the coordinator (the reference states ∀q. q ∈ coord.HO
    ∧ |coord.HO| > n/2; each direction is consumed by the rounds that
    need it: collect/ack need the coordinator's majority mailbox,
    vote/decide need the coordinator in every mailbox) — the four rounds
    of one phase chain to a universal decision:

      live ∧ TR₁ ⊨ commit(coord)′                      (collect)
      commit(coord) ∧ live ∧ TR₂ ⊨ (∀i ts=Φ ∧ x=vote)′ (vote)
      … ∧ live ∧ TR₃ ⊨ ready(coord)′                   (ack)
      ready(coord) ∧ live ∧ TR₄ ⊨ (∀i decided ∧ dec=vote(coord))′

    Each VC's hypothesis is the previous conclusion unprimed; the walk's
    composition is induction over the phase's round sequence
    (Verifier.scala:144-157 checkProgress + the roundInvariants second
    elements, LastVoting.scala:49-61).  The final conclusion is the
    reference's invariants[1] (everyone decided, one value) in witnessed
    form — termination proves from it.

    Run:  python -m round_tpu.apps.verifier_cli lv   (~10 min CPU)."""
    chains, P = lv_staged_chains()
    vcs4, spec, lv = P["vcs"], P["spec"], P["lv"]
    sig = spec.sig
    r = lv["phase"]
    coord = lv["coord"]
    r1, r2, r3, r4 = lv["rounds"]
    assert set(chains) == {vcs4[0][0], vcs4[2][0]}, chains.keys()

    init0 = And(spec.init, Eq(r, IntLit(0)))

    i = Variable("i", procType)
    # the good-phase environment (LastVoting.scala:19-22): HO is the
    # per-round heard-of symbol, so conjoining `live` to each of the four
    # VCs asserts the environment for all four rounds of the phase
    live = And(
        Gt(Times(2, Card(ho_of(coord))), N),
        ForAll([i], In(coord, ho_of(i))),
    )
    c1 = sig.get("commit", coord)
    c2 = And(c1, ForAll([i], And(
        Eq(sig.get("x", i), sig.get("vote", coord)),
        Eq(sig.get("ts", i), r),
    )))
    c3 = And(c2, sig.get("ready", coord))
    c4 = ForAll([i], And(
        sig.get("decided", i),
        Eq(sig.get("dec", i), sig.get("vote", coord)),
    ))
    walk = [
        ("progress: collect — the coordinator commits",
         live, r1.full_tr(), sig.prime(c1)),
        ("progress: vote — everyone adopts the vote at ts = phase",
         And(c1, live), r2.full_tr(), sig.prime(c2)),
        ("progress: ack — the coordinator becomes ready",
         And(c2, live), r3.full_tr(), sig.prime(c3)),
        ("progress: decide — everyone decides the vote",
         And(c3, live), r4.full_tr(), sig.prime(c4)),
    ]

    return ProtocolSpec(
        sig=sig,
        rounds=spec.rounds,
        init=init0,
        # the SAFETY CORE only: F_k facts hold per boundary and must not
        # strengthen the property hypotheses (review r03 soundness finding)
        invariants=[lv["inv1"]],
        properties=[
            ("agreement", spec.properties[0][1]),
            ("validity", spec.properties[1][1],
             ClConfig(venn_bound=2, inst_depth=2)),
        ],
        config=spec.config,
        staged=chains,
        round_staged_inductiveness=list(vcs4),
        round_staged_init=lv["stage0_at"](r),
        phase_progress=walk,
    )


# ---------------------------------------------------------------------------
# FloodMin (example/FloodMin.scala) — extracted-TR lemmas
# ---------------------------------------------------------------------------

def floodmin_extracted_tr(f: int = 2, device=None):
    """FloodMin's transition relation extracted from the EXECUTABLE round
    (models/floodmin.py FloodMinRound.update: fold_min + decide after
    round f) via the aten-graph abstract interpreter.  The reference has no
    FloodMin logic suite at all — these lemmas have no upstream analogue.

    Returns (sig, j, r, update_eqs, site_axioms, payload_def)."""
    import torch

    from round_tpu_torch.ops.mailbox import Mailbox as RtMailbox
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn
    from round_tpu_torch.verify.formula import IN

    sig = StateSig({"x": Int, "decided": Bool, "dec": Int})
    j = Variable("fmj", procType)
    r = Variable("fmr", Int)
    snd = UnInterpretedFct("fmsnd", FunT([procType], Int))

    def upd(n, rr, x, decided, dec, vals, mask):
        # models/floodmin.py FloodMinRound.update, verbatim semantics
        m = RtMailbox(vals, mask)
        x2 = m.fold_min(x)
        deciding = rr > f
        decided2 = decided | deciding
        dec2 = torch.where(deciding & ~decided, x2, dec)
        return x2, decided2, dec2

    ne = 5
    ex_args = [_i32(ne), _i32(0), _i32(0), _b(False),
               _i32(-1), _zeros(ne),
               _zeros(ne, "bool")]
    fargs = [
        Scalar(N),
        Scalar(r),
        Scalar(sig.get("x", j)),
        Scalar(sig.get("decided", j)),
        Scalar(sig.get("dec", j)),
        Vec(lambda i: Application(snd, [i]).with_type(Int)),
        Vec(lambda i: Application(IN, [i, ho_of(j)]).with_type(Bool)),
    ]
    outs, axioms = extract_lane_fn(
        upd, ex_args, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    update_eqs = And(*[
        Eq(sig.get_primed(name, j), out.f)
        for name, out in zip(["x", "decided", "dec"], outs)
    ])
    i0 = Variable("fmi0", procType)
    payload_def = ForAll([i0], Eq(Application(snd, [i0]).with_type(Int),
                                  sig.get("x", i0)))
    return sig, j, r, update_eqs, axioms, payload_def


def floodmin_extracted_lemmas(f: int = 2, device=None):
    """Provable consequences of the extracted FloodMin TR — the safety
    skeleton of the f-crash min-flooding argument (FloodMin.scala:22-33):

      lower-bound:  every estimate >= m stays >= m through the round
                    (with validity init, decisions stay in the initial
                    range — no value is invented);
      monotone:     x'(j) <= x(j) (the fold includes the own estimate);
      attainment:   the new estimate is SOME current estimate;
      decide-pins:  a fresh round-(f+1) decision records exactly x'.

    Returns (lemmas, meta): lemmas = [(name, hyp, concl, cfg)]."""
    sig, j, r, update_eqs, axioms, payload_def = \
        floodmin_extracted_tr(f, device)
    tr = And(update_eqs, payload_def, *axioms)
    mlb = Variable("fmlb", Int)
    kq = Variable("fmk", procType)
    cfg = ClConfig(venn_bound=2, inst_depth=2)

    lemmas = [
        ("lower-bound",
         And(tr, ForAll([kq], Geq(sig.get("x", kq), mlb))),
         Geq(sig.get_primed("x", j), mlb), cfg),
        ("monotone",
         tr, Leq(sig.get_primed("x", j), sig.get("x", j)), cfg),
        ("attainment",
         tr,
         Exists([kq], Eq(sig.get_primed("x", j), sig.get("x", kq))), cfg),
        ("decide-pins",
         And(tr, Gt(r, IntLit(f)), Not(sig.get("decided", j))),
         And(sig.get_primed("decided", j),
             Eq(sig.get_primed("dec", j), sig.get_primed("x", j))), cfg),
    ]
    meta = dict(sig=sig, j=j, r=r, update_eqs=update_eqs, axioms=axioms,
                payload_def=payload_def)
    return lemmas, meta


# ---------------------------------------------------------------------------
# KSetEarlyStopping (example/KSetEarlyStopping.scala) — extracted-TR lemmas
# ---------------------------------------------------------------------------

def kset_extracted_tr(t: int = 3, k: int = 2, device=None):
    """KSetEarlyStopping's TR extracted from the EXECUTABLE round
    (models/kset.py KSetESRound.update): est = masked min, canDecide =
    heard-can ∨ fewer-than-k-dropouts, horizon r > t/k.  The est site
    extracts as an extremum with bound/attainment axioms; |mailbox| as a
    Cardinality comprehension over HO(j) — the dropout trigger is real
    cardinality arithmetic.  No upstream logic-suite analogue.

    Returns (sig, j, r, update_eqs, site_axioms, payload_defs)."""
    import torch

    from round_tpu_torch.ops.mailbox import Mailbox as RtMailbox
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn
    from round_tpu_torch.verify.formula import IN

    sig = StateSig({"est": Int, "can": Bool, "last_nb": Int,
                    "decided": Bool, "dec": Int})
    j = Variable("ksj", procType)
    r = Variable("ksr", Int)
    snde = UnInterpretedFct("kse", FunT([procType], Int))
    sndc = UnInterpretedFct("ksc", FunT([procType], Bool))

    def upd(n, rr, est, can, last_nb, decided, dec, v_est, v_can, mask):
        # models/kset.py KSetESRound.update, verbatim semantics
        m = RtMailbox({"est": v_est, "can": v_can}, mask)
        curr_nb = m.size()
        deciding = (rr > t // k) | can
        est2 = m.masked_min(v_est)
        can2 = m.exists(lambda mm: mm["can"]) | (last_nb - curr_nb < k)
        decided2 = decided | deciding
        dec2 = torch.where(deciding & ~decided, est, dec)
        return (torch.where(deciding, est, est2),
                torch.where(deciding, can, can2),
                torch.where(deciding, last_nb, curr_nb), decided2, dec2)

    ne = 5
    ex_args = [_i32(ne), _i32(0), _i32(0), _b(False),
               _i32(ne), _b(False), _i32(-1),
               _zeros(ne), _zeros(ne, "bool"),
               _zeros(ne, "bool")]
    fargs = [
        Scalar(N), Scalar(r),
        Scalar(sig.get("est", j)), Scalar(sig.get("can", j)),
        Scalar(sig.get("last_nb", j)), Scalar(sig.get("decided", j)),
        Scalar(sig.get("dec", j)),
        Vec(lambda i: Application(snde, [i]).with_type(Int)),
        Vec(lambda i: Application(sndc, [i]).with_type(Bool)),
        Vec(lambda i: Application(IN, [i, ho_of(j)]).with_type(Bool)),
    ]
    outs, axioms = extract_lane_fn(
        upd, ex_args, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    update_eqs = And(*[
        Eq(sig.get_primed(name, j), out.f)
        for name, out in zip(["est", "can", "last_nb", "decided", "dec"],
                             outs)
    ])
    i0 = Variable("ksi0", procType)
    i1 = Variable("ksi1", procType)
    payload_defs = And(
        ForAll([i0], Eq(Application(snde, [i0]).with_type(Int),
                        sig.get("est", i0))),
        ForAll([i1], Eq(Application(sndc, [i1]).with_type(Bool),
                        sig.get("can", i1))),
    )
    return sig, j, r, update_eqs, axioms, payload_defs


def kset_extracted_lemmas(t: int = 3, k: int = 2, device=None):
    """Provable consequences of the extracted KSetEarlyStopping TR
    (KSetEarlyStopping.scala:8-46 semantics):

      lower-bound:   estimates >= m stay >= m (validity skeleton; needs
                     self-delivery and the int32-sentinel value bound,
                     as OTR's mmor lemma does);
      monotone:      est'(j) <= est(j) under self-delivery;
      can-propagate: one heard canDecide infects the receiver;
      dropout-trigger: last_nb - |HO(j)| < k flips canDecide — REAL
                     cardinality arithmetic on the extracted |mailbox|
                     comprehension;
      decide-pins:   a fresh decision records exactly est(j).

    Returns (lemmas, meta)."""
    sig, j, r, update_eqs, axioms, payload_defs = \
        kset_extracted_tr(t, k, device)
    tr = And(update_eqs, payload_defs, *axioms)
    not_deciding = And(Not(Gt(r, IntLit(t // k))), Not(sig.get("can", j)))
    self_heard = In(j, ho_of(j))
    mlb = Variable("kslb", Int)
    kq = Variable("ksq", procType)
    p0 = Variable("ksp0", procType)
    imax = IntLit(2**31 - 1)
    value_bound = ForAll([kq], Lt(sig.get("est", kq), imax))
    cfg = ClConfig(venn_bound=2, inst_depth=2)

    i2 = Variable("ksi2", procType)
    ho_card = Card(Comprehension([i2], In(i2, ho_of(j))))

    lemmas = [
        ("lower-bound",
         And(tr, self_heard, value_bound,
             ForAll([kq], Geq(sig.get("est", kq), mlb))),
         Geq(sig.get_primed("est", j), mlb), cfg),
        ("monotone",
         And(tr, self_heard),
         Leq(sig.get_primed("est", j), sig.get("est", j)), cfg),
        ("can-propagate",
         And(tr, not_deciding, In(p0, ho_of(j)), sig.get("can", p0)),
         sig.get_primed("can", j), cfg),
        ("dropout-trigger",
         And(tr, not_deciding,
             Lt(Minus(sig.get("last_nb", j), ho_card), IntLit(k))),
         sig.get_primed("can", j), cfg),
        ("decide-pins",
         And(tr, Gt(r, IntLit(t // k)), Not(sig.get("decided", j))),
         And(sig.get_primed("decided", j),
             Eq(sig.get_primed("dec", j), sig.get("est", j))), cfg),
    ]
    meta = dict(sig=sig, j=j, r=r, update_eqs=update_eqs, axioms=axioms,
                payload_defs=payload_defs, not_deciding=not_deciding,
                ho_card=ho_card, t=t, k=k)
    return lemmas, meta


# ---------------------------------------------------------------------------
# BenOr round 1 (example/BenOr.scala) — extracted-TR lemmas
# ---------------------------------------------------------------------------

def benor_extracted_tr(receiver: str = "boj", device=None):
    """BenOr's VOTE round extracted from the executable model
    (models/benor.py BenOrRound1.update): vote = majority-or-heard-decider
    over (x, canDecide) broadcasts; canDecide propagates; a canDecide
    lane decides its estimate.  The counts extract as Card comprehensions
    over HO(receiver), the decider tests as ∃ — nested in Ite BRANCHES,
    exercising the branch-quantified lift.  The reference has no BenOr
    logic suite.

    Returns (sig, j, update_eqs, axioms, payload_defs) for the given
    receiver name — the vote-exclusivity lemma instantiates TWO receivers
    against the same payload functions."""
    import torch

    from round_tpu_torch.ops.mailbox import Mailbox as RtMailbox
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn
    from round_tpu_torch.verify.formula import IN

    sig = StateSig({"x": Bool, "can": Bool, "vote": Int,
                    "decided": Bool, "dec": Bool})
    j = Variable(receiver, procType)
    sndx = UnInterpretedFct("box", FunT([procType], Bool))
    sndc = UnInterpretedFct("boc", FunT([procType], Bool))

    def upd(n, x, can, vote, decided, dec, v_x, v_can, mask):
        # models/benor.py BenOrRound1.update, verbatim semantics
        m = RtMailbox({"x": v_x, "can": v_can}, mask)
        t_cnt = m.count(lambda mm: mm["x"])
        f_cnt = m.count(lambda mm: ~mm["x"])
        t_dec = m.exists(lambda mm: mm["x"] & mm["can"])
        f_dec = m.exists(lambda mm: ~mm["x"] & mm["can"])
        vote2 = torch.where(
            (t_cnt > n // 2) | t_dec, 1,
            torch.where((f_cnt > n // 2) | f_dec, 0, -1)).to(torch.int32)
        can2 = m.exists(lambda mm: mm["can"])
        deciding = can
        decided2 = decided | deciding
        dec2 = torch.where(deciding & ~decided, x, dec)
        return (torch.where(deciding, vote, vote2),
                torch.where(deciding, can, can2), decided2, dec2)

    ne = 5
    ex_args = [_i32(ne), _b(False), _b(False),
               _i32(-1), _b(False), _b(False),
               _zeros(ne, "bool"), _zeros(ne, "bool"),
               _zeros(ne, "bool")]
    fargs = [
        Scalar(N),
        Scalar(sig.get("x", j)), Scalar(sig.get("can", j)),
        Scalar(sig.get("vote", j)), Scalar(sig.get("decided", j)),
        Scalar(sig.get("dec", j)),
        Vec(lambda i: Application(sndx, [i]).with_type(Bool)),
        Vec(lambda i: Application(sndc, [i]).with_type(Bool)),
        Vec(lambda i: Application(IN, [i, ho_of(j)]).with_type(Bool)),
    ]
    outs, axioms = extract_lane_fn(
        upd, ex_args, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    update_eqs = And(*[
        Eq(sig.get_primed(name, j), out.f)
        for name, out in zip(["vote", "can", "decided", "dec"], outs)
    ])
    i0 = Variable(f"{receiver}i0", procType)
    i1 = Variable(f"{receiver}i1", procType)
    payload_defs = And(
        ForAll([i0], Eq(Application(sndx, [i0]).with_type(Bool),
                        sig.get("x", i0))),
        ForAll([i1], Eq(Application(sndc, [i1]).with_type(Bool),
                        sig.get("can", i1))),
    )
    return sig, j, update_eqs, axioms, payload_defs


def benor_extracted_lemmas(device=None):
    """Provable consequences of the extracted BenOr vote round:

      vote-exclusivity: in a phase where nobody canDecide yet, two
        receivers cannot vote OPPOSITE values — the two >n/2 majorities
        count DISJOINT payload classes (x vs ¬x), so their sum would
        exceed n (the PODC'83 safety core, via Venn cardinalities over
        two receivers' HO sets);
      can-propagate: one heard canDecide infects the receiver;
      decide-pins: a canDecide lane decides exactly its estimate.

    Returns (lemmas, meta)."""
    sig, j, eqs_j, ax_j, payload = benor_extracted_tr("boj", device)
    _, jp, eqs_jp, ax_jp, _ = benor_extracted_tr("bok", device)
    ks = Variable("boks", procType)
    p0 = Variable("bop0", procType)
    nobody_can = ForAll([ks], Not(sig.get("can", ks)))
    tr2 = And(eqs_j, eqs_jp, payload, *(list(ax_j) + list(ax_jp)))
    tr1 = And(eqs_j, payload, *ax_j)
    cfg = ClConfig(venn_bound=3, inst_depth=2)

    lemmas = [
        ("vote-exclusivity",
         And(tr2, nobody_can),
         Not(And(Eq(sig.get_primed("vote", j), IntLit(1)),
                 Eq(sig.get_primed("vote", jp), IntLit(0)))), cfg),
        ("can-propagate",
         And(tr1, Not(sig.get("can", j)), In(p0, ho_of(j)),
             sig.get("can", p0)),
         sig.get_primed("can", j), cfg),
        ("decide-pins",
         And(tr1, sig.get("can", j), Not(sig.get("decided", j))),
         And(sig.get_primed("decided", j),
             Eq(sig.get_primed("dec", j), sig.get("x", j))), cfg),
    ]
    meta = dict(sig=sig, j=j, jp=jp, payload=payload, eqs_j=eqs_j,
                eqs_jp=eqs_jp, ax_j=ax_j, ax_jp=ax_jp,
                nobody_can=nobody_can)
    return lemmas, meta


# ---------------------------------------------------------------------------
# PBFT view change (example/byzantine/pbft/ViewChange.scala) — the new-view
# selection extracted from the executable round
# ---------------------------------------------------------------------------

def pbft_vc_selection_extracted(device=None):
    """The NEW-VIEW selection extracted from the EXECUTABLE
    VcViewChangeAck update (models/pbft.py — ViewChange.scala:26-40's
    "compute new view" collapsed to the single-decision case): among the
    CONFIRMED view-change certificates, pick the request prepared at the
    highest view; with no prepared certificate, fall back to the
    primary's own request.

    The first_true(key == key.max()) tie-break extracts as a
    max-extremum site (bound + attainment) and a boolean argmax site
    (any at-max candidate → the site is one) — the sound
    over-approximation the safety lemmas need; the smallest-id tie-break
    itself is abstracted away.

    Returns (sel_term, anyp_term, axioms, meta)."""
    import torch

    from round_tpu_torch.ops.mailbox import first_true
    from round_tpu_torch.verify.extract import Scalar, Vec, extract_lane_fn

    j = Variable("pvj", procType)
    conf = UnInterpretedFct("pv!conf", FunT([procType], Bool))
    vreq = UnInterpretedFct("pv!req", FunT([procType], Int))
    vpv = UnInterpretedFct("pv!pv", FunT([procType], Int))
    xv = Variable("pvx", Int)

    def conf_of(i):
        return Application(conf, [i]).with_type(Bool)

    def vreq_of(i):
        return Application(vreq, [i]).with_type(Int)

    def vpv_of(i):
        return Application(vpv, [i]).with_type(Int)

    def sel_fn(n, x, confirmed, vr, vp):
        # models/pbft.py VcViewChangeAck.update's selection, as it stands
        has_prep = confirmed & (vp >= 0)
        key = torch.where(has_prep, vp, -2)
        best = first_true(key == key.max())
        any_prep = has_prep.any()
        sel = torch.where(any_prep, vr[best.reshape(1)][0], x)
        return sel, any_prep

    ne = 5
    ex_args = [_i32(ne), _i32(0), _zeros(ne, "bool"),
               _zeros(ne), _zeros(ne)]
    fargs = [
        Scalar(N), Scalar(xv),
        Vec(conf_of), Vec(vreq_of), Vec(vpv_of),
    ]
    outs, axioms = extract_lane_fn(
        sel_fn, ex_args, fargs, lambda i: Literal(True), receiver=j,
        return_axioms=True, device=device,
    )
    sel_t, anyp_t = outs[0].f, outs[1].f
    meta = dict(j=j, x=xv, conf_of=conf_of, vreq_of=vreq_of,
                vpv_of=vpv_of, axioms=axioms)
    return sel_t, anyp_t, axioms, meta


def pbft_vc_extracted_lemmas(device=None):
    """Safety of the extracted new-view selection (the round-5 verdict's
    "a prepared value survives into the new view"):

      attainment: with any prepared certificate confirmed, the selection
                  IS some confirmed certificate's request (prepared at a
                  view >= 0) — the new primary cannot invent a value;
      survival:   if every confirmed prepared certificate carries v (the
                  post-commit situation: a >2n/3 commit quorum forces
                  every intersecting certificate to v), the selection is
                  v — the committed value survives the rotation;
      max-view:   no confirmed certificate is prepared at a view above
                  the selected one (the PBFT max-𝓟 rule);
      fallback:   with NO prepared certificate the primary's own request
                  is selected.

    Returns (lemmas, meta); the no-axioms negative control lives in
    tests/test_extract_vcs.py."""
    sel_t, anyp_t, axioms, meta = pbft_vc_selection_extracted(device)
    conf_of, vreq_of, vpv_of = (meta["conf_of"], meta["vreq_of"],
                                meta["vpv_of"])
    xv = meta["x"]
    i = Variable("pvi", procType)
    v = Variable("pvv", Int)
    base = And(*axioms)
    has_prep_i = And(conf_of(i), Geq(vpv_of(i), IntLit(0)))

    c02 = ClConfig(venn_bound=0, inst_depth=2)
    c03 = ClConfig(venn_bound=0, inst_depth=3)

    lemmas = [
        ("selection-attainment",
         And(base, anyp_t),
         Exists([i], And(has_prep_i, Eq(sel_t, vreq_of(i)))), c03),
        ("prepared-value-survives",
         And(base, anyp_t,
             ForAll([i], Implies(has_prep_i, Eq(vreq_of(i), v)))),
         Eq(sel_t, v), c03),
        ("max-view-selected",
         And(base, anyp_t),
         Exists([i], And(has_prep_i, Eq(sel_t, vreq_of(i)),
                         ForAll([Variable("pvk", procType)],
                                Implies(And(conf_of(Variable("pvk", procType)),
                                            Geq(vpv_of(Variable("pvk", procType)),
                                                IntLit(0))),
                                        Leq(vpv_of(Variable("pvk", procType)),
                                            vpv_of(i)))))), c03),
        ("no-certificate-fallback",
         And(base, Not(anyp_t)),
         Eq(sel_t, xv), c02),
    ]
    return lemmas, meta
