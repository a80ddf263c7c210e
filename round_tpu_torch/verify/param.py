"""Parameterized verification from extracted threshold automata.

Port of round_tpu/verify/param.py, the package name changed and a
``device=`` for the automaton's traces (the card unless the caller names
one).

analysis/threshold.py recovers, from the live aten-graph traces, each
protocol's threshold automaton: quorum guards as affine-in-n count
thresholds, control locations, rules, and the declared resilience
condition (n > Kf).  This module turns that automaton into verification
conditions over the SYMBOLIC group size (venn.N_VAR) and a symbolic fault
bound f, states them in the verify/formula.py vocabulary, and discharges
them through the CL reducer + ground solver — so every PROVED verdict
holds for ALL n satisfying the resilience condition, not for an anchored
instance.

Generated VC classes (all mechanically derived from the automaton):

  correct-quorum-exists   n > Kf ∧ |C| ≥ n−f  ⊨  guard(C)
                          (per-round progress: the correct processes alone
                          can fire every threshold rule — the HO-assumption
                          form of liveness enabledness)
  quorum-intersection     guard₁(A) ∧ guard₂(B)  ⊨  |A∩B| ≥ 1
                          (and |A∩B| > f when the envelope is n > 3f —
                          the agreement core: two quorums share a process
                          beyond the fault budget)
  no-faulty-quorum        guard(A) ∧ |A| ≤ f ∧ n > Kf  ⊨  ⊥
                          (counter-abstraction reachability: no rule fires
                          from faulty senders alone)
  good-HO-progress        n > Kf ∧ ∀j.|HO(j)| ≥ n−f  ⊨  ∀j. guard(HO(j))
                          (the magic-round enabledness, per threshold)
  counter-conservation    per automaton rule: the location counters stay a
                          partition of n (Σκ′ = n, κ′ ≥ 0)
  cross-checks            the generated invariants/guards entail (and,
                          where stated, are entailed by) the hand-written
                          fixed-spec formulas of verify/protocols.py — the
                          all-n result is CONSISTENT with the anchored
                          proofs (OTR chain_inv0's invariant, LV's anchor
                          majority / stamp facts)

Plus structural checks evaluated on the automaton itself (no solver):
decided-irrevocable (no rule leaves a decided location), and
decision-has-threshold-pedigree (every rule entering a decided location
is guarded by a threshold or a receive of a threshold-gated sender).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from round_tpu_torch.verify.cl import ClConfig, entailment
from round_tpu_torch.verify.formula import (
    And, Application, Card, Comprehension, Eq, Exists, ForAll, Formula,
    FSet, Geq, Gt, Implies, In, Int, IntLit, INTERSECTION, Leq, Literal,
    Minus, Plus, Times, Variable, procType,
)
from round_tpu_torch.verify.tr import ho_of
from round_tpu_torch.verify.venn import N_VAR as N

F = Variable("f", Int)

c01 = ClConfig(venn_bound=0, inst_depth=1)
c11 = ClConfig(venn_bound=1, inst_depth=1)
c21 = ClConfig(venn_bound=2, inst_depth=1)


@dataclasses.dataclass
class ParamVC:
    """One generated parameterized VC (or structural check)."""

    name: str
    hyp: Optional[Formula] = None
    concl: Optional[Formula] = None
    config: ClConfig = c11
    timeout_s: float = 120.0
    #: structural checks carry a closure instead of formulas
    check: Optional[Callable[[], bool]] = None
    #: VC provenance, shown in reports: which guard(s)/rule produced it
    origin: str = ""


@dataclasses.dataclass
class ParamResult:
    name: str
    ok: bool
    seconds: float
    origin: str = ""
    error: str = ""


# ---------------------------------------------------------------------------
# Threshold → formula
# ---------------------------------------------------------------------------

def threshold_applied(thr, card_terms: Sequence[Formula]) -> Formula:
    """The fitted guard ``Σ coeffᵢ·cᵢ  op  floor((a·n + b)/d)`` applied to
    cardinality terms, floor eliminated by integrality:

        lhs > floor(q/d)  ⟺  d·lhs > q
        lhs ≥ floor(q/d)  ⟺  d·lhs > q − d
        lhs = q           (d = 1 only)
    """
    assert len(card_terms) == len(thr.coeffs), (thr, card_terms)
    parts = [Times(k, c) if k != 1 else c
             for k, c in zip(thr.coeffs, card_terms)]
    lhs = parts[0] if len(parts) == 1 else Plus(*parts)
    if thr.d != 1:
        lhs = Times(thr.d, lhs)
    q = Times(thr.a, N) if thr.b == 0 else (
        Plus(Times(thr.a, N), IntLit(thr.b)) if thr.a != 0 else IntLit(thr.b))
    if thr.op == "gt":
        return Gt(lhs, q)
    if thr.op == "ge":
        return Gt(lhs, Minus(q, IntLit(thr.d))) if thr.d != 1 else Geq(lhs, q)
    if thr.op == "eq" and thr.d == 1:
        return Eq(lhs, q)
    raise ValueError(f"unsupported threshold form for formula export: {thr}")


def _is_quorum(thr) -> bool:
    """A 'quorum' threshold: one count, unit coefficient, strict bound
    growing with n — the guards whose intersection/enabledness lemmas are
    meaningful (the `size > 0` bootstrap and relative thresholds are
    not)."""
    return (len(thr.coeffs) == 1 and thr.coeffs[0] == 1
            and thr.op in ("gt", "ge") and thr.a > 0)


def _setvar(name: str) -> Variable:
    return Variable(name, FSet(procType))


# ---------------------------------------------------------------------------
# VC generation
# ---------------------------------------------------------------------------

def generate_param_vcs(automaton) -> List[ParamVC]:
    """The automaton-derived VC matrix (see module docstring)."""
    if automaton.resilience is None:
        raise ValueError(
            f"{automaton.protocol}: no declared fault envelope "
            "(Algorithm.fault_envelope) — parameterized VCs are stated "
            "under the resilience condition"
        )
    K, res_str = automaton.resilience
    resilience = And(Gt(N, Times(K, F)), Geq(F, IntLit(0)))
    quorums = [(g.name, g.threshold) for g in automaton.thresholds()
               if _is_quorum(g.threshold)]
    vcs: List[ParamVC] = []

    # -- correct-quorum-exists / good-HO-progress per quorum guard --------
    C = _setvar("C")
    j0 = Variable("j0", procType)
    for gname, thr in quorums:
        vcs.append(ParamVC(
            name=f"progress: correct processes fire {thr.render()}",
            hyp=And(resilience, Geq(Card(C), Minus(N, F))),
            concl=threshold_applied(thr, [Card(C)]),
            config=c11,
            origin=f"guard {gname} [{res_str}]",
        ))
        good_ho = ForAll([j0], Geq(Card(ho_of(j0)), Minus(N, F)))
        jc = Variable("jc", procType)
        vcs.append(ParamVC(
            name=f"progress: good-HO round enables {thr.render()} "
                 "at every receiver",
            hyp=And(resilience, good_ho),
            concl=ForAll([jc], threshold_applied(thr, [Card(ho_of(jc))])),
            config=c11,
            origin=f"guard {gname} [{res_str}]",
        ))

    # -- quorum intersection (the agreement core) -------------------------
    A, B = _setvar("A"), _setvar("B")
    byzantine = K >= 3
    seen_pairs = set()
    for i, (gn1, t1) in enumerate(quorums):
        for gn2, t2 in quorums[i:]:
            key = tuple(sorted([t1.render(), t2.render()]))
            if key in seen_pairs:
                continue
            seen_pairs.add(key)
            hyp = And(resilience,
                      threshold_applied(t1, [Card(A)]),
                      threshold_applied(t2, [Card(B)]))
            inter_set = Application(INTERSECTION, [A, B])
            inter_set.tpe = FSet(procType)
            inter = Card(inter_set)
            vcs.append(ParamVC(
                name=f"safety: quorums intersect "
                     f"({t1.render()} ∩ {t2.render()})",
                hyp=hyp,
                concl=Geq(inter, IntLit(1)),
                config=c21,
                origin=f"guards {gn1}×{gn2}",
            ))
            if byzantine:
                vcs.append(ParamVC(
                    name=f"safety: quorum intersection exceeds the fault "
                         f"budget ({t1.render()} ∩ {t2.render()} > f)",
                    hyp=hyp,
                    concl=Gt(inter, F),
                    config=c21,
                    origin=f"guards {gn1}×{gn2} [{res_str}]",
                ))

    # -- no faulty-only quorum (reachability: rules need real senders) ----
    for gname, thr in quorums:
        vcs.append(ParamVC(
            name=f"safety: no faulty-only quorum for {thr.render()}",
            hyp=And(resilience,
                    threshold_applied(thr, [Card(A)]),
                    Leq(Card(A), F)),
            concl=Literal(False),
            config=c11,
            origin=f"guard {gname} [{res_str}]",
        ))

    # -- counter-abstraction conservation per rule ------------------------
    locs = list(automaton.locations)
    loc_index = {loc: i for i, loc in enumerate(locs)}
    seen_moves = set()
    for rule in automaton.rules:
        move = (rule.src, rule.dst)
        if move in seen_moves or rule.src == rule.dst:
            continue
        seen_moves.add(move)
        ks = [Variable(f"k{i}", Int) for i in range(len(locs))]
        kps = [Variable(f"k{i}!p", Int) for i in range(len(locs))]
        m = Variable("m", Int)
        si, di = loc_index[rule.src], loc_index[rule.dst]
        hyp_parts = [Geq(k, IntLit(0)) for k in ks]
        hyp_parts.append(Eq(Plus(*ks) if len(ks) > 1 else ks[0], N))
        hyp_parts += [Geq(m, IntLit(0)), Leq(m, ks[si])]
        for i in range(len(locs)):
            if i == si:
                hyp_parts.append(Eq(kps[i], Minus(ks[i], m)))
            elif i == di:
                hyp_parts.append(Eq(kps[i], Plus(ks[i], m)))
            else:
                hyp_parts.append(Eq(kps[i], ks[i]))
        src_s = "{" + ",".join(f for f, b in rule.src if b) + "}"
        dst_s = "{" + ",".join(f for f, b in rule.dst if b) + "}"
        vcs.append(ParamVC(
            name=f"counters: rule {src_s}→{dst_s} preserves the "
                 "partition of n",
            hyp=And(*hyp_parts),
            concl=And(Eq(Plus(*kps) if len(kps) > 1 else kps[0], N),
                      *[Geq(kp, IntLit(0)) for kp in kps]),
            config=c01,
            origin=f"rule r{rule.round}",
        ))

    # -- structural checks ------------------------------------------------
    def decided_irrevocable() -> bool:
        for r in automaton.rules:
            if dict(r.src).get("decided") and not dict(r.dst).get("decided"):
                return False
        return True

    def decision_has_pedigree() -> bool:
        """Every rule that SETS decided is guarded by a threshold or a
        receive atom (a decision is caused by messages, never spontaneous)."""
        for r in automaton.rules:
            if dict(r.dst).get("decided") and not dict(r.src).get("decided"):
                kinds = {automaton.guards[a].kind for a, pol in r.guard
                         if pol and a in automaton.guards}
                if not kinds & {"threshold", "receive"}:
                    return False
        return True

    if "decided" in automaton.fields:
        vcs.append(ParamVC(
            name="structure: decided locations are absorbing "
                 "(irrevocability skeleton)",
            check=decided_irrevocable,
            origin="automaton rules",
        ))
        vcs.append(ParamVC(
            name="structure: every decision rule has a threshold/receive "
                 "pedigree",
            check=decision_has_pedigree,
            origin="automaton rules",
        ))
    return vcs


# ---------------------------------------------------------------------------
# Cross-checks against the hand-written fixed-spec proofs (protocols.py)
# ---------------------------------------------------------------------------

def _otr_cross_vcs(automaton) -> List[ParamVC]:
    """OTR: the automaton's decision guard REGENERATES the hand invariant
    of protocols.otr_spec() — the one chain_inv0/chain_p1_inductive prove
    inductive (for symbolic n) and the anchored n=4 suite pins.  Both
    entailment directions are discharged, so the all-n proof and the
    existing proofs are consistent by machine check, not by reading."""
    from round_tpu_torch.verify.tr import StateSig
    from round_tpu_torch.verify.formula import Bool

    sig = StateSig({"x": Int, "decided": Bool, "dec": Int})
    i = Variable("i", procType)
    v = Variable("v", Int)

    dec_guards = [g.threshold for g in automaton.thresholds()
                  if g.threshold and "support" in "".join(
                      g.threshold.counts) and _is_quorum(g.threshold)]
    if not dec_guards:
        raise ValueError("otr automaton lost its support-threshold guard")
    thr = dec_guards[0]

    # the value-support comprehension from the guard's count descriptor
    # (support over state field x) — same bound-var name as the hand
    # invariant's so comprehension templates line up
    def support_global(val):
        kk = Variable("invk", procType)
        return Comprehension([kk], Eq(sig.get("x", kk), val))

    gen_inv = Exists([v], And(
        threshold_applied(thr, [Card(support_global(v))]),
        ForAll([i], Implies(sig.get("decided", i),
                            Eq(sig.get("dec", i), v))),
    ))

    from round_tpu_torch.verify.protocols import otr_spec

    spec = otr_spec()
    hand_inv = spec.invariants[0]

    # the magic-round assumption: the quorum guard applied to |HO(j)|
    size_guards = [g.threshold for g in automaton.thresholds()
                   if g.threshold and g.threshold.counts == ("size",)]
    jq = Variable("j", procType)
    gen_magic = ForAll(
        [jq], threshold_applied(size_guards[0], [Card(ho_of(jq))])
    ) if size_guards else None

    vcs = [
        ParamVC(
            name="cross-check: generated support invariant ⊨ hand "
                 "invariant (protocols.otr_spec inv)",
            hyp=gen_inv, concl=hand_inv, config=c21,
            origin="decision guard → chain_inv0's proven invariant",
        ),
        ParamVC(
            name="cross-check: hand invariant ⊨ generated support "
                 "invariant",
            hyp=hand_inv, concl=gen_inv, config=c21,
            origin="chain_inv0's proven invariant → decision guard",
        ),
    ]
    if gen_magic is not None:
        hand_magic = spec.liveness[0]
        vcs += [
            ParamVC(
                name="cross-check: generated HO threshold ⊨ hand magic "
                     "round",
                hyp=gen_magic, concl=hand_magic, config=c11,
                origin="quorum guard → otr_spec liveness",
            ),
            ParamVC(
                name="cross-check: hand magic round ⊨ generated HO "
                     "threshold",
                hyp=hand_magic, concl=gen_magic, config=c11,
                origin="otr_spec liveness → quorum guard",
            ),
        ]
    return vcs


def _lv_cross_vcs(automaton) -> List[ParamVC]:
    """LastVoting: the extracted guards must agree with the HAND-WRITTEN
    protocols.lv_spec formulas — the conclusions below are taken from (or
    mirror, independently of the fit) the fixed-spec proof objects, so a
    mis-fitted threshold FAILS here rather than trivially re-proving
    itself:

      * ack: extracted-guard(heard ∧ stamped) must entail the LITERAL
        stamp-majority consequent of F[3] (the re-anchor backing the
        staged chains consume) — pulled out of lv_spec's stage formula,
        not rebuilt from the fit.  A too-weak fit (e.g. > n/3) leaves
        2·|stamped| > n unprovable.
      * collect: the extracted size guard must be EQUIVALENT (both
        entailment directions) to the majority form over the hand r1
        mailbox comprehension, where the majority bound 2·card > n is
        written out verbatim (LvExample's majority), never via the
        extracted threshold — pinning the fit to exactly > n/2."""
    from round_tpu_torch.verify.futils import get_conjuncts
    from round_tpu_torch.verify.protocols import lv_spec

    spec, lv = lv_spec()
    sig = spec.sig
    r = lv["phase"]
    coord = lv["coord"]
    j0 = Variable("j0", procType)

    ack = [g.threshold for g in automaton.thresholds()
           if g.threshold and any("ts" in c for c in g.threshold.counts)]
    collect = [g.threshold for g in automaton.thresholds()
               if g.threshold and g.threshold.counts == ("size",)
               and g.threshold.a > 0]
    if not ack or not collect:
        raise ValueError("lv automaton lost its majority guards")

    # the HAND stamp-majority: the consequent of F[3]'s second conjunct
    # (Implies(∃ ready, majority(|stamped|)), protocols.lv_spec)
    f3_conjuncts = get_conjuncts(lv["stages"][3])
    stamp_majority = f3_conjuncts[1].args[1]

    # extracted ack count: heard senders stamped with the current phase
    kk = Variable("lvs", procType)
    heard_stamped = Comprehension(
        [kk], And(In(kk, ho_of(j0)), Eq(sig.get("ts", kk), r)))
    vcs = [
        ParamVC(
            name="cross-check: extracted ack majority ⊨ the hand stamp "
                 "majority (F[3]'s re-anchor backing)",
            hyp=threshold_applied(ack[0], [Card(heard_stamped)]),
            concl=stamp_majority,
            config=c21,
            origin="ack guard → lv_spec F[3] (literal formula)",
        ),
    ]

    # extracted collect count (plain heard-set size) vs the hand r1
    # mailbox {i | i ∈ HO(j0) ∧ dest(i, j0)} with dest = (j0 = coord),
    # under the hypothesis that j0 IS the coordinator.  The hand side's
    # majority bound is written out (2·card > n), NOT threshold_applied:
    # both directions together force the fit to be exactly the majority.
    mb = Comprehension(
        [kk], And(In(kk, ho_of(j0)), Eq(j0, coord)))
    gen = threshold_applied(collect[0], [Card(ho_of(j0))])
    hand = Gt(Times(2, Card(mb)), N)
    at_coord = Eq(j0, coord)
    vcs += [
        ParamVC(
            name="cross-check: extracted collect majority ⟹ hand "
                 "mailbox majority at the coordinator",
            hyp=And(at_coord, gen), concl=hand, config=c21,
            origin="collect guard → lv_spec round-1 TR",
        ),
        ParamVC(
            name="cross-check: hand mailbox majority ⟹ extracted "
                 "collect majority",
            hyp=And(at_coord, hand), concl=gen, config=c21,
            origin="lv_spec round-1 TR → collect guard",
        ),
    ]
    return vcs


# ---------------------------------------------------------------------------
# Suites
# ---------------------------------------------------------------------------

#: protocol → (registry model name, cross-check generator)
PARAM_SUITES: Dict[str, Tuple[str, Optional[Callable]]] = {
    "param-otr": ("otr", _otr_cross_vcs),
    "param-lv": ("lastvoting", _lv_cross_vcs),
}


def build_param_suite(suite: str, device=None):
    """(automaton, vcs) for a named parameterized suite, the automaton
    traced on ``device`` (round_tpu/verify/param.py::build_param_suite)."""
    from round_tpu_torch.analysis.threshold import extract_automaton

    model, cross = PARAM_SUITES[suite]
    automaton = extract_automaton(model, device=device)
    vcs = generate_param_vcs(automaton)
    if cross is not None:
        vcs += cross(automaton)
    return automaton, vcs


def run_param_suite(suite: str, verbose: bool = False,
                    quiet: bool = False,
                    device=None) -> Tuple[bool, List[ParamResult]]:
    """Extract (on ``device``) + discharge one parameterized suite.
    Mirrors verifier_cli.run_lemma_suite's budget discipline (per-VC
    budgets honor ROUND_TPU_VC_TIMEOUT_SCALE via solve_param_vc)."""
    results: List[ParamResult] = []
    t0 = time.monotonic()
    try:
        automaton, vcs = build_param_suite(suite, device)
    except Exception as e:  # noqa: BLE001 — extraction failure is a verdict
        results.append(ParamResult(
            name="threshold-automaton extraction", ok=False,
            seconds=time.monotonic() - t0,
            error=f"{type(e).__name__}: {str(e).splitlines()[0][:300]}",
        ))
        return False, results
    results.append(ParamResult(
        name=f"threshold-automaton extraction "
             f"({len(automaton.rules)} rules, "
             f"{len(automaton.thresholds())} thresholds, "
             f"{automaton.resilience[1] if automaton.resilience else '-'})",
        ok=True, seconds=time.monotonic() - t0,
    ))
    if not quiet:
        print(f"Parameterized suite: {suite} "
              f"({len(vcs)} VCs, {automaton.resilience[1]})")
        if verbose:
            print(automaton.render())

    ok = True
    for vc in vcs:
        r = solve_param_vc(vc)
        results.append(r)
        ok &= r.ok
        if not quiet or not r.ok:
            mark = "✓" if r.ok else "✗"
            print(f"  {mark} {r.name} ({r.seconds:.2f}s)"
                  + (f" [{r.error}]" if r.error else ""))
    return ok, results


def solve_param_vc(vc: ParamVC) -> ParamResult:
    """Discharge ONE generated VC (solver or structural) — the unit the
    federated task dispatch schedules."""
    import os

    scale = 1.0
    try:
        scale = float(os.environ.get("ROUND_TPU_VC_TIMEOUT_SCALE", "1"))
    except ValueError:
        pass
    t0 = time.monotonic()
    err = ""
    if vc.check is not None:
        good = bool(vc.check())
    else:
        try:
            good = entailment(
                vc.hyp, vc.concl, vc.config,
                timeout_s=vc.timeout_s * scale,
                total_timeout_s=vc.timeout_s * scale,
            )
        except Exception as e:  # noqa: BLE001
            good, err = False, f"{type(e).__name__}: {e}"
    return ParamResult(name=vc.name, ok=good,
                       seconds=time.monotonic() - t0,
                       origin=vc.origin, error=err)
