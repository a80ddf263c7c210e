"""The Verifier: generates and discharges a protocol's verification
conditions.

Reference parity: psync.verification.Verifier
(verification/Verifier.scala:234-276 generateVCs; :170-181 inductiveness;
:144-157 progress; :183-229 properties; :279-367 report).  The VC classes are
the same four:

  1. initial state ⇒ invariant 0,
  2. every invariant is inductive across every round (inv ∧ TR ⇒ inv′),
  3. progress: under the round's liveness predicate (the "magic round" HO
     assumption), invariant i advances to invariant i+1,
  4. invariants ⇒ stated safety properties.

A ProtocolSpec mirrors the Specs trait (Specs.scala:8-41): invariants,
properties, safetyPredicate (communication assumption conjoined to every
TR, mkTR Verifier.scala:159-168), livenessPredicate per phase.

Port of round_tpu/verify/verifier.py, copied with only the package name changed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from round_tpu_torch.verify.cl import ClConfig, ClDefault
from round_tpu_torch.verify.formula import (
    And, Exists, ForAll, Formula, Implies, TRUE, Variable,
)
from round_tpu_torch.verify.futils import free_vars
from round_tpu_torch.verify.tr import RoundTR, StateSig
from round_tpu_torch.verify.vc import VC, CompositeVC, SingleVC

Stage = Tuple[str, Formula, Formula, Optional[ClConfig]]


@dataclasses.dataclass
class StagedChain:
    """A staged decomposition of one VC whose COMPOSITION is machine-checked.

    The chain proves  H ⊨ G  (H = the VC's hypothesis ∧ transition,
    G = its conclusion) by natural deduction:

      * `intros`: ∃-eliminations from H — each (vars, P, cfg) asserts
        H ⊨ ∃vars. P and names the witnesses as free constants carrying P.
      * `stages`: each (name, h_i, c_i, cfg) is an entailment h_i ⊨ c_i,
        valid for every valuation of its free variables.  Variables free in
        a stage but nowhere earlier are that stage's UNIVERSALS: since they
        are fresh (checked syntactically), the stage's conclusion may be
        ∀-generalized over them for later stages (∀-intro).

    The verifier discharges, per chain:
      1. each intro VC          H ∧ P_{<k} [∧ A] ⊨ ∃vars. P      (reducer)
      2. each stage VC          h_i [∧ A] ⊨ c_i                  (reducer)
      3. each justification VC  H ∧ P* ∧ ∀-closed c_{<i} [∧ A] ⊨ h_i
      4. the final VC           H ∧ P* ∧ ∀-closed c_* ⊨ G        (reducer)
      5. freshness side conditions: witnesses/universals are fresh where
         introduced and witnesses do not occur in H or G (syntactic;
         violation raises at VC-generation time)

    Together these ARE the composition argument — nothing is left
    author-supplied.  `just_configs` / `final_config` tune the reducer for
    the bookkeeping VCs (they default to the spec config).

    ASSUMPTION SCOPING (`assumes`, implication introduction): an entry
    under key "intro:<k>" or a stage name scopes that step under an
    assumption A — the natural-deduction shape for case analysis (∨-elim
    across stages) and for witnesses that exist only conditionally:

      * scoped intro: the VC proves  context ∧ A ⊨ ∃vars. P  and the fact
        entering the context is  A → P(w)  (conditional skolemization —
        sound classically on the nonempty process domain:
        A → ∃x.P  ⊨  ∃x.(A → P), name x as the fresh w).
      * scoped stage: the stage VC proves  h_i ∧ A ⊨ c_i; its
        justification VCs may use A (context ∧ A ⊨ each conjunct of h_i);
        the closed fact entering later context is  ∀u.(A → c_i).
        Soundness: context ∧ A ⊨ h_i and h_i ∧ A ⊨ c_i give
        context ⊨ A → c_i; u are fresh, so ∀-intro applies.

    The final VC sees only the conditional closed facts, so an ∨-elim
    (e.g. H's noDecision-vs-anchored disjunction against the two cases'
    A → c facts) is itself machine-checked there."""

    stages: List[Stage]
    intros: List[Tuple[List[Variable], Formula, Optional[ClConfig]]] = \
        dataclasses.field(default_factory=list)
    just_configs: Dict[str, ClConfig] = dataclasses.field(default_factory=dict)
    final_config: Optional[ClConfig] = None
    assumes: Dict[str, Formula] = dataclasses.field(default_factory=dict)
    # hypothesis pruning for the bookkeeping VCs: key = "intro:<k>",
    # "justify:<stage name>" or "final"; value = the EXACT conjuncts of the
    # available context to keep.  Pruning is hypothesis WEAKENING (sound);
    # membership of every listed formula in the actual context is verified
    # structurally at VC-generation time, so an author cannot smuggle in a
    # fact the chain does not have.
    prune: Dict[str, List[Formula]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ProtocolSpec:
    """What the user states about a protocol (Specs.scala:8-41).

    `staged` maps a generated VC's name to a protocol-supplied
    ∃-elimination chain — a list of (stage name, hypothesis, conclusion,
    ClConfig-or-None).  When present, the verifier discharges the chain
    (a CompositeVC, all-of) in place of the monolithic VC: the reference's
    VC.decompose (VC.scala:76-96) generalized to author-chosen stages,
    exactly the discipline of the hand-translated logic suites
    (LvExample.scala et al.) where monolithic inductiveness "completely
    blows up".  Soundness is the author's composition argument — each
    stage's hypothesis must be a skolemized piece of the original VC or a
    ∀-generalized earlier conclusion — stated in the spec's code."""

    sig: StateSig
    rounds: List[RoundTR]
    init: Formula                      # initial-state relation (over fields)
    invariants: List[Formula]          # invariants[k] holds from phase k on
    # (name, formula[, ClConfig-or-None[, from_inv]]): from_inv picks the
    # ONE ladder rung the property proves from; REQUIRED when the spec has
    # more than one invariant (the later rungs only hold after magic
    # rounds, so the all-rungs conjunction is not a sound default there)
    properties: List[Tuple] = dataclasses.field(default_factory=list)
    safety_predicate: Formula = TRUE   # communication assumption, every round
    liveness: List[Formula] = dataclasses.field(default_factory=list)
    config: Optional[ClConfig] = None
    # a plain stage list = legacy author-supplied composition (caveat in the
    # report); a StagedChain = machine-checked composition (no caveat)
    staged: Dict[str, Union[List[Stage], StagedChain]] = \
        dataclasses.field(default_factory=dict)
    # the reference's roundInvariants mechanism (Specs.scala:20-24,
    # LastVoting.scala:49-61): a protocol whose invariant is NOT preserved
    # round-by-round supplies one VC per round boundary — (name, hyp, tr,
    # concl) with hyp = safety core ∧ the round-position facts F_k and
    # concl = their primed form at the next boundary (the last round wraps
    # the phase).  When non-empty this REPLACES the per-invariant
    # inductiveness generation; `staged` chains attach by name as usual.
    # The cyclic composition over the round sequence is the roundInvariants
    # semantics itself (as in the reference's Verifier).
    round_staged_inductiveness: List[Tuple[str, Formula, Formula, Formula]] = \
        dataclasses.field(default_factory=list)
    # in round-staged mode: the first boundary's round-position facts F_0,
    # checked as init ⊨ F_0 SEPARATELY from the invariant — F_k facts hold
    # only at their boundary, so they must NOT strengthen the property
    # hypothesis (properties must hold at every reachable state, which the
    # safety-core invariant alone covers)
    round_staged_init: Optional[Formula] = None
    # the multi-round liveness walk (the reference's checkProgress over the
    # roundInvariants second elements, Verifier.scala:144-157 +
    # LastVoting.scala:49-61): entries (name, hyp, tr, concl) chain through
    # ONE phase under the liveness environment — hyp_{k+1} is concl_k's
    # unprimed form, every hyp conjoins the phase's liveness predicate, and
    # concl is primed by the author.  Soundness of the walk's composition
    # is induction over the phase's round sequence: if the liveness env
    # holds for all rounds of one phase, chaining the VCs yields the final
    # conclusion at phase end.  Protocols whose single-round TRs can't
    # realize progress (LastVoting: deciding takes the whole 4-round
    # phase) use this instead of the invariants-ladder `liveness` path.
    phase_progress: List[Tuple[str, Formula, Formula, Formula]] = \
        dataclasses.field(default_factory=list)


class Verifier:
    def __init__(self, spec: ProtocolSpec, config: ClConfig = ClDefault):
        self.spec = spec
        self.config = spec.config or config

    # -- VC generation (Verifier.scala:234-276) -----------------------------

    def generate_vcs(self) -> List[VC]:
        spec = self.spec
        sig = spec.sig
        vcs: List[VC] = []
        self._staged_unused = set(spec.staged)

        if spec.invariants:
            from round_tpu_torch.verify.futils import get_conjuncts

            # per-conjunct decomposition (sound AND complete for ∧): the
            # conjuncts of an invariant have different proof characters,
            # and a combined negated conclusion multiplies venn branches
            inv0_parts = get_conjuncts(spec.invariants[0])
            if len(inv0_parts) == 1:
                vcs.append(SingleVC(
                    "initial state implies invariant 0",
                    spec.init, TRUE, spec.invariants[0],
                ))
            else:
                vcs.append(CompositeVC(
                    "initial state implies invariant 0", True,
                    [SingleVC(
                        f"init => invariant conjunct {ci}",
                        spec.init, TRUE, part,
                    ) for ci, part in enumerate(inv0_parts)],
                ))

        if spec.round_staged_inductiveness:
            if spec.round_staged_init is not None:
                vcs.append(SingleVC(
                    "initial state establishes round-stage F0",
                    spec.init, TRUE, spec.round_staged_init,
                ))
            children = []
            for name, hyp, tr, concl in spec.round_staged_inductiveness:
                if name in spec.staged:
                    children.append(
                        self._staged_vc(name, And(hyp, tr), concl)
                    )
                    continue
                # round-staged VCs are the protocol's hardest obligations
                # (the reference ignores them outright): give them the
                # budget the decomposition matrices were validated with
                children.append(SingleVC(name, hyp, tr, concl,
                                         timeout_s=420.0))
            vcs.append(CompositeVC(
                "round-staged induction (roundInvariants)", True, children,
            ))
        else:
            for inv_idx, inv in enumerate(spec.invariants):
                children = []
                for r_idx, rnd in enumerate(spec.rounds):
                    name = f"invariant {inv_idx} inductive at round {r_idx}"
                    tr = And(spec.safety_predicate, rnd.full_tr())
                    if name in spec.staged:
                        children.append(
                            self._staged_vc(name, And(inv, tr), sig.prime(inv))
                        )
                        continue
                    children.append(SingleVC(
                        name, inv, tr, sig.prime(inv),
                    ))
                vcs.append(CompositeVC(
                    f"invariant {inv_idx} is inductive", True, children,
                ))

        # progress: inv_k ∧ liveness_k ∧ TR ⇒ inv_{k+1}′ (magic rounds,
        # Verifier.scala:144-157) — one VC per consecutive invariant pair,
        # any round of the phase may realize it
        for k in range(len(spec.invariants) - 1):
            live = spec.liveness[k] if k < len(spec.liveness) else TRUE
            children = []
            for r_idx, rnd in enumerate(spec.rounds):
                name = f"progress {k}→{k + 1} via round {r_idx}"
                hyp = And(spec.invariants[k], live)
                tr = And(spec.safety_predicate, rnd.full_tr())
                concl = sig.prime(spec.invariants[k + 1])
                if name in spec.staged:
                    children.append(
                        self._staged_vc(name, And(hyp, tr), concl)
                    )
                else:
                    children.append(SingleVC(name, hyp, tr, concl))
            if children:
                vcs.append(CompositeVC(
                    f"progress {k}→{k + 1}", False, children,
                ))

        # the phase-walk liveness ladder (see ProtocolSpec.phase_progress)
        if spec.phase_progress:
            children = []
            for name, hyp, tr, concl in spec.phase_progress:
                tr = And(spec.safety_predicate, tr)
                if name in spec.staged:
                    children.append(
                        self._staged_vc(name, And(hyp, tr), concl)
                    )
                else:
                    children.append(SingleVC(name, hyp, tr, concl,
                                             timeout_s=420.0))
            vcs.append(CompositeVC(
                "progress (phase liveness walk)", True, children,
            ))

        for prop in spec.properties:
            name, formula = prop[0], prop[1]
            pcfg = prop[2] if len(prop) > 2 else None
            # optional 4th element: the index of the ONE invariant this
            # property is proved from (the phase-indexed ladder semantics —
            # invariants[k] holds from phase k on, so e.g. termination
            # proves from the final rung while agreement must prove from
            # the always-inductive rung 0 alone, not from the conjunction
            # of rungs that only hold after magic rounds)
            from_inv = prop[3] if len(prop) > 3 else None
            if from_inv is None:
                if len(spec.invariants) > 1:
                    # rungs past 0 hold only after magic rounds — proving
                    # a property from their conjunction would let a
                    # formula false at reachable pre-magic states verify
                    raise ValueError(
                        f"property {name!r}: a phase-ladder spec "
                        f"({len(spec.invariants)} invariants) requires an "
                        "explicit from_inv (4th tuple element)"
                    )
                hyp = And(*spec.invariants) if spec.invariants else TRUE
            else:
                if not (0 <= from_inv < len(spec.invariants)):
                    raise ValueError(
                        f"property {name!r}: from_inv={from_inv} out of "
                        f"range for {len(spec.invariants)} invariants"
                    )
                hyp = spec.invariants[from_inv]
            vcs.append(SingleVC(
                f"property: {name}", hyp, TRUE, formula, config=pcfg,
            ))
        if self._staged_unused:
            # an unconsumed staged key means a renamed/shifted VC would
            # silently fall back to the monolithic form the chain exists
            # to avoid — refuse instead.  List the MATCHABLE names (the
            # per-round inductiveness children), not the composite heads.
            if spec.round_staged_inductiveness:
                matchable = [
                    name for name, *_rest in spec.round_staged_inductiveness
                ]
            else:
                matchable = [
                    f"invariant {k} inductive at round {r}"
                    for k in range(len(spec.invariants))
                    for r in range(len(spec.rounds))
                ]
            matchable += [
                f"progress {k}→{k + 1} via round {r}"
                for k in range(len(spec.invariants) - 1)
                for r in range(len(spec.rounds))
            ] + [name for name, *_rest in spec.phase_progress]
            raise ValueError(
                "staged chains matched no generated VC: "
                f"{sorted(self._staged_unused)} (matchable: {matchable})"
            )
        return vcs

    def _staged_vc(self, name: str, H: Formula, G: Formula) -> VC:
        chain = self.spec.staged[name]
        self._staged_unused.discard(name)
        if not isinstance(chain, StagedChain):
            # legacy: stage list only, composition author-supplied
            children = [
                SingleVC(sname, hyp, TRUE, concl, config=cfg,
                         timeout_s=420.0)
                for sname, hyp, concl, cfg in chain
            ]
            return CompositeVC(f"{name} [staged ∃-elim]", True, children)
        return self._composed_vc(name, chain, H, G)

    def _composed_vc(self, name: str, chain: StagedChain,
                     H: Formula, G: Formula) -> VC:
        """Build the machine-checked chain (see StagedChain): intro VCs,
        stage VCs, justification VCs, the final VC — plus the syntactic
        freshness side conditions, which raise on violation (a spec bug,
        not a proof failure)."""
        from round_tpu_torch.verify.futils import get_conjuncts

        known = {f"intro:{i}" for i in range(len(chain.intros))} | {
            s[0] for s in chain.stages
        }
        bad = set(chain.assumes) - known
        if bad:
            # a typo'd key would silently leave a step unscoped (and its
            # case VC unsound to compose) — refuse instead
            raise ValueError(
                f"staged chain {name!r}: assumes keys match no intro/stage: "
                f"{sorted(bad)}"
            )

        base_fv = free_vars(H) | free_vars(G)
        h_conjuncts = get_conjuncts(H)
        children: List[VC] = []

        def pruned_hyp(key: str, context: List[Formula],
                       assume: Optional[Formula] = None) -> Formula:
            """The VC's hypothesis: the full context, or — when the chain
            prunes this key — the listed conjuncts, each verified to BE a
            conjunct of the context (weakening only).  A scoped step's
            assumption is conjoined on top (and its conjuncts are legal
            prune targets)."""
            if key not in chain.prune:
                base = And(*context)
            else:
                universe = []
                for c in context:
                    universe.extend(get_conjuncts(c))
                if assume is not None:
                    universe.extend(get_conjuncts(assume))
                keep = chain.prune[key]
                for f in keep:
                    if not any(f == c for c in universe):
                        raise ValueError(
                            f"staged chain {name!r}, {key}: pruned hypothesis "
                            f"lists a formula that is NOT a conjunct of the "
                            f"available context: {f!r}"
                        )
                base = And(*keep)
            return base if assume is None else And(base, assume)

        witnesses: List[Variable] = []
        intro_facts: List[Formula] = []
        intro_seen = set(base_fv)
        for idx, (vars_, P, cfg) in enumerate(chain.intros):
            A = chain.assumes.get(f"intro:{idx}")
            # fresh against the VC AND every earlier intro: reusing an
            # earlier witness would conjoin facts about two different
            # existential witnesses under one constant (unsound)
            clash = set(vars_) & intro_seen
            if A is not None:
                clash |= set(vars_) & free_vars(A)
            if clash:
                raise ValueError(
                    f"staged chain {name!r}: witness(es) {sorted(str(v) for v in clash)} "
                    "occur free in the VC, an earlier intro, or this "
                    "intro's assumption — not fresh"
                )
            intro_seen |= set(vars_) | free_vars(P)
            if A is not None:
                intro_seen |= free_vars(A)
            # later intros may consume earlier intro facts (iterated
            # skolemization is conservative)
            children.append(SingleVC(
                f"intro ∃{','.join(v.name for v in vars_)}",
                pruned_hyp(f"intro:{idx}", h_conjuncts + intro_facts, A),
                TRUE, Exists(list(vars_), P), config=cfg,
            ))
            witnesses += list(vars_)
            intro_facts.append(P if A is None else Implies(A, P))

        seen = set(base_fv) | set(witnesses)
        for fact in intro_facts:
            seen |= free_vars(fact)
        closed_concls: List[Formula] = []
        for sname, hyp, concl, cfg in chain.stages:
            A = chain.assumes.get(sname)
            # this stage's fresh universals: free in the stage, unseen
            # anywhere earlier — ∀-intro over them is sound by freshness
            stage_fv = free_vars(hyp) | free_vars(concl)
            if A is not None:
                stage_fv |= free_vars(A)
            univ = sorted(stage_fv - seen, key=lambda v: v.name)
            context = h_conjuncts + intro_facts + closed_concls
            # justify each conjunct of the stage hypothesis separately
            # (sound: ⋀ goals ⇔ the conjunction) — the conjuncts have
            # different proof characters (a pure axiom instantiation wants
            # venn_bound 0; a majority fact wants the card machinery), and
            # per-conjunct prune/config keys ("justify:<name>#<k>") keep
            # each tiny.  A scoped stage's justifications run under its
            # assumption (context ∧ A ⊨ h-conjunct — see class docstring).
            h_parts = get_conjuncts(hyp)
            for ci, part in enumerate(h_parts):
                key = f"justify:{sname}#{ci}"
                base = f"justify:{sname}"
                pkey = key if key in chain.prune else base
                jcfg = chain.just_configs.get(
                    key, chain.just_configs.get(base, cfg))
                jhyp = pruned_hyp(pkey, context, A)
                if any(part == c for c in get_conjuncts(jhyp)):
                    # ∧-elimination: the goal is VERBATIM a conjunct of the
                    # (membership-checked) hypothesis — discharged
                    # syntactically, no solver call.  Not just a speedup:
                    # the reducer's bounded instantiation can FAIL to
                    # re-prove X from X ∧ act when extra card atoms poison
                    # trigger selection (observed on the LV chains).
                    continue
                label = (f"justify: {sname} [{ci + 1}/{len(h_parts)}]"
                         if len(h_parts) > 1 else f"justify: {sname}")
                children.append(SingleVC(
                    label,
                    jhyp,
                    TRUE, part, config=jcfg,
                ))
            # stage VCs carry the protocol's hardest obligations — same
            # budget the legacy staged path gave them
            children.append(SingleVC(
                sname, hyp if A is None else And(hyp, A), TRUE, concl,
                config=cfg, timeout_s=420.0,
            ))
            closed = concl if A is None else Implies(A, concl)
            closed_concls.append(
                ForAll(univ, closed) if univ else closed
            )
            seen |= set(univ)
        # the final VC, split per conjunct of G (sound AND complete for ∧,
        # as the justification split): conjuncts that are verbatim closed
        # facts discharge by ∧-elimination; typically only the ∨-elim
        # piece (the invariant's case disjunction) needs the solver
        fhyp = pruned_hyp("final", h_conjuncts + intro_facts + closed_concls)
        fparts = get_conjuncts(fhyp)
        g_parts = get_conjuncts(G)
        for gi, gpart in enumerate(g_parts):
            if any(gpart == c for c in fparts):
                continue
            label = ("composition: chain entails the goal"
                     if len(g_parts) == 1 else
                     f"composition: goal conjunct {gi + 1}/{len(g_parts)}")
            children.append(SingleVC(
                label, fhyp, TRUE, gpart,
                config=chain.final_config, timeout_s=420.0,
            ))
        return CompositeVC(
            f"{name} [staged, composition machine-checked]", True, children,
        )

    @property
    def used_staged(self) -> bool:
        """True when any discharged VC went through a LEGACY staged chain
        (plain stage list) whose composition argument is author-supplied —
        the verdict then carries the 'modulo staged composition' caveat.
        StagedChain chains machine-check their composition and carry no
        caveat."""
        return hasattr(self, "vcs") and any(
            not isinstance(c, StagedChain) for c in self.spec.staged.values()
        )

    # -- checking + report (Verifier.scala:279-367) -------------------------

    def check(self) -> bool:
        self.vcs = self.generate_vcs()
        ok = True
        for vc in self.vcs:
            ok = vc.solve(self.config) and ok
        return ok

    def report(self) -> str:
        lines = ["Verification report", "==================="]
        for vc in getattr(self, "vcs", []):
            lines.append(vc.report())
        if self.used_staged:
            lines.append(
                "note: staged ∃-elim chains are author-supplied "
                "decompositions; each stage is machine-checked, the "
                "composition argument is stated in the protocol spec"
            )
        if self.spec.round_staged_inductiveness and hasattr(self, "vcs"):
            lines.append(
                "note: round-staged induction — the per-round VCs follow "
                "the roundInvariants semantics (Specs.scala:20-24): F_k "
                "holds before round k+1, cyclically with the phase bump; "
                "free anchor witnesses are universally quantified per VC"
            )
        if self.spec.phase_progress and hasattr(self, "vcs"):
            lines.append(
                "note: phase liveness walk — each VC's hypothesis is the "
                "previous VC's conclusion unprimed, under the good-phase "
                "environment; their chaining over one phase's round "
                "sequence is the checkProgress composition "
                "(Verifier.scala:144-157)"
            )
        return "\n".join(lines)

    def html_report(self) -> str:
        """Minimal HTML report (the reference emits one via dzufferey.report,
        Verifier.scala:342-367)."""
        import html as _html

        rows = []
        for vc in getattr(self, "vcs", []):
            for line in vc.report().splitlines():
                ok = line.lstrip().startswith("✓")
                color = "#2a2" if ok else "#c33"
                rows.append(
                    f'<div style="color:{color};font-family:monospace">'
                    f"{_html.escape(line)}</div>"
                )
        if self.used_staged:
            rows.append(
                '<div style="color:#777;font-style:italic">note: staged '
                "∃-elim chains are author-supplied decompositions; each "
                "stage is machine-checked, the composition argument is "
                "stated in the protocol spec</div>"
            )
        return (
            "<html><head><title>Verification report</title></head><body>"
            + "\n".join(rows)
            + "</body></html>"
        )
