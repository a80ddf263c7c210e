"""Proof-licensed reconfiguration: membership ops gated on all-n proofs.

Port of round_tpu/rv/license.py.  The registry, its verdicts, the
envelope arithmetic, the memo and the default prover (the port's
``apps/verifier_cli``, its suite table verify/param.py::PARAM_SUITES) are
round_tpu's; the registry takes ``device=``, where the default prover
traces the suites' threshold automata (the card unless the caller names
one).

The verifier leaves the parameterized proofs (verify/param.py: threshold automata
extracted from the live round traces, all-n VCs discharged through the
solver stack, VC-hash result cache) sitting NEXT to the runtime.  This
module closes them into the ViewManager loop: before a membership op is
proposed (and when one decided elsewhere is adopted), the manager asks
this registry whether resizing the group to the op's n is LICENSED —
i.e. whether the serving protocol carries an all-n safety proof and the
new size still admits a nonzero fault budget under the protocol's
declared ``fault_envelope`` (``n > K·f``).

Verdict vocabulary (License.status):
  licensed          — an all-n parameterized suite covers the model, the
                      proof is PROVED (cache-warm re-verify ~2 s for a
                      suite, sub-ms on a cache hit), and the target n
                      admits f >= 1 under the envelope.
  outside-envelope  — the model HAS an all-n proof but the target n
                      does not tolerate a single fault under its
                      envelope (e.g. OTR at n=3 under n > 3f).
  unlicensed        — the model carries only fixed-n proofs (or none):
                      no parameterized suite is registered for it, or
                      the suite did not verify.

ViewManager (runtime/view.py) maps non-licensed verdicts to REFUSED (the
op is not proposed) or, under the --view-unlicensed-ok escape hatch, to
DEGRADED (the op proceeds, flagged in obs + the replica summary).  See
docs/MEMBERSHIP.md "proof-licensed resizing".
"""

from __future__ import annotations

import dataclasses
import functools
import re
import time as _time
from typing import Callable, Dict, Optional

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime.log import get_logger

log = get_logger("rv.license")

_C_CHECKS = METRICS.counter("license.checks")
_C_GRANTED = METRICS.counter("license.granted")
_C_DENIED = METRICS.counter("license.denied")

# serving-tier algorithm names -> parameterized-proof model names
# (verify/param.py PARAM_SUITES keys are suite names; values name the
# registry model).  LastVotingBytes licenses against the proved
# lastvoting automaton: the byte variant INHERITS the four rounds
# unchanged (models/lastvoting.py LastVotingBytes — the value is opaque
# to every quorum/timestamp test the automaton abstracts, so the
# extracted transition structure is the same object; only the int-domain
# trace Spec does not apply, which licensing never consults).  Variants
# that RESTRUCTURE the phases (slv/mlv) are deliberately absent: their
# resizes stay unlicensed until they carry their own extraction.
MODEL_ALIASES: Dict[str, str] = {
    "otr": "otr",
    "lv": "lastvoting",
    "lastvoting": "lastvoting",
    "lvb": "lastvoting",
    "lastvoting-bytes": "lastvoting",
    "lastvotingbytes": "lastvoting",
}


@dataclasses.dataclass(frozen=True)
class License:
    """One resize verdict: ``ok`` is True only for status 'licensed'."""

    status: str                 # licensed | outside-envelope | unlicensed
    reason: str
    model: Optional[str] = None
    suite: Optional[str] = None
    envelope: Optional[str] = None
    f_max: int = 0
    cached: Optional[bool] = None
    seconds: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "licensed"

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def parse_envelope(envelope: str) -> int:
    """The K of a declared ``n > K·f`` resilience envelope
    (core/algorithm.py Algorithm.fault_envelope)."""
    m = re.fullmatch(r"\s*n\s*>\s*(\d+)\s*\*?\s*f\s*", envelope or "")
    if not m:
        raise ValueError(f"unparseable fault envelope {envelope!r} "
                         "(expected 'n > Kf')")
    return int(m.group(1))


def _default_prover(suite: str, cache_dir: Optional[str], solve: bool,
                    device=None):
    """(proved, cached): discharge (or cache-look-up) one parameterized
    suite through the verifier_cli registry, its automaton traced on
    ``device`` (round_tpu/rv/license.py::_default_prover) — the same
    VC-hash cache the CLI uses, so a nightly ``verifier_cli --all
    --cache`` run makes every runtime license check a warm hit."""
    from round_tpu_torch.apps import verifier_cli as vcli

    if not solve:
        # cache-only: never stall a live view move on a cold solver run
        if not cache_dir:
            return False, None
        _digest, hit = vcli._cache_lookup(cache_dir, suite, device)
        if hit is None:
            return False, False
        return bool(hit.get("ok")), True
    rec = vcli.run_suite_cached(suite, cache_dir=cache_dir, device=device)
    return bool(rec.get("ok")), bool(rec.get("cached"))


class ProofLicenseRegistry:
    """The runtime face of the parameterized-proof registry.

    ``prover(suite, cache_dir, solve) -> (proved, cached)`` is
    injectable (tests swap in a scripted verdict; deployments keep the
    default verifier_cli path).  Only PROVED verdicts are memoized per
    (model, solve) — a proof does not decay within a process, so a view
    change never re-pays even the warm re-verify; a negative (or
    crashed) verdict is re-asked next time, since a transient solver
    timeout or a not-yet-populated nightly cache must not refuse every
    later op for the process lifetime (the same sticky-NOT-PROVED bug
    class the verifier_cli cache fixed)."""

    def __init__(self, cache_dir: Optional[str] = None,
                 solve: bool = True,
                 prover: Optional[Callable] = None,
                 device=None):
        self.cache_dir = cache_dir
        self.solve = solve
        self.prover = prover or functools.partial(_default_prover,
                                                  device=device)
        self._proved: Dict = {}

    def _suite_for(self, model: str) -> Optional[str]:
        from round_tpu_torch.verify.param import PARAM_SUITES

        for suite, (m, _cross) in PARAM_SUITES.items():
            if m == model:
                return suite
        return None

    def check(self, algo_name: str, new_n: int,
              solve: Optional[bool] = None) -> License:
        """License verdict for resizing ``algo_name``'s serving group to
        ``new_n`` members.  ``solve`` overrides the registry default
        (ViewManager passes solve=False on the ADOPT path: an op decided
        elsewhere is already committed — the check may flag, never
        stall)."""
        t0 = _time.monotonic()
        _C_CHECKS.inc()
        solve = self.solve if solve is None else solve
        model = MODEL_ALIASES.get((algo_name or "").lower())
        if model is None:
            _C_DENIED.inc()
            return License(
                status="unlicensed", model=algo_name,
                reason=f"{algo_name!r} carries no parameterized proof "
                       "(fixed-n verification only)",
                seconds=_time.monotonic() - t0)
        suite = self._suite_for(model)
        if suite is None:
            _C_DENIED.inc()
            return License(
                status="unlicensed", model=model,
                reason=f"no parameterized suite registered for {model}",
                seconds=_time.monotonic() - t0)
        from round_tpu_torch.apps.selector import select

        envelope = getattr(select(algo_name), "fault_envelope", None)
        try:
            k = parse_envelope(envelope)
        except ValueError as e:
            _C_DENIED.inc()
            return License(status="unlicensed", model=model, suite=suite,
                           reason=str(e),
                           seconds=_time.monotonic() - t0)
        f_max = max(0, (new_n - 1) // k)
        if f_max < 1:
            _C_DENIED.inc()
            return License(
                status="outside-envelope", model=model, suite=suite,
                envelope=envelope, f_max=f_max,
                reason=f"n={new_n} admits no fault under {envelope} "
                       f"(needs n >= {k + 1})",
                seconds=_time.monotonic() - t0)
        memo = self._proved.get((model, solve))
        if memo is None:
            try:
                memo = self.prover(suite, self.cache_dir, solve)
            except Exception as e:  # noqa: BLE001 — a prover crash is a
                # denial with a reason, never a view-manager crash
                log.warning("license prover failed for %s: %s", suite, e)
                memo = (False, None)
            if memo[0]:
                # PROVED verdicts only — a negative is re-asked, never
                # latched (class docstring)
                self._proved[(model, solve)] = memo
        proved, cached = memo
        if not proved:
            _C_DENIED.inc()
            return License(
                status="unlicensed", model=model, suite=suite,
                envelope=envelope, f_max=f_max, cached=cached,
                reason=(f"suite {suite} not PROVED"
                        + ("" if solve else
                           " in the cache (adopt-path check is "
                           "cache-only; run verifier_cli --cache)")),
                seconds=_time.monotonic() - t0)
        _C_GRANTED.inc()
        return License(
            status="licensed", model=model, suite=suite,
            envelope=envelope, f_max=f_max, cached=cached,
            reason=f"all-n proof {suite} PROVED; n={new_n} tolerates "
                   f"f <= {f_max} under {envelope}",
            seconds=_time.monotonic() - t0)
