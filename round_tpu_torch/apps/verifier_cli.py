"""Verifier CLI: check protocol specs and emit reports.

Port of round_tpu/apps/verifier_cli.py.  The suites that trace round code
(the extracted-TR lemma suites and the parameterized suites, whose
threshold automata come from traces) trace on ``--device`` (``device=``;
the card by default, raising where there is none); the spec suites trace
nothing.  A suite's cache key hashes its printed VC formulas as
round_tpu's does, and equals round_tpu's key for every suite.

Reference parity: example/Verifier.scala:22-37 — a CLI that runs the
verifier on example.OTR / LastVoting and writes report.html — grown a
FEDERATED DISPATCH seam (the "Federated Formal Verification" pattern,
PAPERS.md): the proof workload is a matrix of independent suites (spec
suites, extracted-TR lemma suites, parameterized threshold-automaton
suites), and ``--all`` schedules them over a process pool.

Usage:  python -m round_tpu_torch.apps.verifier_cli tpc [-r report.html] [-v]
        python -m round_tpu_torch.apps.verifier_cli --all
        python -m round_tpu_torch.apps.verifier_cli --all --jobs 2 --json out.json
        python -m round_tpu_torch.apps.verifier_cli --suites param-otr,param-lv
        python -m round_tpu_torch.apps.verifier_cli --all --device cpu

``--all`` sweeps every registered suite, one line per protocol, exiting
nonzero if any is NOT PROVED.  ``--jobs N`` federates the suites'
VC-tree tasks over N worker processes (``--jobs 1`` is the deterministic
sequential baseline; verdicts are identical at any job count — only
wall-clock changes; see the stage-level federation note below for the
measured ceiling on this box).  ``--json`` writes the machine-readable
per-suite/per-stage timing + verdict report.  ``--cache DIR`` keys each
suite's verdict by a hash of its generated VC formulas: an unchanged
suite is a cache hit and is not re-proved (the LV anchored-case history
— 398 s → 13 s — is why this seam pays).

Per-VC wall budgets are tuned to an idle box; on a loaded one set
ROUND_TPU_VC_TIMEOUT_SCALE (e.g. 2) to scale every budget uniformly
instead of getting spurious timeouts reported as failures.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import re
import sys
import time

from round_tpu_torch.verify.verifier import Verifier


def _spec_registry():
    from round_tpu_torch.verify import protocols

    return {
        "tpc": protocols.tpc_spec,
        "otr": protocols.otr_spec,
        "lv": protocols.lv_verifier_spec,
        "erb": protocols.erb_spec,
    }


def spec_by_name(name: str):
    registry = _spec_registry()
    if name not in registry:
        valid = list(registry) + list(_LEMMA_SUITES) + list(_PARAM_SUITES)
        raise SystemExit(
            f"unknown protocol {name!r} (expected {'|'.join(valid)})"
        )
    return registry[name]()


_LEMMA_SUITES = {
    # extracted-TR lemma suites (no upstream analogue: the reference has
    # no logic suite for any of these protocols)
    "floodmin": ("round_tpu_torch.verify.protocols",
                 "floodmin_extracted_lemmas"),
    "kset": ("round_tpu_torch.verify.protocols", "kset_extracted_lemmas"),
    "benor": ("round_tpu_torch.verify.protocols", "benor_extracted_lemmas"),
    # the view-change selection safety skeleton (the reference ships only
    # an unwired sketch, example/byzantine/pbft/ViewChange.scala)
    "pbft": ("round_tpu_torch.verify.protocols", "pbft_vc_extracted_lemmas"),
}

#: parameterized threshold-automaton suites (verify/param.py): safety for
#: ALL n under the declared resilience condition, cross-checked against
#: the fixed-spec proofs above
_PARAM_SUITES = ("param-otr", "param-lv")

#: dispatch order of --all (spec suites, then lemma suites, then the
#: parameterized suites)
ALL_SUITES = ("tpc", "otr", "lv", "erb",
              "floodmin", "kset", "benor", "pbft") + _PARAM_SUITES


def run_lemma_suite(name: str, verbose: bool, quiet: bool = False,
                    device=None):
    """Discharge an extracted-TR lemma suite (TRs extracted from the
    executable round code; see each protocols.*_extracted_lemmas
    docstring).  Returns (ok, stages) where stages is one
    {name, ok, seconds} row per lemma — a NOT PROVED names the failing
    lemma instead of burying it (the summary/JSON consume this).
    Budgets honor ROUND_TPU_VC_TIMEOUT_SCALE like every other verifier
    path, and each lemma's 600 s is a TOTAL budget (a failing lemma
    cannot burn it once per decomposed sub-VC).  The TRs are extracted
    on ``device``."""
    import importlib

    from round_tpu_torch.verify.cl import entailment

    budget = 600.0
    try:
        budget *= float(os.environ.get("ROUND_TPU_VC_TIMEOUT_SCALE", "1"))
    except ValueError:
        pass
    mod, fn = _LEMMA_SUITES[name]
    lemmas, _meta = getattr(importlib.import_module(mod), fn)(device=device)
    ok = True
    stages = []
    if not quiet:
        print(f"Extracted-TR lemma suite: {name}")
    for lname, hyp, concl, cfg in lemmas:
        if verbose:
            print(f"  … {lname}: {cfg}")
        t0 = time.monotonic()
        err = ""
        try:
            good = entailment(hyp, concl, cfg, timeout_s=budget,
                              total_timeout_s=budget)
        except Exception as e:  # noqa: BLE001 — a crash is a stage verdict
            good, err = False, f"{type(e).__name__}: {e}"
        dt = time.monotonic() - t0
        stages.append({"name": lname, "ok": good,
                       "seconds": round(dt, 3),
                       **({"error": err[:300]} if err else {})})
        ok &= good
        mark = "✓" if good else "✗"
        if not quiet or not good:
            print(f"  {mark} {lname} ({dt:.2f}s)"
                  + (f" [{err[:200]}]" if err else ""))
    return ok, stages


def _vc_stage_rows(vc, out):
    """Flatten a (possibly composite) VC into {name, ok, seconds} rows."""
    from round_tpu_torch.verify.vc import CompositeVC, SingleVC

    if isinstance(vc, SingleVC):
        out.append({
            "name": vc.name,
            "ok": bool(vc.status),
            "seconds": round(vc.solve_time_s or 0.0, 3),
        })
    elif isinstance(vc, CompositeVC):
        for c in vc.children:
            if getattr(c, "status", None) is None and \
                    getattr(c, "solve_time_s", 1) is None:
                continue  # short-circuited: never attempted
            _vc_stage_rows(c, out)
    return out


def run_suite(name: str, verbose: bool = False, device=None) -> dict:
    """Run ONE suite (spec / lemma / parameterized; traces on ``device``)
    and return the structured record the dispatcher, JSON report and cache
    share: {name, kind, ok, seconds, stages, note?, error?}."""
    t0 = time.monotonic()
    rec = {"name": name, "ok": False, "stages": []}
    try:
        if name in _PARAM_SUITES:
            from round_tpu_torch.verify.param import run_param_suite

            rec["kind"] = "param"
            ok, results = run_param_suite(name, verbose, quiet=not verbose,
                                          device=device)
            rec["ok"] = ok
            rec["stages"] = [
                {"name": r.name, "ok": r.ok, "seconds": round(r.seconds, 3),
                 **({"origin": r.origin} if r.origin else {}),
                 **({"error": r.error[:300]} if r.error else {})}
                for r in results
            ]
        elif name in _LEMMA_SUITES:
            rec["kind"] = "lemmas"
            ok, stages = run_lemma_suite(name, verbose, quiet=not verbose,
                                         device=device)
            rec["ok"] = ok
            rec["stages"] = stages
        else:
            rec["kind"] = "spec"
            ver = Verifier(_spec_registry()[name]())
            rec["ok"] = ver.check()
            rec["stages"] = _vc_stage_rows_all(ver)
            if rec["ok"] and ver.used_staged:
                rec["note"] = "staged"
            if verbose and not rec["ok"]:
                print(ver.report())
    except Exception as e:  # noqa: BLE001 — one crash must not hide the rest
        rec["error"] = f"{type(e).__name__}: {e}".strip()[:500]
    rec["seconds"] = round(time.monotonic() - t0, 3)
    return rec


def _vc_stage_rows_all(ver) -> list:
    rows = []
    for vc in getattr(ver, "vcs", []):
        _vc_stage_rows(vc, rows)
    return rows


# ---------------------------------------------------------------------------
# VC hashing + result cache
# ---------------------------------------------------------------------------

_ID_SUFFIX = re.compile(r"!\d+")


def _canon_ids(texts):
    """Canonicalize id-derived symbol suffixes ACROSS one VC's printed
    parts: each distinct ``!<digits>`` suffix becomes ``!<first-occurrence
    index>``.  Stable across processes (same structure → same sequence of
    distinct suffixes) WITHOUT conflating distinct symbols — a blanket
    ``!#`` rewrite would hash 'k!3 … k!3' and 'k!3 … k!7' identically,
    letting an edited suite false-hit the cache."""
    seen: dict = {}

    def sub(m):
        tok = m.group(0)
        if tok not in seen:
            seen[tok] = len(seen)
        return f"!{seen[tok]}"

    return [_ID_SUFFIX.sub(sub, t) for t in texts]


def suite_vc_hash(name: str, device=None) -> str:
    """A stable digest of the suite's GENERATED VC formulas (no solving).
    Symbol suffixes derived from object ids (snd!x!1234, mbi!88) are
    canonicalized per VC — they vary per process, the formulas do not.
    Every suite's key equals round_tpu's (the extracted-TR lemma suites'
    too: their counter-made suffixes differ, their first-occurrence order
    does not), so one warm cache serves both packages."""
    from round_tpu_torch.verify.printer import pretty

    parts = [name]

    def add(label, *formulas):
        parts.append(label)
        parts.extend(_canon_ids(
            [pretty(f) for f in formulas if f is not None]))

    built = _built_suite(name, device)
    if built[0] == "param":
        _kind, automaton, vcs = built
        parts.append(json.dumps(automaton.to_dict(), sort_keys=True))
        for vc in vcs:
            if vc.check is None:
                add(vc.name + repr(vc.config), vc.hyp, vc.concl)
            else:
                parts.append(vc.name)
    elif built[0] == "lemmas":
        for lname, hyp, concl, cfg in built[1]:
            add(lname + repr(cfg), hyp, concl)
    else:
        for vc in built[2]:
            _hash_vc(vc, add)
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()


def _hash_vc(vc, add):
    from round_tpu_torch.verify.vc import CompositeVC, SingleVC

    if isinstance(vc, SingleVC):
        add(vc.name + repr(vc.config), vc.hypothesis, vc.transition,
            vc.conclusion)
    elif isinstance(vc, CompositeVC):
        for c in vc.children:
            _hash_vc(c, add)


def _cache_path(cache_dir: str, name: str, digest: str) -> str:
    return os.path.join(cache_dir, f"{name}-{digest[:16]}.json")


def _cache_lookup(cache_dir: str, name: str, device=None):
    """(digest, cached-record-or-None).  A hash failure degrades to an
    uncached run (digest None), never to a failed proof."""
    try:
        digest = suite_vc_hash(name, device)
    except Exception as e:  # noqa: BLE001
        print(f"note: VC-hash cache unavailable for {name}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return None, None
    path = _cache_path(cache_dir, name, digest)
    if os.path.exists(path):
        try:
            with open(path) as fh:
                rec = json.load(fh)
            rec["cached"] = True
            rec["vc_hash"] = digest
            return digest, rec
        except (OSError, ValueError) as e:
            print(f"note: unreadable cache entry for {name}: {e}",
                  file=sys.stderr)
    return digest, None


def _cache_store(cache_dir: str, name: str, digest: str, rec: dict):
    """Persist a suite record — PROVED verdicts only.  A NOT PROVED may
    be a transient solver timeout on a loaded box (the docstring's
    ROUND_TPU_VC_TIMEOUT_SCALE caveat); caching it would make the
    spurious failure sticky until the formulas change."""
    if not rec.get("ok") or rec.get("error"):
        return
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = _cache_path(cache_dir, name, digest) + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(rec, fh)
        os.replace(tmp, _cache_path(cache_dir, name, digest))
    except OSError as e:
        print(f"note: could not write cache for {name}: {e}",
              file=sys.stderr)


def run_suite_cached(name: str, verbose: bool = False,
                     cache_dir: str | None = None, device=None) -> dict:
    """run_suite with the VC-hash result cache around it."""
    digest = None
    if cache_dir:
        digest, hit = _cache_lookup(cache_dir, name, device)
        if hit is not None:
            return hit
    rec = run_suite(name, verbose, device)
    rec["cached"] = False
    if cache_dir and digest is not None:
        rec["vc_hash"] = digest
        _cache_store(cache_dir, name, digest, rec)
    return rec


# ---------------------------------------------------------------------------
# Stage-level task federation
#
# Suite-level parallelism is the wrong grain: lv's 303 s is 64% of the
# whole matrix, so co-scheduling anything next to it only inflates the
# critical path (measured: --jobs 2 at suite grain was SLOWER than
# sequential, 571 s vs 473 s).  The federated unit is therefore one
# VC-tree node: all-of composites split into their children recursively
# (sound — their verdict is the conjunction), while any-of composites
# stay atomic (their short-circuit IS the semantics).  lv's 148 s
# phase-bump VC and benor's 141 s vote-exclusivity lemma then overlap
# each other instead of serializing.
#
# HONEST CEILING, measured on the 2-vCPU dev box: two co-running solver
# processes aggregate to ≈1.0× a single one (the reducer's card/venn
# working set thrashes the shared LLC: one otr suite is 19 s alone,
# 41 s each when paired even pinned to separate vCPUs), so --jobs 2 is
# wall-NEUTRAL here at any granularity (full sweep 486 s federated vs
# 473 s sequential, verdicts identical).  On hardware with real per-core
# caches the same schedule parallelizes; on this box the multiplier is
# the VC-hash cache (an unchanged matrix re-verifies in seconds), and
# the dispatch seam is what makes both safe: verdicts never depend on
# job count.
# ---------------------------------------------------------------------------

#: measured-cost hints (idle seconds) for makespan scheduling: the pool
#: is FIFO, so submitting longest-first puts the two dominant tasks on
#: both workers immediately.  Hints are matched by (suite, task-label
#: prefix); unknown tasks default to 1 — order is all that matters.
_TASK_COST = (
    ("lv", "stage 3 -> 0 via round 4", 150.0),
    ("benor", "vote-exclusivity", 140.0),
    ("lv", "fa2", 40.0),
    ("lv", "maxTS bridge", 27.0),
    ("lv", "anchored case (re-anchor)", 19.0),
    ("lv", "ready' majority", 15.0),
    ("lv", "vi no-majority complement", 15.0),
    ("lv", "stage 1 -> 2 via round 2", 11.0),
    ("otr", "invariant", 8.0),
    ("otr", "progress", 8.0),
)


def _task_cost(suite: str, label: str) -> float:
    for s, prefix, cost in _TASK_COST:
        if s == suite and label.startswith(prefix):
            return cost
    return 1.0


def _built_suite(name: str, device=None):
    """The suite's solvable pieces, built deterministically — the SAME
    construction in the parent (task enumeration + hashing) and in every
    worker (per-task solving), traced on ``device``.  Memoized per
    process."""
    return _built_suite_cached(
        name, None if device is None else str(device))


@functools.lru_cache(maxsize=32)
def _built_suite_cached(name: str, device):
    if name in _PARAM_SUITES:
        from round_tpu_torch.verify.param import build_param_suite

        automaton, vcs = build_param_suite(name, device)
        return ("param", automaton, vcs)
    if name in _LEMMA_SUITES:
        import importlib

        mod, fn = _LEMMA_SUITES[name]
        lemmas, _meta = getattr(importlib.import_module(mod), fn)(
            device=device)
        return ("lemmas", lemmas)
    ver = Verifier(_spec_registry()[name]())
    ver.vcs = ver.generate_vcs()  # used_staged reads it (cosmetic note)
    return ("spec", ver, ver.vcs)


def _enumerate_tasks(name: str, device=None):
    """[(path, label)] for one suite, in deterministic report order."""
    from round_tpu_torch.verify.vc import CompositeVC

    built = _built_suite(name, device)
    if built[0] == "param":
        return [((i,), vc.name) for i, vc in enumerate(built[2])]
    if built[0] == "lemmas":
        return [((i,), lemma[0]) for i, lemma in enumerate(built[1])]

    tasks = []

    def walk(node, path):
        if isinstance(node, CompositeVC) and node.all_of \
                and len(node.children) > 1:
            for j, child in enumerate(node.children):
                walk(child, path + (j,))
        else:
            tasks.append((path, node.name))

    for i, vc in enumerate(built[2]):
        walk(vc, (i,))
    return tasks


def _solve_task(name: str, path, device=None) -> dict:
    """Solve ONE federated task in this process.  Returns
    {ok, stages, seconds}."""
    t0 = time.monotonic()
    built = _built_suite(name, device)
    if built[0] == "param":
        from round_tpu_torch.verify.param import solve_param_vc

        r = solve_param_vc(built[2][path[0]])
        stages = [{"name": r.name, "ok": r.ok,
                   "seconds": round(r.seconds, 3),
                   **({"origin": r.origin} if r.origin else {}),
                   **({"error": r.error[:300]} if r.error else {})}]
        return {"ok": r.ok, "stages": stages,
                "seconds": round(time.monotonic() - t0, 3)}
    if built[0] == "lemmas":
        from round_tpu_torch.verify.cl import entailment

        budget = 600.0
        try:
            budget *= float(os.environ.get("ROUND_TPU_VC_TIMEOUT_SCALE",
                                           "1"))
        except ValueError:
            pass
        lname, hyp, concl, cfg = built[1][path[0]]
        err = ""
        try:
            ok = entailment(hyp, concl, cfg, timeout_s=budget,
                            total_timeout_s=budget)
        except Exception as e:  # noqa: BLE001
            ok, err = False, f"{type(e).__name__}: {e}"
        dt = time.monotonic() - t0
        stages = [{"name": lname, "ok": ok, "seconds": round(dt, 3),
                   **({"error": err[:300]} if err else {})}]
        return {"ok": ok, "stages": stages, "seconds": round(dt, 3)}

    _kind, ver, vcs = built
    node = vcs[path[0]]
    for j in path[1:]:
        node = node.children[j]
    ok = node.solve(ver.config)
    rows = _vc_stage_rows(node, [])
    return {"ok": bool(ok), "stages": rows,
            "seconds": round(time.monotonic() - t0, 3)}


def _pool_task_entry(args):
    """Top-level pool worker: (suite, path, device) -> task record.
    Workers re-import under spawn and rebuild the suite on ``device``;
    _built_suite memoizes the rebuild per worker."""
    name, path, device = args
    import contextlib
    import io

    buf = io.StringIO()
    rec = {"suite": name, "path": list(path)}
    try:
        with contextlib.redirect_stdout(buf):
            rec.update(_solve_task(name, path, device))
    except Exception as e:  # noqa: BLE001 — a task crash is a verdict
        rec.update(ok=False, stages=[], seconds=0.0,
                   error=f"{type(e).__name__}: {e}"[:300])
    rec["output"] = buf.getvalue()
    return rec


def _first_failure(rec: dict) -> str:
    """The actionable part of a NOT PROVED: the failing stage's name (and
    error), not a truncated exception."""
    if rec.get("error"):
        return rec["error"][:200]
    for st in rec.get("stages", []):
        if not st.get("ok"):
            msg = f"✗ {st['name']}"
            if st.get("error"):
                msg += f": {st['error'][:120]}"
            return msg
    return ""


def _run_federated(names, jobs: int, verbose: bool,
                   cache_dir: str | None,
                   suite_timeout: float | None, device=None) -> list:
    """Dispatch the suites' VC-tree tasks over a process pool (see the
    stage-level federation note above).  The parent builds every suite
    once (formula construction only — no solving) to enumerate tasks and
    compute cache hashes; workers rebuild deterministically and solve
    one node per task.  Records come back in suite order with stage rows
    in enumeration order, so the report is independent of completion
    order — verdicts are identical to --jobs 1 (each SingleVC solve is
    deterministic; splitting an all-of composite only removes its
    short-circuit, never changes its conjunction)."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    records = []
    pending: list = []   # (suite, path, label)
    suite_meta: dict = {}
    for name in names:
        digest = None
        if cache_dir:
            digest, hit = _cache_lookup(cache_dir, name, device)
            if hit is not None:
                suite_meta[name] = {"cached_rec": hit}
                continue
        try:
            tasks = _enumerate_tasks(name, device)
        except Exception as e:  # noqa: BLE001
            suite_meta[name] = {"cached_rec": {
                "name": name, "ok": False, "stages": [], "seconds": 0.0,
                "cached": False,
                "error": f"{type(e).__name__}: {e}".strip()[:500]}}
            continue
        suite_meta[name] = {"digest": digest, "tasks": tasks}
        pending += [(name, path_, label) for path_, label in tasks]

    task_results: dict = {}
    if pending:
        ctx = mp.get_context("spawn")
        order = sorted(pending, key=lambda t: -_task_cost(t[0], t[2]))
        # the per-suite wall budget is a shared DEADLINE over the suite's
        # tasks (not a fresh allowance per task); a blown deadline marks
        # the remaining tasks failed.  It cannot kill a running solver —
        # the executor has no preemption — so the per-VC budgets stay the
        # real backstop; this bound exists so one wedged suite reports
        # instead of silently stretching the sweep.
        t_pool = time.monotonic()
        with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
            futures = {(name, path_): pool.submit(
                _pool_task_entry, (name, path_, device))
                for name, path_, _label in order}
            for key, fut in futures.items():
                left = None
                if suite_timeout is not None:
                    left = max(0.0,
                               suite_timeout - (time.monotonic() - t_pool))
                try:
                    task_results[key] = fut.result(timeout=left)
                except Exception as e:  # noqa: BLE001 — incl. timeout
                    fut.cancel()
                    task_results[key] = {
                        "ok": False, "stages": [], "seconds": 0.0,
                        "error": f"dispatch: {type(e).__name__}: {e}"[:300]}

    for name in names:
        meta = suite_meta[name]
        if "cached_rec" in meta:
            records.append(meta["cached_rec"])
            continue
        ok, seconds, stages, errors = True, 0.0, [], []
        for path_, _label in meta["tasks"]:
            tr = task_results[(name, path_)]
            ok &= bool(tr["ok"])
            seconds += tr.get("seconds", 0.0)
            stages += tr.get("stages", [])
            if tr.get("error"):
                errors.append(tr["error"])
            out = tr.get("output", "")
            if verbose and out:
                print(out, end="")
        kind = ("param" if name in _PARAM_SUITES
                else "lemmas" if name in _LEMMA_SUITES else "spec")
        rec = {"name": name, "kind": kind, "ok": ok,
               "seconds": round(seconds, 3), "stages": stages,
               "cached": False}
        if kind == "spec":
            built = _built_suite(name, device)
            if ok and built[1].used_staged:
                rec["note"] = "staged"
        if errors:
            rec["error"] = "; ".join(errors)[:500]
        if meta.get("digest"):
            rec["vc_hash"] = meta["digest"]
            _cache_store(cache_dir, name, meta["digest"], rec)
        records.append(rec)
    return records


def run_all(verbose: bool, jobs: int = 1, json_out: str | None = None,
            cache_dir: str | None = None, suites=None,
            suite_timeout: float | None = None, device=None) -> bool:
    """The CI sweep: every suite (or the --suites subset), one summary
    line per protocol, optionally over a process pool, tracing on
    ``device``.  Returns True iff everything PROVED."""
    names = list(suites) if suites else list(ALL_SUITES)
    t_start = time.monotonic()
    records = []

    if jobs <= 1:
        for name in names:
            records.append(run_suite_cached(name, verbose, cache_dir,
                                            device))
    else:
        records = _run_federated(names, jobs, verbose, cache_dir,
                                 suite_timeout, device)

    all_ok = all(r["ok"] for r in records)
    for rec in records:
        verdict = "VERIFIED" if rec["ok"] else "NOT PROVED"
        note = ""
        if rec.get("note"):
            note += f" ({rec['note']})"
        if rec.get("cached"):
            note += " (cached)"
        if not rec["ok"]:
            fail = _first_failure(rec)
            if fail:
                note += f" ({fail})"
        print(f"{rec['name']:10s} {verdict:10s} "
              f"({rec.get('seconds', 0.0):6.2f}s){note}")
    wall = time.monotonic() - t_start
    hits = sum(1 for r in records if r.get("cached"))
    print(f"total {wall:.2f}s, jobs={jobs}"
          + (f", cache {hits}/{len(records)} hits" if cache_dir else ""))
    print("ALL VERIFIED" if all_ok else "SWEEP FAILED: see NOT PROVED lines")

    if json_out:
        doc = {
            "all_ok": all_ok,
            "jobs": jobs,
            "wall_seconds": round(wall, 3),
            "cache": {"dir": cache_dir, "hits": hits,
                      "misses": len(records) - hits} if cache_dir else None,
            "suites": records,
        }
        with open(json_out, "w") as fh:
            json.dump(doc, fh, indent=2)
        print(f"report written to {json_out}")
    return all_ok


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("protocol", nargs="?", default=None,
                    help="tpc | otr | lv | erb | floodmin | kset | benor | "
                         "pbft | param-otr | param-lv")
    ap.add_argument("--all", action="store_true", dest="all_protocols",
                    help="sweep every registered suite; one line per "
                         "protocol, nonzero exit if any NOT PROVED")
    ap.add_argument("--suites", default=None,
                    help="comma-separated subset to sweep (implies the "
                         "--all machinery): e.g. --suites param-otr,param-lv")
    ap.add_argument("--jobs", type=int, default=1, metavar="N",
                    help="dispatch suites over N worker processes "
                         "(default 1 = the deterministic sequential "
                         "baseline; verdicts are identical at any N)")
    ap.add_argument("--json", default=None, dest="json_out", metavar="OUT",
                    help="write the machine-readable per-suite/per-stage "
                         "report to OUT")
    ap.add_argument("--cache", default=None, dest="cache_dir", metavar="DIR",
                    help="cache suite verdicts keyed by VC-formula hash "
                         "in DIR (an unchanged suite is not re-proved)")
    ap.add_argument("--suite-timeout", type=float, default=None,
                    metavar="S",
                    help="--jobs>1 only: a shared wall DEADLINE over the "
                         "sweep's dispatched tasks — tasks still pending "
                         "past it are marked failed (it cannot preempt a "
                         "running solver; the per-VC budgets remain the "
                         "real backstop).  Default: none.  NOTE: a blown "
                         "deadline can fail a suite --jobs 1 would prove, "
                         "so CI that asserts verdict-identity across job "
                         "counts must not set it")
    ap.add_argument("--device", default="cuda",
                    help="device the lemma and parameterized suites trace "
                         "round code on (default: the card; cpu for a "
                         "machine without one)")
    ap.add_argument("-r", "--report", default=None,
                    help="write an HTML report to this path")
    ap.add_argument("-v", "--verbose", action="store_true")
    ns = ap.parse_args(sys.argv[1:] if argv is None else argv)

    if ns.all_protocols or ns.suites:
        if ns.protocol:
            ap.error("--all/--suites take no protocol argument")
        if ns.report:
            print("note: -r/--report is not supported with --all; "
                  f"ignoring {ns.report}", file=sys.stderr)
        suites = None
        if ns.suites:
            suites = [s.strip() for s in ns.suites.split(",") if s.strip()]
            unknown = [s for s in suites if s not in ALL_SUITES]
            if unknown:
                ap.error(f"unknown suite(s) {unknown}; "
                         f"registered: {', '.join(ALL_SUITES)}")
        return run_all(ns.verbose, jobs=ns.jobs, json_out=ns.json_out,
                       cache_dir=ns.cache_dir, suites=suites,
                       suite_timeout=ns.suite_timeout, device=ns.device)
    if not ns.protocol:
        ap.error("name a protocol, or pass --all")

    if ns.protocol in _PARAM_SUITES:
        from round_tpu_torch.verify.param import run_param_suite

        ok, _results = run_param_suite(ns.protocol, ns.verbose,
                                       device=ns.device)
        print("VERIFIED" if ok else "NOT PROVED")
        return ok

    if ns.protocol in _LEMMA_SUITES:
        if ns.report:
            print(f"note: -r/--report is not supported for lemma suites; "
                  f"ignoring {ns.report}", file=sys.stderr)
        ok, _stages = run_lemma_suite(ns.protocol, ns.verbose,
                                      device=ns.device)
        print("VERIFIED" if ok else "NOT PROVED")
        return ok

    ver = Verifier(spec_by_name(ns.protocol))
    ok = ver.check()
    print(ver.report())
    if ns.report:
        with open(ns.report, "w") as fh:
            fh.write(ver.html_report())
        print(f"report written to {ns.report}")
    verdict = "VERIFIED" if ok else "NOT PROVED"
    if ok and ver.used_staged:
        verdict = "VERIFIED (modulo staged composition, see report note)"
    print(verdict)
    return ok


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
