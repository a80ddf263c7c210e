"""Schedule artifacts: a TPU/CPU-sim finding as a portable, replayable file.

The artifact is a small JSON document naming exactly the (round, dst, src)
link events a minimized schedule drops, the VALUE events a byzantine
sender forges (schema v2, round_tpu/byz), the proposals, and the
RECORDED outcome on both worlds:

  {
    "kind": "round_tpu.fuzz.schedule", "version": 2,
    "protocol": "otr", "n": 4, "rounds": 12, "seed": 0,
    "values": [0, 1, 2, 3],
    "drops": [[r, dst, src], ...],          # off-diagonal, deliver=False
    "value_subs": [[r, dst, src, v], ...],  # v2: claimed-value forgeries
    "stale_subs": [[r, dst, src], ...],     # v2: stale-round replays
    "expected": {
      "engine": {"decided": [...], "decision": [...],
                 "decided_round": [...]},
      "host":   {"decided": [...], "decision": [...], "rounds": [...]}
    },
    "meta": {...}                            # provenance (free-form)
  }

Version 1 artifacts (drops only) load unchanged; an artifact is written
as v1 unless it carries value events, so the regression bank stays
byte-compatible with older readers.

Replay surfaces:
  * engine — `scenarios.from_schedule` through the SAME batched evaluator
    the search used (bit-exact by construction);
  * host   — `runtime.chaos.FaultyTransport` in explicit-schedule mode
    over real sockets: in-process thread clusters (replay_host_threads,
    the fast regression form) or true multi-process clusters of
    apps/host_replica subprocesses (run_schedule_cluster).

Rounds past the schedule clamp to the LAST row on every surface (the
`from_schedule` convention), so a short artifact pins a steady-state tail.

Port of round_tpu/fuzz/replay.py.  The artifact bytes are round_tpu's
(same kind string, version rule, key order and indentation), so an
artifact written by either package loads in the other.  Every replay
surface takes ``device=``: the engine replay runs the port's batched
evaluator on it, and the host replays run their replicas on it (the
card unless the caller passes another).  There is no warm-up cluster:
the port's round functions have no compile step, and a thread replay's
replicas build theirs before the first round's deadline starts.
"""

from __future__ import annotations

import functools as _functools
import json
import os
import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from round_tpu_torch.obs.metrics import METRICS

ARTIFACT_KIND = "round_tpu.fuzz.schedule"
ARTIFACT_VERSION = 2


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def make_artifact(*, protocol: str, schedule: np.ndarray,
                  values: np.ndarray, seed: int = 0,
                  value_plan: Optional[np.ndarray] = None,
                  engine_outcome: Optional[Dict[str, Any]] = None,
                  host_outcome: Optional[Dict[str, Any]] = None,
                  meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    from round_tpu_torch.byz.adversary import VP_STALE, plan_is_trivial

    schedule = np.asarray(schedule, dtype=bool)
    T, n, n2 = schedule.shape
    if n != n2:
        raise ValueError(f"schedule must be [T, n, n], got {schedule.shape}")
    eye = np.eye(n, dtype=bool)
    if not schedule[:, eye].all():
        raise ValueError("self-delivery must be True in every round "
                         "(the engines' HO convention)")
    drops = np.argwhere(~schedule & ~eye[None, :, :])
    has_values = value_plan is not None and not plan_is_trivial(value_plan)
    art: Dict[str, Any] = {
        "kind": ARTIFACT_KIND,
        # v1 unless the artifact actually carries value events: the
        # drop-only bank keeps its wire format
        "version": ARTIFACT_VERSION if has_values else 1,
        "protocol": protocol,
        "n": int(n),
        "rounds": int(T),
        "seed": int(seed),
        "values": [int(v) for v in np.asarray(values).reshape(-1)],
        "drops": [[int(r), int(d), int(s)] for r, d, s in drops],
        "expected": {},
    }
    if has_values:
        plan = np.asarray(value_plan, dtype=np.int32)
        if plan.shape != schedule.shape:
            raise ValueError(
                f"value plan {plan.shape} != schedule {schedule.shape}")
        if np.any(plan[:, eye] != -1):
            raise ValueError("value events must be off-diagonal "
                             "(a process cannot lie to itself)")
        subs = np.argwhere(plan >= 0)
        stale = np.argwhere(plan == VP_STALE)
        art["value_subs"] = [
            [int(r), int(d), int(s), int(plan[r, d, s])]
            for r, d, s in subs]
        art["stale_subs"] = [[int(r), int(d), int(s)]
                             for r, d, s in stale]
    if engine_outcome is not None:
        art["expected"]["engine"] = engine_outcome
    if host_outcome is not None:
        art["expected"]["host"] = host_outcome
    if meta:
        art["meta"] = meta
    return art


def dump_artifact(path: str, art: Dict[str, Any]) -> None:
    if art.get("kind") != ARTIFACT_KIND:
        raise ValueError(f"not a fuzz schedule artifact: {art.get('kind')!r}")
    # write-then-rename: several replicas of one cluster can dump the
    # SAME violation path concurrently (rv/dump.py names artifacts by
    # (protocol, inst, label), not by node) — a plain open(path, "w")
    # interleaves and a reader sees torn JSON; with replace() readers
    # only ever see one writer's complete document
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        json.dump(art, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    METRICS.counter("fuzz.exports").inc()


def load_artifact(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        art = json.load(fh)
    if art.get("kind") != ARTIFACT_KIND:
        raise ValueError(
            f"{path}: kind {art.get('kind')!r} != {ARTIFACT_KIND!r}")
    if int(art.get("version", -1)) > ARTIFACT_VERSION:
        raise ValueError(f"{path}: artifact version {art['version']} is "
                         f"newer than this tree ({ARTIFACT_VERSION})")
    n, T = int(art["n"]), int(art["rounds"])
    if len(art.get("values", [])) != n:
        raise ValueError(f"{path}: values must have n={n} entries")
    for r, d, s in art.get("drops", []):
        if not (0 <= r < T and 0 <= d < n and 0 <= s < n and d != s):
            raise ValueError(f"{path}: bad drop event {(r, d, s)}")
    for r, d, s, v in art.get("value_subs", []):
        if not (0 <= r < T and 0 <= d < n and 0 <= s < n and d != s
                and v >= 0):
            raise ValueError(f"{path}: bad value event {(r, d, s, v)}")
    for r, d, s in art.get("stale_subs", []):
        if not (0 <= r < T and 0 <= d < n and 0 <= s < n and d != s):
            raise ValueError(f"{path}: bad stale event {(r, d, s)}")
    return art


def schedule_from_artifact(art: Dict[str, Any]) -> np.ndarray:
    """[rounds, n, n] bool deliver schedule (deliver[r, dst, src])."""
    n, T = int(art["n"]), int(art["rounds"])
    sched = np.ones((T, n, n), dtype=bool)
    for r, d, s in art.get("drops", []):
        sched[r, d, s] = False
    return sched


def value_plan_from_artifact(art: Dict[str, Any]) -> Optional[np.ndarray]:
    """[rounds, n, n] int32 substitution plan (byz/adversary.py opcodes),
    or None for a drops-only (v1) artifact."""
    from round_tpu_torch.byz.adversary import VP_NONE, VP_STALE

    subs = art.get("value_subs", [])
    stale = art.get("stale_subs", [])
    if not subs and not stale:
        return None
    n, T = int(art["n"]), int(art["rounds"])
    plan = np.full((T, n, n), VP_NONE, dtype=np.int32)
    for r, d, s, v in subs:
        plan[r, d, s] = v
    for r, d, s in stale:
        plan[r, d, s] = VP_STALE
    return plan


def _outcome_json(decided, decision, rounds_key: str, rounds) -> Dict:
    """Normalize an outcome to the artifact form: decision is null where
    undecided (never state garbage)."""
    decided = [bool(x) for x in decided]
    return {
        "decided": decided,
        "decision": [int(v) if d else None
                     for d, v in zip(decided, decision)],
        rounds_key: [int(x) for x in rounds],
    }


# ---------------------------------------------------------------------------
# Engine replay
# ---------------------------------------------------------------------------


def _target_for(art: Dict[str, Any], seed: Optional[int] = None,
                device=None):
    from round_tpu_torch.fuzz.search import make_target

    return make_target(
        art["protocol"], n=int(art["n"]), horizon=int(art["rounds"]),
        seed=int(art["seed"] if seed is None else seed),
        values=np.asarray(art["values"], dtype=np.int32), device=device)


def replay_engine(art: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Run the artifact's schedule (and value plan, for v2) through the
    batched engine on ``device``; returns the outcome in artifact form
    (expected.engine's schema)."""
    target = _target_for(art, device=device)
    vplan = value_plan_from_artifact(art)
    out = target.evaluate_schedules(
        schedule_from_artifact(art)[None],
        None if vplan is None else vplan[None])
    METRICS.counter("fuzz.replays").inc()
    return _outcome_json(
        np.asarray(out["decided"][0]), np.asarray(out["decision"][0]),
        "decided_round", np.asarray(out["decided_round"][0]))


def check_engine(art: Dict[str, Any], device=None) -> tuple:
    """(ok, got): engine replay vs the recorded expected.engine outcome —
    EXACT equality; a banked artifact that stops reproducing is a
    regression."""
    got = replay_engine(art, device=device)
    want = art.get("expected", {}).get("engine")
    return (want is not None and got == want), got


# ---------------------------------------------------------------------------
# Host-wire replay
# ---------------------------------------------------------------------------


@_functools.lru_cache(maxsize=None)
def _shared_algo(protocol: str):
    """ONE Algorithm object per protocol for every in-process replay: the
    host round functions cache on the Round objects
    (HostRunner._round_fns), so sharing the instance shares them."""
    from round_tpu_torch.apps.selector import select

    return select(protocol)


def replay_host_threads(art: Dict[str, Any], *, timeout_ms: int = 250,
                        proto: str = "tcp", device=None) -> Dict[str, Any]:
    """Replay on REAL sockets in-process: n HostRunner threads, each
    behind a FaultyTransport carrying the artifact's explicit schedule.
    Returns the outcome in artifact form (expected.host's schema: per-
    replica decided / decision / rounds-to-exit).

    Every replica's socket is bound before any replica starts.  round_tpu
    binds inside each thread, and its replicas' first send waits for the
    round functions' jit compile, so every peer is bound by then; the
    port's first send goes out within milliseconds of a thread's start,
    and a peer still binding would lose that round-0 frame — a delivery
    the schedule does not drop, which changes the replayed outcome."""
    from round_tpu_torch.runtime.chaos import FaultPlan, FaultyTransport, alloc_ports
    from round_tpu_torch.runtime.host import HostRunner
    from round_tpu_torch.runtime.transport import HostTransport

    n = int(art["n"])
    schedule = schedule_from_artifact(art)
    vplan = value_plan_from_artifact(art)
    algo = _shared_algo(art["protocol"])
    ports = alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    results: Dict[int, Any] = {}
    errors: Dict[int, BaseException] = {}

    wires = [HostTransport(i, peers[i][1], proto=proto) for i in range(n)]

    def node(i):
        tr0 = wires[i]
        tr = FaultyTransport(tr0, FaultPlan(), n, schedule=schedule,
                             value_plan=vplan,
                             protocol=art["protocol"],
                             rounds_per_phase=algo.rounds_per_phase)
        try:
            runner = HostRunner(algo, i, peers, tr, timeout_ms=timeout_ms,
                                device=device)
            results[i] = runner.run(
                {"initial_value": np.int32(art["values"][i])},
                max_rounds=int(art["rounds"]))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors[i] = e
            raise
        finally:
            tr0.close()

    threads = [threading.Thread(target=node, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("schedule-replay replica thread wedged")
    if errors:
        raise RuntimeError(f"schedule-replay replica errors: {errors}")
    METRICS.counter("fuzz.replays").inc()
    decided = [bool(results[i].decided) for i in range(n)]
    decision = [int(np.asarray(results[i].decision).reshape(-1)[0])
                for i in range(n)]
    rounds = [int(results[i].rounds_run) for i in range(n)]
    return _outcome_json(decided, decision, "rounds", rounds)


def run_schedule_cluster(workdir: str, artifact_path: str, *,
                         timeout_ms: int = 250, proto: str = "tcp",
                         join_timeout: float = 150.0,
                         rv: Optional[str] = None,
                         rv_gossip=False,
                         algo_opts: Optional[Dict[str, Any]] = None,
                         device=None) -> Dict[str, Any]:
    """Replay on a REAL MULTI-PROCESS cluster: n apps/host_replica
    subprocesses, each wrapping its wire in the explicit-schedule
    FaultyTransport (--chaos-schedule; a v2 artifact's value-fault plan
    rides along automatically).  With ``rv``, each replica additionally
    runs the runtime-verification monitors at that policy (the artifact's
    proposal vector is the validity witness set) — the adversarial
    workout for round_tpu/rv: an equivocating peer must TRIP the
    agreement monitor, never crash the driver.  Returns the outcome in
    artifact form plus the raw per-replica summaries."""
    import subprocess

    from round_tpu_torch.runtime.chaos import alloc_ports, cluster_env
    from round_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    art = load_artifact(artifact_path)
    n = int(art["n"])
    os.makedirs(workdir, exist_ok=True)
    ports = alloc_ports(n)
    peer_arg = ",".join(f"127.0.0.1:{p}" for p in ports)
    env = cluster_env()

    def argv(i: int):
        a = [sys.executable, "-m", "round_tpu_torch.apps.host_replica",
             "--id", str(i), "--peers", peer_arg,
             "--algo", art["protocol"],
             "--value", str(int(art["values"][i])),
             "--timeout-ms", str(timeout_ms),
             "--max-rounds", str(int(art["rounds"])),
             "--proto", proto,
             "--chaos-schedule", artifact_path,
             "--device", str(dev)]
        for k, v in (algo_opts or {}).items():
            a += ["--algo-opt", f"{k}={v}"]
        if rv:
            a += ["--rv", rv,
                  "--rv-dir", os.path.join(workdir, f"rv-{i}")]
            # rv_gossip: True = every replica gossips decisions; a
            # collection of node ids scopes it (the byz workout keeps
            # the equivocation VICTIM silent so its early decision
            # cannot convert the honest camp before it decides)
            if rv_gossip is True or (rv_gossip and i in rv_gossip):
                a += ["--rv-gossip"]
        return a

    procs = [subprocess.Popen(argv(i), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for i in range(n)]
    outs = []
    try:
        for i, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=join_timeout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"replica {i} failed (rc={p.returncode}): "
                    f"{stderr[-2000:]}")
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                try:
                    p.communicate(timeout=10)
                except Exception:  # noqa: BLE001 - best-effort reap
                    pass
    METRICS.counter("fuzz.replays").inc()
    got = _outcome_json(
        [o["decided"] for o in outs],
        [o["decision"] if o["decision"] is not None else -1 for o in outs],
        "rounds", [o["rounds"] for o in outs])
    got_raw: Dict[str, Any] = dict(got)
    got_raw["summaries"] = outs
    return got_raw


def check_host(art: Dict[str, Any], *, threads: bool = True,
               workdir: Optional[str] = None, timeout_ms: int = 250,
               device=None) -> tuple:
    """(ok, got): host-wire replay vs the recorded expected.host outcome —
    EXACT equality on decided/decision/rounds."""
    if threads:
        got = replay_host_threads(art, timeout_ms=timeout_ms,
                                  device=device)
    else:
        if workdir is None:
            raise ValueError("multi-process replay needs a workdir")
        res = run_schedule_cluster(
            workdir, _artifact_tmp(art, workdir), timeout_ms=timeout_ms,
            device=device)
        got = {k: res[k] for k in ("decided", "decision", "rounds")}
    want = art.get("expected", {}).get("host")
    return (want is not None and got == want), got


def _artifact_tmp(art: Dict[str, Any], workdir: str) -> str:
    path = os.path.join(workdir, "artifact.json")
    dump_artifact(path, art)
    return path
