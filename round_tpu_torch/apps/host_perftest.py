"""Host-deployment throughput harness: decisions/sec over the native
transport.

Reference parity: PerfTest2 + runPerfTest2.sh — the reference's actual
measurement apparatus (4 JVM replicas on localhost, bounded in-flight
instances, decisions/sec; PerfTest2.scala:19-110, SURVEY.md §6).  Here:
n replica processes (or threads) run consecutive consensus instances over
the C++ TCP transport, each instance through the same Round-DSL classes
the engines simulate, and the harness reports decisions/sec.

    python -m round_tpu_torch.apps.host_perftest --n 4 --instances 50
    → {"metric": "host_otr_n4_decisions_per_sec", "value": ..., ...}

Port of round_tpu/apps/host_perftest.py: the result dict (``_score``),
``measure`` (a thread per replica), ``measure_processes`` (a
``host_replica`` process per replica), the wire and pump A/Bs and the CLI
for them, the lane driver (``--lanes``) and its A/B (``--ab-lanes``),
the overload A/B (``--ab-overload``), open-loop fleet serving
(``--open-loop``) and the fleet A/B (``--ab-fleet``).  Every replica's
rounds run on ``device`` (``--device``; the card by default, raising
where there is none), where round_tpu pins its replicas to the CPU;
thread-mode replicas share the card and its default stream, and each
fleet shard process opens its own CUDA context on it.  The runtime-
verification A/B (``--ab-rv``, measure_rv_ab) runs the lane driver with
and without the fused monitor term, the snapshot A/B (``--ab-snap``,
measure_snap_ab) with and without sampling, cut assembly and the audit.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from round_tpu_torch.apps.selector import select
from round_tpu_torch.runtime.chaos import alloc_ports, cluster_env
from round_tpu_torch.runtime.host import (
    AdaptiveTimeout, run_instance_loop, run_instance_loop_pipelined,
)
from round_tpu_torch.runtime.transport import HostTransport
from round_tpu_torch.utils.device import resolve_device


def run_node(my_id, peers, algo_name, instances, timeout_ms, results, seed,
             errors=None, proto="tcp", stats=None, algo=None, rate=1,
             adaptive_cap_ms=0, wire="binary", lanes=0, pump=True,
             device=None, tr=None, rv=None, snap=None):
    """One replica's instance loop; closes its transport (``tr``, or one
    bound here) when done."""
    if tr is None:
        tr = HostTransport(my_id, peers[my_id][1], proto=proto)
    # ONE algorithm object across instances: the round functions cache on
    # its rounds.  Thread mode passes ONE shared object for all replicas
    algo = select(algo_name) if algo is None else algo
    try:
        # one estimator PER REPLICA, shared across its instances: the EWMA
        # models the wire, which does not reset between instances.  Built
        # inside the try: a bad cap must land in `errors` (and close the
        # transport), not silently score the run as zero agreement
        adaptive = (AdaptiveTimeout(cap_ms=adaptive_cap_ms,
                                    seed=seed * 31 + my_id)
                    if adaptive_cap_ms > 0 else None)
        node_stats: dict = {}
        if lanes > 1:
            # the lane-batched driver (runtime/lanes.py): `lanes`
            # concurrent instances advanced by one vmapped mega-step per
            # round class instead of one Python round loop per instance
            from round_tpu_torch.runtime.lanes import run_instance_loop_lanes

            results[my_id] = run_instance_loop_lanes(
                algo, my_id, peers, tr, instances, lanes=lanes,
                timeout_ms=timeout_ms, seed=seed, stats_out=node_stats,
                adaptive=adaptive, wire=wire, use_pump=pump, rv=rv,
                snap=snap, device=device,
            )
        elif rate > 1:
            # the in-flight window (PerfTest2 -rt): `rate` concurrent
            # instances over one InstanceMux
            results[my_id] = run_instance_loop_pipelined(
                algo, my_id, peers, tr, instances, rate=rate,
                timeout_ms=timeout_ms, seed=seed, stats_out=node_stats,
                adaptive=adaptive, wire=wire, device=device,
            )
        else:
            results[my_id] = run_instance_loop(
                algo, my_id, peers, tr, instances, timeout_ms=timeout_ms,
                seed=seed, stats_out=node_stats, adaptive=adaptive,
                wire=wire, pump=pump, rv=rv, snap=snap, device=device,
            )
        if stats is not None:
            stats[my_id] = node_stats
    except Exception as e:  # noqa: BLE001 - surfaced by measure()
        if errors is not None:
            errors[my_id] = e
        raise
    finally:
        tr.close()


def _score(logs, instances, wall, n, algo, timeout_ms, mode,
           wall_basis="harness-wall", proto="tcp"):
    """Strict instance scoring: agreed = every replica decided AND equal;
    any decider short of that = partial.

    `wall_basis` names what `wall` measures so the two modes' headline
    numbers are not mistaken for the same measurement (advisor r02): thread
    mode scores against the harness wall (startup included); process mode
    against the slowest replica's own loop wall (per-process interpreter
    startup excluded — see measure_processes)."""
    agreed = partial = 0
    for inst in range(instances):
        vals = [logs[i][inst] for i in logs]
        if all(v is not None for v in vals) and len(set(vals)) == 1:
            agreed += 1
        elif any(v is not None for v in vals):
            partial += 1
    dps = agreed / wall if wall > 0 else 0.0
    return {
        "metric": f"host_{algo}_n{n}_decisions_per_sec",
        "value": round(dps, 2),
        "unit": "decisions/sec",
        "extra": {
            "wall_s": round(wall, 3),
            "wall_basis": wall_basis,
            "instances": instances,
            "agreed_instances": agreed,
            "partial_instances": partial,
            "replica_decisions": sum(
                1 for log in logs.values() for d in log if d is not None
            ),
            "n": n,
            "timeout_ms": timeout_ms,
            "mode": mode,
            "transport": f"native {proto} (native/transport.cpp)",
        },
    }


def _algo_opts(payload_bytes):
    return {"payload_bytes": payload_bytes} if payload_bytes > 0 else {}


def _mode(base, rate, adaptive_cap_ms, wire, pump, payload_bytes, device,
          lanes=0):
    mode = base
    if lanes > 1:
        mode += f" lanes={lanes}"
    if rate > 1:
        mode += f" rate={rate}"
    if adaptive_cap_ms > 0:
        mode += f" adaptive(cap={adaptive_cap_ms}ms)"
    mode += f" wire={wire}"
    if not pump:
        mode += " pump=python"
    if payload_bytes > 0:
        mode += f" payload={payload_bytes}B"
    return mode + f" device={device}"


def measure(n=4, instances=20, algo="otr", timeout_ms=300, seed=0,
            proto="tcp", rate=1, adaptive_cap_ms=0, wire="binary",
            lanes=0, payload_bytes=0, pump=True, device=None, rv=None,
            snap=None, algo_obj=None):
    """Run `instances` consecutive consensus instances over `n` replicas
    (threads, each with its own transport+sockets, all on ``device``; see
    measure_processes for the reference's exact multi-process shape).
    Every replica's socket is bound before any replica starts, so no
    first-round frame is lost to a peer still starting (round_tpu binds
    each inside its thread).  Returns (result dict, per-node decision
    logs).  ``rv`` runs every replica under runtime verification, and
    ``snap`` under snapshot sampling and audits;
    ``algo_obj`` lets a repeated-measurement harness (measure_rv_ab)
    share one algorithm object, and so its cached steps, across runs."""
    device = resolve_device(device)
    # thread-mode scheduling: n replicas in lockstep rounds over ONE GIL —
    # with CPython's default 5 ms switch interval, a replica waiting for
    # the round's last message can stall a full interval behind a peer's
    # dispatch burst.  0.5 ms bounds the convoy; applies to the whole
    # process, i.e. identically to both arms of the wire A/B — and is
    # RESTORED on exit so an embedding process keeps its own interval
    prev_switch = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    ports = alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    results: dict = {}
    errors: dict = {}
    stats: dict = {}
    shared_algo = (algo_obj if algo_obj is not None
                   else select(algo, _algo_opts(payload_bytes)))
    trs = [HostTransport(i, ports[i], proto=proto) for i in range(n)]
    threads = [
        threading.Thread(
            target=run_node,
            args=(i, peers, algo, instances, timeout_ms, results, seed,
                  errors, proto, stats, shared_algo, rate, adaptive_cap_ms,
                  wire, lanes, pump, device, trs[i], rv, snap),
        )
        for i in range(n)
    ]
    try:
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        join_timeout = max(60.0, instances * n * timeout_ms / 1000.0)
        for t in threads:
            t.join(timeout=join_timeout)
        wall = time.perf_counter() - t0
    finally:
        sys.setswitchinterval(prev_switch)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(
            f"replica thread(s) wedged after {join_timeout:.0f}s; "
            f"results so far: {sorted(results)}"
        )
    if len(results) != n:
        # a crashed replica must fail the run, not shrink the quorum the
        # agreement score is computed over
        raise RuntimeError(
            f"replica(s) died: {sorted(set(range(n)) - set(results))}; "
            f"errors: {errors}"
        )
    mode = _mode("thread-per-replica", rate, adaptive_cap_ms, wire, pump,
                 payload_bytes, device, lanes)
    score = _score(results, instances, wall, n, algo, timeout_ms,
                   mode, proto=proto)
    # per-node diagnostics: timeouts is the throughput killer (each one
    # burned a full round deadline)
    score["extra"]["node_stats"] = {i: stats.get(i, {}) for i in sorted(stats)}
    return score, results


def measure_processes(n=4, instances=100, algo="otr", timeout_ms=300,
                      proto="tcp", adaptive_cap_ms=0, trace=None,
                      metrics_json=None, wire="binary", lanes=0, rate=1,
                      payload_bytes=0, pump=True, device=None):
    """One OS PROCESS per replica (the reference's exact shape: 4 JVMs on
    localhost) via the host_replica CLI's --instances loop, each on
    ``device`` (``--device``; the card when None).  Returns the same
    result dict as measure(), plus each replica's rounds, start-up
    seconds (launch to the start of its loop) and peak GiB on the card.

    ``trace``/``metrics_json`` name per-replica artifact prefixes: replica
    i writes ``<trace>.<i>`` / ``<metrics_json>.<i>`` (one OS process
    each owns its own tracer/registry); merge with tools/trace_view.py."""
    import subprocess

    device = resolve_device(device)
    ports = alloc_ports(n)
    peer_arg = ",".join(f"127.0.0.1:{p}" for p in ports)
    env = cluster_env()
    t0 = time.perf_counter()
    base_argv = [
        "--peers", peer_arg, "--algo", algo,
        "--instances", str(instances),
        "--timeout-ms", str(timeout_ms),
        "--proto", proto,
        "--wire", wire,
        "--max-rounds", "32",  # same per-instance cap as measure()
        "--device", str(device),
    ]
    if not pump:
        base_argv += ["--no-pump"]
    if adaptive_cap_ms > 0:
        base_argv += ["--adaptive-timeout",
                      "--timeout-cap-ms", str(adaptive_cap_ms)]
    if lanes > 1:
        base_argv += ["--lanes", str(lanes)]
    if rate > 1:
        base_argv += ["--rate", str(rate)]
    if payload_bytes > 0:
        base_argv += ["--payload-bytes", str(payload_bytes)]

    def extra_argv(i):
        a = []
        if trace:
            a += ["--trace", f"{trace}.{i}"]
        if metrics_json:
            a += ["--metrics-json", f"{metrics_json}.{i}"]
        return a

    launched = time.time()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "round_tpu_torch.apps.host_replica",
             "--id", str(i), *base_argv, *extra_argv(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for i in range(n)
    ]
    join_timeout = max(120.0, instances * n * timeout_ms / 1000.0)
    outs = {}
    try:
        for i, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=join_timeout)
            if p.returncode != 0:
                raise RuntimeError(f"replica {i} failed: {stderr[-2000:]}")
            outs[i] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        # a failed/wedged replica must not orphan the others (each would
        # keep burning its full --instances loop of timeouts); kill THEN
        # reap, or the children stay zombies for the caller's lifetime
        for p in procs:
            if p.poll() is None:
                p.kill()
                try:
                    p.communicate(timeout=10)
                except Exception:  # noqa: BLE001 - best-effort reap
                    pass
    harness_wall = time.perf_counter() - t0
    # score against the slowest replica's OWN loop time: the harness wall
    # additionally includes each subprocess's interpreter, torch import
    # and CUDA start-up, which thread mode pays before its timed window
    wall = max(
        (o["wall_s"] for o in outs.values() if "wall_s" in o),
        default=harness_wall,
    )
    logs = {i: outs[i]["decisions"] for i in outs}
    mode = _mode("process-per-replica", rate, adaptive_cap_ms, wire, pump,
                 payload_bytes, device, lanes)
    result = _score(logs, instances, wall, n, algo, timeout_ms,
                    mode, wall_basis="slowest-replica-loop",
                    proto=proto)
    result["extra"]["node_timeouts"] = {
        i: outs[i].get("timeouts", 0) for i in outs}
    result["extra"]["startup_s"] = {
        i: round(outs[i]["loop_started_at"] - launched, 3) for i in outs}
    result["extra"]["peak_gib"] = {i: outs[i].get("peak_gib") for i in outs}
    result["extra"]["rounds_run"] = {i: outs[i]["rounds_run"] for i in outs}
    result["extra"]["harness_wall_s"] = round(harness_wall, 3)
    # also report the harness-wall-based rate so the two modes ARE
    # comparable on a shared basis (advisor r02)
    agreed = result["extra"]["agreed_instances"]
    result["extra"]["decisions_per_sec_harness_wall"] = round(
        agreed / harness_wall if harness_wall > 0 else 0.0, 2
    )
    return result, logs


def measure_wire_ab(n=4, instances=20, algo="otr", timeout_ms=300,
                    proto="tcp", rate=1, pairs=9, warmup=1,
                    processes=False, payload_bytes=0, device=None):
    """The wire old-vs-new interleaved A/B (apps/perf_ab.py): arm A is
    the seed path (``wire="pickle"``: pickle payloads, one native send
    per message, dict-inbox mailbox), arm B the rebuilt hot path
    (``wire="binary"``: codec + per-peer coalescing + batched receive +
    in-place mailbox).  Same ports discipline, same schedules; the
    warmup pass absorbs one-time costs so the pairs measure the WIRE.
    Returns one result dict (``ratio`` >= 1 is the regression gate)."""
    from round_tpu_torch.apps.perf_ab import interleaved_ab

    def arm(wire):
        def run():
            if processes:
                res, _ = measure_processes(
                    n=n, instances=instances, algo=algo,
                    timeout_ms=timeout_ms, proto=proto, wire=wire,
                    payload_bytes=payload_bytes, device=device)
            else:
                res, _ = measure(n=n, instances=instances, algo=algo,
                                 timeout_ms=timeout_ms, proto=proto,
                                 rate=rate, wire=wire,
                                 payload_bytes=payload_bytes, device=device)
            return res["value"]
        return run

    ab = interleaved_ab(arm("pickle"), arm("binary"), pairs=pairs,
                        warmup=warmup)
    return {
        "metric": f"host_{algo}_n{n}_wire_ab_speedup",
        "value": ab["ratio"],
        "unit": "x (binary/pickle decisions-per-sec)",
        "extra": {
            "dps_pickle": ab["mean_a"],
            "dps_binary": ab["mean_b"],
            "median_pickle": ab["median_a"],
            "median_binary": ab["median_b"],
            "samples_pickle": ab["a"],
            "samples_binary": ab["b"],
            "pairs": pairs,
            "warmup": warmup,
            "instances": instances,
            "n": n,
            "timeout_ms": timeout_ms,
            "mode": ("process-per-replica" if processes
                     else "thread-per-replica"
                     + (f" rate={rate}" if rate > 1 else "")),
            "payload_bytes": payload_bytes,
        },
    }


def measure_pump_ab(n=4, instances=20, algo="otr", timeout_ms=300,
                    proto="tcp", rate=1, lanes=0, pairs=9, warmup=1,
                    processes=False, payload_bytes=0, seed=0, device=None):
    """The NATIVE-ROUND-PUMP interleaved A/B: arm A is the Python pump
    (the per-message recv loop), arm B the native pump
    (native/transport.cpp rt_pump_*: round state machine in the transport
    event loop, one blocking wait + one flush crossing per round wave).
    Same binary wire, same schedules and seeds in both arms — the A/B
    isolates the PUMP.  ``lanes`` > 1 runs both arms through the lane-
    batched driver."""
    from round_tpu_torch.apps.perf_ab import interleaved_ab

    def arm(pump):
        def run():
            kw = dict(n=n, instances=instances, algo=algo,
                      timeout_ms=timeout_ms, proto=proto, lanes=lanes,
                      payload_bytes=payload_bytes, pump=pump, device=device)
            if processes:
                res, _ = measure_processes(rate=rate, **kw)
            else:
                res, _ = measure(rate=rate, seed=seed, **kw)
            return res["value"]
        return run

    ab = interleaved_ab(arm(False), arm(True), pairs=pairs, warmup=warmup)
    return {
        "metric": f"host_{algo}_n{n}_pump_ab_speedup",
        "value": ab["ratio"],
        "unit": "x (native-pump/python-pump decisions-per-sec)",
        "extra": {
            "dps_python_pump": ab["mean_a"],
            "dps_native_pump": ab["mean_b"],
            "median_python_pump": ab["median_a"],
            "median_native_pump": ab["median_b"],
            "samples_python_pump": ab["a"],
            "samples_native_pump": ab["b"],
            "pairs": pairs,
            "warmup": warmup,
            "instances": instances,
            "lanes": lanes,
            "rate": rate,
            "n": n,
            "timeout_ms": timeout_ms,
            "payload_bytes": payload_bytes,
            "mode": (("process-per-replica" if processes
                      else "thread-per-replica")
                     + (f" lanes={lanes}" if lanes > 1 else "")
                     + (f" rate={rate}" if rate > 1 else "")),
        },
    }


def measure_lanes_ab(n=4, instances=64, algo="otr", timeout_ms=300,
                     proto="tcp", lanes=64, rate=1, pairs=3, warmup=1,
                     processes=False, payload_bytes=0, seed=0, device=None):
    """The driver A/B (round_tpu/apps/host_perftest.py::measure_lanes_ab):
    arm A is the per-instance driver (the sequential loop, or the
    pipelined InstanceMux window when ``rate`` > 1), arm B the lane-
    batched driver (runtime/lanes.py) with ``lanes`` instances on the
    mega-step's lane axis.  Same ports discipline, same schedules and
    seeds, interleaved pairs (apps/perf_ab.py); the warmup pair absorbs
    first-call costs so the pairs measure the DRIVER."""
    from round_tpu_torch.apps.perf_ab import interleaved_ab

    if lanes < 2:
        # lanes<=1 selects the per-instance driver in run_node: arm B
        # would silently re-measure arm A
        raise ValueError(f"lanes must be >= 2 for the driver A/B, "
                         f"got {lanes}")

    def arm(use_lanes):
        def run():
            kw = dict(n=n, instances=instances, algo=algo,
                      timeout_ms=timeout_ms, proto=proto,
                      payload_bytes=payload_bytes,
                      lanes=lanes if use_lanes else 0, device=device)
            if processes:
                res, _ = measure_processes(
                    rate=1 if use_lanes else rate, **kw)
            else:
                res, _ = measure(seed=seed,
                                 rate=1 if use_lanes else rate, **kw)
            return res["value"]
        return run

    ab = interleaved_ab(arm(False), arm(True), pairs=pairs, warmup=warmup)
    return {
        "metric": f"host_{algo}_n{n}_lanes_ab_speedup",
        "value": ab["ratio"],
        "unit": "x (lane-batched/per-instance decisions-per-sec)",
        "extra": {
            "dps_per_instance": ab["mean_a"],
            "dps_lanes": ab["mean_b"],
            "median_per_instance": ab["median_a"],
            "median_lanes": ab["median_b"],
            "samples_per_instance": ab["a"],
            "samples_lanes": ab["b"],
            "pairs": pairs,
            "warmup": warmup,
            "instances": instances,
            "lanes": lanes,
            "rate": rate,
            "n": n,
            "timeout_ms": timeout_ms,
            "payload_bytes": payload_bytes,
            "mode": ("process-per-replica" if processes
                     else "thread-per-replica"),
            "device": str(resolve_device(device)),
        },
    }


def measure_rv_ab(n=4, instances=64, algo="otr", timeout_ms=300,
                  proto="tcp", lanes=16, pairs=3, warmup=1, seed=0,
                  payload_bytes=0, device=None):
    """The monitor-overhead A/B (round_tpu/apps/host_perftest.py::
    measure_rv_ab): arm A is the lane driver with monitors OFF, arm B the
    same driver with the monitor term fused into its update mega-step
    (policy 'log', no dumps), interleaved pairs on ``device``.  The gate
    (``rv_gate``): checks counted, zero violations on the clean run,
    byte-identical decision logs, and no decisive overhead regression."""
    from round_tpu_torch.apps.perf_ab import interleaved_ab
    from round_tpu_torch.rv.dump import RvConfig

    logs = {"off": None, "on": None}
    violations = {"count": 0, "checks": 0}
    shared = select(algo, _algo_opts(payload_bytes))

    def arm(monitors_on):
        def run():
            rv = RvConfig(policy="log") if monitors_on else None
            res, res_logs = measure(
                n=n, instances=instances, algo=algo,
                timeout_ms=timeout_ms, proto=proto, lanes=lanes,
                payload_bytes=payload_bytes, seed=seed, rv=rv,
                algo_obj=shared, device=device)
            logs["on" if monitors_on else "off"] = res_logs
            if monitors_on:
                for st in res["extra"]["node_stats"].values():
                    violations["count"] += len(
                        st.get("rv_violations", []))
                    violations["checks"] += st.get("rv_checks", 0)
            return res["value"]
        return run

    ab = interleaved_ab(arm(False), arm(True), pairs=pairs,
                        warmup=warmup)
    out = {
        "metric": f"host_{algo}_n{n}_rv_overhead",
        "value": ab["ratio"],
        "unit": "x (monitors-on/monitors-off decisions-per-sec)",
        "extra": {
            "dps_off": ab["mean_a"],
            "dps_on": ab["mean_b"],
            "median_off": ab["median_a"],
            "median_on": ab["median_b"],
            "samples_off": ab["a"],
            "samples_on": ab["b"],
            "pairs": pairs,
            "warmup": warmup,
            "instances": instances,
            "lanes": lanes,
            "n": n,
            "rv_checks": violations["checks"],
            "rv_violations": violations["count"],
            # the last pair's logs, same seeds both arms: the fused
            # monitor must be a pure observer
            "logs_identical": logs["off"] == logs["on"],
            "device": str(resolve_device(device)),
        },
    }
    out["gate"] = rv_gate(out)
    return out


def rv_gate(res) -> dict:
    """round_tpu's gate on the monitor A/B (tools/soak.py check_host_rv):
    the monitors ran (checks > 0), zero violations and byte-identical
    logs on the clean run, and not both the mean and median ratios under
    0.85 (a decisive regression; ``acceptance_ok`` is the idle-box
    number, on/off >= 0.95)."""
    ex = res["extra"]
    med = ex["median_on"] / max(ex["median_off"], 1e-9)
    fails = []
    if ex["rv_checks"] <= 0:
        fails.append("rv_checks == 0: the monitors-on arm ran unmonitored")
    if ex["rv_violations"]:
        fails.append(f"{ex['rv_violations']} violation(s) on a clean run")
    if not ex["logs_identical"]:
        fails.append("decision logs differ monitors-on vs off")
    if res["value"] < 0.85 and med < 0.85:
        fails.append(f"overhead regression: mean {res['value']} and "
                     f"median {round(med, 3)} both < 0.85")
    return {"ok": not fails, "fails": fails,
            "median_ratio": round(med, 3),
            "acceptance_ok": res["value"] >= 0.95}


def measure_snap_ab(n=4, instances=64, algo="lvb", timeout_ms=300,
                    proto="tcp", lanes=16, pairs=3, warmup=1, seed=0,
                    payload_bytes=1024, every_k=2, device=None):
    """The snapshot-audit overhead A/B (round_tpu/apps/host_perftest.py::
    measure_snap_ab): arm A is the lane driver with snapshots OFF, arm B
    the same driver with sampling, cut assembly and the batched audit
    live (policy 'log', no dumps, collector replica 0), interleaved pairs
    on ``device``.  The gate (``snap_gate``): cuts audited, zero
    violations and divergences on the clean run, byte-identical logs and
    no decisive overhead regression.  lvb's spec=None exercises the whole
    sampling, assembly and digest path with an empty formula dispatch."""
    from round_tpu_torch.apps.perf_ab import interleaved_ab
    from round_tpu_torch.snap import SnapConfig

    logs = {"off": None, "on": None}
    counts = {"violations": 0, "divergences": 0, "cuts_audited": 0,
              "samples": 0}
    shared = select(algo, _algo_opts(payload_bytes))

    def arm(snap_on):
        def run():
            snap = (SnapConfig(policy="log", every_k=every_k)
                    if snap_on else None)
            res, res_logs = measure(
                n=n, instances=instances, algo=algo,
                timeout_ms=timeout_ms, proto=proto, lanes=lanes,
                payload_bytes=payload_bytes, seed=seed, snap=snap,
                algo_obj=shared, device=device)
            logs["on" if snap_on else "off"] = res_logs
            if snap_on:
                for st in res["extra"]["node_stats"].values():
                    counts["violations"] += len(
                        st.get("snap_violations", []))
                    counts["divergences"] += len(
                        st.get("snap_divergences", []))
                    counts["cuts_audited"] += st.get(
                        "snap_cuts_audited", 0)
                    counts["samples"] += st.get("snap_samples", 0)
            return res["value"]
        return run

    ab = interleaved_ab(arm(False), arm(True), pairs=pairs,
                        warmup=warmup)
    out = {
        "metric": f"host_{algo}_n{n}_snap_overhead",
        "value": ab["ratio"],
        "unit": "x (snap-on/snap-off decisions-per-sec)",
        "extra": {
            "dps_off": ab["mean_a"],
            "dps_on": ab["mean_b"],
            "median_off": ab["median_a"],
            "median_on": ab["median_b"],
            "samples_off": ab["a"],
            "samples_on": ab["b"],
            "pairs": pairs,
            "warmup": warmup,
            "instances": instances,
            "lanes": lanes,
            "n": n,
            "every_k": every_k,
            "payload_bytes": payload_bytes,
            "snap_samples": counts["samples"],
            "snap_cuts_audited": counts["cuts_audited"],
            "snap_violations": counts["violations"],
            "snap_divergences": counts["divergences"],
            # the last pair's logs, same seeds both arms: sampling must
            # be a pure observer
            "logs_identical": logs["off"] == logs["on"],
            "device": str(resolve_device(device)),
        },
    }
    out["gate"] = snap_gate(out)
    return out


def snap_gate(res) -> dict:
    """round_tpu's gate on the snapshot A/B (tools/soak.py
    check_host_snap): cuts audited (> 0), zero violations and
    divergences and byte-identical logs on the clean run, and not both
    the mean and median ratios under 0.85 (``acceptance_ok`` is the
    idle-box number, on/off >= 0.95)."""
    ex = res["extra"]
    med = ex["median_on"] / max(ex["median_off"], 1e-9)
    fails = []
    if ex["snap_cuts_audited"] <= 0:
        fails.append("snap.cuts_audited == 0: a dead collector")
    if ex["snap_violations"]:
        fails.append(f"{ex['snap_violations']} violation(s) on a clean "
                     "run")
    if ex["snap_divergences"]:
        fails.append(f"{ex['snap_divergences']} divergence(s) on a clean "
                     "run")
    if not ex["logs_identical"]:
        fails.append("decision logs differ snapshots-on vs off")
    if res["value"] < 0.85 and med < 0.85:
        fails.append(f"overhead regression: mean {res['value']} and "
                     f"median {round(med, 3)} both < 0.85")
    return {"ok": not fails, "fails": fails,
            "median_ratio": round(med, 3),
            "acceptance_ok": res["value"] >= 0.95}


def _overload_cluster(n, instances, algo, timeout_ms, lanes_by_id,
                      hardened_ids, quarantine_ids, seed,
                      admission_bytes_per_lane, shed_deadline_ms=250,
                      hung_ids=frozenset(), device=None):
    """One degraded-capacity process cluster for the overload A/B
    (round_tpu/apps/host_perftest.py::_overload_cluster): per-replica
    lane counts, --admission on ``hardened_ids``, --quarantine on
    ``quarantine_ids``, peers lingering so the strapped replica catches
    up via decision replies.  ``hung_ids`` replicas run only the first
    two instances, then hold their port and linger — live on the wire,
    silent in every later round wave.  Every replica runs on ``device``.
    Returns (participant summaries, wall_s, replica0_peak_rss_kb)."""
    import subprocess

    ports = alloc_ports(n)
    peer_arg = ",".join(f"127.0.0.1:{p}" for p in ports)
    env = cluster_env()
    dev = str(resolve_device(device))

    def argv_for(i):
        hung = i in hung_ids
        a = [sys.executable, "-m", "round_tpu_torch.apps.host_replica",
             "--id", str(i), "--peers", peer_arg, "--algo", algo,
             "--instances", "2" if hung else str(instances),
             "--timeout-ms", str(timeout_ms),
             "--max-rounds", "32", "--value-schedule", "uniform",
             "--seed", str(seed), "--lanes",
             "1" if hung else str(lanes_by_id[i]),
             # adaptive deadlines: a stray expiry costs the EWMA
             # estimate, not the full configured timeout
             "--adaptive-timeout", "--timeout-cap-ms", str(timeout_ms),
             # peers must outlive the strapped replica's deferred tail
             "--linger-ms", "180000" if hung else "6000",
             "--device", dev]
        if i in hardened_ids:
            a += ["--admission", "--admission-bytes-per-lane",
                  str(admission_bytes_per_lane),
                  "--shed-deadline-ms", str(shed_deadline_ms)]
        if i in quarantine_ids:
            # two evidence rounds suffice against a HUNG peer, and the
            # probe backoff starts past the run tail
            a += ["--quarantine", "--quarantine-after", "2",
                  "--probe-backoff-ms", "15000"]
        return a

    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv_for(i), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for i in range(n)]
    # peak RSS of the STRAPPED replica, polled (VmHWM is absent on some
    # stripped /proc implementations)
    peak_kb = [0]
    stop = threading.Event()

    def poll_rss():
        path = f"/proc/{procs[0].pid}/status"
        while not stop.is_set():
            try:
                with open(path) as f:
                    for line in f:
                        if line.startswith(("VmHWM:", "VmRSS:")):
                            peak_kb[0] = max(peak_kb[0],
                                             int(line.split()[1]))
                            break
            except OSError:
                return
            stop.wait(0.05)

    poller = threading.Thread(target=poll_rss, daemon=True)
    poller.start()
    join_timeout = max(180.0, instances * n * timeout_ms / 1000.0)
    outs = {}
    try:
        # participants first: the hung replicas linger past the run and
        # are reaped by the kill below
        for i, p in enumerate(procs):
            if i in hung_ids:
                continue
            stdout, stderr = p.communicate(timeout=join_timeout)
            if p.returncode != 0:
                raise RuntimeError(f"replica {i} failed: {stderr[-2000:]}")
            outs[i] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                try:
                    p.communicate(timeout=10)
                except Exception:  # noqa: BLE001 - best-effort reap
                    pass
    wall = max((o["wall_s"] for o in outs.values() if "wall_s" in o),
               default=time.perf_counter() - t0)
    return outs, wall, peak_kb[0]


def measure_overload_ab(n=4, algo="otr", timeout_ms=150, lanes_slow=2,
                        overload=3, instances=432, seed=0,
                        admission_bytes_per_lane=2048, device=None):
    """The overload degradation A/B
    (round_tpu/apps/host_perftest.py::measure_overload_ab): replica
    ``n-1`` is HUNG (live on the wire, silent in every round wave) and
    the surviving peers run ``overload x lanes_slow`` lanes against
    replica 0's ``lanes_slow``.  Four process clusters, same seeds:
    capacity (every replica healthy at lanes_slow, the denominator),
    baseline (hung peer + lane flood, no hardening), hardened (the same
    with --quarantine on the survivors and --admission on replica 0) and
    shedding (the lane flood without the hung peer, admission budget
    tightened so replica 0 SHEDS).  Throughput = decided entries per
    participating replica per second.  Every arm's shed frames must be
    NACK-accounted (``shed_accounting_ok``)."""
    fast = max(2, overload * lanes_slow)
    hung = frozenset({n - 1})
    lanes_cap = {i: lanes_slow for i in range(n)}
    lanes_over = {0: lanes_slow, **{i: fast for i in range(1, n)}}
    shed_bytes_per_lane = 64

    def dps(outs, wall):
        decided = sum(o.get("decided_instances", 0) for o in outs.values())
        return decided / wall / max(1, len(outs)) if wall > 0 else 0.0

    runs = {}
    for name, lanes_by_id, hardened_ids, quar_ids, hung_ids, bpl, inst in (
            ("capacity", lanes_cap, frozenset(), frozenset(), frozenset(),
             admission_bytes_per_lane, instances),
            # the baseline arm burns a deadline per round: a third of the
            # instances measures the same degraded RATE
            ("baseline", lanes_over, frozenset(), frozenset(), hung,
             admission_bytes_per_lane, max(24, instances // 3)),
            ("hardened", lanes_over, frozenset({0}),
             frozenset(range(n)) - hung, hung, admission_bytes_per_lane,
             instances),
            ("shedding", lanes_over, frozenset({0}),
             frozenset(range(n)), frozenset(), shed_bytes_per_lane,
             instances)):
        outs, wall, rss_kb = _overload_cluster(
            n, inst, algo, timeout_ms, lanes_by_id, hardened_ids,
            quar_ids, seed, bpl, hung_ids=hung_ids, device=device)
        entry = {
            "dps": round(dps(outs, wall), 2),
            "wall_s": round(wall, 3),
            "decided": {i: outs[i].get("decided_instances", 0)
                        for i in outs},
            "timeouts": {i: outs[i].get("timeouts", 0) for i in outs},
            "replica0_peak_rss_kb": rss_kb,
        }
        if "overload" in outs.get(0, {}):
            entry["overload"] = outs[0]["overload"]
        if "quarantine" in outs.get(0, {}):
            entry["quarantine_r0"] = {
                k: outs[0]["quarantine"][k]
                for k in ("quarantines", "probes", "rejoins")}
        runs[name] = entry
    accounted = True
    for r in runs.values():
        ov = r.get("overload", {})
        if ov.get("shed_frames", 0) != ov.get("nacks_sent", 0) \
                + ov.get("nacks_suppressed", 0):
            accounted = False
    sheds = runs["shedding"].get("overload", {})
    cap_dps = runs["capacity"]["dps"] or 1e-9
    # RSS ratios only where /proc yielded samples in EVERY arm
    cap_rss = runs["capacity"]["replica0_peak_rss_kb"]
    rss_ok = all(runs[a]["replica0_peak_rss_kb"] > 0 for a in runs)

    def _rss_ratio(arm: str):
        if not rss_ok:
            return None
        return round(runs[arm]["replica0_peak_rss_kb"] / cap_rss, 3)

    return {
        "metric": f"host_{algo}_n{n}_overload{overload}x_hardened_ratio",
        "value": round(runs["hardened"]["dps"] / cap_dps, 3),
        "unit": "x (hardened-at-overload / at-capacity decided-per-sec)",
        "extra": {
            "runs": runs,
            "baseline_ratio": round(runs["baseline"]["dps"] / cap_dps, 3),
            "shedding_ratio": round(runs["shedding"]["dps"] / cap_dps, 3),
            "rss_ratio_hardened": _rss_ratio("hardened"),
            "rss_ratio_baseline": _rss_ratio("baseline"),
            "rss_ratio_shedding": _rss_ratio("shedding"),
            "rss_unavailable": not rss_ok,
            "shed_accounting_ok": accounted,
            "sheds": sheds,
            "lanes_slow": lanes_slow,
            "overload": overload,
            "instances": instances,
            "n": n,
            "timeout_ms": timeout_ms,
            "mode": "process-per-replica hung-peer + asymmetric-lanes",
            "device": str(resolve_device(device)),
        },
    }


def measure_open_loop(rate, drivers=4, instances=400, n=3, lanes=16,
                      algo="otr", timeout_ms=300, skew=0.0,
                      payload_bytes=0, seed=0, warmup=8,
                      deadline_s=180.0, admission_bytes_per_lane=0,
                      device=None):
    """Open-loop serving (round_tpu/apps/host_perftest.py::
    measure_open_loop): a ``drivers``-shard fleet (apps/fleet.py, one OS
    process per shard, each on ``device``) under Poisson arrivals at
    ``rate``/s, reported as per-request p50/p99 decision latency and
    offered-vs-achieved throughput."""
    from round_tpu_torch.apps.fleet import run_fleet_bench

    rep = run_fleet_bench(
        drivers=drivers, rate=rate, instances=instances, n=n,
        lanes=lanes, algo=algo, timeout_ms=timeout_ms, skew=skew,
        payload_bytes=payload_bytes, seed=seed, warmup=warmup,
        deadline_s=deadline_s,
        admission_bytes_per_lane=admission_bytes_per_lane, device=device)
    ol = rep["open_loop"]
    return {
        "metric": f"fleet_{algo}_d{drivers}_open_loop_dps",
        "value": ol["achieved_dps"],
        "unit": "decisions/sec (achieved, open-loop)",
        "extra": rep,
    }


def measure_fleet_ab(drivers=4, rate=1e9, instances=1024, n=3, lanes=16,
                     algo="lvb", timeout_ms=150, pairs=2, warmup=0,
                     seed=0, payload_bytes=1024, deadline_s=420.0,
                     device=None):
    """The fleet scale-out A/B (round_tpu/apps/host_perftest.py::
    measure_fleet_ab): arm A is ONE driver, arm B a ``drivers``-shard
    fleet, both offered the SAME open-loop load (``rate`` defaults to an
    instantaneous blast, so both arms run saturated and achieved dps
    measures serving capacity).  Interleaved pairs; every arm's shed
    accounting must hold.  Default workload: LastVotingBytes at 1 KiB
    with deadline-paced rounds at lanes=16."""
    from round_tpu_torch.apps.fleet import run_fleet_bench
    from round_tpu_torch.apps.perf_ab import interleaved_ab

    def arm(d):
        def run():
            rep = run_fleet_bench(
                drivers=d, rate=rate, instances=instances, n=n,
                lanes=lanes, algo=algo, timeout_ms=timeout_ms,
                seed=seed, warmup=8, payload_bytes=payload_bytes,
                deadline_s=deadline_s, device=device)
            if not rep["shed_accounting_ok"]:
                raise RuntimeError(
                    f"shed accounting broke in the d={d} arm: "
                    f"{rep['shed_frames']} != {rep['nacks_accounted']}")
            return rep["open_loop"]["achieved_dps"]
        return run

    ab = interleaved_ab(arm(1), arm(drivers), pairs=pairs, warmup=warmup)
    return {
        "metric": f"fleet_{algo}_d{drivers}_ab_speedup",
        "value": ab["ratio"],
        "unit": f"x ({drivers}-driver fleet / single driver "
                f"decisions-per-sec)",
        "extra": {
            "dps_single": ab["mean_a"],
            "dps_fleet": ab["mean_b"],
            "median_single": ab["median_a"],
            "median_fleet": ab["median_b"],
            "samples_single": ab["a"],
            "samples_fleet": ab["b"],
            "pairs": pairs,
            "instances": instances,
            "drivers": drivers,
            "n": n,
            "lanes": lanes,
            "timeout_ms": timeout_ms,
            "payload_bytes": payload_bytes,
            "mode": "process-per-shard open-loop blast",
            "device": str(resolve_device(device)),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--instances", type=int, default=20)
    ap.add_argument("--algo", type=str, default="otr")
    ap.add_argument("--timeout-ms", type=int, default=300)
    ap.add_argument("--device", type=str, default=None,
                    help="where every replica's rounds run (default: "
                         "cuda; raises where there is no card)")
    ap.add_argument("--processes", action="store_true",
                    help="one OS process per replica (the reference's "
                         "4-JVM shape) instead of threads")
    ap.add_argument("--proto", choices=["tcp", "udp"], default="tcp",
                    help="native transport: tcp (framed/reconnecting) or "
                         "udp (the reference's default perf transport)")
    ap.add_argument("-rt", "--rate", type=int, default=1,
                    help="instances in flight per replica (PerfTest2 -rt): "
                         ">1 pipelines burned round deadlines on lossy "
                         "networks (per-instance driver; one thread per "
                         "in-flight instance)")
    ap.add_argument("--lanes", type=int, default=0, metavar="L",
                    help="lane-batched driver (runtime/lanes.py): L "
                         "concurrent instances multiplexed onto the "
                         "engine's lane axis, ONE vmapped mega-step per "
                         "round class instead of one Python round loop "
                         "per instance; 0/1 = per-instance driver")
    ap.add_argument("--payload-bytes", type=int, default=0, metavar="B",
                    help="with --algo lvb: consensus over opaque uint8[B] "
                         "payloads (the KB-scale wire-fraction workload; "
                         "default 1024 when --algo lvb is given without "
                         "this flag)")
    ap.add_argument("--adaptive-timeout", action="store_true",
                    help="EWMA + backoff round deadlines instead of the "
                         "fixed --timeout-ms (runtime/host.py "
                         "AdaptiveTimeout)")
    ap.add_argument("--timeout-cap-ms", type=int, default=2000,
                    help="adaptive-timeout backoff cap / initial deadline "
                         "(with --adaptive-timeout)")
    ap.add_argument("--trace", type=str, default=None, metavar="FILE",
                    help="record the round-level event trace "
                         "(round_tpu_torch/obs/trace.py) — one JSONL file "
                         "in thread mode, FILE.<id> per replica in "
                         "--processes mode")
    ap.add_argument("--metrics-json", type=str, default=None, metavar="FILE",
                    help="write the unified metrics snapshot "
                         "(round_tpu_torch/obs/metrics.py) as JSON — "
                         "FILE.<id> per replica in --processes mode")
    ap.add_argument("--wire", choices=["binary", "pickle"],
                    default="binary",
                    help="payload path: 'binary' (codec + per-peer frame "
                         "coalescing + batched receive, the hot path) or "
                         "'pickle' (the pre-rebuild baseline)")
    ap.add_argument("--pump", dest="pump", action="store_true",
                    default=True,
                    help="use the NATIVE round pump when available "
                         "(native/transport.cpp rt_pump_*; the default)")
    ap.add_argument("--no-pump", dest="pump", action="store_false",
                    help="pin the Python round pump (the --ab-pump "
                         "baseline arm)")
    ap.add_argument("--ab-pump", action="store_true",
                    help="run the interleaved PUMP A/B (Python pump vs "
                         "native pump, apps/perf_ab.py) and report the "
                         "speedup instead of a single measurement")
    ap.add_argument("--ab-wire", action="store_true",
                    help="run the interleaved wire A/B (pickle vs binary, "
                         "apps/perf_ab.py) and report the speedup instead "
                         "of a single measurement")
    ap.add_argument("--ab-lanes", action="store_true",
                    help="run the interleaved DRIVER A/B (per-instance vs "
                         "lane-batched with --lanes, apps/perf_ab.py) and "
                         "report the speedup instead of a single "
                         "measurement")
    ap.add_argument("--ab-pairs", type=int, default=9,
                    help="interleaved pairs for --ab-wire/--ab-pump/"
                         "--ab-lanes/--ab-fleet")
    ap.add_argument("--ab-rv", action="store_true",
                    help="run the interleaved monitor-overhead A/B (the "
                         "lane driver with and without the fused rv "
                         "term, measure_rv_ab; --lanes, default 16) and "
                         "exit nonzero unless its gate holds")
    ap.add_argument("--ab-snap", action="store_true",
                    help="run the interleaved snapshot-overhead A/B (the "
                         "lane driver with and without sampling and cut "
                         "audits, measure_snap_ab: lvb 1 KiB, every_k=2) "
                         "and exit nonzero unless its gate holds")
    ap.add_argument("--ab-overload", action="store_true",
                    help="run the overload degradation A/B (at-capacity "
                         "vs ~3x offered load, pre- vs post-hardening — "
                         "measure_overload_ab; process mode always)")
    ap.add_argument("--overload", type=int, default=3, metavar="X",
                    help="offered-load multiple for --ab-overload "
                         "(peers run X*--lanes lanes; default 3)")
    ap.add_argument("--open-loop", type=float, default=None, metavar="RATE",
                    help="open-loop serving measurement: a --drivers "
                         "shard fleet (apps/fleet.py) under Poisson "
                         "arrivals at RATE/s, reporting p50/p99 decision "
                         "latency + offered-vs-achieved throughput "
                         "(apps/loadgen.py; --instances arrivals)")
    ap.add_argument("--drivers", type=int, default=4, metavar="D",
                    help="fleet size for --open-loop/--ab-fleet (one "
                         "shard process per driver; default 4)")
    ap.add_argument("--skew", type=float, default=0.0,
                    help="hot-shard Zipf exponent for --open-loop")
    ap.add_argument("--ab-fleet", action="store_true",
                    help="run the interleaved FLEET A/B (single driver "
                         "vs --drivers shards at equal offered load, "
                         "measure_fleet_ab) and report the speedup")
    args = ap.parse_args(argv)
    cap = args.timeout_cap_ms if args.adaptive_timeout else 0
    if args.algo in ("lvb", "lastvoting-bytes", "lastvotingbytes") \
            and args.payload_bytes <= 0:
        args.payload_bytes = 1024
    if args.open_loop is not None:
        result = measure_open_loop(
            args.open_loop, drivers=args.drivers,
            instances=args.instances, algo=args.algo,
            lanes=args.lanes if args.lanes > 1 else 16,
            timeout_ms=args.timeout_ms, skew=args.skew,
            payload_bytes=args.payload_bytes, device=args.device,
        )
        print(json.dumps(result))
        return 0
    if args.ab_fleet:
        result = measure_fleet_ab(
            drivers=args.drivers, instances=args.instances,
            algo=args.algo, timeout_ms=args.timeout_ms,
            lanes=args.lanes if args.lanes > 1 else 16,
            pairs=args.ab_pairs, payload_bytes=args.payload_bytes,
            device=args.device,
        )
        print(json.dumps(result))
        return 0
    if args.ab_overload:
        result = measure_overload_ab(
            n=args.n, algo=args.algo, timeout_ms=args.timeout_ms,
            lanes_slow=args.lanes if args.lanes > 1 else 4,
            overload=args.overload, instances=args.instances,
            device=args.device,
        )
        print(json.dumps(result))
        return 0
    if args.ab_rv:
        result = measure_rv_ab(
            n=args.n, instances=args.instances, algo=args.algo,
            timeout_ms=args.timeout_ms, proto=args.proto,
            lanes=args.lanes if args.lanes > 1 else 16,
            pairs=args.ab_pairs, payload_bytes=args.payload_bytes,
            device=args.device)
        print(json.dumps(result))
        return 0 if result["gate"]["ok"] else 1
    if args.ab_snap:
        result = measure_snap_ab(
            n=args.n, instances=args.instances,
            lanes=args.lanes if args.lanes > 1 else 16,
            pairs=args.ab_pairs, device=args.device)
        print(json.dumps(result))
        return 0 if result["gate"]["ok"] else 1
    if args.ab_lanes:
        if args.lanes == 1:
            # lanes<=1 routes run_node to the per-instance driver
            ap.error("--ab-lanes needs --lanes >= 2 (1 IS the "
                     "per-instance driver)")
        result = measure_lanes_ab(
            n=args.n, instances=args.instances, algo=args.algo,
            timeout_ms=args.timeout_ms, proto=args.proto,
            lanes=args.lanes if args.lanes > 1 else 64, rate=args.rate,
            pairs=args.ab_pairs, processes=args.processes,
            payload_bytes=args.payload_bytes, device=args.device,
        )
        print(json.dumps(result))
        return 0
    if args.ab_pump:
        result = measure_pump_ab(
            n=args.n, instances=args.instances, algo=args.algo,
            timeout_ms=args.timeout_ms, proto=args.proto, rate=args.rate,
            lanes=args.lanes, pairs=args.ab_pairs,
            processes=args.processes,
            payload_bytes=args.payload_bytes, device=args.device,
        )
        print(json.dumps(result))
        return 0
    if args.ab_wire:
        result = measure_wire_ab(
            n=args.n, instances=args.instances, algo=args.algo,
            timeout_ms=args.timeout_ms, proto=args.proto, rate=args.rate,
            pairs=args.ab_pairs, processes=args.processes,
            payload_bytes=args.payload_bytes, device=args.device,
        )
        print(json.dumps(result))
        return 0
    if args.processes:
        result, _logs = measure_processes(
            n=args.n, instances=args.instances, algo=args.algo,
            timeout_ms=args.timeout_ms, proto=args.proto,
            adaptive_cap_ms=cap, trace=args.trace,
            metrics_json=args.metrics_json, wire=args.wire,
            lanes=args.lanes, rate=args.rate,
            payload_bytes=args.payload_bytes, pump=args.pump,
            device=args.device,
        )
    else:
        if args.trace:
            # thread mode: every replica shares the process tracer; events
            # carry their emitter's node id, so one file merges cleanly
            from round_tpu_torch.obs.trace import TRACE

            TRACE.enable()
        result, _logs = measure(
            n=args.n, instances=args.instances, algo=args.algo,
            timeout_ms=args.timeout_ms, proto=args.proto, rate=args.rate,
            adaptive_cap_ms=cap, wire=args.wire, lanes=args.lanes,
            payload_bytes=args.payload_bytes, pump=args.pump,
            device=args.device,
        )
        if args.trace:
            TRACE.dump_jsonl(args.trace)
        if args.metrics_json:
            from round_tpu_torch.obs.metrics import METRICS

            METRICS.dump_json(args.metrics_json)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
