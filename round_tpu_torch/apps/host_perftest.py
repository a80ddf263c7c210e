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
for them.  Every replica's rounds run on ``device`` (``--device``; the
card by default, raising where there is none), where round_tpu pins its
replicas to the CPU; thread-mode replicas share the card and its default
stream.  The lane, runtime-verification, snapshot, overload, open-loop
and fleet arms (``--lanes``, ``--ab-lanes``, ``--ab-overload``,
``--open-loop``, ``--ab-fleet``) need ROADMAP slices 6d and 5b and exit
with an error that names the slice.
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
             adaptive_cap_ms=0, wire="binary", pump=True, device=None,
             tr=None):
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
        if rate > 1:
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
                wire=wire, pump=pump, device=device,
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


def _mode(base, rate, adaptive_cap_ms, wire, pump, payload_bytes, device):
    mode = base
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
            payload_bytes=0, pump=True, device=None):
    """Run `instances` consecutive consensus instances over `n` replicas
    (threads, each with its own transport+sockets, all on ``device``; see
    measure_processes for the reference's exact multi-process shape).
    Every replica's socket is bound before any replica starts, so no
    first-round frame is lost to a peer still starting (round_tpu binds
    each inside its thread).  Returns (result dict, per-node decision
    logs)."""
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
    shared_algo = select(algo, _algo_opts(payload_bytes))
    trs = [HostTransport(i, ports[i], proto=proto) for i in range(n)]
    threads = [
        threading.Thread(
            target=run_node,
            args=(i, peers, algo, instances, timeout_ms, results, seed,
                  errors, proto, stats, shared_algo, rate, adaptive_cap_ms,
                  wire, pump, device, trs[i]),
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
                 payload_bytes, device)
    score = _score(results, instances, wall, n, algo, timeout_ms,
                   mode, proto=proto)
    # per-node diagnostics: timeouts is the throughput killer (each one
    # burned a full round deadline)
    score["extra"]["node_stats"] = {i: stats.get(i, {}) for i in sorted(stats)}
    return score, results


def measure_processes(n=4, instances=100, algo="otr", timeout_ms=300,
                      proto="tcp", adaptive_cap_ms=0, trace=None,
                      metrics_json=None, wire="binary", rate=1,
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
                 payload_bytes, device)
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
                    proto="tcp", rate=1, pairs=9, warmup=1,
                    processes=False, payload_bytes=0, seed=0, device=None):
    """The NATIVE-ROUND-PUMP interleaved A/B: arm A is the Python pump
    (the per-message recv loop), arm B the native pump
    (native/transport.cpp rt_pump_*: round state machine in the transport
    event loop, one blocking wait + one flush crossing per round wave).
    Same binary wire, same schedules and seeds in both arms — the A/B
    isolates the PUMP."""
    from round_tpu_torch.apps.perf_ab import interleaved_ab

    def arm(pump):
        def run():
            kw = dict(n=n, instances=instances, algo=algo,
                      timeout_ms=timeout_ms, proto=proto,
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
            "rate": rate,
            "n": n,
            "timeout_ms": timeout_ms,
            "payload_bytes": payload_bytes,
            "mode": (("process-per-replica" if processes
                      else "thread-per-replica")
                     + (f" rate={rate}" if rate > 1 else "")),
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
                    help="lane-batched driver (runtime/lanes.py, ROADMAP "
                         "slice 6d: not ported, an error)")
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
    ap.add_argument("--ab-pairs", type=int, default=9,
                    help="interleaved pairs for --ab-wire/--ab-pump")
    for flag, what in (("--ab-lanes", "the lane driver A/B (slice 6d)"),
                       ("--ab-overload", "the overload A/B (slice 6d)"),
                       ("--ab-fleet", "the fleet A/B (slice 6d)")):
        ap.add_argument(flag, action="store_true",
                        help=f"{what}: not ported, an error")
    ap.add_argument("--open-loop", type=float, default=None, metavar="RATE",
                    help="open-loop fleet serving (slice 6d): not ported, "
                         "an error")
    args = ap.parse_args(argv)
    if args.lanes > 1 or args.ab_lanes or args.ab_overload \
            or args.ab_fleet or args.open_loop is not None:
        ap.error("the lane, overload, fleet and open-loop arms need "
                 "runtime/lanes.py and runtime/fleet.py, which come with "
                 "ROADMAP slice 6d")
    cap = args.timeout_cap_ms if args.adaptive_timeout else 0
    if args.algo in ("lvb", "lastvoting-bytes", "lastvotingbytes") \
            and args.payload_bytes <= 0:
        args.payload_bytes = 1024
    if args.ab_pump:
        result = measure_pump_ab(
            n=args.n, instances=args.instances, algo=args.algo,
            timeout_ms=args.timeout_ms, proto=args.proto, rate=args.rate,
            pairs=args.ab_pairs, processes=args.processes,
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
            rate=args.rate, payload_bytes=args.payload_bytes,
            pump=args.pump, device=args.device,
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
            adaptive_cap_ms=cap, wire=args.wire,
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
