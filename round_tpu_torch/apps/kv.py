"""KV front-door CLI: serve a kv-enabled shard, bench the replicated
store under a YCSB-style mixed workload, replay a banked
linearizability artifact (kv/, docs/KV.md).

    # one kv shard process (apps/fleet.py serve with --kv forced on)
    python -m round_tpu_torch.apps.kv serve --ports 7101,7102,7103

    # 2-shard store + mixed 90/10 open loop, checker-gated
    python -m round_tpu_torch.apps.kv bench --shards 2 --rate 120 --ops 1000

    # rate ladder to the op knee, banked into the read-aware capacity
    # model (runtime/capacity.py b_read/b_lease axes)
    python -m round_tpu_torch.apps.kv bench --sweep 60,120,240,480 \
        --capacity-samples knees_kv.json --capacity-out capacity_kv.json

    # re-run the checker on a banked violation artifact
    python -m round_tpu_torch.apps.kv check kv_dumps/kv-lin-....json

``run_kv_bench`` is the programmatic core.  Every bench run ends with
the kv/lin.py Wing & Gong check over the FULL client history — a
violating run fails loudly AND banks a replayable artifact.

Port of round_tpu/apps/kv.py.  Every shard is one process whose lanes
run on ``--device`` (the card by default; a shard raises where there is
none, with no fall-back to the CPU), and so does the client's commit
calculus.  A bench routes to a shard only once the shard says it is
serving, and its report adds each shard's start-up seconds and peak
GiB (apps/fleet.py).  round_tpu's module pins JAX to the CPU when it is
imported; the port sets nothing in the environment.
"""

from __future__ import annotations

import argparse
import json
import sys
import time as _time
from typing import Any, Dict, List, Optional


def _kv_argv(lease_replica: int, lease_ms: float, keyspace: int,
             broken_lease: bool) -> List[str]:
    """The ``serve`` flags that make a fleet shard a kv shard."""
    argv = ["--kv", "--kv-lease-replica", str(lease_replica),
            "--kv-lease-ms", str(lease_ms), "--kv-keyspace", str(keyspace)]
    if broken_lease:
        argv.append("--kv-broken-lease")
    return argv


def run_kv_bench(*, shards: int = 2, n: int = 3, lanes: int = 16,
                 rate: float = 100.0, rates: Optional[List[float]] = None,
                 ops: int = 400, payload_bytes: int = 256,
                 timeout_ms: int = 200, seed: int = 0, keys: int = 64,
                 key_skew: float = 0.8, read_frac: float = 0.9,
                 grade_mix=(0.2, 0.4, 0.4), value_bytes: int = 8,
                 warmup: int = 4, deadline_s: float = 120.0,
                 proto: str = "tcp", idle_ms: int = 4000,
                 admission_bytes_per_lane: int = 0,
                 shed_deadline_ms: int = 250, lease_replica: int = 0,
                 lease_ms: float = 0.0, keyspace: int = 4096,
                 broken_lease: bool = False,
                 dump_dir: str = "kv_dumps",
                 write_p99_cap_ms: float = 5000.0,
                 min_completed: float = 0.9,
                 capacity_samples: Optional[str] = None,
                 capacity_out: Optional[str] = None,
                 device=None) -> Dict[str, Any]:
    """Spawn a ``shards``-shard KV fleet (one OS process per shard, each
    on ``device``), offer the mixed YCSB-style trace open-loop at
    ``rate`` (or walk the ``rates`` ladder to the OP knee — reads
    included, unlike the write-only fleet knee), then gate on:

      * the kv/lin.py checker over the full client history (zero
        violations, else the history banks as a replayable artifact),
      * the fleet NACK/shed accounting invariant across all shards,
      * zero router give-ups.

    With ``rates`` + ``capacity_samples`` the measured knee banks with
    its read axes (read_frac, lease_frac) for the read-aware capacity
    fit (runtime/capacity.py) (round_tpu/apps/kv.py::run_kv_bench)."""
    from round_tpu_torch.apps.fleet import (
        _spawn_fleet, await_ready, bank_and_maybe_fit, reap_shards,
        shard_startup,
    )
    from round_tpu_torch.apps.loadgen import kv_open_loop
    from round_tpu_torch.kv.client import KVClient
    from round_tpu_torch.kv.lin import check_history, dump_history_violation
    from round_tpu_torch.runtime.fleet import FleetRouter
    from round_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    gm = [float(g) for g in grade_mix]
    s = sum(gm) or 1.0
    gm = [g / s for g in gm]
    max_ms = int(deadline_s * 1000) + 120_000
    launched = _time.time()
    procs, addrs = _spawn_fleet(
        shards, n, lanes, "lvb", payload_bytes, timeout_ms, seed, proto,
        idle_ms, max_ms, admission_bytes_per_lane, shed_deadline_ms,
        no_pump=False, device=device,
        extra_argv=_kv_argv(lease_replica, lease_ms, keyspace,
                            broken_lease))
    report: Dict[str, Any] = {
        "shards": shards, "n": n, "lanes": lanes,
        "payload_bytes": payload_bytes, "timeout_ms": timeout_ms,
        "seed": seed, "keys": keys, "key_skew": key_skew,
        "read_frac": read_frac, "grade_mix": gm,
        "broken_lease": broken_lease,
        "mode": "process-per-shard", "device": device,
    }
    router = FleetRouter(proto=proto)
    history: List[Dict[str, Any]] = []
    try:
        await_ready(procs, router, addrs)
        client = KVClient(router, payload_bytes=payload_bytes,
                          lease_replica=lease_replica, keyspace=keyspace,
                          device=device)
        first = [True]

        def run_point(r):
            rep = kv_open_loop(
                client, r, ops, seed=seed, keys=keys, key_skew=key_skew,
                read_frac=read_frac, grade_mix=tuple(gm),
                value_bytes=value_bytes,
                warmup=warmup if first[0] else 0, deadline_s=deadline_s)
            first[0] = False
            history.extend(rep.pop("history"))
            return rep

        if rates:
            # the OP knee: last rate on the ladder that completed
            # >= min_completed of what it issued, kept the write p99
            # under the cap and lost nothing to router give-ups
            curve = []
            knee = None
            for r in rates:
                rep = run_point(r)
                ok = (rep["issued"] > 0
                      and rep["completed"]
                      >= min_completed * rep["issued"]
                      and (rep["write_p99_ms"] is None
                           or rep["write_p99_ms"] <= write_p99_cap_ms)
                      and rep["give_ups"] == 0)
                rep["within_slo"] = ok
                curve.append(rep)
                if ok:
                    knee = rep
                elif knee is not None:
                    break  # past the knee: the ladder only gets worse
            report["sweep"] = {
                "curve": curve,
                "knee_rate": knee["offered_rate"] if knee else None,
                "knee_ops": knee["achieved_ops"] if knee else None,
                "knee_dps": knee["achieved_dps"] if knee else None,
                "knee_write_p99_ms":
                    knee["write_p99_ms"] if knee else None,
            }
        else:
            report["open_loop"] = run_point(rate)
        report["client"] = client.status()
    finally:
        router.close()
        outs = report["servers"] = reap_shards(procs, idle_ms)
    report.update(shard_startup(outs, launched))
    # the overload invariant through the router, kv reads included:
    # every shed frame (writes AND queued lin reads) is NACK-accounted
    shed = sum(o.get("shed_frames", 0) for o in outs.values())
    nacks = sum(o.get("nacks_sent", 0) + o.get("nacks_suppressed", 0)
                for o in outs.values())
    report["shed_frames"] = shed
    report["nacks_accounted"] = nacks
    report["shed_accounting_ok"] = shed == nacks
    # the serving contract, checked post-hoc over everything the client
    # banked (every point of a sweep: one history, one total order)
    violations = check_history(history)
    report["checked_ops"] = len(history)
    report["violations"] = violations
    report["lin_ok"] = not violations
    if violations:
        report["artifact"] = dump_history_violation(
            dump_dir, history, violations,
            meta={"bench": {k: report[k] for k in
                            ("shards", "n", "lanes", "payload_bytes",
                             "seed", "read_frac", "broken_lease")}})
    if capacity_samples and report.get("sweep", {}).get("knee_ops"):
        report["capacity"] = bank_and_maybe_fit(
            capacity_samples, capacity_out, {
                "drivers": shards, "lanes": lanes, "n": n,
                "payload_bytes": payload_bytes,
                # the op knee IS the dps axis here: a read-heavy mix
                # serves ops the write path never sees, which is what
                # b_read/b_lease measure
                "knee_dps": report["sweep"]["knee_ops"],
                "knee_rate": report["sweep"]["knee_rate"],
                "knee_p99_ms": report["sweep"]["knee_write_p99_ms"],
                "read_frac": read_frac,
                "lease_frac": round(read_frac * gm[1], 4),
                "workload": "kv-mixed",
            })
    return report


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        # thin delegation: a kv shard IS a fleet shard with --kv forced
        # on (and the bytes-payload algo, which kv records require)
        from round_tpu_torch.apps.fleet import main as fleet_main

        rest = argv[1:]
        forced = ["--kv"] if "--kv" not in rest else []
        if "--algo" not in rest:
            forced += ["--algo", "lvb"]
        return fleet_main(["serve", *forced, *rest])

    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("serve", help="one kv shard (apps/fleet.py serve "
                                 "--kv --algo lvb; flags pass through)")

    bn = sub.add_parser("bench", help="spawn a kv fleet + mixed "
                                      "open-loop workload, checker-gated")
    bn.add_argument("--shards", type=int, default=2)
    bn.add_argument("--device", type=str, default=None,
                    help="where every shard's lanes run (default: cuda; "
                         "raises where there is no card)")
    bn.add_argument("--n", type=int, default=3)
    bn.add_argument("--lanes", type=int, default=16)
    bn.add_argument("--rate", type=float, default=100.0)
    bn.add_argument("--sweep", type=str, default=None, metavar="R1,R2,..",
                    help="rate ladder to the OP knee instead of one "
                         "point")
    bn.add_argument("--ops", type=int, default=400)
    bn.add_argument("--payload-bytes", type=int, default=256)
    bn.add_argument("--timeout-ms", type=int, default=200)
    bn.add_argument("--seed", type=int, default=0)
    bn.add_argument("--keys", type=int, default=64)
    bn.add_argument("--key-skew", type=float, default=0.8,
                    help="Zipf KEY popularity exponent (0 = uniform)")
    bn.add_argument("--read-frac", type=float, default=0.9)
    bn.add_argument("--grade-mix", type=str, default="0.2,0.4,0.4",
                    metavar="LIN,LEASE,STALE")
    bn.add_argument("--value-bytes", type=int, default=8)
    bn.add_argument("--warmup", type=int, default=4)
    bn.add_argument("--deadline-s", type=float, default=120.0)
    bn.add_argument("--admission-bytes-per-lane", type=int, default=0)
    bn.add_argument("--lease-replica", type=int, default=0)
    bn.add_argument("--lease-ms", type=float, default=0.0)
    bn.add_argument("--keyspace", type=int, default=4096)
    bn.add_argument("--broken-lease", action="store_true",
                    help="INJECT the stale-lease fixture — the bench "
                         "must FAIL with a banked kv-lin artifact")
    bn.add_argument("--dump-dir", type=str, default="kv_dumps")
    bn.add_argument("--capacity-samples", type=str, default=None,
                    help="append the measured op knee (with --sweep) "
                         "to this JSON sample bank, read axes included")
    bn.add_argument("--capacity-out", type=str, default=None,
                    help="with --capacity-samples: (re)fit and write "
                         "the read-aware capacity model here")

    ck = sub.add_parser("check", help="re-run the linearizability "
                                      "checker on a banked artifact")
    ck.add_argument("artifact", type=str)

    args = ap.parse_args(argv)
    if args.cmd == "check":
        from round_tpu_torch.kv.lin import replay_artifact

        out = replay_artifact(args.artifact)
        print(json.dumps(out))
        return 0 if out["matches_expected"] else 4

    rates = ([float(r) for r in args.sweep.split(",")]
             if args.sweep else None)
    gm = tuple(float(g) for g in args.grade_mix.split(","))
    if len(gm) != 3:
        ap.error("--grade-mix needs exactly three proportions")
    t0 = _time.perf_counter()
    report = run_kv_bench(
        shards=args.shards, n=args.n, lanes=args.lanes, rate=args.rate,
        rates=rates, ops=args.ops, payload_bytes=args.payload_bytes,
        timeout_ms=args.timeout_ms, seed=args.seed, keys=args.keys,
        key_skew=args.key_skew, read_frac=args.read_frac, grade_mix=gm,
        value_bytes=args.value_bytes, warmup=args.warmup,
        deadline_s=args.deadline_s,
        admission_bytes_per_lane=args.admission_bytes_per_lane,
        lease_replica=args.lease_replica, lease_ms=args.lease_ms,
        keyspace=args.keyspace, broken_lease=args.broken_lease,
        dump_dir=args.dump_dir, capacity_samples=args.capacity_samples,
        capacity_out=args.capacity_out, device=args.device)
    report["harness_wall_s"] = round(_time.perf_counter() - t0, 3)
    print(json.dumps(report))
    # a violating history is a FAILING bench — the artifact is banked
    return 0 if report["lin_ok"] else 4


if __name__ == "__main__":
    sys.exit(main())
