"""Fleet front-door CLI: serve one shard, bench a whole fleet, fit the
capacity model (docs/SERVING.md).

    # one shard process (the deployment unit: an n-replica lane-driver
    # group in client-serving mode, runtime/fleet.py DriverServer)
    python -m round_tpu_torch.apps.fleet serve --ports 7101,7102,7103 \
        --lanes 32 --admission-bytes-per-lane 262144

    # spawn a 4-driver fleet + open-loop loadgen, report the curve
    python -m round_tpu_torch.apps.fleet bench --drivers 4 --rate 300 \
        --instances 600

    # fit the capacity model from banked knee samples
    python -m round_tpu_torch.apps.fleet fit --samples knees.json \
        --out capacity.json

``run_fleet_bench`` is the programmatic core: apps/loadgen.py and
apps/host_perftest.py (--open-loop / --ab-fleet) drive it.

Port of round_tpu/apps/fleet.py.  Every shard's lanes run on ``--device``
(``device=``; the card by default, raising where there is none): a bench
spawns one shard process per driver, each with its own CUDA context on
the card.  A shard opens that context before it serves, so its start-up
time (``startup_s``, launch to ready) includes it; its summary carries
its peak GiB on the card.  A bench routes to a shard only once the shard
says it is serving (a ``{"ready": ...}`` line); round_tpu routes at once.
``serve --rv``/``--snap`` run every replica under runtime verification
and snapshot audits (a halt exits 3 with the shard's summary);
``serve --kv`` serves the shard as a replicated key-value store (kv/,
apps/kv.py).  ``autoscale``'s default
proof gate is ``rv/license.py``'s registry with its default prover (the
port's verifier_cli), which traces the suites' automata on the bench's
device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time as _time
from typing import Any, Dict, List, Optional


def _select_algo(algo: str, payload_bytes: int):
    from round_tpu_torch.apps.selector import select

    if algo in ("lvb", "lastvoting-bytes", "lastvotingbytes") \
            and payload_bytes <= 0:
        payload_bytes = 1024
    return select(algo, {"payload_bytes": payload_bytes}
                  if payload_bytes > 0 else {}), payload_bytes


def _aggregate_server_stats(stats: List[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for st in stats:
        for k in ("timeouts", "rounds_run", "malformed", "shed_frames",
                  "shed_instances", "nacks_sent", "nacks_suppressed",
                  "client_proposals", "client_streams"):
            out[k] = out.get(k, 0) + int(st.get(k, 0))
    return out


def _parse_tenant_weights(text: Optional[str]
                          ) -> Optional[Dict[int, float]]:
    """``"1:1,2:3"`` -> {1: 1.0, 2: 3.0} (the serve-side share table)."""
    if not text:
        return None
    out: Dict[int, float] = {}
    for pair in text.split(","):
        t, _, w = pair.partition(":")
        out[int(t)] = float(w) if w else 1.0
    return out


def serve_main(args) -> int:
    """One shard process: bind the given ports, serve until idle
    (round_tpu/apps/fleet.py::serve_main)."""
    import torch

    from round_tpu_torch.runtime.fleet import DriverServer
    from round_tpu_torch.utils.device import resolve_device

    if args.switch_interval_ms > 0:
        sys.setswitchinterval(args.switch_interval_ms / 1000.0)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # open the CUDA context before serving: the start-up clock
        # includes it, and no first proposal pays it
        torch.zeros((), device=device)
    algo, payload_bytes = _select_algo(args.algo, args.payload_bytes)
    ports = [int(p) for p in args.ports.split(",")]
    rv = None
    if args.rv:
        from round_tpu_torch.rv.dump import RvConfig

        rv = RvConfig(policy=args.rv, protocol=args.algo,
                      dump_dir=args.rv_dir or "rv_dumps")
    snap = None
    if args.snap:
        from round_tpu_torch.snap import SnapConfig

        snap = SnapConfig(
            policy=args.snap, protocol=args.algo,
            dump_dir=args.snap_dir or "snap_dumps",
            every_k=args.snap_every, bank_dir=args.snap_bank)
    kv = None
    if args.kv:
        from round_tpu_torch.kv.store import KvConfig

        kv = KvConfig(lease_ms=args.kv_lease_ms,
                      lease_replica=args.kv_lease_replica,
                      keyspace=args.kv_keyspace,
                      broken_lease=args.kv_broken_lease)
    # fixed ports: the bench parent announced them to the router
    srv = DriverServer(
        algo, n=len(ports), lanes=args.lanes,
        timeout_ms=args.timeout_ms, seed=args.seed,
        max_rounds=args.max_rounds, proto=args.proto,
        idle_ms=args.idle_ms, max_ms=args.max_ms,
        use_pump=not args.no_pump,
        admission_bytes_per_lane=args.admission_bytes_per_lane,
        shed_deadline_ms=args.shed_deadline_ms,
        adaptive_cap_ms=args.adaptive_cap_ms, ports=ports, rv=rv,
        snap=snap, kv=kv,
        tenants=_parse_tenant_weights(args.tenant_weights),
        tenant_bytes_per_lane=args.tenant_bytes_per_lane, device=device)
    srv.start()
    ready_at = _time.time()
    # the bench parent waits for this line before it routes to the shard
    print(json.dumps({"ready": args.shard, "ready_at": ready_at}),
          flush=True)
    rc = 0
    try:
        try:
            srv.join(timeout_s=args.max_ms / 1000.0 + 30.0)
        except RuntimeError:
            # an rv- or snap-halted replica surfaces through its summary
            # below; anything else keeps the loud failure
            if not ((rv is not None or snap is not None)
                    and srv.errors and all(
                        type(e).__name__ in ("RvViolation",
                                             "SnapViolation")
                        for e in srv.errors.values())):
                raise
            rc = 3
    finally:
        served = sorted(set().union(*[set(r) for r in srv.results]))
        agg = _aggregate_server_stats(srv.stats)
        summary = {
            "shard": args.shard,
            "n": srv.n,
            "lanes": args.lanes,
            "served_instances": len(served),
            # decided on ANY replica: one replica idling out must not
            # under-report a shard whose sibling decided the instance
            "decided_instances": sum(
                1 for i in served
                if any(r.get(i) is not None for r in srv.results)),
            **agg,
            # the port's own fields: where the lanes ran, when the shard
            # was ready to serve (the bench's start-up clock) and its peak
            "device": str(device),
            "ready_at": ready_at,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if device.type == "cuda" else None),
        }
        if args.tenant_weights:
            summary["tenants"] = srv.tenant_summary()
        if rv is not None:
            summary["rv"] = srv.rv_summary()
        if snap is not None:
            summary["snap"] = srv.snap_summary()
        if kv is not None:
            summary["kv"] = srv.kv_summary()
        print(json.dumps(summary))
    return rc


def _spawn_fleet(drivers: int, n: int, lanes: int, algo: str,
                 payload_bytes: int, timeout_ms: int, seed: int,
                 proto: str, idle_ms: int, max_ms: int,
                 admission_bytes_per_lane: int, shed_deadline_ms: int,
                 no_pump: bool, adaptive_cap_ms: int = 0,
                 tenant_weights: Optional[str] = None,
                 tenant_bytes_per_lane: int = 0, device: str = "cuda",
                 extra_argv=()):
    """D shard processes (the deployment shape), each on ``device``, +
    their address lists.  ``extra_argv`` goes to every shard's ``serve``
    (apps/kv.py passes the ``--kv`` flags)."""
    import subprocess
    import tempfile

    from round_tpu_torch.runtime.chaos import alloc_ports, cluster_env

    ports = alloc_ports(drivers * n)
    env = cluster_env()
    procs = []
    addrs = []
    for d in range(drivers):
        p = ports[d * n:(d + 1) * n]
        argv = [sys.executable, "-m", "round_tpu_torch.apps.fleet", "serve",
                "--shard", f"s{d}", "--ports",
                ",".join(str(x) for x in p),
                "--algo", algo, "--lanes", str(lanes),
                "--timeout-ms", str(timeout_ms),
                "--seed", str(seed + d), "--proto", proto,
                "--idle-ms", str(idle_ms), "--max-ms", str(max_ms),
                "--payload-bytes", str(payload_bytes),
                "--shed-deadline-ms", str(shed_deadline_ms),
                "--device", device]
        if admission_bytes_per_lane > 0:
            argv += ["--admission-bytes-per-lane",
                     str(admission_bytes_per_lane)]
        if adaptive_cap_ms > 0:
            argv += ["--adaptive-cap-ms", str(adaptive_cap_ms)]
        if tenant_weights:
            argv += ["--tenant-weights", tenant_weights]
            if tenant_bytes_per_lane > 0:
                argv += ["--tenant-bytes-per-lane",
                         str(tenant_bytes_per_lane)]
        if no_pump:
            argv += ["--no-pump"]
        argv += list(extra_argv)
        # stderr goes to an unbuffered temp FILE, not a pipe: the bench
        # only reaps output after the whole open-loop run, and a shard
        # logging more than the OS pipe buffer mid-run would block on
        # write() and wedge — read as a serving regression.  stdout
        # stays a pipe (one small summary JSON line at exit).
        errf = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=errf, text=True, env=env)
        proc._fleet_errf = errf
        procs.append(proc)
        addrs.append([("127.0.0.1", x) for x in p])
    return procs, addrs


def await_ready(procs, router, addrs) -> None:
    """Add each shard to ``router`` once it says it is serving: a
    proposal sent while its process still starts fails, and the
    transport's send pause can keep the shard unreached."""
    for d, (p, a) in enumerate(zip(procs, addrs)):
        line = p.stdout.readline()
        if not line.startswith('{"ready"'):
            raise RuntimeError(f"shard s{d} did not start: {line!r}")
        router.add_shard(f"s{d}", a)


def reap_shards(procs, idle_ms: int) -> Dict[int, Any]:
    """Collect each shard's one-line JSON summary (or its stderr tail);
    a wedged shard is killed and marked."""
    outs: Dict[int, Any] = {}
    for d, p in enumerate(procs):
        errf = getattr(p, "_fleet_errf", None)

        def err_tail():
            if errf is None:
                return ""
            try:
                errf.seek(0, 2)
                errf.seek(max(0, errf.tell() - 500))
                return errf.read()
            except Exception:  # noqa: BLE001 - diagnostics only
                return ""

        try:
            stdout, _ = p.communicate(timeout=idle_ms / 1000.0 + 60.0)
            if p.returncode == 0 and stdout.strip():
                outs[d] = json.loads(stdout.strip().splitlines()[-1])
            else:
                outs[d] = {"error": err_tail()}
        except Exception:  # noqa: BLE001 — wedged shard: kill + mark
            p.kill()
            try:
                p.communicate(timeout=10)
            except Exception:  # noqa: BLE001 - best-effort reap
                pass
            outs[d] = {"error": "wedged", "stderr": err_tail()}
        finally:
            if errf is not None:
                errf.close()
    return outs


def shard_startup(outs: Dict[int, Any], launched: float) -> Dict[str, Any]:
    """Each served shard's start-up seconds (launch to ready) and peak
    GiB on its device, from the summaries ``reap_shards`` collected."""
    up = {d: o for d, o in outs.items() if "ready_at" in o}
    return {"startup_s": {d: round(o["ready_at"] - launched, 3)
                          for d, o in up.items()},
            "peak_gib": {d: o.get("peak_gib") for d, o in up.items()}}


def bank_and_maybe_fit(samples_path: str, model_path: Optional[str],
                       sample: Dict[str, Any]) -> Dict[str, Any]:
    """Append one measured knee sample and re-fit the capacity model
    when enough samples exist (runtime/capacity.py needs >= 3 with real
    axis variation).  Returns {"banked": N, "fitted": bool, ...}."""
    from round_tpu_torch.runtime.capacity import CapacityFitError, fit_capacity

    samples: List[Dict[str, Any]] = []
    if os.path.exists(samples_path):
        with open(samples_path) as f:
            samples = json.load(f)
    samples.append(sample)
    tmp = samples_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(samples, f, indent=1)
    os.replace(tmp, samples_path)
    out: Dict[str, Any] = {"banked": len(samples), "fitted": False}
    if model_path:
        try:
            model = fit_capacity(samples)
            model.save(model_path)
            out.update(fitted=True, r2=model.r2,
                       b_drivers=model.b_drivers, b_lanes=model.b_lanes,
                       b_payload=model.b_payload)
        except CapacityFitError as e:
            out["fit_pending"] = str(e)
    return out


def run_fleet_bench(*, drivers: int = 4, rate: float = 100.0,
                    rates: Optional[List[float]] = None,
                    instances: int = 200, n: int = 3, lanes: int = 16,
                    algo: str = "otr", skew: float = 0.0,
                    payload_bytes: int = 0, timeout_ms: int = 300,
                    seed: int = 0, warmup: int = 8,
                    deadline_s: float = 180.0,
                    proto: str = "tcp", idle_ms: int = 3000,
                    admission_bytes_per_lane: int = 0,
                    shed_deadline_ms: int = 250,
                    no_pump: bool = False,
                    adaptive_cap_ms: int = 0,
                    capacity_out: Optional[str] = None,
                    capacity_samples: Optional[str] = None,
                    tenants: Optional[List[Dict[str, Any]]] = None,
                    tenant_bytes_per_lane: int = 64 << 10,
                    device=None,
                    ) -> Dict[str, Any]:
    """Spawn a ``drivers``-shard fleet (one OS process per shard, each
    on ``device``), drive it open-loop at ``rate`` (or walk the ``rates``
    ladder to the knee), collect the per-shard server summaries and gate
    the end-to-end NACK/shed accounting invariant
    (round_tpu/apps/fleet.py::run_fleet_bench).  The measurement core of
    host_perftest's --open-loop and --ab-fleet.  The report adds each
    shard's start-up seconds (launch to ready) and peak GiB."""
    from round_tpu_torch.apps.loadgen import (
        open_loop, open_loop_tenants, sweep,
    )
    from round_tpu_torch.runtime.fleet import FleetRouter
    from round_tpu_torch.utils.device import resolve_device

    device = str(resolve_device(device))
    _algo, payload_bytes = _select_algo(algo, payload_bytes)
    max_ms = int(deadline_s * 1000) + 120_000
    tenant_weights = None
    if tenants:
        tenant_weights = ",".join(
            f"{int(s['tenant'])}:{float(s.get('weight', 1.0))}"
            for s in sorted(tenants, key=lambda s: int(s["tenant"])))
    launched = _time.time()
    procs, addrs = _spawn_fleet(
        drivers, n, lanes, algo, payload_bytes, timeout_ms, seed, proto,
        idle_ms, max_ms, admission_bytes_per_lane, shed_deadline_ms,
        no_pump, adaptive_cap_ms=adaptive_cap_ms,
        tenant_weights=tenant_weights,
        tenant_bytes_per_lane=tenant_bytes_per_lane, device=device)
    report: Dict[str, Any] = {
        "drivers": drivers, "n": n, "lanes": lanes, "algo": algo,
        "payload_bytes": payload_bytes, "skew": skew,
        "timeout_ms": timeout_ms, "seed": seed,
        "mode": "process-per-shard", "device": device,
    }
    router = FleetRouter(proto=proto)
    try:
        await_ready(procs, router, addrs)
        start_id = [1]

        def run_point(r):
            rep = open_loop(
                router, r, instances, seed=seed, skew=skew,
                payload_bytes=payload_bytes, start_id=start_id[0],
                warmup=warmup if start_id[0] == 1 else 0,
                deadline_s=deadline_s)
            # advance past the HIGHEST id the point consumed: a skewed
            # plan scans ids beyond start+instances to fill hot-shard
            # pools, and re-proposing a consumed id raises
            start_id[0] = rep["last_id"] + 1
            return rep

        if tenants:
            report["tenant_mix"] = open_loop_tenants(
                router, tenants, seed=seed,
                payload_bytes=payload_bytes, warmup=warmup,
                deadline_s=deadline_s)
        elif rates:
            report["sweep"] = sweep(run_point, rates)
        else:
            report["open_loop"] = run_point(rate)
    finally:
        router.close()
        outs = report["servers"] = reap_shards(procs, idle_ms)
    report.update(shard_startup(outs, launched))
    # the shed invariant, extended THROUGH the router: every shed frame
    # any shard counted is NACK-accounted, fleet client traffic included
    shed = sum(o.get("shed_frames", 0) for o in outs.values())
    nacks = sum(o.get("nacks_sent", 0) + o.get("nacks_suppressed", 0)
                for o in outs.values())
    report["shed_frames"] = shed
    report["nacks_accounted"] = nacks
    report["shed_accounting_ok"] = shed == nacks
    if tenants:
        # the SAME invariant, metered per tenant: every tenant-shed
        # frame any shard counted is NACK-accounted to THAT tenant
        per: Dict[int, Dict[str, int]] = {}
        for o in outs.values():
            for tid, st in (o.get("tenants", {}) or {}) \
                    .get("by_tenant", {}).items():
                agg = per.setdefault(int(tid), {})
                for k, v in st.items():
                    agg[k] = agg.get(k, 0) + int(v)
        report["tenant_stats"] = per
        report["tenant_shed_accounting_ok"] = all(
            st.get("shed_frames", 0)
            == st.get("nacks_sent", 0) + st.get("nacks_suppressed", 0)
            for st in per.values())
    if capacity_samples and report.get("sweep", {}).get("knee_dps"):
        report["capacity"] = bank_and_maybe_fit(
            capacity_samples, capacity_out, {
                "drivers": drivers, "lanes": lanes, "n": n,
                "payload_bytes": payload_bytes,
                "knee_dps": report["sweep"]["knee_dps"],
                "knee_rate": report["sweep"]["knee_rate"],
                "knee_p99_ms": report["sweep"]["knee_p99_ms"],
            })
    return report


def run_autoscale_bench(*, algo: str = "lvb", n: int = 3,
                        lanes: int = 8, payload_bytes: int = 1024,
                        timeout_ms: int = 300, seed: int = 0,
                        min_shards: int = 1, max_shards: int = 4,
                        multipliers=(0.3, 1.0, 2.0, 3.0),
                        point_s: float = 5.0, slo_ms: float = 2000.0,
                        model_path: str = "CAPACITY_r02.json",
                        regions: int = 2,
                        admission_bytes_per_lane: int = 0,
                        tenants: Optional[List[Dict[str, Any]]] = None,
                        tenant_bytes_per_lane: int = 64 << 10,
                        license_registry=None,
                        license_solve: Optional[bool] = None,
                        warmup: int = 8, deadline_s: float = 60.0,
                        window_s: float = 1.5, dwell_steps: int = 2,
                        cooldown_s: float = 1.5,
                        step_interval_s: float = 0.25,
                        bank_out: Optional[str] = None,
                        capacity_samples: Optional[str] = None,
                        capacity_out: Optional[str] = None,
                        device=None,
                        ) -> Dict[str, Any]:
    """(round_tpu/apps/fleet.py::run_autoscale_bench; the port's shards
    run on ``device``, and so do the traces of the default
    ``license_registry``'s prover.)  The autoscale trajectory bench: an IN-PROCESS
    fleet under a
    FleetSupervisor, load swept as MULTIPLES of the fitted knee for the
    minimum fleet (0.3x -> 3x), every resize decision banked.

    The gate the fleet-autoscale soak rung reads: the SLO must be held
    by SCALING, not shedding — a point that stays inside the SLO while
    the router eats NACK-retries/give-ups AND the model says capacity
    existed at a fleet size the supervisor never reached is flagged
    ``slo_met_by_shedding`` and fails the rung.  With ``tenants``, each
    point offers the mix through the weighted-fair admission path and
    the per-tenant shed accounting invariant is gated too.

    In-SLO achieved rates per distinct fleet size, plus the
    supervisor's knee-drift samples, feed ``capacity.fit`` — the
    CAPACITY_r03 refit is exactly this bench's output."""
    from round_tpu_torch.apps.loadgen import open_loop, open_loop_tenants
    from round_tpu_torch.runtime.capacity import CapacityModel
    from round_tpu_torch.runtime.control import FleetSupervisor
    from round_tpu_torch.runtime.fleet import DriverServer, FleetRouter

    algo_obj, payload_bytes = _select_algo(algo, payload_bytes)
    model = CapacityModel.load(model_path)
    base = float(model.predict_dps(min_shards, lanes,
                                   payload_bytes=payload_bytes))
    weights = ({int(s["tenant"]): float(s.get("weight", 1.0))
                for s in tenants} if tenants else None)
    servers: Dict[str, DriverServer] = {}

    def spawn(name: str):
        srv = DriverServer(
            algo_obj, n=n, lanes=lanes, timeout_ms=timeout_ms,
            idle_ms=120_000,
            admission_bytes_per_lane=admission_bytes_per_lane,
            tenants=weights,
            tenant_bytes_per_lane=tenant_bytes_per_lane, device=device)
        servers[name] = srv
        return srv.start()

    def retire(name: str) -> None:
        srv = servers[name]
        srv.stop()
        srv.join(30)

    if license_registry is None:
        from round_tpu_torch.rv.license import ProofLicenseRegistry

        license_registry = ProofLicenseRegistry(device=device)
    router = FleetRouter()
    report: Dict[str, Any] = {
        "algo": algo, "n": n, "lanes": lanes,
        "payload_bytes": payload_bytes, "seed": seed,
        "min_shards": min_shards, "max_shards": max_shards,
        "slo_ms": slo_ms, "model": model_path,
        "base_knee_dps": round(base, 2),
        "multipliers": list(multipliers),
        "tenants": bool(tenants),
        "mode": "in-process-autoscale",
    }
    try:
        for d in range(min_shards):
            router.add_shard(f"s{d}", spawn(f"s{d}"),
                             region=f"r{d % max(1, regions)}")
        sup = FleetSupervisor(
            router, algo_name=algo, n=n, spawn=spawn, retire=retire,
            model=model, lanes=lanes, payload_bytes=payload_bytes,
            slo_ms=slo_ms, min_shards=min_shards, max_shards=max_shards,
            license_registry=license_registry,
            license_solve=license_solve,
            region_fn=lambda i: f"r{i % max(1, regions)}",
            window_s=window_s, dwell_steps=dwell_steps,
            cooldown_s=cooldown_s, step_interval_s=step_interval_s)
        # pre-warm the proof license OUTSIDE the measured windows: the
        # deployed posture is a nightly verifier_cli --cache run making
        # every live check a warm memo hit, not a mid-blast solver call
        report["license_prewarm"] = sup._license().to_json()
        points: List[Dict[str, Any]] = []
        start_id = 1
        for j, mult in enumerate(multipliers):
            rate = mult * base
            if tenants:
                # the sweep re-derives each tenant's offered rate from
                # the multiplier; a spec's own rate (CLI form) survives
                # as the RELATIVE split when no explicit frac is given
                fracs = [float(s.get("frac", s.get("rate", 1.0)))
                         for s in tenants]
                tot = sum(fracs) or 1.0
                specs = [dict(s, rate=rate * fracs[k] / tot,
                              instances=max(
                                  10, int(rate * fracs[k] / tot
                                          * point_s)))
                         for k, s in enumerate(tenants)]
                rep = open_loop_tenants(
                    router, specs, seed=seed + j,
                    payload_bytes=payload_bytes, start_id=start_id,
                    warmup=warmup if j == 0 else 0,
                    deadline_s=deadline_s, controller=sup)
                decided, total = rep["decided"], rep["instances"]
                p99 = max((t["p99_ms"] for t in rep["tenants"].values()
                           if t["p99_ms"] is not None), default=None)
            else:
                instances = max(20, int(rate * point_s))
                rep = open_loop(
                    router, rate, instances, seed=seed + j,
                    payload_bytes=payload_bytes, start_id=start_id,
                    warmup=warmup if j == 0 else 0,
                    deadline_s=deadline_s, controller=sup)
                decided, total = rep["decided"], rep["instances"]
                p99 = rep["p99_ms"]
            start_id = rep["last_id"] + 1
            rep["multiplier"] = mult
            rep["offered_dps"] = round(rate, 2)
            rep["drivers_at_end"] = len(sup.owned)
            rep["within_slo"] = (decided >= 0.9 * total
                                 and (p99 is None or p99 <= slo_ms))
            # the shed-not-scale smell: inside the SLO, but the router
            # absorbed overload (retries/give-ups) while the model says
            # a fleet size the supervisor never reached held this rate
            overloaded = (rep.get("give_ups", 0) > 0
                          or rep.get("nack_retries", 0) > 0.05 * total
                          or any(t.get("nacks", 0) > 0
                                 for t in rep.get("tenants", {})
                                 .values()))
            cap_existed = (rep["drivers_at_end"] < max_shards
                           and rate <= float(model.predict_dps(
                               max_shards, lanes,
                               payload_bytes=payload_bytes)))
            rep["slo_met_by_shedding"] = bool(
                rep["within_slo"] and overloaded and cap_existed)
            points.append(rep)
        report["points"] = points
        report["supervisor"] = sup.summary()
        report["slo_met_by_shedding"] = any(
            p["slo_met_by_shedding"] for p in points)
        report["slo_held"] = all(p["within_slo"] for p in points
                                 if p["multiplier"] <= 1.0)
        # live knee samples for the refit: best in-SLO achieved rate per
        # distinct fleet size + every knee-drift sample the supervisor
        # banked mid-blast
        by_drivers: Dict[int, Dict[str, Any]] = {}
        for p in points:
            if not p["within_slo"]:
                continue
            d = p["drivers_at_end"]
            # an in-SLO point far below the model's prediction for this
            # fleet size is just light load, not a knee observation —
            # banking it would teach the fit that capacity IS the
            # offered rate
            if p["offered_dps"] < 0.8 * float(model.predict_dps(
                    d, lanes, payload_bytes=payload_bytes)):
                continue
            dps = (p.get("achieved_dps")
                   or sum(t["achieved_dps"]
                          for t in p.get("tenants", {}).values()))
            if d not in by_drivers \
                    or dps > by_drivers[d]["knee_dps"]:
                by_drivers[d] = {
                    "drivers": d, "lanes": lanes, "n": n,
                    "payload_bytes": payload_bytes,
                    "knee_dps": dps, "knee_rate": p["offered_dps"],
                    "knee_p99_ms": p.get("p99_ms"),
                    "source": "autoscale_bench",
                }
        # knee-drift samples collapse to ONE live knee per fleet size
        # (the max achieved rate measured under breach at that size) so
        # a long breachy run cannot swamp the refit's sample bank
        drift: Dict[int, Dict[str, Any]] = {}
        for s in sup.knee_samples:
            d = int(s["drivers"])
            if d not in drift or s["knee_dps"] > drift[d]["knee_dps"]:
                drift[d] = {
                    "drivers": d, "lanes": lanes, "n": n,
                    "payload_bytes": payload_bytes,
                    "knee_dps": s["knee_dps"],
                    "read_frac": s.get("read_frac", 0.0),
                    "source": "knee_drift",
                }
        for d, s in drift.items():
            if d not in by_drivers \
                    or s["knee_dps"] > by_drivers[d]["knee_dps"]:
                by_drivers[d] = s
        report["live_samples"] = list(by_drivers.values())
        report["knee_drift_samples"] = len(sup.knee_samples)
    finally:
        router.close()
        for srv in servers.values():
            srv.stop()
        for srv in servers.values():
            try:
                srv.join(30)
            except RuntimeError:
                pass
        if tenants:
            per: Dict[int, Dict[str, int]] = {}
            for srv in servers.values():
                for tid, st in srv.tenant_summary() \
                        .get("by_tenant", {}).items():
                    agg = per.setdefault(int(tid), {})
                    for k, v in st.items():
                        agg[k] = agg.get(k, 0) + int(v)
            report["tenant_stats"] = per
            report["tenant_shed_accounting_ok"] = all(
                st.get("shed_frames", 0)
                == st.get("nacks_sent", 0)
                + st.get("nacks_suppressed", 0)
                for st in per.values())
    if capacity_samples and report.get("live_samples"):
        fit = None
        for s in report["live_samples"]:
            fit = bank_and_maybe_fit(capacity_samples, capacity_out, s)
        report["capacity"] = fit
    if bank_out:
        tmp = bank_out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, bank_out)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    sv = sub.add_parser("serve", help="one shard: an n-replica "
                                      "client-serving lane-driver group")
    sv.add_argument("--shard", type=str, default="s0",
                    help="stable shard name (the ring key)")
    sv.add_argument("--ports", type=str, required=True,
                    help="comma-separated replica ports; index = "
                         "replica id, count = group size n")
    sv.add_argument("--algo", type=str, default="otr")
    sv.add_argument("--lanes", type=int, default=16)
    sv.add_argument("--timeout-ms", type=int, default=300)
    sv.add_argument("--max-rounds", type=int, default=32)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--proto", choices=["tcp", "udp"], default="tcp")
    sv.add_argument("--idle-ms", type=int, default=8000,
                    help="exit after this long with no live lanes, no "
                         "queued proposals and no traffic")
    sv.add_argument("--max-ms", type=int, default=600_000)
    sv.add_argument("--payload-bytes", type=int, default=0)
    sv.add_argument("--admission-bytes-per-lane", type=int, default=0,
                    help="> 0 opts into admission control + NACK load "
                         "shedding on every replica")
    sv.add_argument("--shed-deadline-ms", type=int, default=250)
    sv.add_argument("--tenant-weights", type=str, default=None,
                    metavar="T:W,..",
                    help="per-tenant weighted-fair admission: "
                         "'1:1,2:3' gives tenant 2 a 3x byte share; "
                         "any listed tenant opts every replica into "
                         "TenantAdmission metering")
    sv.add_argument("--tenant-bytes-per-lane", type=int,
                    default=64 << 10,
                    help="the per-lane byte budget the tenant shares "
                         "divide (runtime/instances.py TenantAdmission)")
    sv.add_argument("--adaptive-cap-ms", type=int, default=0,
                    help="> 0 replaces the fixed --timeout-ms deadline "
                         "with EWMA+backoff adaptive deadlines capped "
                         "here (the deployed serving posture)")
    sv.add_argument("--no-pump", action="store_true")
    sv.add_argument("--switch-interval-ms", type=float, default=0.5)
    sv.add_argument("--device", type=str, default=None,
                    help="where the shard's lanes run (default: cuda; "
                         "raises where there is no card)")
    sv.add_argument("--rv", choices=["halt", "shed", "log"], default=None,
                    help="runtime verification for this shard's drivers "
                         "(rv/, docs/RUNTIME_VERIFICATION.md); a 'halt' "
                         "violation stops the shard (exit 3) with "
                         "clients failed fast via FLAG_TOO_LATE")
    sv.add_argument("--rv-dir", type=str, default=None, metavar="DIR",
                    help="violation dump directory (default rv_dumps/)")
    sv.add_argument("--snap", nargs="?", const="log", default=None,
                    choices=["halt", "shed", "log"], metavar="POLICY",
                    help="round-consistent snapshots for this shard "
                         "(snap/, docs/SNAPSHOTS.md): replica 0 "
                         "assembles and audits the cuts")
    sv.add_argument("--snap-every", type=int, default=4, metavar="K")
    sv.add_argument("--snap-dir", type=str, default=None, metavar="DIR",
                    help="snap violation dump directory (default "
                         "snap_dumps/)")
    sv.add_argument("--snap-bank", type=str, default=None, metavar="DIR",
                    help="bank assembled cuts as .snapcut files "
                         "(apps/snap_cli.py audits them offline)")
    sv.add_argument("--kv", action="store_true",
                    help="serve this shard as a replicated KV store "
                         "(kv/, docs/KV.md): decided lvb records apply "
                         "to a per-replica state machine, FLAG_READ "
                         "serves the three read grades, FLAG_TXN "
                         "validates transaction records")
    sv.add_argument("--kv-lease-replica", type=int, default=0,
                    help="which replica answers lease reads")
    sv.add_argument("--kv-lease-ms", type=float, default=0.0,
                    help="lease staleness bound (0 = derive from the "
                         "round deadline, rv.compile.lease_bound_ms)")
    sv.add_argument("--kv-keyspace", type=int, default=4096)
    sv.add_argument("--kv-broken-lease", action="store_true",
                    help="INJECT the stale-lease fixture: the lease "
                         "replica freezes each key's first answer and "
                         "never refuses — the kv/lin.py checker must "
                         "catch it (tests + docs only)")

    bn = sub.add_parser("bench", help="spawn a fleet + open-loop loadgen")
    bn.add_argument("--drivers", type=int, default=4)
    bn.add_argument("--device", type=str, default=None,
                    help="where every shard's lanes run (default: cuda)")
    bn.add_argument("--rate", type=float, default=100.0)
    bn.add_argument("--sweep", type=str, default=None,
                    metavar="R1,R2,..")
    bn.add_argument("--instances", type=int, default=200)
    bn.add_argument("--n", type=int, default=3)
    bn.add_argument("--lanes", type=int, default=16)
    bn.add_argument("--algo", type=str, default="otr")
    bn.add_argument("--skew", type=float, default=0.0)
    bn.add_argument("--payload-bytes", type=int, default=0)
    bn.add_argument("--timeout-ms", type=int, default=300)
    bn.add_argument("--seed", type=int, default=0)
    bn.add_argument("--warmup", type=int, default=8)
    bn.add_argument("--deadline-s", type=float, default=180.0)
    bn.add_argument("--admission-bytes-per-lane", type=int, default=0)
    bn.add_argument("--adaptive-cap-ms", type=int, default=0)
    bn.add_argument("--no-pump", action="store_true")
    bn.add_argument("--capacity-samples", type=str, default=None,
                    help="append the measured knee (with --sweep) to "
                         "this JSON sample bank")
    bn.add_argument("--capacity-out", type=str, default=None,
                    help="with --capacity-samples: (re)fit and write "
                         "the capacity model artifact here")

    bn.add_argument("--tenants", type=str, default=None,
                    metavar="SPEC;SPEC..",
                    help="per-tenant mix: 't=1,rate=50,inst=100,w=1,"
                         "skew=0;t=2,...' (apps/loadgen.py "
                         "parse_tenant_specs) — offers every tenant's "
                         "stream through the same router with weighted-"
                         "fair admission on the shards")
    bn.add_argument("--tenant-bytes-per-lane", type=int,
                    default=64 << 10)

    ft = sub.add_parser("fit", help="fit the capacity model from banked "
                                    "knee samples")
    ft.add_argument("--samples", type=str, required=True)
    ft.add_argument("--out", type=str, required=True)

    au = sub.add_parser(
        "autoscale",
        help="model-driven autoscale trajectory bench: an in-process "
             "fleet under a FleetSupervisor, load swept as multiples "
             "of the fitted knee, every resize licensed + banked")
    au.add_argument("--algo", type=str, default="lvb")
    au.add_argument("--device", type=str, default=None,
                    help="where every shard's lanes run (default: cuda)")
    au.add_argument("--n", type=int, default=3)
    au.add_argument("--lanes", type=int, default=8)
    au.add_argument("--payload-bytes", type=int, default=1024)
    au.add_argument("--min-shards", type=int, default=1)
    au.add_argument("--max-shards", type=int, default=4)
    au.add_argument("--multipliers", type=str, default="0.3,1,2,3",
                    help="offered load as multiples of the model's "
                         "knee for --min-shards")
    au.add_argument("--point-s", type=float, default=5.0)
    au.add_argument("--slo-ms", type=float, default=2000.0)
    au.add_argument("--model", type=str, default="CAPACITY_r02.json")
    au.add_argument("--regions", type=int, default=2)
    au.add_argument("--seed", type=int, default=0)
    au.add_argument("--timeout-ms", type=int, default=300)
    au.add_argument("--deadline-s", type=float, default=60.0)
    au.add_argument("--admission-bytes-per-lane", type=int, default=0)
    au.add_argument("--tenants", type=str, default=None,
                    metavar="SPEC;SPEC..")
    au.add_argument("--tenant-bytes-per-lane", type=int,
                    default=64 << 10)
    au.add_argument("--bank", type=str, default=None, metavar="FILE",
                    help="bank the full trajectory report (e.g. "
                         "AUTOSCALE_r01.json)")
    au.add_argument("--capacity-samples", type=str, default=None,
                    help="append the live knee samples to this bank")
    au.add_argument("--capacity-out", type=str, default=None,
                    help="refit target (e.g. CAPACITY_r03.json)")

    args = ap.parse_args(argv)
    if args.cmd == "serve":
        return serve_main(args)
    if args.cmd == "autoscale":
        from round_tpu_torch.apps.loadgen import parse_tenant_specs

        report = run_autoscale_bench(
            algo=args.algo, n=args.n, lanes=args.lanes,
            payload_bytes=args.payload_bytes,
            timeout_ms=args.timeout_ms, seed=args.seed,
            min_shards=args.min_shards, max_shards=args.max_shards,
            multipliers=[float(m)
                         for m in args.multipliers.split(",")],
            point_s=args.point_s, slo_ms=args.slo_ms,
            model_path=args.model, regions=args.regions,
            admission_bytes_per_lane=args.admission_bytes_per_lane,
            tenants=(parse_tenant_specs(args.tenants)
                     if args.tenants else None),
            tenant_bytes_per_lane=args.tenant_bytes_per_lane,
            deadline_s=args.deadline_s, bank_out=args.bank,
            capacity_samples=args.capacity_samples,
            capacity_out=args.capacity_out, device=args.device)
        print(json.dumps(report))
        return 0
    if args.cmd == "fit":
        from round_tpu_torch.runtime.capacity import fit_capacity

        with open(args.samples) as f:
            model = fit_capacity(json.load(f))
        model.save(args.out)
        print(json.dumps({"fitted": True, "r2": model.r2,
                          "n_samples": model.n_samples,
                          "b_drivers": model.b_drivers,
                          "b_lanes": model.b_lanes,
                          "b_payload": model.b_payload}))
        return 0
    from round_tpu_torch.apps.loadgen import parse_tenant_specs

    rates = ([float(r) for r in args.sweep.split(",")]
             if args.sweep else None)
    t0 = _time.perf_counter()
    report = run_fleet_bench(
        drivers=args.drivers, rate=args.rate, rates=rates,
        instances=args.instances, n=args.n, lanes=args.lanes,
        algo=args.algo, skew=args.skew,
        payload_bytes=args.payload_bytes, timeout_ms=args.timeout_ms,
        seed=args.seed, warmup=args.warmup, deadline_s=args.deadline_s,
        admission_bytes_per_lane=args.admission_bytes_per_lane,
        adaptive_cap_ms=args.adaptive_cap_ms,
        no_pump=args.no_pump, capacity_samples=args.capacity_samples,
        capacity_out=args.capacity_out,
        tenants=(parse_tenant_specs(args.tenants)
                 if args.tenants else None),
        tenant_bytes_per_lane=args.tenant_bytes_per_lane,
        device=args.device)
    report["harness_wall_s"] = round(_time.perf_counter() - t0, 3)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
