"""Open-loop load generator for the fleet serving tier (docs/SERVING.md).

Every pre-fleet A/B was CLOSED-loop: drivers pace themselves, so a
saturated system just takes longer and queueing collapse is invisible.
Production traffic is open-loop — arrivals do not slow down because the
server is behind — so this generator offers load on a Poisson clock
(seeded, reproducible), with optional HOT-KEY SKEW (a Zipf-weighted
shard choice: consistent hashing spreads sequential ids near-uniformly,
and skew is exactly what a real key distribution does to that) and
KB-scale payloads (the LastVotingBytes workload: the proposal IS the
uint8[B] vector, so the client leg carries the bytes too).

Per-request decision latency is measured propose→decision at the
router; the report carries p50/p95/p99, offered vs achieved throughput,
and the full NACK/give-up accounting.  ``sweep`` walks a rate ladder to
the KNEE — the last offered rate still served without falling behind —
which is the measurement the capacity model (runtime/capacity.py) fits.

    python -m round_tpu_torch.apps.loadgen --drivers 2 --rate 200 \
        --instances 400            # spawns a fleet, offers 200 req/s

Programmatic use (apps/fleet.py bench): ``open_loop(router, ...)`` drives
an existing FleetRouter.

Port of round_tpu/apps/loadgen.py: arrival plans and payload vectors are
round_tpu's (numpy's seeded generator, byte for byte), and so are the
key-value workload's (``plan_kv_ops``).  The fleet's shard processes run
on ``--device`` (the card by default).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time as _time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from round_tpu_torch.obs.metrics import METRICS

_H_ARRIVAL_LAG = METRICS.histogram(
    "fleet.arrival_lag_ms", (1, 2, 5, 10, 20, 50, 100, 500), unit="ms")


def payload_value(value: int, payload_bytes: int) -> np.ndarray:
    """The deterministic uint8[B] proposal vector for the byte-payload
    workload — the SAME expansion as runtime.host.instance_io, so a
    fleet client and a scheduled driver proposing `value` agree byte for
    byte (equal values ⇒ equal vectors ⇒ validity pins the decision)."""
    vec = ((np.arange(payload_bytes, dtype=np.int64) * 131
            + value * 31 + 7) % 256)
    return vec.astype(np.uint8)


def plan_arrivals(rate: float, instances: int, seed: int,
                  skew: float, ring, start_id: int = 1
                  ) -> List[Dict[str, Any]]:
    """The offered-load schedule: Poisson arrival times (exponential
    inter-arrivals at ``rate``/s) over ``instances`` NEW instance ids.

    ``skew`` > 0 biases WHICH SHARD each arrival lands on with Zipf
    weights ``(rank+1)^-skew`` over the ring's shards (rank order is the
    sorted shard-name order, deterministic): each arrival draws a shard,
    then takes the next unused instance id that hashes to it — hot-key
    pressure without fabricating ids outside the 16-bit space.  skew=0
    keeps natural sequential placement."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), size=instances))
    shards = ring.shards
    if skew <= 0 or len(shards) <= 1:
        ids = list(range(start_id, start_id + instances))
        return [{"t": float(t[i]), "inst": ids[i]}
                for i in range(instances)]
    w = np.array([(r + 1) ** -skew for r in range(len(shards))])
    w /= w.sum()
    choice = rng.choice(len(shards), size=instances, p=w)
    need = {s: int((choice == i).sum()) for i, s in enumerate(shards)}
    pools: Dict[str, List[int]] = {s: [] for s in shards}
    cand = start_id
    from round_tpu_torch.runtime.fleet import MAX_FLEET_INSTANCE

    while any(len(pools[s]) < need[s] for s in shards):
        if cand > MAX_FLEET_INSTANCE:
            raise ValueError(
                f"instance id space exhausted planning {instances} "
                f"skewed arrivals from {start_id}")
        owner = ring.owner(cand)
        if owner in pools and len(pools[owner]) < need[owner]:
            pools[owner].append(cand)
        cand += 1
    cursors = {s: 0 for s in shards}
    out = []
    for i in range(instances):
        s = shards[int(choice[i])]
        out.append({"t": float(t[i]), "inst": pools[s][cursors[s]],
                    "shard": s})
        cursors[s] += 1
    return out


def open_loop(router, rate: float, instances: int, *, seed: int = 0,
              skew: float = 0.0, payload_bytes: int = 0,
              value_base: int = 0, start_id: int = 1,
              warmup: int = 0, deadline_s: float = 120.0,
              value_fn: Optional[Callable[[int], Any]] = None,
              controller=None) -> Dict[str, Any]:
    """Offer ``instances`` arrivals at ``rate``/s through ``router`` and
    report per-request decision latency + offered-vs-achieved
    throughput.  ``warmup`` proposals (closed-loop, excluded from the
    stats) absorb the fleet's jit compiles so the measured window sees a
    warm fabric — the same discipline as every perf_ab harness.

    ``controller`` (a runtime.control.FleetSupervisor, or anything with
    ``maybe_step()``) is polled once per pump iteration: the autoscale
    loop observes the SAME router the load flows through, so a resize
    lands mid-blast exactly as it would in production."""
    if value_fn is None:
        if payload_bytes > 0:
            def value_fn(i):
                return payload_value(value_base + i, payload_bytes)
        else:
            def value_fn(i):
                return value_base + i
    next_id = start_id
    base = {k: getattr(router, k) for k in
            ("nack_retries", "give_ups", "reproposals", "dup_decisions")}
    carried_inflight = len(router._inflight)
    if warmup > 0:
        for i in range(warmup):
            router.propose(next_id, value_fn(next_id))
            next_id += 1
        router.drain(deadline_s)
    plan = plan_arrivals(rate, instances, seed, skew, router.ring,
                         start_id=next_id)
    measured = [p["inst"] for p in plan]
    t0 = _time.monotonic()
    i = 0
    t_hard = t0 + deadline_s
    while (i < len(plan) or router._inflight) \
            and _time.monotonic() < t_hard:
        now = _time.monotonic() - t0
        while i < len(plan) and plan[i]["t"] <= now:
            lag_ms = (now - plan[i]["t"]) * 1000.0
            _H_ARRIVAL_LAG.observe(lag_ms)
            router.propose(plan[i]["inst"], value_fn(plan[i]["inst"]))
            i += 1
        if i < len(plan):
            gap_ms = max(0.0, (plan[i]["t"] - (_time.monotonic() - t0))
                         * 1000.0)
            router.pump(int(min(20.0, gap_ms)))
        else:
            router.pump(20)
        if controller is not None:
            controller.maybe_step()
    wall = _time.monotonic() - t0
    lats = sorted(router.latency_ms[m] for m in measured
                  if m in router.latency_ms)
    decided = sum(1 for m in measured
                  if router.results.get(m) is not None)
    resolved_t = [router.decide_t[m] for m in measured
                  if m in router.decide_t]
    span = (max(resolved_t) - t0) if resolved_t else wall

    def pct(p):
        if not lats:
            return None
        return round(lats[min(len(lats) - 1,
                              int(math.ceil(p / 100.0 * len(lats))) - 1)],
                     2)

    return {
        "offered_rate": rate,
        "instances": instances,
        "decided": decided,
        "undecided": sum(1 for m in measured
                         if router.results.get(m) is None
                         and m in router.results),
        "unresolved": sum(1 for m in measured
                          if m not in router.results),
        "achieved_dps": round(decided / span, 2) if span > 0 else 0.0,
        "wall_s": round(wall, 3),
        "p50_ms": pct(50), "p95_ms": pct(95), "p99_ms": pct(99),
        "mean_ms": round(float(np.mean(lats)), 2) if lats else None,
        "skew": skew,
        "payload_bytes": payload_bytes,
        "seed": seed,
        "warmup": warmup,
        # id-space high watermark: a skewed plan consumes ids past
        # start_id + instances to fill hot-shard pools — the NEXT
        # measurement point must start above everything proposed here
        "last_id": max([next_id - 1] + measured),
        # per-POINT deltas (the router's counters are lifetime totals —
        # a sweep's later points must not inherit earlier overload) +
        # the backlog this point started with, so a curve reader can
        # see when a point serviced a previous point's leftovers
        "carried_inflight": carried_inflight,
        "nack_retries": router.nack_retries - base["nack_retries"],
        "give_ups": router.give_ups - base["give_ups"],
        "reproposals": router.reproposals - base["reproposals"],
        "dup_decisions": router.dup_decisions - base["dup_decisions"],
    }


def sweep(make_run, rates: List[float], *, p99_cap_ms: float = 2000.0,
          min_served: float = 0.9) -> Dict[str, Any]:
    """Walk a rate ladder to the knee: ``make_run(rate)`` measures one
    open-loop point (a fresh id range per point), and the KNEE is the
    last rate that (a) decided >= ``min_served`` of its offered
    instances and (b) kept p99 under ``p99_cap_ms``.  Returns the full
    curve — the capacity model fits knees, the soak rung banks curves."""
    curve = []
    knee = None
    for rate in rates:
        rep = make_run(rate)
        ok = (rep["decided"] >= min_served * rep["instances"]
              and (rep["p99_ms"] is None or rep["p99_ms"] <= p99_cap_ms))
        rep["within_slo"] = ok
        curve.append(rep)
        if ok:
            knee = rep
        elif knee is not None:
            break  # past the knee: the ladder only gets worse
    return {
        "curve": curve,
        "knee_rate": knee["offered_rate"] if knee else None,
        "knee_dps": knee["achieved_dps"] if knee else None,
        "knee_p99_ms": knee["p99_ms"] if knee else None,
    }


# -- per-tenant workload mixes (docs/SERVING.md control plane) --------------

def plan_tenant_arrivals(tenants: List[Dict[str, Any]], seed: int,
                         ring, start_id: int = 1
                         ) -> List[Dict[str, Any]]:
    """A merged multi-tenant offered-load schedule.  Each spec in
    ``tenants`` is ``{"tenant": id, "rate": r, "instances": n}`` plus
    optional ``"skew"`` (per-tenant Zipf hot-shard exponent — a hot
    tenant is usually hot on a FEW shards, not everywhere) and
    ``"weight"`` (carried through to the report, not used here).

    Instance-id ranges are DISJOINT per tenant: each tenant plans from a
    sequential cursor starting where the previous tenant's plan stopped
    consuming ids (a skewed plan eats ids past start+instances to fill
    hot-shard pools), so two tenants never collide on an id and the
    per-tenant decision accounting stays exact.  Arrival clocks are
    independent per tenant (seed + tenant*7919), merged by time."""
    merged: List[Dict[str, Any]] = []
    cursor = int(start_id)
    for spec in sorted(tenants, key=lambda s: int(s["tenant"])):
        tid = int(spec["tenant"])
        if not 0 <= tid <= 0xFF:
            raise ValueError(f"tenant id {tid} outside 0..255")
        plan = plan_arrivals(float(spec["rate"]),
                             int(spec["instances"]),
                             seed + tid * 7919,
                             float(spec.get("skew", 0.0)),
                             ring, start_id=cursor)
        for p in plan:
            p["tenant"] = tid
        merged.extend(plan)
        cursor = max([cursor - 1] + [p["inst"] for p in plan]) + 1
    merged.sort(key=lambda p: (p["t"], p["inst"]))
    return merged


def open_loop_tenants(router, tenants: List[Dict[str, Any]], *,
                      seed: int = 0, payload_bytes: int = 0,
                      value_base: int = 0, start_id: int = 1,
                      warmup: int = 0, deadline_s: float = 120.0,
                      controller=None) -> Dict[str, Any]:
    """The multi-tenant open_loop: every tenant's Poisson stream rides
    the SAME router (and the same pump loop — contention is the point),
    each propose stamped with its tenant id so the drivers' weighted-
    fair admission (runtime/instances.py TenantAdmission) can meter it.
    The report carries per-tenant p50/p95/p99, offered-vs-achieved, and
    the NACK/give-up split from the router's per-tenant counters — the
    isolation gate reads exactly this."""
    next_id = start_id
    if warmup > 0:
        for _ in range(warmup):
            if payload_bytes > 0:
                router.propose(next_id,
                               payload_value(value_base + next_id,
                                             payload_bytes))
            else:
                router.propose(next_id, value_base + next_id)
            next_id += 1
        router.drain(deadline_s)
    plan = plan_tenant_arrivals(tenants, seed, router.ring,
                                start_id=next_id)
    by_tenant: Dict[int, List[int]] = {}
    for p in plan:
        by_tenant.setdefault(p["tenant"], []).append(p["inst"])
    nacks0 = dict(router.tenant_nacks)
    gups0 = dict(router.tenant_give_ups)
    t0 = _time.monotonic()
    i = 0
    t_hard = t0 + deadline_s
    while (i < len(plan) or router._inflight) \
            and _time.monotonic() < t_hard:
        now = _time.monotonic() - t0
        while i < len(plan) and plan[i]["t"] <= now:
            p = plan[i]
            _H_ARRIVAL_LAG.observe((now - p["t"]) * 1000.0)
            if payload_bytes > 0:
                val = payload_value(value_base + p["inst"],
                                    payload_bytes)
            else:
                val = value_base + p["inst"]
            router.propose(p["inst"], val, tenant=p["tenant"])
            i += 1
        if i < len(plan):
            gap_ms = max(0.0, (plan[i]["t"] - (_time.monotonic() - t0))
                         * 1000.0)
            router.pump(int(min(20.0, gap_ms)))
        else:
            router.pump(20)
        if controller is not None:
            controller.maybe_step()
    wall = _time.monotonic() - t0
    specs = {int(s["tenant"]): s for s in tenants}

    def pct(lats, p):
        if not lats:
            return None
        return round(lats[min(len(lats) - 1,
                              int(math.ceil(p / 100.0 * len(lats))) - 1)],
                     2)

    per_tenant: Dict[int, Dict[str, Any]] = {}
    for tid, ids in sorted(by_tenant.items()):
        lats = sorted(router.latency_ms[m] for m in ids
                      if m in router.latency_ms)
        decided = sum(1 for m in ids
                      if router.results.get(m) is not None)
        resolved_t = [router.decide_t[m] for m in ids
                      if m in router.decide_t]
        span = (max(resolved_t) - t0) if resolved_t else wall
        per_tenant[tid] = {
            "weight": float(specs[tid].get("weight", 1.0)),
            "offered_rate": float(specs[tid]["rate"]),
            "instances": len(ids),
            "decided": decided,
            "achieved_dps": round(decided / span, 2) if span > 0
            else 0.0,
            "p50_ms": pct(lats, 50), "p95_ms": pct(lats, 95),
            "p99_ms": pct(lats, 99),
            "nacks": router.tenant_nacks.get(tid, 0)
            - nacks0.get(tid, 0),
            "give_ups": router.tenant_give_ups.get(tid, 0)
            - gups0.get(tid, 0),
        }
    all_ids = [p["inst"] for p in plan]
    return {
        "tenants": per_tenant,
        "instances": len(plan),
        "decided": sum(t["decided"] for t in per_tenant.values()),
        "wall_s": round(wall, 3),
        "payload_bytes": payload_bytes,
        "seed": seed,
        "last_id": max([next_id - 1] + all_ids),
    }


def parse_tenant_specs(text: str) -> List[Dict[str, Any]]:
    """Parse the CLI tenant-mix grammar: ';'-separated groups of
    key=value pairs — ``t=0,rate=50,inst=100,w=1,skew=0``.  Keys:
    t (tenant id), rate (req/s), inst (instances), w (weight, default
    1), skew (Zipf exponent, default 0)."""
    out: List[Dict[str, Any]] = []
    for group in text.split(";"):
        group = group.strip()
        if not group:
            continue
        kv = {}
        for pair in group.split(","):
            k, _, v = pair.partition("=")
            kv[k.strip()] = v.strip()
        try:
            out.append({"tenant": int(kv["t"]),
                        "rate": float(kv["rate"]),
                        "instances": int(kv["inst"]),
                        "weight": float(kv.get("w", 1.0)),
                        "skew": float(kv.get("skew", 0.0))})
        except KeyError as e:
            raise ValueError(
                f"tenant spec {group!r} missing key {e}") from None
    if not out:
        raise ValueError("empty tenant spec")
    return out


# -- the KV serving workload (kv/, docs/KV.md) ------------------------------

def plan_kv_ops(rate: float, ops: int, seed: int, *, keys: int = 64,
                key_skew: float = 0.8, read_frac: float = 0.9,
                grade_mix=(0.2, 0.4, 0.4), key_prefix: bytes = b"k"
                ) -> List[Dict[str, Any]]:
    """A YCSB-style mixed open-loop trace: Poisson arrivals at ``rate``,
    Zipf KEY skew (weights ``(rank+1)^-key_skew`` over ``keys`` hot-
    ranked keys — real key popularity, not just hot shards),
    ``read_frac`` reads with ``grade_mix`` = (lin, lease, stale)
    proportions.  Deterministic per seed, like plan_arrivals: the plan
    is round_tpu's for the same seed (round_tpu/apps/loadgen.py::
    plan_kv_ops)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1.0 / max(rate, 1e-9), size=ops))
    w = np.array([(r + 1) ** -max(key_skew, 0.0) for r in range(keys)])
    w /= w.sum()
    kidx = rng.choice(keys, size=ops, p=w)
    is_read = rng.random(ops) < read_frac
    gm = np.asarray(grade_mix, dtype=float)
    gm = gm / gm.sum()
    grades = rng.choice(3, size=ops, p=gm)
    plan: List[Dict[str, Any]] = []
    for i in range(ops):
        key = key_prefix + str(int(kidx[i])).encode()
        if is_read[i]:
            plan.append({"t": float(t[i]), "op": "r", "key": key,
                         "grade": int(grades[i])})
        else:
            plan.append({"t": float(t[i]), "op": "w", "key": key})
    return plan


def kv_open_loop(client, rate: float, ops: int, *, seed: int = 0,
                 keys: int = 64, key_skew: float = 0.8,
                 read_frac: float = 0.9, grade_mix=(0.2, 0.4, 0.4),
                 value_bytes: int = 8, warmup: int = 4,
                 deadline_s: float = 120.0) -> Dict[str, Any]:
    """Offer a mixed KV trace through a kv.client.KVClient and report
    per-grade read latency beside the write/decision accounting.  The
    returned ``history`` slice (measured window only) is the
    linearizability checker's input — the bench gates on it
    (round_tpu/apps/loadgen.py::kv_open_loop)."""
    router = client.router
    for i in range(warmup):
        client.put(b"_warm" + str(i).encode(), b"w")
    client.drain(deadline_s)
    hist0 = len(client.history)
    base = {k: getattr(router, k) for k in
            ("nack_retries", "give_ups", "reproposals")}
    lease_served0 = client.lease_served
    fallbacks0 = client.lease_fallbacks
    plan = plan_kv_ops(rate, ops, seed, keys=keys, key_skew=key_skew,
                       read_frac=read_frac, grade_mix=grade_mix)
    t0 = _time.monotonic()
    t_hard = t0 + deadline_s
    i = 0
    while (i < len(plan) or client._writes or client._reads) \
            and _time.monotonic() < t_hard:
        now = _time.monotonic() - t0
        while i < len(plan) and plan[i]["t"] <= now:
            p = plan[i]
            _H_ARRIVAL_LAG.observe((now - p["t"]) * 1000.0)
            if p["op"] == "w":
                val = bytes(payload_value(i, value_bytes))
                client.put(p["key"], val)
            else:
                client.read(p["key"], p["grade"])
            i += 1
        if i < len(plan):
            gap_ms = max(0.0, (plan[i]["t"]
                               - (_time.monotonic() - t0)) * 1000.0)
            client.pump(int(min(20.0, gap_ms)))
        else:
            client.pump(20)
    wall = _time.monotonic() - t0
    history = client.history[hist0:]

    def pct(lats, p):
        if not lats:
            return None
        lats = sorted(lats)
        return round(lats[min(len(lats) - 1,
                              int(math.ceil(p / 100.0 * len(lats))) - 1)],
                     2)

    reads = {"lin": [], "lease": [], "stale": []}
    writes = []
    for op in history:
        ms = (op["t1"] - op["t0"]) * 1000.0
        if op["op"] == "r" and op["ok"]:
            reads[op["grade"]].append(ms)
        elif op["op"] == "w" and op["ok"]:
            writes.append(ms)
    decided = len(writes)
    return {
        "offered_rate": rate,
        "ops": ops,
        "issued": i,
        "completed": len(history),
        "writes_decided": decided,
        "achieved_dps": round(decided / wall, 2) if wall > 0 else 0.0,
        "achieved_ops": round(len(history) / wall, 2) if wall > 0
        else 0.0,
        "wall_s": round(wall, 3),
        "write_p50_ms": pct(writes, 50), "write_p99_ms": pct(writes, 99),
        "read_grades": {
            g: {"count": len(ls), "p50_ms": pct(ls, 50),
                "p95_ms": pct(ls, 95), "p99_ms": pct(ls, 99)}
            for g, ls in reads.items()},
        "lease_served": client.lease_served - lease_served0,
        "lease_fallbacks": client.lease_fallbacks - fallbacks0,
        "read_frac": read_frac,
        "grade_mix": list(grade_mix),
        "key_skew": key_skew,
        "keys": keys,
        "seed": seed,
        "nack_retries": router.nack_retries - base["nack_retries"],
        "give_ups": router.give_ups - base["give_ups"],
        "reproposals": router.reproposals - base["reproposals"],
        "history": history,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--drivers", type=int, default=2,
                    help="fleet size: one DriverServer process per "
                         "driver (apps/fleet.py serve)")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="offered load, requests/sec (Poisson)")
    ap.add_argument("--sweep", type=str, default=None, metavar="R1,R2,..",
                    help="rate ladder to the knee instead of one point")
    ap.add_argument("--instances", type=int, default=200)
    ap.add_argument("--device", type=str, default=None,
                    help="where every shard's lanes run (default: cuda; "
                         "raises where there is no card)")
    ap.add_argument("--n", type=int, default=3,
                    help="replicas per shard (consensus group size)")
    ap.add_argument("--lanes", type=int, default=16)
    ap.add_argument("--algo", type=str, default="otr")
    ap.add_argument("--skew", type=float, default=0.0,
                    help="Zipf hot-shard exponent (0 = uniform)")
    ap.add_argument("--payload-bytes", type=int, default=0,
                    help="propose uint8[B] vectors (LastVotingBytes "
                         "workload; selects --algo lvb)")
    ap.add_argument("--timeout-ms", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--deadline-s", type=float, default=180.0)
    ap.add_argument("--tenants", type=str, default=None,
                    metavar="SPEC;SPEC..",
                    help="per-tenant mix instead of one stream: "
                         "'t=1,rate=50,inst=100,w=1,skew=0;t=2,...' — "
                         "tenant ids ride FLAG_PROPOSE tags, shards "
                         "meter each tenant under weighted-fair "
                         "admission, the report splits p50/p95/p99 and "
                         "offered-vs-achieved per tenant")
    ap.add_argument("--tenant-bytes-per-lane", type=int,
                    default=64 << 10)
    ap.add_argument("--capacity-out", type=str, default=None,
                    metavar="FILE",
                    help="with --sweep: bank the measured knee into "
                         "FILE.samples.json and (re)fit the capacity "
                         "model into FILE once >= 3 samples with real "
                         "axis variation exist (runtime/capacity.py; "
                         "--admission auto reads FILE)")
    args = ap.parse_args(argv)
    from round_tpu_torch.apps.fleet import run_fleet_bench

    rates = ([float(r) for r in args.sweep.split(",")]
             if args.sweep else None)
    report = run_fleet_bench(
        drivers=args.drivers, rate=args.rate, rates=rates,
        instances=args.instances, n=args.n, lanes=args.lanes,
        algo=args.algo, skew=args.skew,
        payload_bytes=args.payload_bytes, timeout_ms=args.timeout_ms,
        seed=args.seed, warmup=args.warmup, deadline_s=args.deadline_s,
        capacity_samples=(args.capacity_out + ".samples.json"
                          if args.capacity_out else None),
        capacity_out=args.capacity_out,
        tenants=(parse_tenant_specs(args.tenants)
                 if args.tenants else None),
        tenant_bytes_per_lane=args.tenant_bytes_per_lane,
        device=args.device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
