"""Throughput benchmark driver: windows of concurrent consensus instances.

Port of round_tpu/apps/perftest.py.  Reference parity: example/
PerfTest2.scala:19-110 + test_scripts/runPerfTest2.sh — a rate-limited
stream of instances (Semaphore of `-rt` in-flight), per-decision TSV log,
algorithm picked with `-a`.  Here the "rate" is the InstancePool window
(one batched device program per step, runtime/instances.py).

CLI:  python -m round_tpu_torch.apps.perftest -a otr -n 16 -rt 32 \\
          --instances 256 --log decisions.tsv [--stat] [--device cpu]

The run is on the card unless ``--device`` names another.  Keys follow the
port's rule (runtime/instances.py::instance_key): round_tpu's
``PRNGKey(seed)`` is the pair ``(0, seed)``, and the window that ends with
instance ``iid`` runs under ``instance_key(key, iid)``.
"""

from __future__ import annotations

import sys
import time

import torch

from round_tpu_torch.apps.selector import select
from round_tpu_torch.engine import scenarios
from round_tpu_torch.models.common import consensus_io
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime.config import Options, parse_args
from round_tpu_torch.runtime.decisions import DecisionLog
from round_tpu_torch.runtime.instances import InstancePool, instance_key
from round_tpu_torch.runtime.stats import stats
from round_tpu_torch.utils.device import resolve_device


def run(
    opts: Options,
    n_instances: int = 64,
    p_drop: float = 0.05,
    device=None,
    log: DecisionLog = None,
) -> dict:
    """Run `n_instances` consensus instances, `opts.rate` at a time, on
    ``device``.  Returns {decided, total, wall_s, decisions_per_s}; the
    decisions land in ``log`` (a fresh DecisionLog unless one is given)."""
    dev = resolve_device(device)
    algo = select(opts.algorithm)
    sampler = scenarios.omission(opts.n, p_drop, device=dev)
    pool = InstancePool(
        algo, opts.n, sampler, max_phases=opts.max_phases, window=opts.rate,
        device=dev,
    )
    log = DecisionLog() if log is None else log
    key = (0, opts.seed)

    if TRACE.enabled or stats.enabled:
        # per-round HO-mask statistics of a schedule the run ACTUALLY
        # executes (the shared reducer of engine.fast.mix_ho_stats):
        # instance 0 runs its sampler under the key the pool derives,
        # instance_key(window_key, 0) with window_key = instance_key(key,
        # last submitted iid of the first window)
        from round_tpu_torch.engine.fast import sampler_ho_stats

        first_window_end = min(opts.rate, n_instances) - 1
        k_inst0 = instance_key(instance_key(key, first_window_end), 0)
        st = sampler_ho_stats(sampler, k_inst0, opts.max_phases)
        METRICS.gauge("engine.ho_density_mean").set(
            float(st["density"].mean()))
        METRICS.gauge("engine.ho_heard_min").set(
            float(st["heard_min"].min()))
        if TRACE.enabled:
            TRACE.emit("ho_stats", rounds=opts.max_phases,
                       density=[round(float(d), 4) for d in st["density"]],
                       heard_mean=[round(float(h), 2)
                                   for h in st["heard_mean"]],
                       heard_min=[int(h) for h in st["heard_min"]])

    # every instance proposes the same values: one io on the host, which
    # the pool stacks per window and copies to the device in one copy
    io = consensus_io(torch.arange(opts.n, dtype=torch.int32) % 5)
    t0 = time.monotonic()
    for iid in range(n_instances):
        with stats.timer("perftest.submit"):
            pool.submit(iid, io)
        if (iid + 1) % opts.rate == 0 or iid == n_instances - 1:
            with stats.timer("perftest.window"):
                for res in pool.run_pending(instance_key(key, iid)):
                    stats.counter("perftest.instances")
                    if res.value is not None:
                        rnd = int(res.decided_round[res.decided.argmax()])
                        ok = log.record(res.instance_id, rnd, int(res.value))
                        if not ok:
                            raise AssertionError(
                                f"agreement violation at {res.instance_id}")
                        if TRACE.enabled:
                            TRACE.emit("decision", inst=res.instance_id,
                                       round=rnd, decided=True,
                                       value=int(res.value))
    wall = time.monotonic() - t0
    METRICS.gauge("engine.decisions_per_sec").set(
        len(log) / wall if wall > 0 else 0.0)
    if opts.log_file:
        log.dump_tsv(opts.log_file)
    return {
        "decided": len(log),
        "total": n_instances,
        "wall_s": wall,
        "decisions_per_s": len(log) / wall if wall > 0 else 0.0,
    }


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    import argparse

    extra = argparse.ArgumentParser(add_help=False)
    extra.add_argument("--instances", type=int, default=64)
    extra.add_argument("--p-drop", type=float, default=0.05)
    extra.add_argument("--device", type=str, default=None,
                       help="torch device (default: cuda)")
    extra.add_argument("--trace", type=str, default=None, metavar="FILE",
                       help="dump the engine-side event trace (decisions, "
                            "per-round HO-mask stats) as JSONL at exit")
    extra.add_argument("--metrics-json", type=str, default=None,
                       metavar="FILE",
                       help="write the unified metrics snapshot (engine "
                            "run timer, perftest counters) as JSON at exit")
    ns, rest = extra.parse_known_args(argv)
    opts = parse_args(rest)
    if opts.stats:
        stats.enable()
    elif ns.metrics_json:
        # --metrics-json implies collection (no atexit report): the
        # perftest.* timers are stats-gated
        stats.enable(report_at_exit=False)
    if ns.trace:
        TRACE.enable()
    out = run(opts, n_instances=ns.instances, p_drop=ns.p_drop,
              device=ns.device)
    if ns.trace:
        TRACE.dump_jsonl(ns.trace)
    if ns.metrics_json:
        METRICS.dump_json(ns.metrics_json)
    print(out)
    return out


if __name__ == "__main__":
    main()
