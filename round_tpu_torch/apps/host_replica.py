"""One replica OS process of a host deployment.

Reference parity: the multi-JVM integration scripts (test_scripts/testOTR.sh
spawning 4 `example.PerfTest2` JVMs over localhost with an XML peer list,
Runner.scala:26-32).  Usage:

    python -m round_tpu_torch.apps.host_replica --id 0 \
        --peers 127.0.0.1:7001,127.0.0.1:7002,127.0.0.1:7003 \
        --algo otr --value 3

Each process binds its slot of the peer list, runs the algorithm over the
native TCP transport (runtime/host.py), and prints one JSON line with its
decision — the shape the shell harness (and tests/test_host.py) collect.

Port of round_tpu/apps/host_replica.py.  A replica's rounds run on
``--device`` (default ``cuda``; where there is no card the replica
raises, it never carries on on the CPU), where round_tpu pins its
replicas to the CPU; the lane driver (``--lanes`` > 1) keeps its ``[L,
...]`` state there.  Runtime verification (``--rv``, ``--rv-dir``,
``--rv-gossip``; a halt exits 3), proof-licensed views
(``--view-license``; the registry's default prover traces on
``--device``), fuzz-artifact replays
(``--chaos-schedule``) and round-consistent snapshots (``--snap`` and
its tuning flags; a halt exits 3) run as round_tpu's do.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--id", type=int, required=True)
    ap.add_argument("--peers", type=str, default=None,
                    help="comma-separated host:port, index = node id "
                         "(or use --conf)")
    ap.add_argument("--conf", type=str, default=None,
                    help="XML/JSON config with the replica list (the "
                         "reference's shape, Config.scala:6-27); "
                         "<param name= value=/> entries are applied as "
                         "CLI defaults, explicit flags override them")
    ap.add_argument("--algo", type=str, default="otr")
    ap.add_argument("--device", type=str, default=None,
                    help="where the replica's rounds run (default: cuda; "
                         "raises where there is no card)")
    ap.add_argument("--value", type=int, default=0)
    ap.add_argument("--instance", type=int, default=1)
    ap.add_argument("--timeout-ms", type=int, default=300)
    ap.add_argument("--max-rounds", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--instances", type=int, default=1,
                    help="run this many consecutive instances (PerfTest2 "
                         "loop; one summary JSON line at the end)")
    ap.add_argument("--proto", choices=["tcp", "udp"], default="tcp",
                    help="native transport: tcp (framed/reconnecting) or "
                         "udp (the reference's default perf transport)")
    ap.add_argument("--no-send-when-catching-up", dest="send_when_catching_up",
                    action="store_false", default=True,
                    help="skip sending a round's messages when a peer was "
                         "already observed past it (RuntimeOptions."
                         "sendWhenCatchingUp=false)")
    ap.add_argument("--send-when-catching-up", dest="send_when_catching_up",
                    action="store_true",
                    help="re-enable catch-up sends (the default); the "
                         "paired positive flag exists so a --conf file "
                         "that sets the store_false param can be "
                         "overridden from the CLI — without it the "
                         "file's choice was one-way")
    ap.add_argument("--delay-first-send", dest="delay_first_send_ms",
                    type=int, default=-1, metavar="MS",
                    help="sleep MS before the first round's send "
                         "(RuntimeOptions.delayFirstSend; start-skew "
                         "injection)")
    ap.add_argument("--byzantine", dest="nbr_byzantine", type=int, default=0,
                    help="f for the byzantine catch-up rule: the round "
                         "catch-up target needs f+1 attestations "
                         "(RuntimeOptions.nbrByzantine)")
    ap.add_argument("-rt", "--rate", type=int, default=1,
                    help="instances in flight (PerfTest2 -rt; applies "
                         "with --instances > 1): >1 pipelines burned "
                         "round deadlines over the InstanceMux")
    ap.add_argument("--lanes", type=int, default=0, metavar="L",
                    help="lane-batched driver (runtime/lanes.py; applies "
                         "with --instances > 1): L concurrent instances "
                         "multiplexed onto the engine's lane axis — one "
                         "vmapped mega-step per round class advances all "
                         "of them, the Python loop only feeds mailboxes "
                         "in and decisions out.  0/1 = the per-instance "
                         "driver")
    ap.add_argument("--payload-bytes", type=int, default=0, metavar="B",
                    help="with --algo lvb: consensus over opaque uint8[B] "
                         "payloads (the KB-scale wire-fraction workload; "
                         "defaults to 1024 for --algo lvb)")
    ap.add_argument("--algo-opt", action="append", default=[],
                    metavar="K=V",
                    help="algorithm option (repeatable), passed to the "
                         "selector — e.g. after_decision=6 keeps decided "
                         "OTR replicas participating (the byz rv workout "
                         "needs the equivocation victim alive when the "
                         "honest camp's decision gossip lands); integer "
                         "values are parsed, everything else stays a "
                         "string")
    ap.add_argument("--value-schedule", choices=["mixed", "uniform"],
                    default="mixed",
                    help="per-instance proposal schedule: 'mixed' "
                         "(distinct per replica, the PerfTest2 shape) or "
                         "'uniform' (identical proposals, so by validity "
                         "the decision log is fault-schedule-invariant — "
                         "the chaos harness's diffable mode)")
    ap.add_argument("--chaos", type=str, default=None, metavar="SPEC",
                    help="wrap the transport in runtime/chaos.py's "
                         "FaultyTransport with this seeded fault plan, "
                         "e.g. 'drop=0.2,reorder=0.15,dup=0.05,seed=7' "
                         "(families mirror engine/scenarios.py)")
    ap.add_argument("--chaos-schedule", type=str, default=None,
                    metavar="ARTIFACT",
                    help="wrap the transport in FaultyTransport's "
                         "EXPLICIT-schedule mode: drop exactly the "
                         "(src,dst,round) links a fuzz schedule artifact "
                         "(round_tpu/fuzz, docs/FUZZING.md) names — the "
                         "deterministic replay of an engine finding on "
                         "the real wire (mutually exclusive with --chaos)")
    ap.add_argument("--checkpoint-dir", type=str, default=None,
                    help="durably checkpoint the decision list after "
                         "every instance (runtime/checkpoint.py atomic "
                         "npz+manifest+TSV) and RESUME from an existing "
                         "checkpoint — the crash-restart recovery path "
                         "(sequential --instances loop only)")
    ap.add_argument("--decision-log", type=str, default=None, metavar="PATH",
                    help="write the canonical instance\\tvalue decision "
                         "TSV here at exit (atomic write-then-rename; "
                         "the chaos harness's byte-diff artifact)")
    ap.add_argument("--adaptive-timeout", action="store_true",
                    help="replace the fixed --timeout-ms round deadline "
                         "with the EWMA + exponential-backoff estimator "
                         "(runtime/host.py AdaptiveTimeout; the adaptive "
                         "form of the reference's RuntimeOptions.timeout)")
    ap.add_argument("--timeout-cap-ms", type=int, default=2000,
                    help="adaptive-timeout backoff cap and initial "
                         "deadline (ignored without --adaptive-timeout)")
    ap.add_argument("--timeout-floor-ms", type=int, default=10,
                    help="adaptive-timeout lower bound (ignored without "
                         "--adaptive-timeout)")
    ap.add_argument("--trace", type=str, default=None, metavar="FILE",
                    help="record the round-level event trace "
                         "(round start/end, sends/recvs, timeouts, "
                         "adaptive-deadline moves, chaos faults, "
                         "decisions — round_tpu/obs/trace.py) and dump "
                         "it as JSONL at exit; merge replicas with "
                         "tools/trace_view.py")
    ap.add_argument("--metrics-json", type=str, default=None, metavar="FILE",
                    help="write the unified metrics registry snapshot "
                         "(round_tpu/obs/metrics.py: host.*/wire.*/"
                         "chaos.*/ckpt.* counters and histograms) as "
                         "JSON at exit")
    ap.add_argument("--view-change", type=str, default=None, metavar="SPEC",
                    help="scripted live membership changes "
                         "(runtime/view.py): comma-separated "
                         "INST:add=PORT / INST:remove=PID entries — after "
                         "data instance INST completes, propose that op "
                         "by consensus over the current view and rewire "
                         "the live peer table on decision "
                         "(DynamicMembership.scala:231-245 on the real "
                         "wire; every replica must carry the same script; "
                         "sequential --instances loop only)")
    ap.add_argument("--view-epoch", type=int, default=0,
                    help="initial view epoch (default 0).  A replica "
                         "ADDED by a view change is launched with the "
                         "post-add peer list, its new --id and the "
                         "post-add epoch")
    ap.add_argument("--join-wait", dest="join_wait_ms", type=int,
                    default=0, metavar="MS",
                    help="hold this replica SILENT until traffic stamped "
                         "with its epoch (or newer) arrives, up to MS — "
                         "the added replica's guard: it must not leak its "
                         "future-epoch view before the add is actually "
                         "decided by the current members")
    ap.add_argument("--reconnect-ms", type=int, default=200, metavar="MS",
                    help="period of the transport auto-reconnect loop "
                         "(dead peers re-dialed with per-peer exponential "
                         "backoff, runtime/transport.py start_reconnect); "
                         "0 disables — a dead peer is then only redialed "
                         "when a send to it happens")
    ap.add_argument("--wire", choices=["binary", "pickle"],
                    default="binary",
                    help="payload path (runtime/host.py HostRunner): "
                         "'binary' = the codec + frame-coalescing hot "
                         "path; 'pickle' = the pre-rebuild baseline "
                         "(receiving is always bilingual, so mixed "
                         "clusters interoperate)")
    ap.add_argument("--pump", dest="pump", action="store_true",
                    default=True,
                    help="use the NATIVE round pump when available "
                         "(native/transport.cpp rt_pump_*: the per-round "
                         "receive state machine runs in the transport "
                         "event loop, Python blocks in one wait per "
                         "round) — the default; falls back to the Python "
                         "pump automatically when the native surface is "
                         "missing")
    ap.add_argument("--no-pump", dest="pump", action="store_false",
                    help="pin the Python round pump (the A/B baseline "
                         "arm; also what chaos plans with receiver-side "
                         "families and --trace select automatically)")
    ap.add_argument("--switch-interval-ms", type=float, default=0.5,
                    metavar="MS",
                    help="sys.setswitchinterval for this replica process "
                         "(default 0.5 ms; 0 keeps CPython's 5 ms "
                         "default).  PERF_MODEL.md's host-wire roofline "
                         "measured the default interval costing a full "
                         "round of scheduler convoy per round on small "
                         "boxes — the perf harness sets 0.5 ms, and this "
                         "flag gives DEPLOYED replicas "
                         "the same behavior the A/Bs measure")
    ap.add_argument("--admission", nargs="?", const="on", default=None,
                    choices=["on", "auto"],
                    help="overload hardening (docs/HOST_FAULT_MODEL.md): "
                         "admission control + load shedding on the lane "
                         "loop — a per-driver byte budget (live lanes x "
                         "--admission-bytes-per-lane over stash + pending "
                         "+ native inbox backlog) defers, then sheds, new "
                         "instances, and refuses future-instance frames "
                         "with accounted FLAG_NACK replies instead of "
                         "queueing unboundedly.  '--admission auto' "
                         "derives the watermark AND the lane count from "
                         "a fitted capacity model (--capacity-model, "
                         "runtime/capacity.py; PERF_MODEL.md 'serving "
                         "capacity model') instead of fixed defaults")
    ap.add_argument("--capacity-model", type=str, default=None,
                    metavar="FILE",
                    help="fitted capacity-model artifact (apps/fleet.py "
                         "fit / bench --capacity-out) consumed by "
                         "--admission auto")
    ap.add_argument("--admission-slo-ms", type=float, default=1000.0,
                    help="latency SLO the auto-derived admission "
                         "watermark budgets for (Little's-law queue "
                         "bound; ignored without --admission auto)")
    ap.add_argument("--admission-bytes-per-lane", type=int,
                    default=256 << 10, metavar="BYTES",
                    help="admission high watermark per live lane "
                         "(default 256 KiB; shedding clears at half)")
    ap.add_argument("--shed-deadline-ms", type=int, default=2000,
                    metavar="MS",
                    help="how long an admission may stay deferred before "
                         "the instance is shed outright (default 2000)")
    ap.add_argument("--quarantine", action="store_true",
                    help="peer quarantine (runtime/health.py): score "
                         "peers by timeout contribution / malformed-frame "
                         "rate / reconnect churn, excuse quarantined "
                         "peers from the round-progress threshold, and "
                         "probe them back in with exponential backoff.  "
                         "NOT a membership change: their frames still "
                         "count when they arrive")
    ap.add_argument("--quarantine-after", type=float, default=3.0,
                    metavar="SCORE",
                    help="health score at which a peer is quarantined "
                         "(default 3.0 — three expired deadlines)")
    ap.add_argument("--probe-backoff-ms", type=int, default=1000,
                    metavar="MS",
                    help="initial quarantine probe backoff (doubles per "
                         "requarantine, capped at 60 s; default 1000)")
    ap.add_argument("--rv", choices=["halt", "shed", "log"], default=None,
                    help="runtime verification (round_tpu/rv, docs/"
                         "RUNTIME_VERIFICATION.md): fuse the protocol's "
                         "monitors into serving — 'halt' stops the "
                         "replica on a violation (exit 3, artifact path "
                         "in the summary), 'shed' retires the violating "
                         "instance undecided, 'log' records and keeps "
                         "serving")
    ap.add_argument("--rv-dir", type=str, default=None, metavar="DIR",
                    help="violation dump directory (default: "
                         "rv_dumps/ beside the cwd); artifacts are "
                         "fuzz/replay.py schedule JSON, replayable via "
                         "fuzz_cli replay")
    ap.add_argument("--rv-gossip", dest="rv_gossip",
                    action="store_true", default=False,
                    help="broadcast FLAG_DECISION on every local decide "
                         "so decided replicas cross-check each other's "
                         "values (adversarial posture; costs an n^2 "
                         "decision fan-out)")
    ap.add_argument("--snap", nargs="?", const="log", default=None,
                    choices=["halt", "shed", "log"], metavar="POLICY",
                    help="round-consistent snapshots (round_tpu/snap, "
                         "docs/SNAPSHOTS.md): sample round-boundary "
                         "state, assemble cuts at the collector replica "
                         "and audit the FULL-STATE invariants the live "
                         "rv monitors cannot see.  POLICY on a cut "
                         "violation: halt (exit 3, artifact path in the "
                         "summary) | shed (violating instance retired "
                         "undecided) | log (default)")
    ap.add_argument("--snap-every", type=int, default=4, metavar="K",
                    help="sample every Kth round per instance "
                         "(deterministically jittered; default 4)")
    ap.add_argument("--snap-collector", type=int, default=0,
                    metavar="PID",
                    help="replica that assembles and audits cuts "
                         "(default 0)")
    ap.add_argument("--snap-dir", type=str, default=None, metavar="DIR",
                    help="violation dump directory (default: "
                         "snap_dumps/); artifacts are fuzz/replay.py "
                         "schedule JSON, replayable via fuzz_cli replay")
    ap.add_argument("--snap-bank", type=str, default=None, metavar="DIR",
                    help="bank every assembled cut as a .snapcut file "
                         "for offline audit (apps/snap_cli.py)")
    ap.add_argument("--snap-budget", type=int, default=256 << 10,
                    metavar="BYTES",
                    help="sample-traffic byte budget per second (token "
                         "bucket; 0 = unbudgeted; default 256 KiB/s)")
    ap.add_argument("--snap-deadline-ms", type=int, default=3000,
                    metavar="MS",
                    help="how long a part-cut waits for missing "
                         "contributors before the fault-envelope "
                         "tolerance resolves it (default 3000)")
    ap.add_argument("--view-license", action="store_true",
                    help="proof-licensed reconfiguration (rv/license.py "
                         "+ docs/MEMBERSHIP.md): membership ops are "
                         "proposed only when the parameterized-proof "
                         "registry licenses the target group size — "
                         "refused otherwise")
    ap.add_argument("--view-unlicensed-ok", action="store_true",
                    help="escape hatch: an unlicensed membership op "
                         "proceeds anyway, with this replica flagged "
                         "DEGRADED (obs event + summary JSON)")
    ap.add_argument("--license-cache", type=str, default=None,
                    metavar="DIR",
                    help="VC-hash proof cache directory (verifier_cli "
                         "--cache)")
    ap.add_argument("--no-license-solve", dest="license_solve",
                    action="store_false", default=True,
                    help="never run the solver from the license gate — "
                         "cache hits only (a cold cache then refuses)")
    ap.add_argument("--linger-ms", type=int, default=0, metavar="MS",
                    help="after the loop completes, keep answering peers' "
                         "traffic with decision replies until the wire is "
                         "idle for MS (runtime/host.py serve_decisions) — "
                         "required by crash-restart recovery when a "
                         "restarted peer's catch-up outlives this "
                         "replica's own run")
    from round_tpu_torch.runtime.log import add_verbosity_flags, configure_from_args

    add_verbosity_flags(ap)
    argv_in = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv_in)
    conf_peers = None
    if args.conf:
        from round_tpu_torch.runtime.config import parse_config_file

        conf_peers, conf_args = parse_config_file(args.conf)
        # normalize '--name value' pairs for NO-VALUE flags (XML params
        # always carry a value attribute): truthy keeps the bare flag,
        # falsy drops it — without this, '--no-send-when-catching-up true'
        # would be a fatal unrecognized argument
        flag_actions = {s: a for a in ap._actions for s in a.option_strings
                        if a.nargs == 0}
        norm: list = []
        i = 0
        while i < len(conf_args):
            tok = conf_args[i]
            if tok in flag_actions and i + 1 < len(conf_args) \
                    and not conf_args[i + 1].startswith("--"):
                if conf_args[i + 1].lower() in ("true", "1", "yes", "on"):
                    norm.append(tok)
                i += 2
            else:
                norm.append(tok)
                i += 1
        # the reference precedence (RTOptions.processConFile,
        # RuntimeOptions.scala:94-102): file params first, explicit CLI
        # flags override.  parse_KNOWN_args: a shared deployment config
        # may carry params only the engine-side parser (runtime/config.py)
        # declares — warn and continue, like that parser does
        args, unknown = ap.parse_known_args(norm + argv_in)
        if unknown:
            print(f"warning: ignoring config params not used by "
                  f"host_replica: {unknown}", file=sys.stderr)
    configure_from_args(args)
    import torch

    from round_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    if args.switch_interval_ms > 0:
        # scheduler hardening (PERF_MODEL.md): bound the GIL convoy the
        # same way the perf harness does, so deployed replicas measure
        # like the A/Bs.  Applied before any worker thread starts.
        sys.setswitchinterval(args.switch_interval_ms / 1000.0)

    if args.trace or args.metrics_json:
        # dumped via atexit, not inline: both branches below and the
        # linger path share one exit point, and a failed run still leaves
        # whatever trace was recorded (SIGKILL loses it — that is the
        # crash model; the restarted replica records its own)
        import atexit

        from round_tpu_torch.obs.metrics import METRICS
        from round_tpu_torch.obs.trace import TRACE

        if args.trace:
            TRACE.enable(node=args.id)
            atexit.register(lambda: TRACE.dump_jsonl(args.trace))
        if args.metrics_json:
            atexit.register(lambda: METRICS.dump_json(args.metrics_json))

    from round_tpu_torch.apps.selector import select
    from round_tpu_torch.runtime.host import (
        AdaptiveTimeout, HostRunner, decision_scalar, instance_io,
    )
    from round_tpu_torch.runtime.transport import HostTransport
    from round_tpu_torch.rv.dump import RvViolation

    peers = {}
    if args.peers:
        for i, hp in enumerate(args.peers.split(",")):
            host, port = hp.rsplit(":", 1)
            peers[i] = (host, int(port))
    elif conf_peers:
        peers = {i: (h, p) for i, (h, p) in enumerate(conf_peers)}
    else:
        ap.error("provide --peers or a --conf file with <replica> entries")
    if args.algo in ("lvb", "lastvoting-bytes", "lastvotingbytes") \
            and args.payload_bytes <= 0:
        args.payload_bytes = 1024
    algo_opts = ({"payload_bytes": args.payload_bytes}
                 if args.payload_bytes > 0 else {})
    for kv in args.algo_opt:
        if "=" not in kv:
            ap.error(f"--algo-opt wants K=V, got {kv!r}")
        k, _, v = kv.partition("=")
        try:
            algo_opts[k] = int(v)
        except ValueError:
            algo_opts[k] = v
    algo = select(args.algo, algo_opts)

    adaptive = None
    if args.adaptive_timeout:
        # per-replica jitter seed: deadlines must NOT fire in lockstep
        adaptive = AdaptiveTimeout(cap_ms=args.timeout_cap_ms,
                                   floor_ms=args.timeout_floor_ms,
                                   seed=args.seed * 31 + args.id)

    def dump_decision_log(decisions):
        if args.decision_log:
            from round_tpu_torch.runtime.decisions import DecisionLog

            DecisionLog.from_values(decisions).dump_values_tsv(
                args.decision_log)

    if args.chaos and args.chaos_schedule:
        ap.error("--chaos and --chaos-schedule are mutually exclusive "
                 "(an explicit schedule replaces the hash families)")
    with HostTransport(args.id, peers[args.id][1], proto=args.proto) as raw_tr:
        tr = raw_tr
        if args.chaos:
            from round_tpu_torch.runtime.chaos import FaultPlan, FaultyTransport

            tr = FaultyTransport(raw_tr, FaultPlan.parse(args.chaos),
                                 n=len(peers))
        elif args.chaos_schedule:
            from round_tpu_torch.runtime.chaos import FaultyTransport

            tr = FaultyTransport.from_schedule_file(
                raw_tr, args.chaos_schedule)
            if tr.n != len(peers):
                ap.error(f"--chaos-schedule artifact is for n={tr.n} "
                         f"but the cluster has {len(peers)} replicas — "
                         "a partial replay would silently diverge from "
                         "the engine finding")
        admission = None
        health = None
        if args.admission:
            from round_tpu_torch.runtime.instances import AdmissionControl

            bytes_per_lane = args.admission_bytes_per_lane
            if args.admission == "auto":
                # model-derived admission: the watermark is the byte depth
                # one lane can drain within the SLO, and the lane count
                # (when not forced) the model's recommendation
                if not args.capacity_model:
                    ap.error("--admission auto needs --capacity-model "
                             "(fit one with apps/fleet.py bench --sweep "
                             "--capacity-samples/--capacity-out)")
                from round_tpu_torch.runtime.capacity import derive_admission

                derived = derive_admission(
                    args.capacity_model, len(peers), args.lanes,
                    payload_bytes=args.payload_bytes,
                    slo_ms=args.admission_slo_ms)
                bytes_per_lane = derived["bytes_per_lane"]
                if args.lanes <= 1:
                    args.lanes = derived["lanes"]
                print(f"admission auto: bytes_per_lane={bytes_per_lane} "
                      f"lanes={args.lanes} "
                      f"(model {args.capacity_model})", file=sys.stderr)
            admission = AdmissionControl(
                high_bytes_per_lane=bytes_per_lane,
                shed_deadline_ms=args.shed_deadline_ms)
            if args.lanes <= 1:
                print("warning: --admission applies to the lane loop "
                      "(--lanes L) only; the sequential loop admits one "
                      "instance at a time and cannot overload itself",
                      file=sys.stderr)
        if args.quarantine:
            if args.lanes <= 1 and args.rate > 1:
                # the pipelined mux has no health hook yet; a silent
                # all-zero quarantine summary would read as "ran,
                # nothing happened" rather than "not active"
                print("warning: --quarantine applies to the sequential "
                      "and lane loops only (ignored with --rate > 1)",
                      file=sys.stderr)
            else:
                from round_tpu_torch.runtime.health import PeerHealth

                health = PeerHealth(
                    len(peers), args.id,
                    quarantine_after=args.quarantine_after,
                    probe_backoff_ms=args.probe_backoff_ms)
        if args.reconnect_ms > 0:
            # churn tolerance: dead peers are re-dialed on a period with
            # backoff (a restarted replica is re-admitted with NO manual
            # redial; the reconnect loop runs on the raw transport — chaos
            # faults are per-frame schedules and persist across reconnects)
            raw_tr.start_reconnect(
                period_ms=args.reconnect_ms,
                on_reconnect=(health.note_reconnect if health is not None
                              else None))

        manager = None
        view_schedule = None
        if args.view_change is not None or args.view_epoch > 0 \
                or args.join_wait_ms > 0:
            from round_tpu_torch.runtime.membership import Group, Replica
            from round_tpu_torch.runtime.view import (
                View, ViewManager, epoch_behind, parse_view_schedule,
            )

            group = Group([Replica(i, h, p)
                           for i, (h, p) in sorted(peers.items())])
            license = None
            if args.view_license:
                from round_tpu_torch.rv.license import ProofLicenseRegistry

                license = ProofLicenseRegistry(
                    cache_dir=args.license_cache,
                    solve=args.license_solve, device=device)
            manager = ViewManager(
                args.id, View(args.view_epoch, group), tr,
                license=license, license_model=args.algo,
                unlicensed_ok=args.view_unlicensed_ok)
            if health is not None:
                # quarantine composes with membership changes: per-peer
                # scores remap through the renames, the (n-1)//3 envelope
                # re-derives for the new n (a view change is NOT an
                # amnesty — runtime/health.py resize)
                manager.on_change = health.resize_from_view

            view_schedule = (parse_view_schedule(args.view_change)
                             if args.view_change else {})
            if args.instances <= 1 or args.rate > 1:
                print("warning: --view-change/--view-epoch apply to the "
                      "sequential --instances loop only", file=sys.stderr)

        if manager is not None and args.join_wait_ms > 0:
            # the added replica's silent join: consume (and discard) wire
            # traffic until a frame stamped with OUR epoch or newer shows
            # the add has decided — only then may we send, or our
            # future-epoch stamps would leak the view to members still
            # voting on it.  FLAG_VIEW catch-ups are adopted directly.
            import time as _t

            from round_tpu_torch.runtime.oob import FLAG_NORMAL, FLAG_VIEW
            from round_tpu_torch.runtime.transport import wire_loads

            t_end = _t.monotonic() + args.join_wait_ms / 1000.0
            joined = False
            while _t.monotonic() < t_end and not joined:
                got = tr.recv(200)
                if got is None:
                    continue
                _sender, tag, raw = got
                if tag.flag == FLAG_VIEW:
                    try:
                        manager.adopt_wire(wire_loads(raw))
                    except Exception:  # noqa: BLE001 — garbage tolerated
                        pass
                    joined = True
                elif tag.flag == FLAG_NORMAL and not epoch_behind(
                        tag.call_stack & 0xFF, manager.epoch_byte):
                    joined = True
            if not joined:
                print(f"warning: --join-wait saw no epoch-"
                      f"{args.view_epoch} traffic in {args.join_wait_ms} "
                      f"ms; joining anyway", file=sys.stderr)
        rv_cfg = None
        if args.rv:
            from round_tpu_torch.rv.dump import RvConfig

            if args.lanes <= 1 and args.rate > 1:
                print("warning: --rv applies to the sequential and lane "
                      "loops only (ignored with --rate > 1)",
                      file=sys.stderr)
            else:
                rv_cfg = RvConfig(
                    policy=args.rv, protocol=args.algo,
                    dump_dir=args.rv_dir or "rv_dumps",
                    schedule_path=args.chaos_schedule,
                    gossip=args.rv_gossip)
        snap_cfg = None
        if args.snap:
            if args.instances <= 1 or (args.lanes <= 1 and args.rate > 1):
                # the snapshot driver rides the loop drivers; a single
                # instance has no derivable proposal row
                print("warning: --snap applies to the sequential and "
                      "lane --instances loops only (ignored here)",
                      file=sys.stderr)
            elif not 0 <= args.snap_collector < len(peers):
                ap.error(f"--snap-collector {args.snap_collector} is "
                         f"not a replica id of this n={len(peers)} "
                         "cluster")
            else:
                from round_tpu_torch.snap import SnapConfig

                snap_cfg = SnapConfig(
                    policy=args.snap, protocol=args.algo,
                    dump_dir=args.snap_dir or "snap_dumps",
                    schedule_path=args.chaos_schedule,
                    every_k=args.snap_every,
                    collector=args.snap_collector,
                    budget_bytes_per_s=args.snap_budget,
                    cut_deadline_ms=args.snap_deadline_ms,
                    bank_dir=args.snap_bank)
        if args.instances <= 1:
            inst_rv = None
            rv_runtime = None
            if rv_cfg is not None and args.chaos_schedule:
                # a schedule artifact names every replica's proposal, the
                # validity witness set, so a single-instance artifact
                # replay can run the monitors
                import numpy as np

                from round_tpu_torch.fuzz.replay import load_artifact
                from round_tpu_torch.rv.compile import (
                    HostRv, monitor_program,
                )
                from round_tpu_torch.rv.dump import RvRuntime

                program = monitor_program(algo, len(peers))
                if program is None:
                    print(f"warning: --rv requested but {args.algo} has "
                          "no decision plane to monitor; rv disabled",
                          file=sys.stderr)
                else:
                    values = [int(v) for v in
                              load_artifact(args.chaos_schedule)["values"]]
                    rv_runtime = RvRuntime(
                        rv_cfg, node=args.id, n=len(peers),
                        seed=args.seed, max_rounds=args.max_rounds,
                        device=device)
                    inst_rv = HostRv(
                        rv_runtime, program, args.instance,
                        np.asarray(values, dtype=np.int32), values,
                        gossip=rv_cfg.gossip)
            elif rv_cfg is not None:
                print("warning: --rv applies to the --instances loops "
                      "or a --chaos-schedule replay (ignored for a "
                      "plain single-instance run)",
                      file=sys.stderr)
            if args.checkpoint_dir:
                print("warning: --checkpoint-dir applies to the "
                      "sequential --instances loop only (ignored for a "
                      "single-instance run — this replica is NOT durable)",
                      file=sys.stderr)
            runner = HostRunner(
                algo, args.id, peers, tr, instance_id=args.instance,
                timeout_ms=args.timeout_ms, seed=args.seed,
                send_when_catching_up=args.send_when_catching_up,
                delay_first_send_ms=args.delay_first_send_ms,
                nbr_byzantine=args.nbr_byzantine,
                adaptive=adaptive, wire=args.wire, health=health,
                rv=inst_rv, device=device,
            )
            halt = None
            try:
                res = runner.run(
                    instance_io(algo, args.value),
                    max_rounds=args.max_rounds,
                )
            except RvViolation as e:
                if inst_rv is None:
                    raise
                halt, res = e, None
            d = (decision_scalar(res.decision)
                 if res is not None and res.decided else None)
            dump_decision_log([d])
            if args.linger_ms > 0:
                from round_tpu_torch.runtime.host import serve_decisions

                serve_decisions(
                    tr, [d], idle_ms=args.linger_ms,
                    adoptable=getattr(algo, "payload_bytes", None) is None)
            summary = {
                "id": args.id,
                "decided": res is not None and res.decided,
                "decision": d,  # null when undecided (never state garbage)
                # list form so harnesses consume single- and multi-instance
                # runs uniformly (host_perftest.measure_processes)
                "decisions": [d],
                "decided_instances": 1 if d is not None else 0,
                "rounds": res.rounds_run if res is not None else 0,
                "dropped": (res.dropped_messages
                            if res is not None else tr.dropped),
                "timeouts": res.timeouts if res is not None else 0,
                "timeout_trajectory": (res.timeout_trajectory
                                       if res is not None else []),
                # the RESOLVED catch-up send policy (conf + CLI override),
                # so deployments and tests can audit boolean precedence
                "send_when_catching_up": args.send_when_catching_up,
            }
            if args.chaos_schedule:
                summary["chaos_injected"] = tr.injected
            if rv_runtime is not None:
                rv_stats: dict = {}
                rv_runtime.fill_stats(rv_stats)
                summary["rv"] = _rv_summary(rv_cfg, rv_stats, halt)
            print(json.dumps(summary))
            return 0

        # PerfTest2 loop: consecutive instances via the shared helper
        # (runtime.host.run_instance_loop); --value offsets the
        # deterministic value schedule, --instance is single-run-only
        import time

        from round_tpu_torch.runtime.host import (
            run_instance_loop, run_instance_loop_pipelined,
        )

        if args.instance != 1:
            print("warning: --instance is ignored with --instances > 1 "
                  "(instances are numbered 1..N)", file=sys.stderr)
        started_at = time.time()
        t0 = time.perf_counter()
        stats: dict = {}
        halt = None
        if args.lanes > 1:
            from round_tpu_torch.runtime.lanes import run_instance_loop_lanes

            if manager is not None:
                print("warning: --view-change/--view-epoch apply to the "
                      "sequential loop only (ignored with --lanes)",
                      file=sys.stderr)
            if (not args.send_when_catching_up
                    or args.delay_first_send_ms > 0):
                print("warning: --no-send-when-catching-up / "
                      "--delay-first-send apply to the sequential loop "
                      "only (ignored with --lanes)", file=sys.stderr)
            try:
                decisions = run_instance_loop_lanes(
                    algo, args.id, peers, tr, args.instances,
                    lanes=args.lanes, timeout_ms=args.timeout_ms,
                    seed=args.seed, base_value=args.value,
                    max_rounds=args.max_rounds,
                    nbr_byzantine=args.nbr_byzantine,
                    value_schedule=args.value_schedule,
                    adaptive=adaptive, stats_out=stats,
                    checkpoint_dir=args.checkpoint_dir, wire=args.wire,
                    use_pump=args.pump, admission=admission,
                    health=health, rv=rv_cfg, snap=snap_cfg,
                    device=device,
                )
            except RvViolation as e:
                halt, decisions = e, [None] * args.instances
        elif args.rate > 1:
            if (not args.send_when_catching_up
                    or args.delay_first_send_ms > 0):
                print("warning: --no-send-when-catching-up / "
                      "--delay-first-send apply to the sequential loop "
                      "only (ignored with --rate > 1)", file=sys.stderr)
            if args.checkpoint_dir:
                print("warning: --checkpoint-dir applies to the "
                      "sequential loop only (ignored with --rate > 1)",
                      file=sys.stderr)
            decisions = run_instance_loop_pipelined(
                algo, args.id, peers, tr, args.instances, rate=args.rate,
                timeout_ms=args.timeout_ms, seed=args.seed,
                base_value=args.value, max_rounds=args.max_rounds,
                nbr_byzantine=args.nbr_byzantine,
                value_schedule=args.value_schedule,
                adaptive=adaptive, stats_out=stats, wire=args.wire,
                pump=args.pump, device=device,
            )
        else:
            try:
                decisions = run_instance_loop(
                    algo, args.id, peers, tr, args.instances,
                    timeout_ms=args.timeout_ms, seed=args.seed,
                    base_value=args.value, max_rounds=args.max_rounds,
                    send_when_catching_up=args.send_when_catching_up,
                    delay_first_send_ms=args.delay_first_send_ms,
                    nbr_byzantine=args.nbr_byzantine,
                    value_schedule=args.value_schedule,
                    adaptive=adaptive, stats_out=stats,
                    checkpoint_dir=args.checkpoint_dir,
                    view=manager, view_schedule=view_schedule,
                    wire=args.wire, pump=args.pump, health=health,
                    rv=rv_cfg, snap=snap_cfg, device=device,
                )
            except RvViolation as e:
                halt, decisions = e, [None] * args.instances
        wall = time.perf_counter() - t0
        dump_decision_log(decisions)
        if args.linger_ms > 0 and not (manager is not None
                                       and manager.removed):
            from round_tpu_torch.runtime.host import serve_decisions

            serve_decisions(
                tr, decisions, idle_ms=args.linger_ms,
                adoptable=getattr(algo, "payload_bytes", None) is None)
        ok = sum(1 for d in decisions if d is not None)
        summary = {
            "id": args.id,
            "instances": args.instances,
            "decided_instances": ok,
            "wall_s": round(wall, 3),
            "decisions_per_sec": round(ok / wall, 2) if wall > 0 else 0.0,
            "decisions": decisions,
            "dropped": tr.dropped,
            "timeouts": stats.get("timeouts", 0),
            "timeout_trajectory": stats.get("timeout_trajectory", []),
            # the port's own fields: where the rounds ran, how many, when
            # the loop started (the harness's start-up clock) and the
            # card's peak
            "device": str(device),
            "rounds_run": stats.get("rounds_run", 0),
            "loop_started_at": started_at,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                         if device.type == "cuda" else None),
        }
        if args.chaos or args.chaos_schedule:
            summary["chaos_injected"] = tr.injected
        snap_halt = halt if type(halt).__name__ == "SnapViolation" else None
        if rv_cfg is not None:
            summary["rv"] = _rv_summary(
                rv_cfg, stats, None if snap_halt is not None else halt)
        if snap_cfg is not None:
            summary["snap"] = {
                "policy": snap_cfg.policy,
                "collector": snap_cfg.collector,
                "samples": stats.get("snap_samples", 0),
                "sample_bytes": stats.get("snap_sample_bytes", 0),
                "skipped": stats.get("snap_skipped", 0),
                "cuts": stats.get("snap_cuts", 0),
                "partial_cuts": stats.get("snap_partial_cuts", 0),
                "cuts_audited": stats.get("snap_cuts_audited", 0),
                "checks": stats.get("snap_checks", 0),
                "violations": stats.get("snap_violations", []),
                "divergences": stats.get("snap_divergences", []),
                "artifacts": stats.get("snap_artifacts", []),
            }
            if snap_halt is not None:
                summary["snap"]["halted"] = str(snap_halt)
                if snap_halt.artifact:
                    summary["snap"]["artifacts"] = sorted(
                        set(summary["snap"]["artifacts"])
                        | {snap_halt.artifact})
        if admission is not None:
            summary["overload"] = {
                "shed_instances": stats.get("shed_instances", 0),
                "shed_frames": stats.get("shed_frames", 0),
                "nacks_sent": stats.get("nacks_sent", 0),
                "nacks_suppressed": stats.get("nacks_suppressed", 0),
                "backpressure_events": raw_tr.backpressure_events,
            }
        if health is not None:
            summary["quarantine"] = stats.get(
                "quarantine", health.summary())
        if manager is not None:
            # the view trajectory: final epoch/n/id, the applied op
            # history, and a clean `removed` marker — the harness's
            # DynamicMembership.scala parity surface
            summary.update({
                "view_epoch": manager.epoch,
                "view_n": manager.view.n,
                "view_id": manager.my_id,
                "view_history": [
                    {"epoch": e, "op": "add" if k == 1 else "remove",
                     "arg": a} for e, k, a in manager.history],
                "removed": manager.removed,
                "reconnects": raw_tr.reconnects,
            })
            if manager.license is not None:
                # the licensing verdict surface: refused ops and whether
                # this replica serves DEGRADED
                summary["view_refused"] = manager.refusals
                summary["view_degraded"] = manager.degraded
        print(json.dumps(summary))
        if halt is not None:
            return 3
    return 0


def _rv_summary(rv_cfg, stats: dict, halt) -> dict:
    """The summary's ``rv`` block from the drivers' fill_stats shape."""
    out = {
        "policy": rv_cfg.policy,
        "checks": stats.get("rv_checks", 0),
        "violations": stats.get("rv_violations", []),
        "artifacts": stats.get("rv_artifacts", []),
    }
    if halt is not None:
        out["halted"] = str(halt)
        if halt.artifact:
            out["artifacts"] = sorted(set(out["artifacts"])
                                      | {halt.artifact})
    return out


if __name__ == "__main__":
    sys.exit(main())
