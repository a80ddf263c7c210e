"""Layered configuration: defaults < config file < CLI < programmatic.

Port of round_tpu/runtime/config.py, unchanged (pure Python).

Reference parity: psync.runtime.RuntimeOptions / RTOptions
(runtime/RuntimeOptions.scala:22-116) and the XML config parser
(runtime/Config.scala:6-27).  The reference declares options once and feeds
the XML file's <parameters> back through the same CLI parser
(RTOptions.processConFile, RuntimeOptions.scala:94-102); this keeps that
architecture: one dataclass of declared options, one parser, and file
contents re-applied through it.

Both the reference's XML shape (<config><peers><replica .../></peers>
<parameters><param name=... value=.../></parameters></config>) and plain
JSON are accepted.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional, Sequence, Tuple

from round_tpu_torch.runtime.membership import Group, Replica


@dataclasses.dataclass
class Options:
    """All engine/runtime knobs (AlgorithmOptions + RuntimeOptions merged —
    the reference splits them at RuntimeOptions.scala:22-67)."""

    # identity & group (reference: -id, peers list)
    id: int = 0
    peers: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    # algorithm options (AlgorithmOptions, RuntimeOptions.scala:22-37)
    timeout_ms: int = 10            # default round timeout (:33)
    max_phases: int = 64            # scan bound on phases
    nbr_byzantine: int = 0          # f for byzantine variants (:49)
    # NB the catch-up send policy (RuntimeOptions.scala:31-32,
    # sendWhenCatchingUp/delayFirstSend) lives on the HOST runner
    # (runtime/host.py HostRunner kwargs + apps/host_replica.py CLI
    # flags), not here: the lockstep engine path this record serves has
    # no per-replica send loop to apply it to

    # engine scale (the TPU-native axes; replaces workers/dispatch knobs)
    n: int = 4                      # group size
    scenarios: int = 1              # HO-scenario batch
    chunk: int = 0                  # scenario micro-batch (0 = all at once)
    seed: int = 0

    # multi-chip (replaces NIO/EPOLL + group options, Runtime.scala:35-41)
    scenario_shards: int = 1
    proc_shards: int = 1

    # observability
    stats: bool = False             # --stat (utils/Options.scala:16-25)
    log_file: str = ""              # decision TSV log (PerfTest --log)

    # benchmark driver knobs (PerfTest2 -a / -rt)
    algorithm: str = "otr"
    rate: int = 16                  # in-flight instances

    def group(self) -> Group:
        if self.peers:
            return Group([Replica(i, h, p) for i, (h, p) in enumerate(self.peers)])
        return Group([Replica(i) for i in range(self.n)])


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--conf", type=str, default=None,
                   help="config file (XML like the reference, or JSON)")
    p.add_argument("-id", "--id", dest="id", type=int)
    p.add_argument("-to", "--timeout", dest="timeout_ms", type=int)
    p.add_argument("--byzantine", dest="nbr_byzantine", type=int)
    p.add_argument("-n", dest="n", type=int)
    p.add_argument("--scenarios", type=int)
    p.add_argument("--chunk", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--max-phases", dest="max_phases", type=int)
    p.add_argument("--scenario-shards", dest="scenario_shards", type=int)
    p.add_argument("--proc-shards", dest="proc_shards", type=int)
    p.add_argument("--stat", dest="stats", action="store_const", const=True)
    p.add_argument("--log", dest="log_file", type=str)
    p.add_argument("-a", "--algorithm", dest="algorithm", type=str)
    p.add_argument("-rt", "--rate", dest="rate", type=int)
    return p


def _apply(opts: Options, ns: argparse.Namespace) -> None:
    for f in dataclasses.fields(Options):
        v = getattr(ns, f.name, None)
        if v is not None:
            setattr(opts, f.name, v)


def parse_config_file(path: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """Returns (peers, extra CLI args).  XML: the reference's shape
    (Config.scala:6-27) — <replica address= port=/> entries plus
    <param name= value=/> re-fed as '--name value' args.  JSON: an object
    whose 'peers' is [[host, port], ...] and other keys are option names."""
    if path.endswith(".json"):
        with open(path) as fh:
            data = json.load(fh)
        peers = [tuple(p) for p in data.pop("peers", [])]
        args: List[str] = []
        for k, v in data.items():
            flag = f"--{k.replace('_', '-')}"
            if k in ("stats", "stat"):
                # the parser knows --stat only as a no-value flag; the
                # '--stats True' form would be silently dropped
                if v:
                    args.append("--stat")
            elif isinstance(v, bool):
                if v:
                    args.append(flag)
            else:
                args.extend([flag, str(v)])
        return peers, args
    root = ET.parse(path).getroot()
    peers = []
    for rep in root.iter("replica"):
        peers.append((rep.get("address", ""), int(rep.get("port", "0"))))
    args = []
    for param in root.iter("param"):
        name = param.get("name")
        value = param.get("value", "")
        args.append(f"--{name}")
        if value:
            args.append(value)
    return peers, args


def parse_args(argv: Sequence[str], base: Optional[Options] = None) -> Options:
    """CLI entry (RTOptions, RuntimeOptions.scala:69-116): --conf file
    contents are applied first, then the command line overrides them."""
    opts = base or Options()
    parser = _parser()
    ns, _ = parser.parse_known_args(list(argv))
    if ns.conf:
        peers, file_args = parse_config_file(ns.conf)
        if peers:
            opts.peers = peers
            opts.n = len(peers)
        fns, unused = parser.parse_known_args(file_args)
        if unused:
            import warnings

            warnings.warn(
                f"config file {ns.conf}: unrecognized options ignored: {unused}"
            )
        _apply(opts, fns)
    _apply(opts, ns)
    if opts.peers and opts.n != len(opts.peers):
        opts.n = len(opts.peers)
    return opts
