"""The closed-loop batch driver: one client submits a batch of fault
scenarios to the program, waits for its verdict (the decided count, the
decided-round histogram and a decision checksum, on the host), and submits
the next.  The client draws the next batch's inputs (the traffic, not the
program) while the card runs the current one, so that a batch's latency
runs from handing the program its inputs to its verdict on the host.

Set-up draws a pool of POOL fault structures on the device and runs WARMUP
batches through the whole path, so that every kernel is built and loaded.
The window then runs batches back to back until `seconds` have passed (and
at least check.SAMPLE_BATCHES have run); a traced window stops after the
traffic's `trace_batches`.  Batch b takes pool entry b mod POOL, with fresh
salts and initial values from the run's generator.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from hobench import check, mixgen, trace
from round_tpu_torch.engine.fast import FaultMix

POOL = 8               # distinct fault structures a run draws in set-up
WARMUP = 2             # batches run in set-up
ROOFLINE_BATCHES = 8   # first traced batches whose links the rooflines count


@dataclass
class Record:
    """What a run measured, for the metrics' readers and the check."""
    setup_s: float
    setup_parts: Dict[str, float]  # seconds of set-up by part
    window: List[dict]            # per batch: submit, done, step seconds
    window_s: float
    work_per_batch: float         # scenario-rounds a batch asks for
    memory_peak_bytes: int
    numbers: Dict[str, int]       # the compared numbers
    check_ordinals: List[int]     # the window's batches that were checked
    check_rows: dict              # the sampled scenarios' inputs ...
    check_init: torch.Tensor      # ... and initial values
    trace: Optional[trace.Trace] = None
    # the first traced batches' fault structures and decided rounds, for
    # the link counts of the roofline shares
    kept: List[dict] = field(default_factory=list)


def summarize(out: dict, rounds: int) -> torch.Tensor:
    """A batch's verdict on the device, one int64 vector: decided lanes,
    the decision checksum, then the decided-round histogram.  The
    histogram is counted per scenario first (S x rounds bins) and then
    summed, so that few lanes contend for one bin."""
    decided = (out["decided"] != 0).to(torch.int32)
    S = decided.shape[0]
    at = out["decided_round"].clamp(min=0).to(torch.int64)
    per = torch.zeros((S, rounds), dtype=torch.int32, device=decided.device)
    hist = per.scatter_add_(1, at, decided).sum(0, dtype=torch.int64)
    checksum = (decided * out["decision"].to(torch.int32)).sum(
        dtype=torch.int64)
    return torch.cat([hist.sum()[None], checksum[None], hist])


def run(cell, seed: int, seconds: float, traced: bool, device,
        t0: float) -> Record:
    cfg, tr = cell.config, cell.traffic
    S, n, rounds = tr["scenarios"], cfg["n"], cfg["rounds"]
    marks = [("start", time.perf_counter())]
    gen = mixgen.generator(seed, device)
    torch.zeros(1, device=device).sum().item()  # the device's context
    marks.append(("device", time.perf_counter()))
    pool = [mixgen.draw_structure(gen, tr["families"], S, n, device)
            for _ in range(POOL)]
    marks.append(("pool", time.perf_counter()))
    program = cell.algo.Program(cfg, tr["engine"])
    spans = trace.Spans(traced)

    def inputs(b: int) -> dict:
        """Batch b's fresh draws, its pool entry, its mix and fresh state."""
        with spans.span("salts"):
            draws = mixgen.draw_batch(gen, S, n, tr["init"], device)
            structure = pool[b % POOL]
            mix = FaultMix(**structure, salt0=draws["salt0"],
                           salt1=draws["salt1"])
            return dict(draws, structure=structure, mix=mix,
                        state0=program.state0(draws["init"]))

    cuda = device.type == "cuda"
    verdict = torch.empty(rounds + 2, dtype=torch.int64, pin_memory=cuda)
    copied = torch.cuda.Event() if cuda else None

    def batch(got: dict, b: int) -> dict:
        """Runs `got`, batch b, to its verdict on the host, and draws batch
        b + 1's inputs while the card works; returns them."""
        with spans.span("batch"):
            with spans.span("engine"):
                got["out"] = program.run(got["state0"], got["mix"])
            with spans.span("summary"):
                verdict.copy_(summarize(got["out"], rounds), non_blocking=cuda)
                if cuda:
                    copied.record()
            nxt = inputs(b + 1)
            with spans.span("summary"):
                if cuda:
                    copied.synchronize()
        return nxt

    nxt = inputs(0)
    for b in range(WARMUP):
        nxt = batch(nxt, b)
    marks.append(("warmup", time.perf_counter()))
    sample = check.Sample(seed, tr["check"]["per_family"],
                          len(tr["families"]))
    roof = ROOFLINE_BATCHES if traced else 0
    limit = tr["trace_batches"] if traced else None
    roof_kept: List[dict] = []
    window = []
    prof = trace.profile() if traced else None
    spans.timeline.clear()
    t_start = time.perf_counter()
    setup_s = t_start - t0
    parts = {"imports": marks[0][1] - t0}
    parts.update({k: t - marks[i][1] for i, (k, t) in enumerate(marks[1:])})
    while True:
        got = nxt
        submit = time.perf_counter()
        nxt = batch(got, WARMUP + len(window))
        done = time.perf_counter()
        i = len(window)
        window.append(dict(submit=submit, done=done, **spans.take()))
        sample.offer(got)
        if i < roof:
            roof_kept.append({"structure": got["structure"],
                              "decided_round": got["out"]["decided_round"]})
        del got
        if i + 1 >= check.SAMPLE_BATCHES and (done - t_start >= seconds or (
                limit is not None and i + 1 >= limit)):
            break
    window_s = window[-1]["done"] - t_start
    del nxt
    reduced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        reduced = trace.reduce_trace(spans.timeline + trace.events(prof))
        del prof
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # the check: the sampled rows, and nothing else of the program's state
    rows, init, outs = sample.gather()
    ordinals = sample.ordinals()
    del sample
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = cell.reference.run(rows, init, cfg)
    numbers = check.compare(outs, want, cell.algo.FIELDS)
    return Record(setup_s=setup_s, setup_parts=parts, window=window,
                  window_s=window_s, work_per_batch=float(S * rounds),
                  memory_peak_bytes=peak, numbers=numbers,
                  check_ordinals=ordinals, check_rows=rows,
                  check_init=init, trace=reduced, kept=roof_kept)
