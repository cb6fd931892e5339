"""The program's own spans in a profiler trace: the `smt::<name>` ranges the
port opens around the phases of its entry points
(`summarymixing_tpu_torch/training/profiling.py::span`), on the profiler's
clock, beside the card's kernels.

`trace.summarize_events` reads the Chrome trace's events once and hands
`attribute` the device intervals, the launches, the spans and the
`asrbench::step` ranges, which gives:

- `span_device_s`: by span name, the device time of the kernels, copies and
  sets whose launch (the runtime or driver call of the same correlation)
  fell inside the span while it was the innermost `smt::` span open. Only
  the launch's time is matched, not its thread, so the kernels that
  autograd's own threads launch during `train.backward` count there;
- `span_idle_s`: the card's idle time inside the `asrbench::step` ranges,
  each instant put down to the innermost `smt::` span open then, or to
  `"outside"` when none was;
- `span_steps`: by span name, the device seconds of each occurrence, in
  order (their sum is `span_device_s`).

A program without spans gives `span_device_s` and `span_steps` empty and
all idle time `"outside"`. `readings` turns these, with the all-reduce
counters and every process's `train.sync` times, into per-layer numbers;
`reading` is the form a metric's reader calls.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

SPAN = "smt::"
STEP = "asrbench::step"
OUTSIDE = "outside"

Interval = Tuple[float, float]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The intervals merged where they touch or overlap, in order."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(spans: List[Tuple[float, float, str]]) -> List[Tuple[float, float, int]]:
    """The timeline cut into pieces `(start, end, span index)`, each where
    one span is the innermost open: of those open, the one that started
    last (of two that started together, the one that ends first)."""
    points = sorted({t for a, b, _ in spans for t in (a, b)})
    pieces = []
    for a, b in zip(points, points[1:]):
        open_ = [(s, -e, i) for i, (s, e, _) in enumerate(spans) if s <= a and b <= e]
        if open_:
            pieces.append((a, b, max(open_)[2]))
    return pieces


def _idle(steps: List[Interval], busy: List[Interval]) -> List[Interval]:
    """The parts of the step ranges in which the card ran nothing."""
    out = []
    for s, e in union(steps):
        at = s
        for a, b in busy:
            if b <= at or a >= e:
                continue
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if at < e:
            out.append((at, e))
    return out


def attribute(dev: Sequence[Tuple[float, float, Optional[int]]], launches: Dict[int, float],
              spans: List[Tuple[float, float, str]], steps: List[Interval]
              ) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, List[float]]]:
    """`(span_device_s, span_idle_s, span_steps)` from the device intervals
    `(start, end, correlation)`, each correlation's launch time, the spans
    `(start, end, name)` and the step ranges, all in microseconds."""
    spans = sorted(spans)
    pieces = _innermost(spans)
    starts = [a for a, _, _ in pieces]

    def owner(t: float) -> Optional[int]:
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if i >= 0 and t <= pieces[i][1] else None

    per = [0.0] * len(spans)
    for a, b, corr in dev:
        at = launches.get(corr)
        i = None if at is None else owner(at)
        if i is not None:
            per[i] += (b - a) * 1e-6
    device_s: Dict[str, float] = {}
    by_step: Dict[str, List[float]] = {}
    for (_, _, name), sec in zip(spans, per):
        by_step.setdefault(name, []).append(sec)
        device_s[name] = device_s.get(name, 0.0) + sec
    idle: Dict[str, float] = defaultdict(float)
    for a, b in _idle(steps, union([(a, b) for a, b, _ in dev])):
        covered = 0.0
        for pa, pb, i in pieces:
            lo, hi = max(a, pa), min(b, pb)
            if lo < hi:
                idle[spans[i][2]] += (hi - lo) * 1e-6
                covered += hi - lo
        if b - a > covered:
            idle[OUTSIDE] += (b - a - covered) * 1e-6
    return device_s, dict(idle), by_step


def allreduce_wait_ms(peers: Sequence[Sequence[float]]) -> Optional[float]:
    """`peers`: every process's `train.sync` device seconds, one per step.
    Each process's time less the least of that step's (what its exchange
    spent waiting for the slowest process), averaged over steps and
    processes, in ms."""
    steps = min((len(p) for p in peers), default=0)
    if len(peers) < 2 or steps == 0:
        return None
    waits = [p[k] - min(q[k] for q in peers) for k in range(steps) for p in peers]
    return 1000.0 * sum(waits) / len(waits)


def allreduce_busbw_gbs(peers: Sequence[Sequence[float]], bytes_per_step: float
                        ) -> Optional[float]:
    """The exchange's bus bandwidth: the bytes all-reduced per step times
    2(n-1)/n (a ring's traffic per card) over that step's least `train.sync`
    device time across the n processes, averaged over steps, in GB/s."""
    n = len(peers)
    steps = min((len(p) for p in peers), default=0)
    if n < 2 or steps == 0 or bytes_per_step <= 0:
        return None
    least = [min(q[k] for q in peers) for k in range(steps)]
    if min(least) <= 0:
        return None
    bus = bytes_per_step * 2.0 * (n - 1) / n
    return sum(bus / t for t in least) / steps / 1e9


def readings(spans, units: int, counters: Optional[Dict[str, int]] = None,
             peers: Optional[Sequence[Sequence[float]]] = None) -> Dict[str, float]:
    """The per-layer numbers of a traced stretch of `units` batches or steps
    (per process), from `spans` (a `trace.TraceSummary`'s span fields): ms
    per unit by phase, and for a run of several processes
    the exchange's wait and bus bandwidth from `counters` (the rise of
    `comm.COLLECTIVES`' `calls` and `bytes` over the stretch) and `peers`.
    A number with nothing to read is left out."""
    dev, idle = spans.span_device_s, spans.span_idle_s
    per = 1000.0 / units
    out: Dict[str, float] = {}
    if "decode.features" in dev:
        out["frontend_ms.decode"] = per * dev["decode.features"]
    if any(k.startswith("decode.") for k in dev):
        out["idle_dispatch_ms.decode"] = per * sum(
            idle.get(k, 0.0) for k in ("decode.features", "decode.model", "decode.search"))
        out["idle_collapse_ms.decode"] = per * idle.get("decode.collapse", 0.0)
    if any(k.startswith("train.") for k in dev):
        for phase in ("input", "forward", "backward"):
            out[f"idle_{phase}_ms.train"] = per * idle.get(f"train.{phase}", 0.0)
        out["idle_update_ms.train"] = per * sum(
            idle.get(k, 0.0) for k in ("train.update", "train.sync", "train.finite_check",
                                       "train.optimizer"))
    if peers:
        wait = allreduce_wait_ms(peers)
        if wait is not None:
            out["allreduce_wait_ms.train"] = wait
        if counters:
            bw = allreduce_busbw_gbs(peers, counters.get("bytes", 0) / units)
            if bw is not None:
                out["allreduce_busbw.train"] = bw
    return out


def reading(ctx, name: str) -> Optional[float]:
    """The per-layer number `name` of `readings` from a traced stretch's
    context (`harness.CellRun._traced`): its spans, the rise of the
    exchange's counters, every process's `train.sync` times. None where the
    trace holds no device time (no card was traced) or the number has
    nothing to read."""
    if ctx.trace.busy_s <= 0:
        return None
    peers = [p.get("train.sync", []) for p in ctx.peers]
    return readings(ctx.spans, ctx.stretch_units, ctx.counters.get("collectives"),
                    peers).get(name)
