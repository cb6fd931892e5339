"""The program's own spans in a profiler trace: the `smt::<name>` ranges the
port opens around the phases of its entry points
(`summarymixing_tpu_torch/training/profiling.py::span`), on the profiler's
clock, beside the card's kernels.

From the Chrome trace's events, as `trace.py` reads them:

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
counters and every process's `train.sync` times, into per-layer numbers.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from asrbench.yardstick.trace import DEVICE_CATS, _union

SPAN = "smt::"
STEP = "asrbench::step"
OUTSIDE = "outside"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]


@dataclass
class SpanSummary:
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_idle_s: Dict[str, float] = field(default_factory=dict)
    span_steps: Dict[str, List[float]] = field(default_factory=dict)


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
    for s, e in _union(steps):
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


def summarize_span_events(events: List[Dict]) -> SpanSummary:
    dev, launches, spans, steps = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation":
            if name.startswith(SPAN):
                spans.append((ts, ts + dur, name[len(SPAN):]))
            elif name == STEP:
                steps.append((ts, ts + dur))
    spans.sort()
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
    out = SpanSummary()
    for (_, _, name), sec in zip(spans, per):
        out.span_steps.setdefault(name, []).append(sec)
        out.span_device_s[name] = out.span_device_s.get(name, 0.0) + sec
    idle: Dict[str, float] = defaultdict(float)
    busy = _union([(a, b) for a, b, _ in dev])
    for a, b in _idle(steps, busy):
        covered = 0.0
        for pa, pb, i in pieces:
            lo, hi = max(a, pa), min(b, pb)
            if lo < hi:
                idle[spans[i][2]] += (hi - lo) * 1e-6
                covered += hi - lo
        if b - a > covered:
            idle[OUTSIDE] += (b - a - covered) * 1e-6
    out.span_idle_s = dict(idle)
    return out


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


def readings(spans: SpanSummary, units: int, counters: Optional[Dict[str, int]] = None,
             peers: Optional[Sequence[Sequence[float]]] = None) -> Dict[str, float]:
    """The per-layer numbers of a traced stretch of `units` batches or steps
    (per process): ms per unit by phase, and for a run of several processes
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
