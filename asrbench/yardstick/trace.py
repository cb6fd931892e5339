"""Reduction of a `torch.profiler` trace of a short steady stretch.

The trace is exported as Chrome JSON to a temporary file (under TMPDIR),
read once and deleted. From it, in one pass over its events:

- device intervals: every kernel, copy and set on the card, and their union
  (the busy time);
- per module: the device time of the kernels launched while a
  `asrbench::<Class>` range was open on the host (forward hooks open one
  around each hooked module's forward);
- collectives: the device time of kernels named like NCCL's;
- the breakdown: the device operations that took the most time, and the
  longest gaps between device work, each named by the innermost host range
  open at its middle;
- the program's `smt::` spans: device time, idle time and each occurrence's
  device time by span (`spans.attribute`).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from asrbench.yardstick.spans import SPAN, STEP, attribute, union

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
PREFIX = "asrbench::"
NAME_CHARS = 160   # a kernel's name is cut to this many characters in the breakdown


@dataclass
class TraceSummary:
    busy_s: float = 0.0
    module_s: Dict[str, float] = field(default_factory=dict)
    nccl_s: float = 0.0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_idle_s: Dict[str, float] = field(default_factory=dict)
    span_steps: Dict[str, List[float]] = field(default_factory=dict)


def summarize(prof) -> TraceSummary:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize_events(events)


def summarize_events(events: List[Dict]) -> TraceSummary:
    dev, launches, ranges, host, program_spans, steps = [], {}, defaultdict(list), [], [], []
    for e in events:
        cat, ph = e.get("cat", ""), e.get("ph")
        if ph != "X":
            continue
        name = e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, name, e.get("args", {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        if cat == "user_annotation":
            if name.startswith(PREFIX):
                ranges[name[len(PREFIX):]].append((ts, ts + dur))
            if name.startswith(SPAN):
                program_spans.append((ts, ts + dur, name[len(SPAN):]))
            elif name == STEP:
                steps.append((ts, ts + dur))
        if cat in HOST_CATS:
            host.append((ts, ts + dur, name))
    out = TraceSummary()
    out.span_device_s, out.span_idle_s, out.span_steps = attribute(
        [(a, b, corr) for a, b, _, corr in dev], launches, program_spans, steps)
    if not dev:
        return out
    busy = union([(a, b) for a, b, _, _ in dev])
    out.busy_s = sum(b - a for a, b in busy) * 1e-6
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name, _ in dev:
        by_name[name] += (b - a) * 1e-6
        if "nccl" in name.lower():
            out.nccl_s += (b - a) * 1e-6
    out.device_ops = [(name[:NAME_CHARS], sec) for name, sec in
                      sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    for cls, spans in ranges.items():
        spans.sort()
        starts = [s for s, _ in spans]
        total = 0.0
        for a, b, _, corr in dev:
            at = launches.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and spans[i][0] <= at <= spans[i][1]:
                total += b - a
        out.module_s[cls] = total * 1e-6
    gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps.sort(reverse=True)
    host.sort(key=lambda h: h[1] - h[0])
    for length, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        label = next((name for s, e, name in host if s <= mid <= e), "no host range")
        out.idle_gaps.append((label[:NAME_CHARS], length * 1e-6))
    return out
