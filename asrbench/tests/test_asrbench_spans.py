"""The reduction of the program's `smt::` spans (`yardstick/spans.py`, in
`trace.summarize_events`' one pass) and the exchange's numbers, against hand
counts."""

from types import SimpleNamespace

import pytest

from asrbench.yardstick.spans import allreduce_busbw_gbs, allreduce_wait_ms, reading, readings
from asrbench.yardstick.trace import summarize_events


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr, tid=1):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, corr, tid)


# Two steps, in microseconds. Step 1 [0, 100]: forward [0, 30], backward
# [30, 60], update [60, 95] holding sync [62, 70], optimizer [75, 90] and
# finite_check [90, 92]; nothing open in [95, 100]. The backward's kernel is
# launched from another thread (autograd's). Step 2 [200, 220]: sync
# [200, 210]. Two kernels run outside every step, one of them named like a
# span.
EVENTS = [
    _x("user_annotation", "asrbench::step", 0, 100),
    _x("user_annotation", "asrbench::step", 200, 20),
    _x("user_annotation", "smt::train.forward", 0, 30),
    _x("user_annotation", "smt::train.backward", 30, 30),
    _x("user_annotation", "smt::train.update", 60, 35),
    _x("user_annotation", "smt::train.sync", 62, 8),
    _x("user_annotation", "smt::train.optimizer", 75, 15),
    _x("user_annotation", "smt::train.finite_check", 90, 2),
    _x("user_annotation", "smt::train.sync", 200, 10),
    _x("cpu_op", "aten::mm", 4, 3),
    _launch(5, 1),
    _launch(40, 2, tid=7),
    _launch(64, 3),
    _launch(72, 4),
    _launch(80, 5),
    _launch(96, 6),
    _launch(201, 7),
    _x("kernel", "k_forward", 10, 15, 1),
    _x("kernel", "k_backward", 40, 18, 2),
    _x("kernel", "ncclDevKernel_AllReduce", 64, 5, 3),
    _x("gpu_memcpy", "Memcpy DtoD", 72, 2, 4),
    _x("kernel", "k_adam", 80, 8, 5),
    _x("kernel", "k_late", 150, 1, 6),
    # the port's own kernels share the prefix: a device event is never a span
    _x("kernel", "smt::pool_pass(float const*)", 150, 1, 6),
    _x("kernel", "ncclDevKernel_AllReduce", 202, 4, 7),
]


def test_span_reduction_by_hand():
    s = summarize_events(EVENTS)
    us = pytest.approx
    assert s.span_device_s == {"train.forward": us(15e-6), "train.backward": us(18e-6),
                               "train.update": us(2e-6), "train.sync": us(9e-6),
                               "train.optimizer": us(8e-6), "train.finite_check": 0.0}
    assert s.span_steps["train.sync"] == [us(5e-6), us(4e-6)]
    assert s.span_steps["train.finite_check"] == [0.0]
    assert {k: len(v) for k, v in s.span_steps.items()} == {
        "train.forward": 1, "train.backward": 1, "train.update": 1, "train.sync": 2,
        "train.optimizer": 1, "train.finite_check": 1}
    # idle inside the steps: 120 us less 52 busy there
    assert s.span_idle_s == {"train.forward": us(15e-6), "train.backward": us(12e-6),
                             "train.update": us(8e-6), "train.sync": us(9e-6),
                             "train.optimizer": us(7e-6), "train.finite_check": us(2e-6),
                             "outside": us(15e-6)}
    assert sum(s.span_idle_s.values()) == us(68e-6)


def test_a_trace_without_spans_puts_all_idle_time_outside():
    plain = [e for e in EVENTS if not e["name"].startswith("smt::")]
    s = summarize_events(plain)
    assert s.span_device_s == {} and s.span_steps == {}
    assert s.span_idle_s == {"outside": pytest.approx(68e-6)}
    assert readings(s, 2) == {}


def test_readings_per_step_by_phase():
    r = readings(summarize_events(EVENTS), 2)
    assert r == {"idle_input_ms.train": 0.0,
                 "idle_forward_ms.train": pytest.approx(0.0075),
                 "idle_backward_ms.train": pytest.approx(0.006),
                 "idle_update_ms.train": pytest.approx(0.013)}


def test_decode_readings_by_hand():
    ev = [_x("user_annotation", "asrbench::step", 0, 50),
          _x("user_annotation", "smt::decode.features", 0, 10),
          _x("user_annotation", "smt::decode.model", 10, 20),
          _x("user_annotation", "smt::decode.search", 30, 5),
          _x("user_annotation", "smt::decode.collapse", 35, 12),
          _launch(1, 1), _x("kernel", "fbank", 2, 6, 1),
          _launch(11, 2), _x("kernel", "enc", 12, 20, 2),
          _launch(31, 3), _x("kernel", "argmax", 33, 2, 3),
          _launch(36, 4), _x("gpu_memcpy", "Memcpy DtoH", 36, 1, 4)]
    s = summarize_events(ev)
    # idle: features [0, 2] [8, 10]; model [10, 12]; search [32, 33];
    # collapse [35, 36] [37, 47]; outside [47, 50]
    r = readings(s, 1)
    assert r["frontend_ms.decode"] == pytest.approx(0.006)
    assert r["idle_dispatch_ms.decode"] == pytest.approx(0.007)
    assert r["idle_collapse_ms.decode"] == pytest.approx(0.011)
    assert s.span_idle_s["outside"] == pytest.approx(3e-6)


PEERS = [[0.010, 0.004], [0.003, 0.006], [0.005, 0.0045], [0.0035, 0.004]]


def test_allreduce_wait_by_hand():
    # step 1: least 3 ms, waits 7, 0, 2, 0.5; step 2: least 4 ms, waits 0, 2, 0.5, 0
    assert allreduce_wait_ms(PEERS) == pytest.approx(12.0 / 8)
    assert allreduce_wait_ms(PEERS[:1]) is None
    r = readings(summarize_events([]), 2, {"calls": 4, "bytes": 954e6}, PEERS)
    assert r["allreduce_wait_ms.train"] == pytest.approx(1.5)


def test_allreduce_busbw_by_hand():
    # 477 MB a step, a ring of 4 moves 1.5x that per card: over 3 ms and 4 ms
    want = (477e6 * 1.5 / 0.003 + 477e6 * 1.5 / 0.004) / 2 / 1e9
    assert allreduce_busbw_gbs(PEERS, 477e6) == pytest.approx(want)
    r = readings(summarize_events([]), 2, {"calls": 4, "bytes": 954e6}, PEERS)
    assert r["allreduce_busbw.train"] == pytest.approx(want)
    assert allreduce_busbw_gbs(PEERS, 0) is None


def test_reading_from_a_traced_context():
    """A reader's view: the exchange's counters and every process's
    `train.sync` times from the context; nothing where no card was traced."""
    s = summarize_events(EVENTS)
    peers = [dict(s.span_steps, **{"train.sync": p}) for p in PEERS]
    ctx = SimpleNamespace(trace=s, spans=s, stretch_units=2, peers=peers,
                          counters={"csgu": {"launches": 0}, "collectives":
                                    {"calls": 4, "bytes": 954e6}})
    assert reading(ctx, "idle_backward_ms.train") == pytest.approx(0.006)
    assert reading(ctx, "allreduce_wait_ms.train") == pytest.approx(1.5)
    assert reading(ctx, "allreduce_busbw.train") == pytest.approx(
        allreduce_busbw_gbs(PEERS, 477e6))
    assert reading(ctx, "frontend_ms.decode") is None
    cpu = summarize_events([e for e in EVENTS if e["cat"] != "kernel"
                            and e["cat"] != "gpu_memcpy"])
    assert cpu.busy_s == 0 and cpu.span_idle_s
    assert reading(SimpleNamespace(**dict(vars(ctx), trace=cpu, spans=cpu)),
                   "idle_backward_ms.train") is None
