"""The harness finds a cell's entry module, reference module and readers by
name: a cell made only of new files (configuration, mix, limits, entry,
reference, reader) runs through `CellRun.run`, and a streaming
Conformer-transducer cell of new files passes the checks the benchmark's own
cells pass (`checks.py`); the system as built carries
the transducer where the recipe has one; the recipe is checked against every
section the configuration file states; and a reader's traced context holds
the program's spans, the counters' rise and every process's span times, by
hand on a small profiled stretch."""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from asrbench import harness
from asrbench.tests import checks, transducer_cell
from asrbench.tests.tiny import tiny_config, tiny_spec
from asrbench.tests.transducer_cell import TINY_CONFORMER, TRANSDUCER_RECIPE
from asrbench.yardstick import traffic

ENTRY = '''
import time
import torch
from summarymixing_tpu_torch.transcribe import greedy_ctc_decode
from asrbench.yardstick import traffic
from asrbench.yardstick.weights import make_norm_stats, make_weights

TRACE_UNITS = 2


def run(cell, system, readers):
    stats = make_norm_stats(cell.cfg["features"]["n_mels"], cell.seeds["stats"], cell.device)
    pool = traffic.make_pool(cell.mix, cell.seeds["data"], cell.device)

    def step(j):
        b = pool[j % len(pool)]
        return greedy_ctc_decode(system.model, system.fbank, stats, b.wav, b.wav_lens)[1]

    setup_s = time.perf_counter() - cell.t0
    start, done, kept = time.perf_counter(), 0, None
    while True:
        out = step(done)
        kept = kept or out
        done += 1
        if time.perf_counter() - start >= cell.seconds:
            break
    window_s = time.perf_counter() - start
    per_layer, trace = ({}, None) if not readers else cell._traced(
        system.model, readers, window_s, 0.0, done, step)
    w = make_weights(cell.ref.param_shapes(cell.cfg), cell.seeds["weights"], cell.device)
    lp, lens = cell.ref.log_probs(w, cell.cfg, stats, pool[0].wav, pool[0].wav_lens)
    valid = torch.arange(lp.shape[1])[None] < lens[:, None]
    gap = float((lp - kept["ctc_log_probs"]).abs()[valid].max())
    return cell._result({"batches_per_s": (done / window_s, "1/s"), "setup_s": (setup_s, "s")},
                        per_layer, {"lp_gap": gap}, done, 0, cell.peak_bytes(), trace)
'''

REFERENCE = '''
from asrbench.reference import asr


def param_shapes(cfg):
    return asr.param_shapes(cfg)


def log_probs(w, cfg, stats, wav, wav_lens):
    return asr.ctc_log_probs(w, cfg, stats, wav, wav_lens)
'''

READER = '''
def read(ctx):
    return (len(ctx.spans.span_steps["decode.model"]) + ctx.counters["collectives"]["calls"]
            + ctx.counters["summary_mixing"]["launches"] + len(ctx.peers) - 1)
'''


def _new_cell(root):
    """A cell of new files under `root`, laid out as the benchmark's folder."""
    for d in ("configs", "traffic", "limits", "entries", "reference", "metrics"):
        (root / d).mkdir()
    cfg = tiny_config("branchformer_summarymixing")
    cfg["training"]["precision"] = "fp32"
    cfg["overrides"]["training.precision"] = "fp32"
    cfg.update(name="tiny_cfg", reference="tiny_ref")
    (root / "configs" / "tiny_cfg.json").write_text(json.dumps(cfg))
    mix = {"entry": "forward_gap", "utterances": 4, "length_seed": 5,
           "lengths": {"kind": "uniform", "min_s": 0.8, "max_s": 2.0},
           "batching": {"max_batch_s": 6.0, "max_rows": 2}, "pad_quantum_s": 0.25}
    (root / "traffic" / "tiny_mix.json").write_text(json.dumps(mix))
    (root / "limits" / "tiny.cell.json").write_text(json.dumps({"limits": {"lp_gap": 2e-4}}))
    (root / "entries" / "forward_gap.py").write_text(ENTRY)
    (root / "reference" / "tiny_ref.py").write_text(REFERENCE)
    (root / "metrics" / "span_count.py").write_text(READER)
    return {"workloads": [{"name": "tiny.cell", "config": "tiny_cfg", "traffic": "tiny_mix",
                           "chips": 1, "why": "a cell of new files only"}],
            "end_to_end": [{"name": "batches_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.1, "source": "host_clock", "workloads": ["tiny.cell"]},
                           {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                            "source": "host_clock"}],
            "per_layer": [{"name": "span_count", "unit": "1", "better": "higher",
                           "source": "program_span", "layer": "entry", "moves": "batches_per_s",
                           "workloads": ["tiny.cell"]}]}


def test_a_cell_of_new_files_only_runs(tmp_path, monkeypatch):
    package = harness.HERE
    bench = _new_cell(tmp_path)
    monkeypatch.setattr(harness, "HERE", tmp_path)
    spec = harness.cell_spec(bench, "tiny.cell")
    traced = harness.CellRun("tiny.cell", 2**31 + 17, 0.2, True, "cpu", time.perf_counter(),
                             spec).run()
    assert traced["correct"] is True, traced["checks"]
    # the reader saw one `decode.model` span a traced batch, no collective,
    # no kernel launch on the CPU and one process
    assert traced["metrics"] == {"span_count": {"value": 2, "unit": "1"}}
    plain = harness.CellRun("tiny.cell", 2**31 + 17, 0.2, False, "cpu", time.perf_counter(),
                            spec).run()
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"batches_per_s", "setup_s"}
    assert plain["metrics"]["batches_per_s"]["value"] > 0
    assert not (package / "entries" / "forward_gap.py").exists()


def _tree(root):
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_transducer_cell_of_new_files_only_passes_the_benchmark_checks(tmp_path,
                                                                          monkeypatch):
    """A streaming Conformer-transducer cell laid out under a temporary
    folder passes the checks that the benchmark's own cells pass (found by
    name, recipe against configuration, every fault of its entry), and runs
    traced and plain, with no file of the benchmark's folder touched."""
    package = harness.HERE
    before = _tree(package)
    here = tmp_path / "asrbench"
    bench = transducer_cell.write(here)
    monkeypatch.setattr(harness, "HERE", here)
    checks.cells_load_by_name(bench)
    checks.recipes_match(bench)
    cases = checks.fault_cases(bench)
    assert cases == [(transducer_cell.CELL, "unchanged", "samples_lost")]
    for case in cases:
        res = checks.fault_makes_correct_false(bench, *case)
        assert res["checks"]["samples_lost"]["value"] > 0
    cell = transducer_cell.CELL
    spec = tiny_spec(cell, bench, per_layer=("stream_chunks",))
    traced = harness.CellRun(cell, 2**31 + 23, 0.2, True, "cpu", time.perf_counter(),
                             spec).run()
    assert traced["correct"] is True, traced["checks"]
    # one `stream.chunk` span a chunk of each traced stream; no kernel on the CPU
    size = spec["mix"]["chunk_frames"] * 4 * 160   # 4 Fbank hops of 160 samples a frame
    pool = traffic.make_pool(spec["mix"], 1, "cpu")
    chunks = sum(-(-pool[j % len(pool)].wav.shape[1] // size) for j in range(2))
    assert traced["metrics"] == {"stream_chunks": {"value": chunks, "unit": "1"}}
    plain = harness.CellRun(cell, 2**31 + 23, 0.2, False, "cpu", time.perf_counter(),
                            spec).run()
    assert plain["correct"] is True and plain["checks"]["samples_lost"]["value"] == 0
    assert set(plain["metrics"]) == {"streams_per_s", "setup_s"}
    assert plain["metrics"]["streams_per_s"]["value"] > 0
    assert _tree(package) == before


def test_the_system_as_built_carries_the_transducer():
    cfg = {"name": "tiny_transducer", "recipe": TRANSDUCER_RECIPE, "overrides": TINY_CONFORMER,
           "transducer": {"joint_dim": 24, "dec_dim": 16}}
    system = harness.build_system(cfg, "cpu")
    assert system.transducer is not None
    named = system.named_parameters()
    own = dict(system.transducer.named_parameters())
    assert own and {f"transducer.{n}" for n in own} <= set(named)
    assert set(named) - {f"transducer.{n}" for n in own} == set(dict(
        system.model.named_parameters()))
    gen = torch.Generator().manual_seed(3)
    weights = {n: torch.randn(p.shape, generator=gen) for n, p in named.items()}
    harness.load_weights(system, weights)
    for n, p in own.items():
        assert torch.equal(p, weights[f"transducer.{n}"])
    with pytest.raises(SystemExit, match="transducer.joint_dim"):
        harness.build_system(dict(cfg, transducer={"joint_dim": 640}), "meta")


def test_a_section_the_recipe_lacks_is_refused():
    """(That each configuration's system carries a transducer exactly where
    its recipe has the section is `checks.recipes_match`'s.)"""
    cfg = dict(harness.load_config("branchformer_summarymixing"), transducer={"joint_dim": 640})
    with pytest.raises(SystemExit, match="transducer section"):
        harness.build_system(cfg, "meta")


def test_traced_context_by_hand(monkeypatch):
    """Three traced steps, each a span `probe.outer` holding `probe.inner`,
    one collective of 64 bytes and two launches of the cell's kernel counted:
    on the CPU the card is never busy, so every instant of each step range is
    idle and put down to the innermost span open, or `outside`."""
    from summarymixing_tpu_torch.ops import fused_summary
    from summarymixing_tpu_torch.parallel import comm
    from summarymixing_tpu_torch.training.profiling import span

    monkeypatch.setattr(fused_summary.fused_summary_mixing, "launches",
                        fused_summary.fused_summary_mixing.launches)
    monkeypatch.setitem(comm.COLLECTIVES, "calls", comm.COLLECTIVES["calls"])
    monkeypatch.setitem(comm.COLLECTIVES, "bytes", comm.COLLECTIVES["bytes"])
    seen = []

    def step(j):
        with span("probe.outer"):
            with span("probe.inner"):
                time.sleep(0.004)
            time.sleep(0.002)
        time.sleep(0.001)
        comm.COLLECTIVES["calls"] += 1
        comm.COLLECTIVES["bytes"] += 64
        fused_summary.fused_summary_mixing.launches += 2

    run = harness.CellRun("bf_sm.train", 3, 0.1, True, "cpu", time.perf_counter(),
                          tiny_spec("bf_sm.train"))
    values, (summary, stretch_s) = run._traced(
        torch.nn.Linear(2, 2), {"probe": SimpleNamespace(read=lambda c: seen.append(c) or 1.0)},
        1.0, 0.0, 3, step)
    assert values == {"probe": 1.0}
    ctx = seen[0]
    assert ctx.stretch_units == run.entry.TRACE_UNITS == 3
    assert ctx.counters["collectives"] == {"calls": 3, "bytes": 192}
    assert ctx.counters["summary_mixing"]["launches"] == 6
    assert ctx.counters["csgu"] == {"launches": 0, "plain_calls": 0, "int8_calls": 0}
    assert set(ctx.counters) >= {"summary_mixing", "csgu", "relpos_attention", "collectives"}
    assert ctx.spans is summary and summary.busy_s == 0
    assert ctx.spans.span_steps == {"probe.outer": [0.0] * 3, "probe.inner": [0.0] * 3}
    assert ctx.peers == [ctx.spans.span_steps]
    idle = ctx.spans.span_idle_s
    assert set(idle) == {"probe.outer", "probe.inner", "outside"}
    assert idle["probe.inner"] >= 3 * 0.004 and idle["probe.outer"] >= 3 * 0.002
    assert idle["outside"] >= 3 * 0.001
    # the step ranges lie inside the stretch and hold the three steps' sleeps
    assert 3 * 0.007 <= sum(idle.values()) <= stretch_s
