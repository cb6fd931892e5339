"""The port's run tooling on the CPU:

- `training/profiling.py`: `trace` writes a Chrome trace and the table of
  operators; `StepProfiler` traces the window after 3 steps;
  `device_memory_stats`; the `smt::` spans of `greedy_ctc_decode`,
  `train_step` and the gradient exchange, in order and nested, under the
  profiler, and none entered without it; `comm.all_reduce_`'s counts;
- `data/native_loader.py` against the port's own Python decoders
  (`dataio.load_wav`, `flac.decode_flac`): mono, interleaved and FLAC
  files bit for bit, cut and zero-padded; a rejected 24-bit row decoded
  again by Python and counted; a failed build raising; the train batches
  and the serving path's FLAC bodies through it;
- the offline transducer artifact, exported with a symbolic batch and
  sample count, against the live inference function at two shapes;
- `recipes/warmup_cache.py`;
- `--set model.mode=SummaryMixing-lite` and `...-expdecay` through the
  train, evaluate, transcribe, serve and export runners to their end.
"""

import json
import os
import wave

import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu_torch.config import build_model, build_trainer, load_recipe
from summarymixing_tpu_torch.data import dataio, native_loader
from summarymixing_tpu_torch.data.dataio import load_audio_bytes, load_wav, read_manifest_csv
from summarymixing_tpu_torch.data.flac import decode_flac, encode_flac
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.ops import _build
from summarymixing_tpu_torch.parallel import comm
from summarymixing_tpu_torch.recipes import (
    common,
    evaluate,
    export_model,
    serve,
    train,
    transcribe,
    warmup_cache,
)
from summarymixing_tpu_torch.serving import DynamicBatchingServer, ServingConfig
from summarymixing_tpu_torch.training import profiling
from summarymixing_tpu_torch.training.optim import make_optimizer, synced_update
from summarymixing_tpu_torch.transcribe import greedy_ctc_decode
from summarymixing_tpu_torch.utils import export
from test_torch_data import make_corpus
from test_torch_export import TINY, TINY_TD, TRANSDUCER, audio, norm_stats
from test_torch_recipes import SMALL_BATCHES, SYNTH
from test_torch_serving import _Http

# the synthetic recipe cut to 2 layers of d64 for the mode runners
SMALL = ["--set", "model.num_encoder_layers=2", "--set", "model.num_decoder_layers=1",
         "--set", "model.d_model=64", "--set", "model.local_proj_out_dim=64",
         "--set", "model.summary_out_dim=64"]


def _wav(path, samples, channels=1, width=2, rate=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(samples.tobytes())
    return str(path)


def _int16(rng, n):
    return (8000 * rng.standard_normal(n)).clip(-32768, 32767).astype(np.int16)


# -- profiling -----------------------------------------------------------------

def test_trace_writes_the_chrome_trace_and_the_table(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof")):
        for _ in range(3):
            a = torch.tanh(a @ a)
    trace = json.load(open(tmp_path / "prof" / profiling.TRACE_FILE))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names and "aten::tanh" in names
    table = open(tmp_path / "prof" / profiling.TABLE_FILE).read()
    assert table.splitlines()[0].split()[:2] == ["device", "ms"] and "aten::mm" in table


def test_step_profiler_traces_the_window_after_three_steps(tmp_path, monkeypatch):
    """Start after step 3, stop after step 3 + N, once per run; `close` at
    an epoch's end ends a window the epoch cut short."""
    events = []
    monkeypatch.setattr(profiling, "start_trace", lambda: events.append("start") or "prof")
    monkeypatch.setattr(profiling, "stop_trace",
                        lambda prof, d: events.append("stop") or os.path.join(d, "trace.json"))
    prof = profiling.StepProfiler(str(tmp_path), n_steps=2)
    seen = []
    for step in range(1, 9):
        prof.step()
        seen.append((step, list(events)))
    assert [s for s, e in seen if e == ["start"]] == [3, 4]
    assert seen[4] == (5, ["start", "stop"]) and events == ["start", "stop"]
    short = profiling.StepProfiler(str(tmp_path), n_steps=5)
    for _ in range(4):
        short.step()
    short.close()
    assert events == ["start", "stop"] * 2 and short.path == str(tmp_path / "trace.json")
    off = profiling.StepProfiler(None)
    for _ in range(9):
        off.step()
    off.close()
    assert len(events) == 4 and off.path is None


def test_device_memory_stats_is_per_card():
    assert profiling.device_memory_stats() == {}   # no card in this process


# -- spans and counters ------------------------------------------------------------

# the synthetic recipe cut to one d32 encoder layer and one decoder layer,
# with speed perturbation
TINY_SPANS = dict(TINY, **{"model.num_decoder_layers": 1, "augment.speed_perturb": True})


@pytest.fixture(scope="module")
def tiny_asr():
    cfg = load_recipe(SYNTH, overrides=TINY_SPANS)
    model, fbank = build_model(cfg, device="cpu")
    stats = {k: torch.from_numpy(np.array(v)) for k, v in norm_stats(2).items()}
    wav, lens = audio(3, 2, 320 * 41)
    batch = {"wav": torch.from_numpy(wav), "wav_lens": torch.from_numpy(lens),
             "tokens": torch.tensor([[3, 4, 5], [6, 7, 0]]), "token_lens": torch.tensor([3, 2])}
    return cfg, model, fbank, stats, batch


def _profiled(fn):
    """`fn()` under `torch.profiler`, and the `smt::` ranges it recorded:
    `(start, end, name)` in order of start."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.time_range.start, e.time_range.end, e.name[len(profiling.SPAN_PREFIX):])
                  for e in prof.events() if e.name.startswith(profiling.SPAN_PREFIX))


def test_greedy_ctc_decode_spans_its_four_phases_in_order(tiny_asr):
    _, model, fbank, stats, batch = tiny_asr
    hyps = []
    spans = _profiled(lambda: hyps.extend(greedy_ctc_decode(model, fbank, stats, batch["wav"],
                                                            batch["wav_lens"])[0]))
    assert [n for _, _, n in spans] == ["decode.features", "decode.model", "decode.search",
                                        "decode.collapse"]
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert len(hyps) == 2


def test_train_step_spans_its_phases_with_the_update_s_nested(tiny_asr):
    cfg, model, fbank, _, batch = tiny_asr
    trainer = build_trainer(cfg, model, fbank)
    state = trainer.init_state(seed=1)
    out = []
    spans = _profiled(lambda: out.append(trainer.train_step(state, batch)))
    top = ["train.input", "train.forward", "train.backward", "train.update"]
    outer = [s for s in spans if s[2] in top]
    assert [n for _, _, n in outer] == top
    assert all(a[1] <= b[0] for a, b in zip(outer, outer[1:]))
    start, end, _ = outer[-1]
    inner = [s for s in spans if s[2] not in top]
    assert [n for _, _, n in inner] == ["train.finite_check", "train.optimizer"]
    assert all(start <= a and b <= end for a, b, _ in inner)
    assert out[0][1]["nonfinite_skipped"] == 0
    # the evaluation path shares `_forward_loss`, and its two spans
    spans = _profiled(lambda: trainer.eval_greedy(out[0][0], batch))
    assert [n for _, _, n in spans] == ["train.input", "train.forward"]


def test_spans_enter_no_record_function_without_a_profiler(tiny_asr, monkeypatch):
    cfg, model, fbank, stats, batch = tiny_asr

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler on")

    monkeypatch.setattr(profiling, "record_function", refuse)
    hyps, _ = greedy_ctc_decode(model, fbank, stats, batch["wav"], batch["wav_lens"])
    trainer = build_trainer(cfg, model, fbank)
    state, met = trainer.train_step(trainer.init_state(seed=1), batch)
    assert len(hyps) == 2 and met["nonfinite_skipped"] == 0
    assert profiling.span("a") is profiling.span("b")   # one shared no-op context


def test_all_reduce_counts_the_collectives_it_runs(monkeypatch):
    """Calls and bytes (elements times element size) of each collective
    run; nothing in one process. Two processes are stood in for by the
    group size and a recording `dist.all_reduce`; the data-parallel
    update's exchange is the span `train.sync`."""
    monkeypatch.setattr(comm, "COLLECTIVES", {"calls": 0, "bytes": 0})
    comm.all_reduce_(torch.ones(5, 3))
    comm.GradientSync().mean_([torch.ones(4)], torch.tensor(1.0))
    assert comm.COLLECTIVES == {"calls": 0, "bytes": 0}
    seen = []
    monkeypatch.setattr(comm, "group_size", lambda group=None: 2)
    monkeypatch.setattr(comm.dist, "all_reduce",
                        lambda t, op=None, group=None: seen.append((t.numel(), t.dtype)))
    comm.all_reduce_(torch.ones(5, 3, dtype=torch.float64))
    params = [torch.ones(4), torch.ones(2, 3)]
    grads = [torch.ones_like(p) for p in params]
    opt = make_optimizer(lambda count: torch.tensor(1e-3))
    spans = _profiled(lambda: synced_update(opt, params, grads, opt.init(params),
                                            torch.tensor(2.0), comm.GradientSync()))
    # the flat float32 vector: 4 + 6 gradient elements and the loss
    assert seen == [(15, torch.float64), (11, torch.float32)]
    assert comm.COLLECTIVES == {"calls": 2, "bytes": 15 * 8 + 11 * 4}
    assert [n for _, _, n in spans] == ["train.sync", "train.finite_check", "train.optimizer"]


# -- the native batch loader ------------------------------------------------------

def test_native_loader_equals_the_python_decoders_bit_for_bit(tmp_path, rng):
    mono = [_wav(tmp_path / f"m{i}.wav", _int16(rng, n)) for i, n in enumerate((3000, 800))]
    stereo = _wav(tmp_path / "s.wav", _int16(rng, 2 * 1500), channels=2)
    flac = str(tmp_path / "f.flac")
    with open(flac, "wb") as f:
        f.write(encode_flac(_int16(rng, 2600).astype(np.int64), 16000))
    paths = mono + [stereo, flac]
    out, lens = native_loader.load_wav_batch(paths, 2800)
    assert out.dtype == np.float32 and lens.tolist() == [2800, 800, 1500, 2600]
    for i, path in enumerate(paths):
        want = load_wav(path, 16000)[:2800]
        assert np.array_equal(out[i, :lens[i]], want) and not out[i, lens[i]:].any()
    assert native_loader.library_path().parent == native_loader.REPO / "build" / "native"


def test_native_loader_retries_a_rejected_row_in_python(tmp_path, rng, monkeypatch):
    """A 24-bit WAV is not the C++ side's: that row alone is decoded by the
    Python decoder, and counted; the 16-bit row beside it is not."""
    monkeypatch.setattr(native_loader.load_wav_batch, "python_retries", 0)
    x24 = (rng.integers(-2 ** 23, 2 ** 23, 1200).astype("<i4").view(np.uint8)
           .reshape(-1, 4)[:, :3].copy())
    paths = [_wav(tmp_path / "a.wav", _int16(rng, 900)), _wav(tmp_path / "b.wav", x24, width=3)]
    out, lens = native_loader.load_wav_batch(paths, 1500)
    assert native_loader.load_wav_batch.python_retries == 1
    assert lens.tolist() == [900, 1200]
    for i, path in enumerate(paths):
        assert np.array_equal(out[i, :lens[i]], load_wav(path, 16000))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF not a wav at all")
    with pytest.raises(Exception):
        native_loader.load_wav_batch([str(bad)], 100)


def test_native_loader_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "dataloader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SRC", broken)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build"):
        native_loader.load_wav_batch([str(tmp_path / "x.wav")], 10)
    assert not list((tmp_path / "build").glob("*.so"))


def test_flac_bodies_and_train_batches_take_the_native_loader(tmp_path, rng, monkeypatch):
    """`load_audio_bytes` on a FLAC body and `common.batches` both go
    through `load_wav_batch`, and give what the Python codec gives."""
    calls = []
    real = native_loader.load_wav_batch

    def spy(paths, max_len, *a, **k):
        calls.append(len(paths))
        return real(paths, max_len, *a, **k)

    monkeypatch.setattr(native_loader, "load_wav_batch", spy)
    x = _int16(rng, 5000)
    body = encode_flac(x.astype(np.int64), 16000)
    samples, _, bps = decode_flac(body)
    assert np.array_equal(load_audio_bytes(body, 16000),
                          samples.astype(np.float32) / float(1 << (bps - 1)))
    assert calls == [1]
    corpus = make_corpus(tmp_path / "c", n=12)
    utts = read_manifest_csv(corpus["train"])
    cfg = load_recipe(SYNTH)
    tok = CharTokenizer.build([u.text for u in utts])
    for batch, idx in common.batches(utts, tok, cfg, False, 0, "cpu"):
        for row, i in enumerate(idx):
            want = load_wav(utts[i].wav_path, 16000)
            assert int(batch["wav_lens"][row]) == len(want)
            assert np.array_equal(batch["wav"][row, :len(want)].numpy(), want)
    assert calls[1:] and sum(calls[1:]) >= len(utts)


# -- the polymorphic transducer artifact --------------------------------------------

def test_polymorphic_transducer_artifact_matches_the_live_model(tmp_path):
    """Exported with a symbolic batch and sample count (the greedy loop over
    frames a `scan` under export), saved and loaded: its tokens, lengths
    and encoder lengths equal the live inference function's at two shapes
    other than the example's."""
    model, fbank, td = build_model(load_recipe(TRANSDUCER, overrides=TINY_TD), device="cpu")
    stats = {k: torch.from_numpy(np.array(v)) for k, v in norm_stats(2).items()}
    live = export.make_transducer_infer_fn(model, td, fbank, InputNormalization(), stats)
    path = str(tmp_path / "td.smt")
    export.save_artifact(path, export.export_ctc_infer(live),
                         {"family": "transducer", "device": "cpu", "polymorphic": True})
    art = export.ExportedASR.load(path, device="cpu")
    shapes = set()
    for seed, b, n in ((7, 3, 320 * 41), (8, 1, 320 * 23)):
        wav, lens = audio(seed, b, n)
        wav[:, :300] *= 20.0
        got = art(wav, lens)
        with torch.inference_mode():
            want = live(torch.from_numpy(wav), torch.from_numpy(lens))
        shapes.add(tuple(got[0].shape))
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
    assert len(shapes) == 2


# -- the warm-up runner ----------------------------------------------------------------

def test_warmup_cache_builds_the_loader_and_the_kernels(monkeypatch):
    """The native loader is built here; `_build.build` needs nvcc, so it is
    stubbed: the runner calls it for every kernel and reports each."""
    monkeypatch.setattr(_build, "build", lambda: {name: {"seconds": 1.5, "ptxas": ""}
                                                  for name in _build.SOURCES})
    summary = warmup_cache.main([])
    assert set(summary) == {"native_loader", "kernel summary_mixing", "kernel csgu",
                            "kernel relpos_attention"}
    assert summary["native_loader"]["path"] == str(native_loader.library_path())
    assert os.path.exists(summary["native_loader"]["path"])


# -- lite and expdecay through the runners -------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), n=40)


@pytest.mark.parametrize("mode", ["SummaryMixing-lite", "SummaryMixing-expdecay"])
def test_runners_take_the_mode(corpus, tmp_path, mode):
    """train (2 steps), evaluate (greedy), transcribe (2 files, one FLAC),
    serve (one WAV body through the HTTP handler) and export_model
    (`--check`: the artifact equal to the live model) run to their end
    with the recipe's cells in `mode`; the run's encoder holds that mode."""
    over = SMALL + ["--set", f"model.mode={mode}", "--device", "cpu"]
    run = str(tmp_path / "run")
    res = train.main([SYNTH, "--train-manifest", corpus["train"], "--valid-manifest",
                      corpus["dev"], "--output", run, "--steps", "2"] + SMALL_BATCHES + over)
    assert res["steps"] == 2 and np.isfinite(res["valid"]["loss"])
    summary = evaluate.main([SYNTH, "--test-manifest", corpus["test"], "--ckpt", run + "/save"]
                            + over)
    assert summary["utterances"] == 4 and np.isfinite(summary["WER"])
    utts = read_manifest_csv(corpus["test"])[:2]
    flac = str(tmp_path / "u.flac")
    with open(flac, "wb") as f:
        x = np.round(load_wav(utts[1].wav_path) * 32768).astype(np.int64)
        f.write(encode_flac(x, 16000))
    got = transcribe.main([SYNTH, utts[0].wav_path, flac, "--ckpt", run + "/save"] + over)
    assert got["utterances"] == 2
    cfg = load_recipe(SYNTH, overrides=common.parse_overrides(over[1:-2:2]))
    assert cfg.model.mode == mode
    infer, _ = serve.build_infer(cfg, run + "/save", 0, torch.device("cpu"))
    with DynamicBatchingServer(infer, ServingConfig(batch_size=2, max_wait_ms=5.0),
                               device="cpu") as srv:
        http = _Http(serve.make_handler(srv, 16000))
        try:
            with open(utts[0].wav_path, "rb") as f:
                assert "text" in http.post("/transcribe", f.read())
        finally:
            http.close()
    out = export_model.main([SYNTH, "--ckpt", run + "/save", "--output",
                             str(tmp_path / "m.smt"), "--check"] + over)
    assert out["check"] is True
    model, _, _, _ = common.restore_inference(cfg, run + "/save", 0, "cpu")
    assert model.asr.encoder.layer_0.mixer.mode == mode
    assert dataio.native_loader is native_loader
