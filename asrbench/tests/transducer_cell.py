"""A streaming Conformer-transducer cell made of new files only, for the
layout test: a configuration on the streaming transducer's recipe with its
small form, a streaming mix with its small form, limits, an entry that
drives chunks through `streaming.make_streaming_infer_fns` and has a fault,
a reference whose `param_shapes` is written out by hand (`transducer.`
included) and a reader. `write(here)` lays them out as the benchmark's
folder under `here` and returns the benchmark's entries for them.

Its one number, `samples_lost`, is what each stream's carry counts against
the samples fed; a real cell compares the tokens with a plain reference."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

TRANSDUCER_RECIPE = "recipes/LibriSpeech/conformer_summarymixing_transducer.yaml"
TINY_CONFORMER = {"model.d_model": 32, "model.num_encoder_layers": 1, "model.d_ffn": 64,
                  "model.nhead": 2, "model.local_proj_hid_dim": [32],
                  "model.local_proj_out_dim": 32, "model.summary_hid_dim": [32],
                  "model.output_neurons": 20, "transducer.joint_dim": 24,
                  "transducer.dec_dim": 16}
CELL = "conformer_tr.probe"
SOURCE = ("https://github.com/SamsungLabs/SummaryMixing/blob/main/recipes/LibriSpeech/ASR/"
          "transducer/hparams/conformer_summarymixing_transducer.yaml")

CONFIG = {
    "name": "conformer_tr_probe", "source": SOURCE, "recipe": TRANSDUCER_RECIPE,
    "reference": "conformer_tr_probe", "overrides": {}, "reduced": [],
    "features": {"sample_rate": 16000, "n_fft": 512, "win_length": 32, "n_mels": 80},
    "model": {"attention_type": "SummaryMixing", "mode": "SummaryMixing-fast",
              "encoder_module": "conformer", "d_model": 512, "nhead": 4,
              "num_encoder_layers": 12, "num_decoder_layers": 0, "d_ffn": 2048,
              "csgu_kernel_size": 31, "local_proj_hid_dim": [512], "local_proj_out_dim": 512,
              "summary_hid_dim": [512], "input_size": 640, "output_neurons": 1000,
              "frontend_channels": [64, 32], "frontend_strides": [2, 2], "blank_index": 0},
    "transducer": {"joint_dim": 640, "dec_dim": 512},
    "tiny": TINY_CONFORMER,
}

MIX = {"entry": "stream_probe",
       "why": "streams of 2-4 s, 4 to a batch, 16-frame chunks with 4 chunks of left context",
       "utterances": 8, "length_seed": 5,
       "lengths": {"kind": "uniform", "min_s": 2.0, "max_s": 4.0},
       "batching": {"max_batch_s": 16.0, "max_rows": 4}, "pad_quantum_s": 0.64,
       "chunk_frames": 16, "left_context_chunks": 4,
       "tiny": {"utterances": 3, "lengths": {"kind": "uniform", "min_s": 0.8, "max_s": 1.5},
                "batching": {"max_batch_s": 3.0, "max_rows": 2}, "pad_quantum_s": 0.32,
                "chunk_frames": 8, "left_context_chunks": 2}}

ENTRY = '''"""Each batch's streams chunk by chunk through the system's streaming step
(`streaming.make_streaming_infer_fns`), one batch after another for the
window; `correct` from the samples that each stream's carry counts against
those fed. Its fault: a step that returns its carry unchanged."""

import time

import torch

from asrbench.yardstick import traffic
from asrbench.yardstick.weights import make_norm_stats

TRACE_UNITS = 2


def _fault_unchanged():
    from summarymixing_tpu_torch import streaming
    saved = streaming.make_streaming_infer_fns

    def stuck(*args, **kwargs):
        init_fn, step_fn, info = saved(*args, **kwargs)
        return init_fn, lambda carry, wav, n: (carry,) + step_fn(carry, wav, n)[1:], info

    streaming.make_streaming_infer_fns = stuck
    return lambda: setattr(streaming, "make_streaming_infer_fns", saved)


FAULTS = {"unchanged": _fault_unchanged}
FAULT_NUMBERS = {"unchanged": "samples_lost"}


def run(cell, system, readers):
    from summarymixing_tpu_torch import streaming
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.training.profiling import span

    stats = make_norm_stats(cell.cfg["features"]["n_mels"], cell.seeds["stats"], cell.device)
    pool = traffic.make_pool(cell.mix, cell.seeds["data"], cell.device)
    init_fn, step_fn, info = streaming.make_streaming_infer_fns(
        system.model.eval(), system.transducer.eval(), system.fbank, InputNormalization(),
        stats, chunk_frames=cell.mix["chunk_frames"],
        left_context_chunks=cell.mix["left_context_chunks"])
    size = info["chunk_samples"]

    def stream(j):
        b = pool[j % len(pool)]
        carry = init_fn(b.wav.shape[0])
        for k in range(-(-b.wav.shape[1] // size)):
            chunk = b.wav[:, k * size:(k + 1) * size]
            chunk = torch.nn.functional.pad(chunk, (0, size - chunk.shape[1]))
            with span("stream.chunk"):
                carry = step_fn(carry, chunk, (b.wav_lens - k * size).clamp(0, size))[0]
        return j % len(pool), carry

    stream(0)
    setup_s = time.perf_counter() - cell.t0
    start, done, kept = time.perf_counter(), 0, None
    while True:
        out = stream(done)
        kept = kept or out
        done += 1
        if time.perf_counter() - start >= cell.seconds:
            break
    window_s = time.perf_counter() - start
    per_layer, trace = ({}, None) if not readers else cell._traced(
        system.model, readers, window_s, 0.0, done, stream)
    i, carry = kept
    lost = int((carry["valid_samples"] - pool[i].wav_lens).abs().sum())
    return cell._result({"streams_per_s": (done / window_s, "1/s"), "setup_s": (setup_s, "s")},
                        per_layer, {"samples_lost": lost}, done, 0, cell.peak_bytes(), trace)
'''

REFERENCE = '''"""The parameters of the streaming Conformer-SummaryMixing-fast
transducer, written out by hand in the system's naming."""


def param_shapes(cfg):
    m, t = cfg["model"], cfg["transducer"]
    d, v, ffn = m["d_model"], m["output_neurons"], m["d_ffn"]
    joint, dec, local = t["joint_dim"], t["dec_dim"], m["local_proj_out_dim"]
    out = []

    def lin(name, i, o, bias=True):
        out.append((f"{name}.weight", (o, i)))
        if bias:
            out.append((f"{name}.bias", (o,)))

    def norm(name, n):
        out.extend([(f"{name}.weight", (n,)), (f"{name}.bias", (n,))])

    prev = 1
    for i, c in enumerate(m["frontend_channels"]):
        out += [(f"cnn.conv_{i}.weight", (c, prev, 3, 3)), (f"cnn.conv_{i}.bias", (c,))]
        norm(f"cnn.norm_{i}", c)
        prev = c
    lin("asr.src_proj", m["input_size"], d)
    for layer in range(m["num_encoder_layers"]):
        p = f"asr.encoder.layer_{layer}"
        lin(f"{p}.mixer.global_proj.layer_0", d, 2 * local)
        lin(f"{p}.mixer.summary_local_merging.layer_0", 2 * local, d)
        c = f"{p}.convolution_module"
        out += [(f"{c}.conv_kernel", (d, 1, m["csgu_kernel_size"])), (f"{c}.conv_bias", (d,))]
        norm(f"{c}.layer_norm", d)
        lin(f"{c}.bottleneck", d, 2 * d)
        norm(f"{c}.after_norm", d)
        lin(f"{c}.pointwise_out", d, d)
        for f in ("ffn1", "ffn2"):
            lin(f"{p}.{f}.ffn_in", d, ffn)
            lin(f"{p}.{f}.ffn_out", ffn, d)
        for n in ("norm_ffn1", "norm_ffn2", "norm1", "norm2"):
            norm(f"{p}.{n}", d)
    norm("asr.encoder.norm", d)
    lin("ctc_lin", d, v)
    lin("transducer.proj_enc", d, joint, bias=False)
    out += [("transducer.predictor.lstm.weight_ih", (4 * dec, v - 1)),
            ("transducer.predictor.lstm.weight_hh", (4 * dec, dec)),
            ("transducer.predictor.lstm.bias", (4 * dec,))]
    lin("transducer.predictor.proj_dec", dec, joint, bias=False)
    lin("transducer.joint.transducer_lin", joint, v, bias=False)
    lin("transducer.proj_ctc", joint, v)
    lin("transducer.dec_lin", joint, v, bias=False)
    return out
'''

READER = '''def read(ctx):
    """Streaming steps in the traced stretch (one `stream.chunk` span each)
    and the cell kernel's plain calls."""
    return (len(ctx.spans.span_steps["stream.chunk"])
            + ctx.counters["summary_mixing"]["plain_calls"])
'''


def write(here: Path) -> Dict:
    """The cell's files under `here` (laid out as the benchmark's folder,
    which `here.parent` holds) and its entries of `BENCHMARK.json`."""
    for d in ("configs", "traffic", "limits", "entries", "reference", "metrics"):
        (here / d).mkdir(parents=True)
    (here / "configs" / f"{CONFIG['name']}.json").write_text(json.dumps(CONFIG, indent=1))
    (here / "traffic" / "stream_probe_mix.json").write_text(json.dumps(MIX, indent=1))
    (here / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": {"samples_lost": 0}}))
    (here / "entries" / "stream_probe.py").write_text(ENTRY)
    (here / "reference" / f"{CONFIG['reference']}.py").write_text(REFERENCE)
    (here / "metrics" / "stream_chunks.py").write_text(READER)
    return {"configs": [{"name": CONFIG["name"], "source": SOURCE,
                         "file": f"{here.name}/configs/{CONFIG['name']}.json", "reduced": [],
                         "why": "the streaming Conformer-SummaryMixing-fast transducer"}],
            "workloads": [{"name": CELL, "config": CONFIG["name"], "traffic": "stream_probe_mix",
                           "chips": 1, "why": "a cell of new files only"}],
            "end_to_end": [{"name": "streams_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.1, "source": "host_clock", "workloads": [CELL]},
                           {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                            "source": "host_clock"}],
            "per_layer": [{"name": "stream_chunks", "unit": "1", "better": "higher",
                           "source": "program_span", "layer": "entry", "moves": "streams_per_s",
                           "workloads": [CELL]}]}
