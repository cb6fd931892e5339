#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`summarymixing_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: refuse to run without CUDA; print the card, the device count, its
   name and power limit from nvidia-smi, and turn TF32 off for matmuls and
   convolutions so the plain versions compute in full float32.
2. Build: compile every kernel source with nvcc (all at once) into the
   ignored `build/kernels/`; print build seconds and the ptxas report, and
   fail if any kernel spills registers.
3. Kernels against their plain versions at the flagship shapes (B=8, T=751,
   ragged lengths): the SummaryMixing cell with erf and tanh GELU, the cgMLP
   branch with tanh GELU. Prints errors against stated tolerances and the
   bound for the same work. Kernel times come from a CUDA graph of 20 calls
   replayed between CUDA events, so the wrappers' host work cannot set them
   (the eager per-call time is printed beside); each pass's device time by
   kernel name comes from torch.profiler, beside its own bound; cuBLAS
   (`torch.nn.functional.linear`) is timed at the cgMLP's two product shapes
   as a yardstick the port never calls.
4. Main path: the flagship Branchformer-SummaryMixing (18 layers, d512,
   vocab 5000, bf16, seeded random weights and NormStats) serves 4 requests
   of 8 synthetic 5-30 s utterances through `batch_waveforms` and
   `greedy_ctc_decode`, each shape warmed up once before the timed pass;
   each kernel's launch counter must rise by 18 per forward.
   Phase 3 also checks both kernels with a dropout keep-mask (rate 0.1)
   at the training shapes (B=16, T=751) against their plain versions, checks
   that their autograd Functions' gradients equal the plain versions'
   autograd gradients bit for bit, and times the masked passes, the cell's
   pooled pass beside its bound.
5. The same first request with both kernels swapped for their plain
   versions, on the card: CTC log-probs and greedy tokens are compared.
6. Device time by kernel over the first request under torch.profiler.
7. Training: the flagship with its 6-layer attention decoder (119,304,304
   parameters, float32, bf16 compute, xavier overwrite from seed 3407,
   dropout 0.1, speed perturbation and SpecAugment on) trains on one batch
   of 16 synthetic utterances (5-30 s, the first 30 s, about 3 random token
   ids per second) through `ASRTrainer.train_step`: one warm-up step, then 5
   timed steps with loss, grad norm and skip flag each; every parameter must
   get a gradient and each kernel's forward and backward counters must rise
   by 18 per step. Audio-seconds per second, the device busy share of one
   step under torch.profiler, and one step with the kernels against the
   same step with their plain versions (same weights, batch and dropout
   masks, augmentation off): loss and per-tensor gradient differences.
8. Checkpoints: three more training steps, each followed by a save through
   `training.checkpoint.CheckpointManager` into a temporary directory;
   `average_checkpoints` over the three must equal the float64 mean of the
   three parameter sets taken directly.
9. Beam evaluation (the recipe's test stage): a fresh flagship with its
   decoder gets the averaged parameters through
   `evaluate.restore_eval_state`; the Transformer LM at `LMConfig()` (12
   layers, d768, vocab 5000, 92,741,000 parameters, float32) is built from
   the seed; request 0 of phase 4 (8 utterances, T = 751) goes through
   `evaluate.evaluate_beam`: the encoder, then the joint CTC/attention beam
   search at beam 66 (528 rows), CTC weight 0.4, LM weight 0.6, decoder and
   LM temperature 1.15, with the KV-cached decoder and LM. Prints latency,
   steps, ms per step, the encoder's and the search's shares, audio-s/s,
   tokens per row, the error rate against seeded token references (not
   held) and peak memory; each kernel's launch counter must rise by 18.
   Checks, each against the tolerance stated below: (a) the cached decoder
   step against `decode_position` over the best hypotheses' prefixes and
   (b) the cached LM step against the full causal LM, both at the search's
   528 rows, (c) the CTC prefix
   scorer's eos log-prob of each best hypothesis against `-ctc_loss`;
   reported only: (d) the same request with the plain versions of both
   kernels. Then torch.profiler over search steps 100-107.
10. Transducer inference (the streaming Conformer-SummaryMixing
   transducer recipe, `recipes/LibriSpeech/conformer_summarymixing_transducer.yaml`,
   built in Python: 12 layers, d512, SummaryMixing-fast with nhead 4, d_ffn
   2048, kernel 31, tanh-GELU, bf16 compute; a 1-layer LSTM predictor of
   512, a sum joint of 640, vocabulary 1000; 79,254,832 parameters from seed
   3407). The 32 utterances of phase 4 in 4 requests of 8 go through
   `transcribe.transducer_greedy_transcribe` (each shape warmed up once):
   latency and audio-s/s per request. Request 0 goes through
   `evaluate.streaming_decode` (chunks of 16 encoder frames, 640 ms of
   audio, with 4 chunks of left context): median and max ms per chunk; and
   through `streaming.run_stream` on raw audio: ms per step. Held: (a) in
   float32 with TF32 off, chunk-by-chunk `encode_streaming` against the
   offline encode under `DynChunkTrainConfig(16, 4)` on the same CNN output,
   within STREAM_TOL over the valid frames. Reported, not held: (a) in
   bf16, the rows where `run_stream` and `streaming_decode` give the same
   tokens (in bf16 and in float32), and the bf16 offline encoder against
   the float32 one. Peak
   memory, and device time by kernel of request 0's greedy decode under
   torch.profiler. No hand-written kernel lies on this path: both launch
   counters must stay at 0 through the phase.
11. Peak memory, parameter counts (88,954,088 for decode, 119,304,304 with
   the decoder) and wall time.
12. Runners, synthetic recipe: `recipes/make_synthetic_corpus.py --hard`
   writes a corpus of 400 utterances (320/40/40) and 2,000 LM sentences in a
   subprocess; the port's runners, called in this process, train
   `recipes/Synthetic/hard_synthetic.yaml` (d128, float32) for 30 steps with
   the test stage, train its Transformer LM for 30 steps, and evaluate the
   test split greedy, with `--beam` and with `--beam --lm-ckpt`, all with
   `--avg 2`. Neither kernel takes this configuration: every cell and cgMLP
   branch must run the plain path, counted in `plain_calls` (above 0), with
   no launch. Prints each stage's WER, step times, seconds and peak memory.
13. Runners, flagship recipe: `recipes/LibriSpeech/branchformer_summarymixing.yaml`
   at full width and depth (its unigram tokenizer trained on the corpus)
   trains for 4 steps through the train runner (batches of 60 s in 2
   buckets: the recipe's 500 s batches hold no full batch of this corpus),
   with greedy validation, then the evaluate runner decodes one batch of 8
   dev utterances greedily. Each kernel's launches must rise by 18 per
   forward (train steps and validation batches), its backward by 18 per
   step, and `plain_calls` must stay 0. Prints steps, ms per step, the
   tokenizer's piece count and peak memory.
   In both runner phases the counts that the train and evaluate runners
   report in their summaries must equal the wrappers' counters.

`plain_calls` (cells or cgMLP branches on the card whose configuration the
kernel does not take, run on the plain path) is set to 0 at phase 4 and
must still be 0 after phases 4, 7 and 9: the flagship takes both kernels
everywhere. The kernels line reports `launches` and `plain_calls` summed
over phases 4, 7, 9, 10, 12 and 13, and each by phase.

The line before the last holds nvidia-smi's name and power limit; the last
line is `{"ok": true, "device": {...}}`. No JAX is imported here.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP_PARAMS = 88_954_088
FLAGSHIP_TRAIN_PARAMS = 119_304_304   # with the 6-layer attention decoder
LENGTHS = [751, 700, 512, 401, 751, 300, 650, 64]   # ragged encoder frames, T = 751
N_REQUESTS, BATCH = 4, 8
# training shapes: the recipe's batch_size 16, ragged, T = 751
TRAIN_LENGTHS = LENGTHS + [600, 420, 233, 751, 128, 555, 380, 690]
TRAIN_BATCH, TRAIN_STEPS, DROPOUT = 16, 5, 0.1
H100_BF16_FLOPS = 989e12      # dense tensor-core bf16, H100 SXM data sheet
H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # HBM3
# Tolerances, on max |kernel - plain| / (1 + |plain|) over every output:
# both sides round their intermediates to bf16 at the same points and
# accumulate in fp32, but in another order, which can move an intermediate by
# one bf16 step (2^-8 relative) and the bf16 output by a few steps.
CELL_TOL = 2.0 ** -5
# The cgMLP kernel also rounds the 3072-wide GELU output and the gated conv
# output to bf16 where the plain version keeps fp32: two more rounding steps
# that feed a LayerNorm and a 1536-deep product.
CSGU_TOL = 2.0 ** -4
# One training step with the kernels against the same step with their plain
# versions, both in bf16 compute with the same dropout masks: the kernels
# round their intermediates where the plain versions keep fp32 (see above),
# 18 layers deep, forward and backward.
TRAIN_LOSS_TOL = 1e-2      # |loss_kernel - loss_plain| / |loss_plain|
TRAIN_GRAD_TOL = 5e-2      # per tensor ||g_kernel - g_plain|| / ||g_plain||
# gradients that are zero in exact arithmetic (the attention's key biases:
# a shift of all scores of a row) are float32 noise in both runs; a tensor
# whose plain gradient norm is below this share of the global norm is
# reported, not held to TRAIN_GRAD_TOL
GRAD_NOISE_SHARE = 1e-6
# beam evaluation (phase 9)
FLAGSHIP_LM_PARAMS = 92_741_000   # LMConfig() at vocab 5000: 12 layers, d768, linear head
N_CHECKPOINTS = 3
# average_checkpoints against the float64 mean taken directly: one float32
# rounding of the same float64 sums (2^-24 relative)
AVG_TOL = 1e-7
# (a) the cached decoder step against decode_position, both in bf16 compute,
# on max |cached - prefix| / (1 + |prefix|): the same products over another
# number of rows, and the masked attention of the cache against the
# additive-bias attention of the prefix, round intermediates differently.
# Set a few times above the reading on an H100 (PERF.md)
DEC_STEP_TOL = 2.0 ** -7
# (b) the cached LM step against the full forward, float32 with TF32 off,
# on max |dlogp|: products over another number of rows, 12 layers deep.
# Set about four times above the largest reading on an H100 (PERF.md)
LM_STEP_TOL = 2e-5
# (c) the prefix scorer's closed forms (cumulative sums of log-probs over
# T <= 751 frames, float32) against torch's CTC forward on the same lattice:
# |eos log-prob + ctc_loss| <= CTC_TOL_REL * |ctc_loss| + CTC_TOL_ABS
CTC_TOL_REL, CTC_TOL_ABS = 1e-4, 1e-3
# transducer inference (phase 10)
TRANSDUCER_PARAMS = 79_254_832   # 73,581,896 recognizer + 5,672,936 transducer
STREAM_CHUNK, STREAM_LEFT = 16, 4   # recipes/evaluate.py --chunk-size, --left-context
# (a) chunk-by-chunk encode_streaming against the offline DCT encode, float32
# with TF32 off, on max |stream - offline| / (1 + |offline|) over the valid
# frames: the same arithmetic, but the pooled summary is a masked mean over
# the 80 frames of [left context | chunk] in one path and a [T, T] masked
# product in the other, and the DCConv's taps are summed in another order:
# float32 rounding (2^-24) over sums of up to 80 terms, 12 layers deep
STREAM_TOL = 1e-4
# runner phases (12-13): the JAX package's synthetic-corpus protocol at a
# smaller training budget (benchmarks/RESULTS.md used --n 400 --lm-text 20000)
RUNNER_CORPUS_N, RUNNER_LM_TEXT = 400, 2000
SYNTH_RECIPE = "recipes/Synthetic/hard_synthetic.yaml"
FLAGSHIP_RECIPE = "recipes/LibriSpeech/branchformer_summarymixing.yaml"
RUNNER_SYNTH_STEPS, RUNNER_LM_STEPS = 30, 30
# the flagship's 500 s batches and 200 buckets hold no full batch of this
# corpus (320 utterances of 1.5-5 s): 2 buckets of 60 s
RUNNER_FLAGSHIP_STEPS, RUNNER_FLAGSHIP_BUCKETS, RUNNER_FLAGSHIP_BATCH_S = 4, 2, 60.0
RUNNER_FLAGSHIP_EVAL_UTTS = 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def hold_no_plain_calls(phase: str) -> dict:
    """Fail unless both wrappers' plain-call counters are 0: every cell and
    cgMLP branch of the flagship takes its kernel. Returns the counters as
    read, by kernel."""
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    plain = {"summary_mixing": fused_summary.fused_summary_mixing.plain_calls,
             "csgu": fused_csgu.fused_convolution_branch.plain_calls}
    if any(plain.values()):
        fail(f"{phase}: the flagship ran {plain} cells/branches on the plain path")
    return plain


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Per-call device time of `fn`: a CUDA graph of `calls` calls, captured
    once and replayed `replays` times between CUDA events."""
    import torch

    fn()   # anything built or declared on first use happens outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def pass_us(fn, calls: int = 20) -> dict:
    """Device microseconds per call of each kernel `fn` launches, by kernel
    name, from torch.profiler over `calls` eager calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out[e.key] = out.get(e.key, 0.0) + us / calls
    return out


def report_passes(kernel: str, measured: dict, passes: list) -> list:
    """Match each (label, key regex, bound ms, bound by, library ms) pass to
    the profiler's kernel names; print and return the rows."""
    rows = []
    for label, key, bound_ms, by, lib_ms in passes:
        hits = [us for name, us in measured.items() if re.search(key, name)]
        if len(hits) != 1:
            fail(f"{kernel}: pass {label} ({key!r}) matched {len(hits)} profiled kernels: "
                 f"{sorted(measured)}")
        ms = hits[0] / 1e3
        rows.append(dict(name=label, ms=ms, bound_ms=bound_ms, bound_by=by,
                         share_of_bound=bound_ms / ms, library_ms=lib_ms))
        lib = f", cuBLAS {lib_ms:.4f} ms" if lib_ms is not None else ""
        print(f"  pass {kernel}.{label}: {ms:.4f} ms device, bound {bound_ms:.4f} ms ({by}), "
              f"{100 * bound_ms / ms:.1f}% of bound{lib}")
    total = sum(r["ms"] for r in rows)
    print(f"  passes {kernel}: {total:.4f} ms summed device time per call")
    return rows


def rel_err(got, want) -> tuple:
    import torch

    g, w = got.to(torch.float32), want.to(torch.float32)
    if not torch.isfinite(g).all():
        fail("kernel output is not finite")
    diff = (g - w).abs()
    return float(diff.max()), float((diff / (1.0 + w.abs())).max())


def bound(nbytes: float, tensor_flops: float, fp32_flops: float = 0.0) -> tuple:
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = tensor_flops / H100_BF16_FLOPS + fp32_flops / H100_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"tf32: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build():
    from summarymixing_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall for {sorted(report)}")
    for name, r in report.items():
        print(f"build {name}: {r['seconds']:.1f} s")
        for line in r["ptxas"].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", r["ptxas"])]
        if any(spills):
            fail(f"csrc/{name}.cu: a kernel spills registers (ptxas report above)")


def phase_kernels():
    import torch

    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    b, t, d, c2, k = BATCH, max(LENGTHS), 512, 3072, 31
    bf = torch.bfloat16

    def w(*shape, scale=None, dtype=bf):
        fan_in = shape[-1] if len(shape) > 1 else 512
        s = scale if scale is not None else fan_in ** -0.5
        return ((torch.rand(*shape, generator=g, device=dev) * 2 - 1) * s).to(dtype)

    x = torch.randn(b, t, d, generator=g, device=dev).to(bf)
    lens = torch.tensor(LENGTHS, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(torch.float32)
    pad = mask[..., None].contiguous()
    merge = w(d, 2 * d)
    cell = (w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1),
            w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1),
            merge[:, :d], merge[:, d:], w(d, scale=0.1))
    rows = {}
    for act in ("gelu_exact", "gelu"):
        got = fused_summary.fused_summary_mixing(x, pad, cell, act)
        want = fused_summary.summary_mixing_reference(x, pad, cell, act)
        torch.cuda.synchronize()
        abs_err, err = rel_err(got, want)
        ok = err <= CELL_TOL
        print(f"kernel summary_mixing[{act}]: max_abs_err {abs_err:.3e} "
              f"max_rel_err {err:.3e} tol {CELL_TOL:.3e} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"summary_mixing[{act}] disagrees with its plain version")
        rows[act] = abs_err
    cell_call = lambda: fused_summary.fused_summary_mixing(x, pad, cell, "gelu")  # noqa: E731
    ms = graph_ms(cell_call)
    eager_ms = cuda_ms(cell_call)
    plain_ms = cuda_ms(lambda: fused_summary.summary_mixing_reference(x, pad, cell, "gelu"))
    m, valid = b * t, int(mask.sum())
    cell_bytes = (x.numel() * 2 + pad.numel() * 4 + m * d * 2
                  + sum(v.numel() * v.element_size() for v in cell))
    # A padded frame needs no product: its local row is zeroed, its summary
    # row is masked out of the mean, so its output is the per-utterance bias.
    cell_flops = 2 * valid * d * d * 5 + 2 * b * d * d
    cell_bound, cell_by = bound(cell_bytes, cell_flops)
    print(f"kernel summary_mixing: {ms:.4f} ms (graph), eager {eager_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {cell_bound:.4f} ms "
          f"({cell_by}: {cell_flops / 1e9:.2f} GFLOP over {valid} valid of {m} frames, "
          f"{cell_bytes / 1e6:.2f} MB)")
    # Per-pass bounds from the shapes. The branch pass needs the five products
    # over the valid frames, x's valid rows, the weights and the fp32
    # pre-activation of the valid rows; the pool a 512 x 512 product per
    # utterance; the finish pass reads pre and writes the output.
    n_tiles = -(-t // 64)
    mats = sum(v.numel() * 2 for v in cell[:8]) + d * d * 2
    cell_passes = report_passes("summary_mixing", pass_us(cell_call), [
        ("branch_pass", "branch_pass", *bound(valid * d * 2 + mats + valid * d * 4,
                                               2 * valid * d * d * 5), None),
        ("pool_pass", "pool_pass", *bound(b * n_tiles * d * 4 + d * d * 2 + m * 4 + b * d * 4,
                                           2 * b * d * d), None),
        ("finish_pass", "finish_pass", *bound(valid * d * 4 + m * 4 + b * d * 4 + m * d * 2, 0),
         None)])

    branch = (w(c2, d), w(c2, scale=0.1, dtype=torch.float32),
              1.0 + w(c2 // 2, scale=0.1, dtype=torch.float32),
              w(c2 // 2, scale=0.1, dtype=torch.float32),
              w(k, c2 // 2, scale=k ** -0.5, dtype=torch.float32),
              1.0 + w(c2 // 2, scale=0.1, dtype=torch.float32),
              w(d, c2 // 2), w(d, scale=0.1, dtype=torch.float32))
    got = fused_csgu.fused_convolution_branch(x, mask, branch)
    want = fused_csgu.convolution_branch_reference(x, mask, branch)
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    ok = err <= CSGU_TOL
    print(f"kernel csgu[gelu]: max_abs_err {abs_err:.3e} max_rel_err {err:.3e} "
          f"tol {CSGU_TOL:.3e} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("csgu disagrees with its plain version")
    csgu_call = lambda: fused_csgu.fused_convolution_branch(x, mask, branch)  # noqa: E731
    csgu_ms = graph_ms(csgu_call)
    csgu_eager = cuda_ms(csgu_call)
    csgu_plain = cuda_ms(lambda: fused_csgu.convolution_branch_reference(x, mask, branch))
    csgu_bytes = (x.numel() * 2 + mask.numel() * 4 + m * d * 2
                  + sum(v.numel() * v.element_size() for v in branch))
    # every frame counts here: `res` is not masked, so a padded frame's output
    # still depends on its own input
    csgu_flops = 2 * m * d * c2 + 2 * m * (c2 // 2) * d
    conv_flops = 2 * m * (c2 // 2) * k
    csgu_bound, csgu_by = bound(csgu_bytes, csgu_flops, conv_flops)
    print(f"kernel csgu: {csgu_ms:.4f} ms (graph), eager {csgu_eager:.4f} ms, "
          f"plain {csgu_plain:.4f} ms, bound {csgu_bound:.4f} ms "
          f"({csgu_by}: {csgu_flops / 1e9:.2f} GFLOP bf16 + {conv_flops / 1e9:.2f} GFLOP fp32 "
          f"conv, {csgu_bytes / 1e6:.2f} MB)")
    # cuBLAS at the two product shapes, a yardstick the port never calls
    c = c2 // 2
    x2 = x.reshape(m, d)
    g2 = torch.randn(m, c, generator=g, device=dev).to(bf)
    b_pre16, b_post16 = branch[1].to(bf), branch[7].to(bf)
    lib_pre = graph_ms(lambda: torch.nn.functional.linear(x2, branch[0], b_pre16))
    lib_post = graph_ms(lambda: torch.nn.functional.linear(g2, branch[6], b_post16))
    # Per-pass bounds from the shapes: each product's operands and result once;
    # the statistics read the valid rows' gate half; the gate pass reads the
    # valid rows' gate half, every row's res half and writes g, and its conv
    # taps run in fp32.
    csgu_passes = report_passes("csgu", pass_us(csgu_call), [
        # gemm_tma<stages, activation id>
        ("gemm_pre (512->3072, tanh-GELU)", r"gemm_tma<\d+, 2>",
         *bound(m * d * 2 + c2 * d * 2 + c2 * 4 + m * c2 * 2, 2 * m * d * c2), lib_pre),
        ("ln_stats", "ln_stats", *bound(valid * c * 2 + m * 4 + valid * 8, 0), None),
        ("gate_pass", "gate_pass", *bound(valid * c * 2 + m * c * 2 + m * 4 + valid * 8
                                          + (k + 4) * c * 4 + m * c * 2, 0, conv_flops), None),
        ("gemm_post (1536->512)", r"gemm_tma<\d+, 0>",
         *bound(m * c * 2 + d * c * 2 + d * 4 + m * d * 2, 2 * m * c * d), lib_post)])
    return {
        "summary_mixing": dict(
            name="summary_mixing", route="cuda",
            source="summarymixing_tpu_torch/csrc/summary_mixing.cu",
            replaces="summarymixing_tpu/ops/pallas_summary.py:109",
            max_abs_err=max(rows.values()), ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
            bound_ms=cell_bound, bound_by=cell_by, library_ms=None, passes=cell_passes),
        "csgu": dict(
            name="csgu", route="cuda", source="summarymixing_tpu_torch/csrc/csgu.cu",
            replaces="summarymixing_tpu/ops/pallas_csgu.py:126",
            max_abs_err=abs_err, ms=csgu_ms, eager_ms=csgu_eager, plain_ms=csgu_plain,
            bound_ms=csgu_bound, bound_by=csgu_by, library_ms=None, passes=csgu_passes),
    }


def phase_masked_kernels(kernel_rows):
    """Both kernels with a dropout keep-mask at the training shapes: forward
    against the plain version, the autograd Function's gradients against
    the plain version's autograd gradients (bit for bit), and the masked
    forward's time, the cell's pooled pass beside its bound."""
    import torch

    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    dev = torch.device("cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # the depthwise conv's backward, bit for bit
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    b, t, d, c2, k = TRAIN_BATCH, max(TRAIN_LENGTHS), 512, 3072, 31
    c, keep_prob = c2 // 2, 1.0 - DROPOUT
    f32 = torch.float32

    def w(*shape, scale=None):
        s_ = scale if scale is not None else (shape[-1] if len(shape) > 1 else 512) ** -0.5
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * s_

    x = torch.randn(b, t, d, generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor(TRAIN_LENGTHS, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(f32)
    pad = mask[..., None].contiguous()
    merge = w(d, 2 * d)
    cell = (w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1),
            w(d, d), w(d, scale=0.1), merge[:, :d], merge[:, d:], w(d, scale=0.1))
    branch = (w(c2, d), w(c2, scale=0.1), 1.0 + w(c, scale=0.1), w(c, scale=0.1),
              w(k, c, scale=k ** -0.5), 1.0 + w(c, scale=0.1), w(d, c), w(d, scale=0.1))
    keep_cell = torch.rand(b, t, 2 * d, generator=g, device=dev) < keep_prob
    keep_branch = torch.rand(b, t, c, generator=g, device=dev) < keep_prob
    g_out = torch.randn(b, t, d, generator=g, device=dev).to(torch.bfloat16)
    m, valid = b * t, int(mask.sum())
    specs = {
        "summary_mixing": (fused_summary, cell, CELL_TOL,
                           lambda xx, ws, **kw: fused_summary.fused_summary_mixing(
                               xx, pad, ws, "gelu", keep_cell, keep_prob, **kw),
                           lambda xx, ws: fused_summary.summary_mixing_reference(
                               xx, pad, fused_summary.kernel_weights(ws), "gelu", keep_cell,
                               keep_prob)),
        "csgu": (fused_csgu, branch, CSGU_TOL,
                 lambda xx, ws, **kw: fused_csgu.fused_convolution_branch(
                     xx, mask, ws, 1e-5, keep_branch, keep_prob, **kw),
                 lambda xx, ws: fused_csgu.convolution_branch_reference(
                     xx, mask, fused_csgu.kernel_weights(ws), 1e-5, keep_branch, keep_prob)),
    }
    for name, (mod, weights, tol, kern, plain) in specs.items():
        grads = []
        for fn in (kern, plain):
            xx = x.detach().requires_grad_()
            ws = [v.detach().requires_grad_() for v in weights]
            out = fn(xx, ws)
            grads.append((out.detach(), torch.autograd.grad(out, [xx] + ws, g_out)))
        torch.cuda.synchronize()
        abs_err, err = rel_err(grads[0][0], grads[1][0])
        bit_equal = all(torch.equal(a, b_) for a, b_ in zip(grads[0][1], grads[1][1]))
        ok = err <= tol and bit_equal
        print(f"masked kernel {name} (B={b}, T={t}, dropout {DROPOUT}): max_abs_err {abs_err:.3e} "
              f"max_rel_err {err:.3e} tol {tol:.3e}; Function gradients equal the plain "
              f"version's bit for bit: {bit_equal} {'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"masked {name} disagrees with its plain version")
        torch.backends.cudnn.deterministic = deterministic
        launch = mod.kernel_weights(weights)
        call = lambda: kern(x, launch)  # noqa: E731
        ms, eager = graph_ms(call), cuda_ms(call)
        plain_ms = cuda_ms(lambda: plain(x, weights))
        # the unmasked call's bytes plus the keep-mask's, one byte an element;
        # the cell's pooled half is now a product for every frame
        # (x in, out: bf16; pad: fp32; the kernel reads bf16 matrices, and the
        # cell's vectors in bf16, the cgMLP's in fp32)
        if name == "summary_mixing":
            w_bytes = sum(v.numel() * 2 for v in weights)
            nbytes = m * d * 4 + m * 4 + m * 2 * d + w_bytes
            flops, fp32 = 2 * valid * d * d * 5 + 2 * m * d * d, 0
        else:
            w_bytes = sum(v.numel() * (2 if i in (0, 6) else 4) for i, v in enumerate(weights))
            nbytes = m * d * 4 + m * 4 + m * c + w_bytes
            flops, fp32 = 2 * m * d * c2 + 2 * m * c * d, 2 * m * c * k
        bound_ms, bound_by = bound(nbytes, flops, fp32)
        kernel_rows[name]["masked"] = dict(batch=b, frames=t, max_abs_err=abs_err,
                                           grad_bit_equal=bit_equal, ms=ms, eager_ms=eager,
                                           plain_ms=plain_ms, bound_ms=bound_ms,
                                           bound_by=bound_by)
        print(f"masked kernel {name}: {ms:.4f} ms (graph), eager {eager:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # the cell's passes with the mask; the pooled pass runs the masked pooled
    # rows of every frame against M2 and adds them to the fp32 pre-activation
    n_tiles = -(-t // 64)
    mats = sum(v.numel() * 2 for v in cell[:8]) + d * d * 2
    cell_launch = fused_summary.kernel_weights(cell)
    cell_call = lambda: specs["summary_mixing"][3](x, cell_launch)  # noqa: E731
    kernel_rows["summary_mixing"]["masked"]["passes"] = report_passes(
        "summary_mixing[masked]", pass_us(cell_call), [
            ("branch_pass", "branch_pass",
             *bound(valid * d * 2 + mats + valid * d * 4 + valid * d, 2 * valid * d * d * 5), None),
            ("pool_pass", "pool_pass", *bound(b * n_tiles * d * 4 + m * 4 + b * d * 6, 0), None),
            ("pooled_pass", "pooled_pass",
             *bound(m * d + b * d * 2 + d * d * 2 + valid * d * 4 + m * d * 4, 2 * m * d * d),
             None),
            ("finish_pass", "finish_pass", *bound(m * d * 4 + b * d * 4 + m * 4 + m * d * 2, 0),
             None)])


def flagship_config(decoder_layers: int = 0):
    from summarymixing_tpu_torch.config.schema import (
        AugmentConfig, DecodingConfig, FeaturesConfig, ModelConfig, RecipeConfig, TrainingConfig)

    # recipes/LibriSpeech/branchformer_summarymixing.yaml (no YAML package is
    # needed here), with or without the attention decoder
    return RecipeConfig(
        seed=3407,
        decoding=DecodingConfig(test_beam_size=66, lm_weight=0.60, lm_temperature=1.15,
                                test_temperature=1.15, ctc_weight_decode=0.40),
        features=FeaturesConfig(sample_rate=16000, n_fft=512, win_length=32, n_mels=80,
                                normalize_update_until_epoch=4),
        augment=AugmentConfig(speed_perturb=True, speeds=(95, 100, 105),
                              time_drop_length_low=15, time_drop_length_high=25,
                              time_drop_count=4, freq_drop_length_low=10,
                              freq_drop_length_high=20, freq_drop_count=4, time_warp_window=5,
                              drop_replace="mean", min_augmentations=3, max_augmentations=3),
        model=ModelConfig(
            attention_type="SummaryMixing", mode="SummaryMixing", encoder_module="branchformer",
            d_model=512, nhead=1, num_encoder_layers=18, num_decoder_layers=decoder_layers,
            d_ffn=2048, transformer_dropout=DROPOUT, activation="gelu", csgu_linear_units=3072,
            csgu_kernel_size=31, local_proj_hid_dim=(512,), local_proj_out_dim=512,
            summary_hid_dim=(512,), summary_out_dim=512, causal=False, input_size=640,
            output_neurons=5000),
        training=TrainingConfig(precision="bf16", batch_size=TRAIN_BATCH,
                                grad_accumulation_factor=1, max_grad_norm=5.0, ctc_weight=0.3,
                                label_smoothing=0.0, lr_adam=0.0005, adam_betas=(0.9, 0.98),
                                adam_eps=1e-9, weight_decay=0.01, scheduler="noam",
                                n_warmup_steps=30000, max_batch_length=500.0))


def synthetic_waveforms(n: int, seed: int, sample_rate: int = 16000):
    """n utterances of 5-30 s: a few drifting tones over noise. The first is
    30 s, so the first request runs at the shapes phase 3 checks the kernels
    at (T = 751 encoder frames)."""
    rng = np.random.default_rng(seed)
    wavs = []
    for i in range(n):
        secs = 30.0 if i == 0 else rng.uniform(5.0, 30.0)
        tt = np.arange(int(secs * sample_rate)) / sample_rate
        sig = 0.02 * rng.standard_normal(tt.shape)
        for _ in range(3):
            f0 = rng.uniform(100.0, 3000.0)
            sig += 0.1 * np.sin(2 * np.pi * (f0 * tt + 20.0 * np.sin(2 * np.pi * 0.5 * tt)))
        wavs.append(sig.astype(np.float32))
    return wavs


def seeded_norm_stats(seed: int = 7) -> dict:
    """InputNormalization statistics of 80 mels on the card, from a seed:
    means around -10 dB, standard deviations 4-8 dB."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    count = torch.tensor(1.0e5, device="cuda")
    std = 4.0 + 4.0 * torch.rand(80, generator=g, device="cuda")
    return {"count": count, "mean": -10.0 + 5.0 * torch.randn(80, generator=g, device="cuda"),
            "m2": std ** 2 * (count - 1.0)}


def phase_main_path(kernel_rows):
    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
    from summarymixing_tpu_torch.transcribe import batch_waveforms, greedy_ctc_decode

    cfg = flagship_config()
    n_layers = cfg.model.num_encoder_layers
    torch.cuda.reset_peak_memory_stats()
    model, fbank = build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    stats = seeded_norm_stats()
    wavs = synthetic_waveforms(N_REQUESTS * BATCH, seed=11)
    batches = list(batch_waveforms(wavs, BATCH, pad_quantum=cfg.features.sample_rate // 2))
    if len(batches) != N_REQUESTS:
        fail(f"expected {N_REQUESTS} requests, got {len(batches)}")

    for _, wav, lens in batches:   # warm-up: library kernels pick algorithms per shape
        greedy_ctc_decode(model, fbank, stats, wav, lens)
    torch.cuda.synchronize()
    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    for fn in kernels:
        # plain_calls is set to 0 here once: the flagship phases 4-9 must
        # all leave it there (checked in each of phases 4, 7 and 9)
        fn.launches, fn.plain_calls = 0, 0
    results = []
    for r, (idx, wav, lens) in enumerate(batches):
        before = [fn.launches for fn in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps, out = greedy_ctc_decode(model, fbank, stats, wav, lens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rose = [fn.launches - b0 for fn, b0 in zip(kernels, before)]
        lp = out["ctc_log_probs"]
        if not torch.isfinite(lp).all():
            fail(f"request {r}: non-finite CTC log-probs")
        if lp.shape[0] != BATCH or lp.shape[2] != cfg.model.output_neurons:
            fail(f"request {r}: CTC log-probs of shape {tuple(lp.shape)}")
        audio_s = float(lens.sum()) / cfg.features.sample_rate
        print(f"request {r}: {BATCH} utterances, wav [{wav.shape[0]}, {wav.shape[1]}], "
              f"{audio_s:.2f} audio-s, latency {dt * 1e3:.2f} ms, {audio_s / dt:.1f} audio-s/s, "
              f"encoder frames {lp.shape[1]}, tokens per row {[len(h) for h in hyps]}, "
              f"launches summary_mixing +{rose[0]} csgu +{rose[1]}")
        if rose != [n_layers, n_layers]:
            fail(f"request {r}: kernel launches rose by {rose}, expected {n_layers} each")
        if r == 0 and lp.shape[1] != max(LENGTHS):
            fail(f"request 0 has {lp.shape[1]} encoder frames, not the {max(LENGTHS)} "
                 "the kernels were checked at")
        results.append((dt, audio_s, out, hyps))
    launches = {"summary_mixing": kernels[0].launches, "csgu": kernels[1].launches}
    plain = hold_no_plain_calls("decode")
    for name, n in launches.items():
        kernel_rows[name]["launches_by_path"] = {"decode": n}
        kernel_rows[name]["plain_calls_by_path"] = {"decode": plain[name]}
        if n == 0:
            fail(f"kernel {name} was never launched on the main path")
    total_dt = sum(r[0] for r in results)
    total_audio = sum(r[1] for r in results)
    print(f"main path: {N_REQUESTS} requests, {total_audio:.2f} audio-s in {total_dt * 1e3:.2f} ms "
          f"({total_audio / total_dt:.1f} audio-s/s), launches {launches}")
    return model, fbank, stats, batches, results, n_params


@contextlib.contextmanager
def plain_kernels():
    """Swap both wrappers for their plain versions on the bf16-cast weights
    the kernels take (the model's modules call the wrappers through these
    module attributes); autograd then differentiates the plain versions."""
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    saved = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)

    def cell(x, pad, weights, activation, keep=None, keep_prob=1.0, launch_weights=None):
        return fused_summary.summary_mixing_reference(
            x, pad, fused_summary.kernel_weights(weights), activation, keep, keep_prob)

    def branch(x, mask, weights, eps, keep=None, keep_prob=1.0, launch_weights=None):
        return fused_csgu.convolution_branch_reference(
            x, mask, fused_csgu.kernel_weights(weights), eps, keep, keep_prob)

    fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch = cell, branch
    try:
        yield
    finally:
        fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch = saved


def phase_plain_path(model, fbank, stats, batches, results):
    import torch

    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    with plain_kernels():
        _, wav, lens = batches[0]
        hyps, out = greedy_ctc_decode(model, fbank, stats, wav, lens)
    torch.cuda.synchronize()
    k_out, k_hyps = results[0][2], results[0][3]
    enc_len = out["enc_lengths"]
    valid = (torch.arange(out["ctc_log_probs"].shape[1], device="cuda")[None, :]
             < enc_len[:, None])
    diff = (out["ctc_log_probs"] - k_out["ctc_log_probs"]).abs().amax(-1)[valid]
    agree = (out["ctc_log_probs"].argmax(-1) == k_out["ctc_log_probs"].argmax(-1))[valid]
    frac = float(agree.float().mean())
    max_diff = float(diff.max())
    same_rows = sum(a == b for a, b in zip(hyps, k_hyps))
    # 18 layers of bf16 activations rounded at other points in each path:
    # frame-level argmax may flip where the top two log-probs nearly tie.
    ok = frac >= 0.95 and max_diff <= 1.0
    print(f"kernel path vs plain path (request 0, on the card): max |dlogp| {max_diff:.4f} "
          f"(tol 1.0), greedy frame agreement {frac:.4f} (tol >= 0.95), "
          f"identical token rows {same_rows}/{len(hyps)} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("the kernel path disagrees with the plain path")


def device_profile(fn, label: str, top: int = 14) -> None:
    """Device time by kernel over one call of `fn` under torch.profiler.
    The profiler slows the host, so the idle share it shows is an upper
    bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue   # host-side ops repeat the device time of their kernels
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    busy_us = sum(r[0] for r in rows)
    if busy_us == 0:
        print(f"profile ({label}): the profiler recorded no device time; device busy share "
              "not measured")
        return
    print(f"profile ({label}): device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall under the profiler, idle share {1 - busy_us / wall_us:.3f}")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        print(f"  profile: {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f}% x{count:<5d} {key[:90]}")


def phase_profile(model, fbank, stats, batches):
    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    _, wav, lens = batches[0]
    device_profile(lambda: greedy_ctc_decode(model, fbank, stats, wav, lens), "request 0")


def training_batch(seed: int = 21) -> dict:
    """16 synthetic utterances of 5-30 s, the first 30 s (so the encoder
    runs at T = 751), at most 500 s in all (the recipe's batch_size 16,
    max_batch_length 500), with random token ids in [3, 5000) at about 3
    per second of audio, padded with 0."""
    import torch

    wavs = synthetic_waveforms(TRAIN_BATCH, seed)
    secs = [len(w) / 16000 for w in wavs]
    if sum(secs) > 500.0:
        fail(f"the training batch holds {sum(secs):.1f} s of audio, above 500 s")
    n = max(len(w) for w in wavs)
    wav = np.zeros((TRAIN_BATCH, n), np.float32)
    for i, w in enumerate(wavs):
        wav[i, :len(w)] = w
    rng = np.random.default_rng(seed)
    token_lens = np.array([max(1, round(3.0 * s)) for s in secs], np.int32)
    tokens = np.zeros((TRAIN_BATCH, int(token_lens.max())), np.int32)
    for i, u in enumerate(token_lens):
        tokens[i, :u] = rng.integers(3, 5000, u)
    lens = np.array([len(w) for w in wavs], np.int32)
    return {k: torch.from_numpy(v).cuda() for k, v in
            dict(wav=wav, wav_lens=lens, tokens=tokens, token_lens=token_lens).items()}


def phase_train(kernel_rows) -> tuple:
    import dataclasses

    import torch

    from summarymixing_tpu_torch.config import build_model, build_trainer
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
    from summarymixing_tpu_torch.ops.layers import set_dropout_generator

    cfg = flagship_config(decoder_layers=6)
    n_layers = cfg.model.num_encoder_layers
    torch.cuda.reset_peak_memory_stats()
    model, fbank = build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != FLAGSHIP_TRAIN_PARAMS:
        fail(f"training parameter count {n_params} != {FLAGSHIP_TRAIN_PARAMS}")
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        fail("the training model's parameters are not all float32")
    trainer = build_trainer(cfg, model, fbank)
    state = trainer.init_state(cfg.seed)
    batch = training_batch()
    audio_s = float(batch["wav_lens"].sum()) / cfg.features.sample_rate
    print(f"train: {TRAIN_BATCH} utterances, {audio_s:.2f} audio-s, "
          f"wav {tuple(batch['wav'].shape)}, "
          f"tokens {tuple(batch['tokens'].shape)}, {n_params:,} float32 parameters, "
          f"dropout {DROPOUT}, speed perturbation and SpecAugment on")
    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    names = [n for n, _ in model.named_parameters()]

    def check(step, metrics):
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(norm)) or metrics["nonfinite_skipped"]:
            fail(f"train step {step}: loss {loss}, grad norm {norm}, "
                 f"skipped {metrics['nonfinite_skipped']}")
        missing = [n for n, p in zip(names, model.parameters()) if p.grad is None]
        if missing:
            fail(f"train step {step}: {len(missing)} parameters got no gradient: {missing[:8]}")

    state, metrics = trainer.train_step(state, batch)      # warm-up
    torch.cuda.synchronize()
    check("warm-up", metrics)
    for fn in kernels:
        fn.launches, fn.backwards = 0, 0
    times = []
    for step in range(TRAIN_STEPS):
        before = [(fn.launches, fn.backwards) for fn in kernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        check(step, metrics)
        rose = [(fn.launches - a, fn.backwards - b_) for fn, (a, b_) in zip(kernels, before)]
        print(f"train step {step}: {dt * 1e3:.2f} ms, loss {float(metrics['loss']):.4f} "
              f"(ctc {float(metrics['ctc']):.4f}, att {float(metrics['att']):.4f}), grad norm "
              f"{float(metrics['grad_norm']):.4f}, skipped {metrics['nonfinite_skipped']}, "
              f"summary_mixing +{rose[0][0]}/+{rose[0][1]} csgu +{rose[1][0]}/+{rose[1][1]} "
              "(forward/backward)")
        if rose != [(n_layers, n_layers)] * 2:
            fail(f"train step {step}: kernel forward/backward counts rose by {rose}, expected "
                 f"{n_layers} each")
    plain = hold_no_plain_calls("train")
    for name, fn in zip(("summary_mixing", "csgu"), kernels):
        kernel_rows[name]["launches_by_path"]["train"] = fn.launches
        kernel_rows[name]["plain_calls_by_path"]["train"] = plain[name]
        kernel_rows[name]["backwards_in_train"] = fn.backwards
        if fn.launches == 0 or fn.backwards == 0:
            fail(f"kernel {name} was never launched or never differentiated in training")
    total = sum(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train: {TRAIN_STEPS} steps in {total * 1e3:.2f} ms, {total / TRAIN_STEPS * 1e3:.2f} ms "
          f"per step, {TRAIN_STEPS * audio_s / total:.1f} audio-s trained per second, peak "
          f"memory {peak:.2f} GiB, parameters {n_params:,}")
    device_profile(lambda: trainer.train_step(state, batch), "one train step", top=16)

    # one step with the kernels against the same step with their plain
    # versions: same weights, batch and dropout masks, augmentation off
    same = dataclasses.replace(trainer.config, augment=None, speed_perturb=False)
    cmp = type(trainer)(model, trainer.optimizer, fbank, same)

    def one_step(plain: bool):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(99)
        set_dropout_generator(model, gen)
        for p in model.parameters():
            p.grad = None
        with plain_kernels() if plain else contextlib.nullcontext():
            loss, _ = cmp._forward_loss(state["norm_stats"], batch, True, state["epoch"], gen)
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), [p.grad.detach().clone() for p in model.parameters()]

    loss_k, grads_k = one_step(False)
    loss_p, grads_p = one_step(True)
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    norm_p = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_p])))
    errs, noise = [], []
    for name, gk, gp in zip(names, grads_k, grads_p):
        nrm = float(gp.norm())
        if nrm < GRAD_NOISE_SHARE * norm_p:
            noise.append(name)
            continue
        errs.append((float((gk - gp).norm()) / nrm, name))
    errs.sort(reverse=True)
    ok = rel_loss <= TRAIN_LOSS_TOL and errs[0][0] <= TRAIN_GRAD_TOL
    print(f"train kernel path vs plain path (one step, same masks, augmentation off): loss "
          f"{loss_k:.6f} vs {loss_p:.6f}, relative {rel_loss:.2e} (tol {TRAIN_LOSS_TOL:.0e}); "
          f"per-tensor relative L2 gradient error max {errs[0][0]:.3e} (tol "
          f"{TRAIN_GRAD_TOL:.0e}), median {errs[len(errs) // 2][0]:.3e} over {len(errs)} "
          f"tensors; worst {[(n, round(e, 4)) for e, n in errs[:3]]}; {len(noise)} tensors "
          f"with a gradient below {GRAD_NOISE_SHARE:.0e} of the global norm {norm_p:.4f} "
          f"not held to it: {noise[:6]} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("the training step with the kernels disagrees with the plain versions")
    return model, trainer, state, batch


def phase_checkpoints(train, ckpt_dir: str) -> None:
    """Three more training steps, a checkpoint through the port's
    `CheckpointManager` after each, and `average_checkpoints` over them
    against the float64 mean of the three parameter sets taken directly."""
    import torch

    from summarymixing_tpu_torch.training.checkpoint import CheckpointManager, average_checkpoints

    model, trainer, state, batch = train
    mgr = CheckpointManager(ckpt_dir, max_to_keep=N_CHECKPOINTS)
    saved, save_s = [], 0.0
    for _ in range(N_CHECKPOINTS):
        state, metrics = trainer.train_step(state, batch)
        if not np.isfinite(float(metrics["loss"])) or metrics["nonfinite_skipped"]:
            fail(f"train step {state['step']} before a checkpoint: loss {float(metrics['loss'])}")
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        saved.append(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(state["step"], {"params": params, "opt_state": state["opt_state"],
                                 "norm_stats": state["norm_stats"], "step": state["step"],
                                 "epoch": state["epoch"]})
        save_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    avg = average_checkpoints(mgr, {"params": None, "norm_stats": None}, num=N_CHECKPOINTS)
    avg_s = time.perf_counter() - t0
    worst, n_el = 0.0, 0
    for name, got in avg["params"].items():
        mean = sum(p[name].to(torch.float64) for p in saved) / len(saved)
        err = (got.to(torch.float64) - mean).abs()
        bad = err > AVG_TOL * mean.abs()
        if bool(bad.any()):
            fail(f"average_checkpoints: {name} differs from the direct float64 mean by "
                 f"{float(err.max()):.3e}")
        ratio = err / mean.abs().clamp_min(torch.finfo(torch.float64).tiny)
        worst = max(worst, float(ratio.max()))
        n_el += got.numel()
    moved = max(float((saved[-1][k] - saved[0][k]).abs().max()) for k in saved[0])
    size = sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(ckpt_dir) for f in files)
    print(f"checkpoints: {N_CHECKPOINTS} saved at steps {mgr.all_steps()} in {save_s:.2f} s "
          f"({size / N_CHECKPOINTS / 2 ** 20:.1f} MiB each, parameters and optimizer state); "
          f"average_checkpoints in {avg_s:.2f} s equals the direct float64 mean of {n_el:,} "
          f"values within {worst:.3e} relative (tol {AVG_TOL:.0e}); the parameters moved by at "
          f"most {moved:.3e} over the three steps")


def beam_references(n: int, audio_s, seed: int = 31) -> dict:
    """Random token ids in [3, 5000) at about 3 per second of audio, one
    list per utterance index: references for the error-rate summary."""
    rng = np.random.default_rng(seed)
    return {i: [int(t) for t in rng.integers(3, 5000, max(1, round(3.0 * audio_s[i])))]
            for i in range(n)}


def phase_beam(kernel_rows, ckpt_dir: str) -> None:
    """Beam-search evaluation of request 0 on the averaged checkpoints with
    the fusion LM through `evaluate.evaluate_beam`, and checks (a)-(d)."""
    import torch
    import torch.nn.functional as F

    from summarymixing_tpu_torch.config import LMConfig, build_lm, build_model
    from summarymixing_tpu_torch.decoding import ctc_prefix
    from summarymixing_tpu_torch.decoding.s2s_beam import tile_for_beam
    from summarymixing_tpu_torch.evaluate import evaluate_beam, restore_eval_state
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
    from summarymixing_tpu_torch.ops.masks import length_to_mask
    from summarymixing_tpu_torch.transcribe import batch_waveforms

    cfg = flagship_config(decoder_layers=6)
    m, dec = cfg.model, cfg.decoding
    torch.cuda.reset_peak_memory_stats()
    model, fbank = build_model(cfg)
    dev = next(model.parameters()).device
    state = restore_eval_state(model, ckpt_dir, avg=N_CHECKPOINTS)
    norm_stats = state["norm_stats"]
    lm_cfg = LMConfig()
    lm = build_lm(lm_cfg, m.output_neurons, seed=cfg.seed)
    n_lm = sum(p.numel() for p in lm.parameters())
    print(f"beam: averaged the last {N_CHECKPOINTS} checkpoints (step {state['step']}) into a "
          f"fresh model; Transformer LM {lm_cfg.num_layers} layers d{lm_cfg.d_model} "
          f"{lm_cfg.nhead} heads d_ffn {lm_cfg.d_ffn} head {lm_cfg.output_proj!r}, vocab "
          f"{m.output_neurons}: {n_lm:,} float32 parameters")
    if n_lm != FLAGSHIP_LM_PARAMS:
        fail(f"LM parameter count {n_lm} != {FLAGSHIP_LM_PARAMS}")
    wavs = synthetic_waveforms(N_REQUESTS * BATCH, seed=11)
    idx, wav, wav_lens = next(iter(batch_waveforms(wavs, BATCH,
                                                   pad_quantum=cfg.features.sample_rate // 2,
                                                   device=dev)))
    audio = [len(w) / cfg.features.sample_rate for w in wavs]
    refs = beam_references(len(wavs), audio)
    audio_s = sum(audio[i] for i in idx)
    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)

    def run(label):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate_beam(model, fbank, norm_stats, [(idx, wav, wav_lens)], cfg, lm=lm,
                            references=refs)
        torch.cuda.synchronize()
        out["latency_s"] = time.perf_counter() - t0
        rows = [len(out["hyps"][i]) for i in idx]
        print(f"beam {label}: {BATCH} utterances, {audio_s:.2f} audio-s, beam {dec.test_beam_size} "
              f"({BATCH * dec.test_beam_size} rows), max_length {out['max_length']}: latency "
              f"{out['latency_s'] * 1e3:.1f} ms, {audio_s / out['latency_s']:.1f} audio-s/s; "
              f"{out['steps']} steps, {out['search_s'] * 1e3 / max(out['steps'], 1):.2f} ms per "
              f"step; encoder {out['encode_s'] * 1e3:.1f} ms "
              f"({100 * out['encode_s'] / out['latency_s']:.1f}%), search "
              f"{out['search_s'] * 1e3:.1f} ms ({100 * out['search_s'] / out['latency_s']:.1f}%); "
              f"tokens per row {rows}; error rate against seeded references (not held) "
              f"{out['summary']}")
        return out

    for fn in kernels:
        fn.launches = 0
    out = run("(kernels)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rose = [fn.launches for fn in kernels]
    print(f"beam: peak memory allocated {peak:.2f} GiB; launches summary_mixing +{rose[0]} "
          f"csgu +{rose[1]}")
    plain = hold_no_plain_calls("beam (and every flagship phase since the decode)")
    for name, n in zip(("summary_mixing", "csgu"), rose):
        kernel_rows[name]["launches_by_path"]["beam"] = n
        kernel_rows[name]["plain_calls_by_path"]["beam"] = plain[name]
    if rose != [m.num_encoder_layers] * 2:
        fail(f"beam: kernel launches rose by {rose}, expected {m.num_encoder_layers} each")
    for i in idx:
        if not np.isfinite(out["scores"][i]):
            fail(f"beam: utterance {i} has score {out['scores'][i]}")

    # the request's encoder output, CTC lattice and best hypotheses again
    feats, _ = InputNormalization()(fbank(wav), norm_stats)
    feat_len = fbank.frame_lengths(wav_lens)
    with torch.inference_mode():
        enc, enc_lens = model.encode(feats, feat_len)
        ctc_lp = model.ctc_head(enc)
        hyps = [out["hyps"][i] for i in idx]
        n_pos = min(max(len(h) for h in hyps) + 1, out["max_length"])
        hl = torch.tensor([min(len(h), n_pos - 1) for h in hyps], device=dev)
        tgt = torch.full((BATCH, n_pos), m.eos_index, dtype=torch.int64, device=dev)
        tgt[:, 0] = m.bos_index
        for r, h in enumerate(hyps):
            tgt[r, 1:1 + int(hl[r])] = torch.tensor(h[:int(hl[r])], device=dev)

        # (a) and (b) run at the search's B·beam rows, so the decoder takes
        # the grouped cross-attention route (an utterance's beam rows against
        # its one cross-K/V row) as in the search; row j of utterance g
        # carries the best hypothesis of utterance (g + j) % B, so the rows
        # of one utterance differ
        beam = dec.test_beam_size
        pick = (torch.arange(BATCH)[:, None] + torch.arange(beam)[None, :]) % BATCH
        tgt_rows = tgt[pick.reshape(-1).to(dev)]
        n_rows = tgt_rows.shape[0]

        # (a) the cached decoder step against decode_position of the prefix
        cache = model.decode_cache_init(enc, n_pos, n_rows)
        enc_pad = length_to_mask(enc_lens, enc.shape[1])
        enc_rows, lens_rows = tile_for_beam(enc, beam), tile_for_beam(enc_lens, beam)
        dec_err = 0.0
        for pos in range(n_pos):
            lp, cache = model.decode_step_cached(tgt_rows[:, pos], pos, cache, enc_pad)
            ref = model.decode_position(tgt_rows[:, :pos + 1], enc_rows, lens_rows, pos)
            dec_err = max(dec_err, float(((lp - ref).abs() / (1 + ref.abs())).max()))
        del cache, enc_rows
        ok_a = dec_err <= DEC_STEP_TOL
        print(f"beam check (a): cached decoder step vs decode_position over {n_rows} rows of "
              f"the best hypotheses, {n_pos} positions (bf16 compute): max |dlogp|/(1+|logp|) "
              f"{dec_err:.3e} (tol {DEC_STEP_TOL:.3e}) {'ok' if ok_a else 'FAILED'}")

        # (b) the cached LM step against the full causal forward
        full = torch.log_softmax(lm(tgt_rows), dim=-1)
        lm_cache = lm.init_cache(n_rows, n_pos)
        lm_err = 0.0
        for pos in range(n_pos):
            logits, lm_cache = lm.step(tgt_rows[:, pos], pos, lm_cache)
            lm_err = max(lm_err, float((torch.log_softmax(logits, -1) - full[:, pos]).abs().max()))
        del full, lm_cache
        ok_b = lm_err <= LM_STEP_TOL
        print(f"beam check (b): cached LM step vs the full causal LM over {n_rows} rows, "
              f"{n_pos} positions (float32): max |dlogp| {lm_err:.3e} (tol {LM_STEP_TOL:.0e}) "
              f"{'ok' if ok_b else 'FAILED'}")

        # (c) the prefix scorer's eos score against -ctc_loss of each hypothesis
        st = ctc_prefix.ctc_prefix_init(ctc_lp, enc_lens, m.blank_index)
        for j in range(int(hl.max())):
            tok = tgt[:, 1 + j]
            _, psi = ctc_prefix.ctc_prefix_score_only(st, ctc_lp, enc_lens, tok[:, None],
                                                      m.blank_index)
            new = ctc_prefix.ctc_prefix_advance(st, ctc_lp, enc_lens, tok, psi[:, 0],
                                                m.blank_index)
            live = j < hl
            st = ctc_prefix.CTCPrefixState(*(
                torch.where(live[:, None] if a.dim() == 2 else live, a, b)
                for a, b in zip(new, st)))
        eos = torch.full((BATCH, 1), m.eos_index, device=dev)
        delta, _ = ctc_prefix.ctc_prefix_score_only(st, ctc_lp, enc_lens, eos, m.blank_index,
                                                    m.eos_index)
        scorer = delta[:, 0] + st.psi
        loss = F.ctc_loss(ctc_lp.transpose(0, 1), tgt[:, 1:].clamp_min(0), enc_lens, hl,
                          blank=m.blank_index, reduction="none")
    feasible = torch.isfinite(loss)
    err_c = (scorer + loss).abs()
    tol_c = CTC_TOL_REL * loss.abs() + CTC_TOL_ABS
    ok_c = bool(feasible.any()) and bool((err_c <= tol_c)[feasible].all())
    print(f"beam check (c): prefix scorer eos log-prob vs -ctc_loss per best hypothesis "
          f"(tol {CTC_TOL_REL:.0e}|loss| + {CTC_TOL_ABS:.0e}): feasible rows "
          f"{int(feasible.sum())}/{BATCH}, -ctc_loss {[round(float(-v), 3) for v in loss]}, "
          f"scorer {[round(float(v), 3) for v in scorer]}, max |diff| on feasible rows "
          f"{float(err_c[feasible].max()) if bool(feasible.any()) else float('nan'):.3e} "
          f"{'ok' if ok_c else 'FAILED'}")

    # (d) the same request with the plain versions of both kernels
    with plain_kernels():
        with torch.inference_mode():
            enc_plain, _ = model.encode(feats, feat_len)
        out_plain = run("(plain versions)")
    valid = length_to_mask(enc_lens, enc.shape[1]) > 0
    enc_diff = float((enc.float() - enc_plain.float()).abs().amax(-1)[valid].max())
    same = sum(out["hyps"][i] == out_plain["hyps"][i] for i in idx)
    print(f"beam check (d): kernel path vs plain path: encoder output max |diff| {enc_diff:.4f}, "
          f"identical best-token rows {same}/{BATCH} (reported, not held)")
    for ok, what in ((ok_a, "(a) the cached decoder step"), (ok_b, "(b) the cached LM step"),
                     (ok_c, "(c) the CTC prefix scorer")):
        if not ok:
            fail(f"beam check {what} is outside its tolerance")
    beam_profile(cfg, model, lm, enc, enc_lens, ctc_lp, out["max_length"],
                 out["search_s"] / max(out["steps"], 1))


class _StopSearch(Exception):
    pass


def beam_profile(cfg, model, lm, enc, enc_lens, ctc_lp, max_length: int, step_s: float,
                 skip: int = 100, active: int = 8) -> None:
    """Device time by kernel over search steps `skip` .. `skip + active - 1`
    of the request's search (the caches as long as in the timed run) under
    torch.profiler, with the host-clock wall of those steps; the search is
    stopped after them. The device's idle share is given against that wall
    (the profiler slows the host: an upper bound) and against `step_s`, the
    unprofiled run's mean step time."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from summarymixing_tpu_torch.decoding.s2s_beam import s2s_beam_search, tile_for_beam
    from summarymixing_tpu_torch.evaluate import beam_config, make_beam_step, make_lm_fusion

    lm_step, make_cache = make_lm_fusion(cfg, lm)
    bc = beam_config(cfg, max_length, lm_step)
    stamps = []
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=skip, warmup=1, active=active, repeat=1)) as prof:
        step, cache, lm_cache = make_beam_step(cfg, model, enc, enc_lens, bc.beam_size, bc,
                                               lm_step, make_cache)

        # profiler step k + 1 is search step k: steps skip .. skip + active - 1 are
        # recorded; the search stops when step skip + active starts
        def profiled(tok, i, c):
            prof.step()
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            if i == skip + active:
                raise _StopSearch
            return step(tok, i, c)

        try:
            s2s_beam_search(profiled, enc, tile_for_beam(enc_lens, bc.beam_size), ctc_lp, bc,
                            lm_step_fn=lm_step, cache=cache, lm_cache=lm_cache)
        except _StopSearch:
            pass
    if len(stamps) <= skip + active:
        print(f"beam profile: not measured (the search ended after {len(stamps)} steps)")
        return
    wall_us = (stamps[skip + active] - stamps[skip]) * 1e6
    rows = []
    for e in prof.key_averages():
        # the schedule's ProfilerStep ranges span whole steps on the device
        # timeline too; they are not kernels
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us, e.count, e.key))
    busy_us = sum(r[0] for r in rows)
    if busy_us == 0:
        print("beam profile: the profiler recorded no device time; busy share not measured")
        return
    busy_step_ms = busy_us / 1e3 / active
    print(f"beam profile (steps {skip}-{skip + active - 1}): device busy {busy_us / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall under the profiler, idle share "
          f"{1 - busy_us / wall_us:.3f}; "
          f"{busy_step_ms:.3f} ms busy per step against {step_s * 1e3:.3f} ms per unprofiled step, "
          f"idle share {1 - busy_step_ms / (step_s * 1e3):.3f}")
    for us, count, key in sorted(rows, reverse=True)[:16]:
        print(f"  beam profile: {us / 1e3:8.3f} ms {100 * us / busy_us:5.1f}% x{count:<6d} "
              f"{key[:90]}")


def transducer_config():
    """recipes/LibriSpeech/conformer_summarymixing_transducer.yaml as the
    port's `load_recipe` reads it (the card has no YAML package)."""
    from summarymixing_tpu_torch.config.schema import (
        AugmentConfig, DecodingConfig, FeaturesConfig, ModelConfig, RecipeConfig,
        TrainingConfig, TransducerConfig)

    return RecipeConfig(
        name="librispeech_conformer_summarymixing_transducer", seed=3407,
        tokenizer_type="sentencepiece", token_type="unigram",
        features=FeaturesConfig(sample_rate=16000, n_fft=512, win_length=32, n_mels=80),
        augment=AugmentConfig(speed_perturb=True, speeds=(95, 100, 105),
                              time_drop_length_low=15, time_drop_length_high=25,
                              time_drop_count=5, freq_drop_length_low=25,
                              freq_drop_length_high=35, freq_drop_count=2, time_warp_window=5,
                              drop_replace="zeros", min_augmentations=3, max_augmentations=3),
        model=ModelConfig(
            attention_type="SummaryMixing", mode="SummaryMixing-fast", encoder_module="conformer",
            d_model=512, nhead=4, num_encoder_layers=12, num_decoder_layers=0, d_ffn=2048,
            transformer_dropout=0.15, activation="gelu", csgu_kernel_size=31,
            local_proj_hid_dim=(512,), local_proj_out_dim=512, summary_hid_dim=(512,),
            causal=False, input_size=640, output_neurons=1000, blank_index=0, bos_index=0,
            eos_index=0, pad_index=0),
        transducer=TransducerConfig(joint_dim=640, dec_dim=512, dec_emb_dropout=0.2,
                                    dec_dropout=0.1, chunkwise_prob=0.6, chunk_size_min=8,
                                    chunk_size_max=32, limited_left_context_prob=0.75,
                                    left_context_chunks_min=2, left_context_chunks_max=32),
        training=TrainingConfig(number_of_epochs=100, optimizer_step_limit=210000, batch_size=8,
                                grad_accumulation_factor=4, precision="bf16", ctc_weight=0.3,
                                number_of_ctc_epochs=60, ce_weight=0.0, lr_adam=0.0008,
                                adam_eps=1.0e-8, weight_decay=0.01, max_grad_norm=5.0,
                                scheduler="warm_exp_decay", n_warmup_steps=25000,
                                decay_factor=0.05, dynamic_batching=True, max_batch_length=150.0,
                                max_batch_length_val=50.0, num_buckets=200, max_batch_ex=256,
                                avg_checkpoints=10),
        decoding=DecodingConfig(beam_size=10, nbest=1, state_beam=2.3, expand_beam=2.3,
                                lm_weight=0.50))


def max_rel(got, want, valid) -> float:
    """max |got - want| / (1 + |want|) over the frames where `valid` `[B, T]`."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (1.0 + w.abs())).amax(-1)[valid].max())


def phase_transducer(kernel_rows) -> None:
    """The transducer recipe's inference: offline greedy over 4 requests,
    chunked streaming and the raw-audio pipeline over request 0, check (a)
    and the reports listed in the module docstring."""
    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.evaluate import streaming_decode
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.models.asr import DynChunkTrainConfig
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype
    from summarymixing_tpu_torch.ops.masks import length_to_mask
    from summarymixing_tpu_torch.streaming import make_streaming_infer_fns, run_stream
    from summarymixing_tpu_torch.transcribe import batch_waveforms, transducer_greedy_transcribe

    cfg = transducer_config()
    sr, vocab = cfg.features.sample_rate, cfg.model.output_neurons
    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    for fn in kernels:
        fn.launches, fn.plain_calls = 0, 0
    torch.cuda.reset_peak_memory_stats()
    model, fbank, td = build_model(cfg)
    n_model = sum(p.numel() for p in model.parameters())
    n_td = sum(p.numel() for p in td.parameters())
    print(f"transducer: Conformer {cfg.model.num_encoder_layers} layers d{cfg.model.d_model} "
          f"{cfg.model.mode} nhead {cfg.model.nhead}, vocabulary {vocab}: {n_model:,} + {n_td:,} "
          f"= {n_model + n_td:,} float32 parameters, encoder compute bf16, transducer float32")
    if n_model + n_td != TRANSDUCER_PARAMS:
        fail(f"transducer parameter count {n_model + n_td} != {TRANSDUCER_PARAMS}")
    stats = seeded_norm_stats()
    wavs = synthetic_waveforms(N_REQUESTS * BATCH, seed=11)
    batches = list(batch_waveforms(wavs, BATCH, pad_quantum=sr // 2))

    def transcribe(wav, lens):
        return transducer_greedy_transcribe(model, td, fbank, stats, wav, lens,
                                            blank_id=cfg.model.blank_index)

    for _, wav, lens in batches:   # warm-up: library kernels pick algorithms per shape
        transcribe(wav, lens)
    total_dt = total_audio = 0.0
    for r, (idx, wav, lens) in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps, out = transcribe(wav, lens)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        enc, n = out["enc_out"], [len(h) for h in hyps]
        if not torch.isfinite(enc).all() or enc.shape[0] != BATCH:
            fail(f"transducer request {r}: encoder output of shape {tuple(enc.shape)} not finite")
        if any(t <= 0 or t >= vocab for h in hyps for t in h) or max(n) > out["tokens"].shape[1]:
            fail(f"transducer request {r}: token ids outside [1, {vocab}) or too many")
        audio_s = float(lens.sum()) / sr
        total_dt, total_audio = total_dt + dt, total_audio + audio_s
        print(f"transducer greedy request {r}: {BATCH} utterances, {audio_s:.2f} audio-s, "
              f"encoder frames {enc.shape[1]}, latency {dt * 1e3:.2f} ms, "
              f"{audio_s / dt:.1f} audio-s/s, tokens per row {n}")
    print(f"transducer greedy: {N_REQUESTS} requests, {total_audio:.2f} audio-s in "
          f"{total_dt * 1e3:.2f} ms ({total_audio / total_dt:.1f} audio-s/s, real-time factor "
          f"{total_dt / total_audio:.5f})")

    _, wav, lens = batches[0]
    chunk_ms = 1e3 * STREAM_CHUNK * 4 * fbank.hop_length / sr
    streaming_decode(model, td, fbank, stats, wav, lens, STREAM_CHUNK, STREAM_LEFT)   # warm-up
    times = []
    toks_c, lens_c = streaming_decode(model, td, fbank, stats, wav, lens, STREAM_CHUNK,
                                      STREAM_LEFT, chunk_times=times)
    ms = sorted(1e3 * t for t in times)
    print(f"transducer streaming_decode (request 0, chunks of {STREAM_CHUNK} frames = "
          f"{chunk_ms:.0f} ms of audio, left context {STREAM_LEFT} chunks): {len(ms)} chunks, "
          f"median {ms[len(ms) // 2]:.2f} ms, max {ms[-1]:.2f} ms per chunk of {BATCH} streams "
          f"(median real-time factor {ms[len(ms) // 2] / chunk_ms:.4f})")

    init_fn, step_fn, info = make_streaming_infer_fns(
        model, td, fbank, InputNormalization(), stats, chunk_frames=STREAM_CHUNK,
        left_context_chunks=STREAM_LEFT, blank_id=cfg.model.blank_index)
    step_times = []

    def timed_step(carry, chunk, n_valid):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(carry, chunk, n_valid)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        return out

    def agreement(toks_c, lens_c, toks_r, lens_r) -> str:
        """Rows where run_stream's tokens equal streaming_decode's: whole,
        and over the shorter row's length (streaming_decode's buffer holds 2
        tokens per encoder frame of the stream, run_stream's 3 per frame of
        each chunk, so the shorter may be cut)."""
        hyp_c = [toks_c[i, :int(lens_c[i])].tolist() for i in range(BATCH)]
        hyp_r = [toks_r[i, :int(lens_r[i])].tolist() for i in range(BATCH)]
        same = sum(a == b for a, b in zip(hyp_c, hyp_r))
        prefix = sum(a[:len(b)] == b[:len(a)] for a, b in zip(hyp_c, hyp_r))
        return (f"rows with the same tokens as streaming_decode {same}/{BATCH}, the same over "
                f"the shorter row's length {prefix}/{BATCH}; tokens per row run_stream "
                f"{[len(h) for h in hyp_r]}, streaming_decode {[len(h) for h in hyp_c]}")

    run_stream(init_fn, step_fn, wav, lens, info["chunk_samples"])   # warm-up
    toks_r, lens_r = run_stream(init_fn, timed_step, wav, lens, info["chunk_samples"])
    ms = sorted(1e3 * t for t in step_times)
    print(f"transducer run_stream (request 0, raw audio in chunks of {info['chunk_samples']} "
          f"samples, {len(ms)} steps with the two flush steps): median {ms[len(ms) // 2]:.2f} ms, "
          f"max {ms[-1]:.2f} ms per step; bf16: {agreement(toks_c, lens_c, toks_r, lens_r)} "
          "(reported, not held: the streamed top-dB clamp takes a running peak)")

    # (a): chunk by chunk against the offline Dynamic Chunk Training encode
    def stream_vs_offline():
        with torch.inference_mode():
            feats, _ = InputNormalization()(fbank(wav), stats)
            src = model.frontend(feats)
            enc_lens = model.subsampled_length(fbank.frame_lengths(lens))
            t_enc = src.shape[1]
            n_chunks = -(-t_enc // STREAM_CHUNK)
            src = torch.nn.functional.pad(src, (0, 0, 0, n_chunks * STREAM_CHUNK - t_enc))
            dct = DynChunkTrainConfig(STREAM_CHUNK, STREAM_LEFT)
            offline = model.asr.encode(src, dynchunktrain=dct)
            state = model.streaming_init(BATCH, dct)
            outs = []
            for c in range(n_chunks):
                out, state = model.encode_streaming_chunk(
                    src[:, c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK], state)
                outs.append(out)
            valid = length_to_mask(enc_lens, offline.shape[1]) > 0
            return max_rel(torch.cat(outs, dim=1), offline, valid)

    set_compute_dtype(model, None)
    err_fp32 = stream_vs_offline()
    agree32 = agreement(
        *streaming_decode(model, td, fbank, stats, wav, lens, STREAM_CHUNK, STREAM_LEFT),
        *run_stream(init_fn, step_fn, wav, lens, info["chunk_samples"]))
    print(f"transducer run_stream vs streaming_decode in float32 (TF32 off): {agree32} "
          "(reported, not held)")
    with torch.inference_mode():
        feats, _ = InputNormalization()(fbank(wav), stats)
        enc32, enc_lens = model.encode(feats, fbank.frame_lengths(lens))
    set_compute_dtype(model, torch.bfloat16)
    err_bf16 = stream_vs_offline()
    with torch.inference_mode():
        enc16, _ = model.encode(feats, fbank.frame_lengths(lens))
    err_enc = max_rel(enc16, enc32, length_to_mask(enc_lens, enc32.shape[1]) > 0)
    ok = err_fp32 <= STREAM_TOL
    print(f"transducer check (a): encode_streaming chunk by chunk vs offline encode with "
          f"DynChunkTrainConfig({STREAM_CHUNK}, {STREAM_LEFT}), request 0, valid frames, max "
          f"|diff|/(1+|offline|): float32 (TF32 off) {err_fp32:.3e} (tol {STREAM_TOL:.0e}) "
          f"{'ok' if ok else 'FAILED'}; bf16 {err_bf16:.3e} (reported); offline encoder bf16 vs "
          f"float32 {err_enc:.3e} (reported)")
    if not ok:
        fail("transducer check (a): chunked streaming disagrees with the offline DCT encode")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"transducer: peak memory allocated {peak:.2f} GiB")
    _, wav0, lens0 = batches[0]
    device_profile(lambda: transcribe(wav0, lens0), "transducer greedy request 0", top=16)
    rose = [fn.launches for fn in kernels]
    plain = [fn.plain_calls for fn in kernels]
    print(f"transducer: launches summary_mixing +{rose[0]} csgu +{rose[1]} (no hand-written "
          f"kernel on this path); plain calls summary_mixing +{plain[0]} (fast-mode cells) "
          f"csgu +{plain[1]}")
    if rose != [0, 0]:
        fail(f"transducer: a hand-written kernel was launched on the transducer path: {rose}")
    for name, n in zip(("summary_mixing", "csgu"), plain):
        kernel_rows[name]["launches_by_path"]["transducer"] = 0
        kernel_rows[name]["plain_calls_by_path"]["transducer"] = n


def make_corpus(here: str, root: str) -> dict:
    """Write the --hard synthetic corpus with `recipes/make_synthetic_corpus.py`
    (numpy and `wave` only) in a subprocess; return its manifests' paths."""
    cmd = [sys.executable, os.path.join(here, "recipes", "make_synthetic_corpus.py"), root,
           "--hard", "--n", str(RUNNER_CORPUS_N), "--lm-text", str(RUNNER_LM_TEXT),
           "--seed", "0"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"make_synthetic_corpus.py failed: {out.stderr.strip()[-2000:]}")
    paths = {split: os.path.join(root, f"manifest_{split}.csv")
             for split in ("train", "dev", "test")}
    paths["lm_text"] = os.path.join(root, "lm_text.txt")
    print(f"runner corpus: {out.stdout.strip().splitlines()[0]}; written in "
          f"{time.perf_counter() - t0:.1f} s")
    return paths


def run_stage(label: str, fn, argv: list) -> tuple:
    """Run one runner's `main(argv)` in this process with both wrappers'
    counters at 0 and the peak-memory counter reset; returns its result,
    the wrappers' (launches, plain calls, backwards) and the seconds and
    peak GiB it took."""
    import torch

    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    for k in kernels:
        k.launches, k.plain_calls, k.backwards = 0, 0, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: (k.launches, k.plain_calls, k.backwards)
              for name, k in zip(("summary_mixing", "csgu"), kernels)}
    reported = {name: (c["launches"], c["plain_calls"])
                for name, c in result.get("kernels", {}).items()}
    if reported and reported != {name: c[:2] for name, c in counts.items()}:
        fail(f"runner {label} reported (launches, plain calls) {reported}, the wrappers "
             f"counted {counts}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"runner {label}: {seconds:.1f} s, peak memory {peak:.2f} GiB, "
          f"(launches, plain calls, backwards) {counts}")
    return result, counts, seconds, peak


def step_ms(step_s: list) -> str:
    ms = np.asarray(step_s[1:] or step_s) * 1e3
    return (f"{len(step_s)} steps, median {np.median(ms):.2f} ms per step, min {ms.min():.2f}, "
            f"max {ms.max():.2f} (the first step left out)")


def check_eval(label: str, summary: dict, n_utts: int) -> None:
    if summary["utterances"] != n_utts or not np.isfinite(summary["WER"]):
        fail(f"runner {label}: {summary['utterances']} utterances scored of {n_utts}, "
             f"WER {summary['WER']}")


def phase_runner_synthetic(kernel_rows, here: str, corpus: dict, root: str) -> None:
    """The three runners on recipes/Synthetic/hard_synthetic.yaml (d128,
    float32): neither kernel takes it, so every cell and cgMLP branch runs
    the plain path, counted."""
    from summarymixing_tpu_torch.data.dataio import read_manifest_csv
    from summarymixing_tpu_torch.recipes import evaluate, train, train_lm

    recipe = os.path.join(here, SYNTH_RECIPE)
    run, lm_run = os.path.join(root, "synthetic"), os.path.join(root, "synthetic_lm")
    n_test = len(read_manifest_csv(corpus["test"]))
    res, counts, secs, peak = run_stage("synthetic train", train.main, [
        recipe, "--train-manifest", corpus["train"], "--valid-manifest", corpus["dev"],
        "--test-manifest", corpus["test"], "--output", run, "--steps", str(RUNNER_SYNTH_STEPS)])
    print(f"runner synthetic train: {step_ms(res['step_s'])}; {res['epochs']} epochs; valid "
          f"{res['valid']}; test (beam {res['test']})")
    if res["steps"] != RUNNER_SYNTH_STEPS or not np.isfinite(res["valid"]["loss"]):
        fail(f"runner synthetic train: {res['steps']} steps, valid {res['valid']}")
    plain_total = {name: c[1] for name, c in counts.items()}
    if any(c[0] for c in counts.values()) or not all(plain_total.values()):
        fail(f"runner synthetic train: launches/plain calls {counts}; the d128 float32 recipe "
             "must run the plain path on the card, counted")
    res, counts, secs, peak = run_stage("synthetic train_lm", train_lm.main, [
        recipe, "--text", corpus["lm_text"], "--tokenizer-dir", run, "--output", lm_run,
        "--steps", str(RUNNER_LM_STEPS)])
    print(f"runner synthetic train_lm: {step_ms(res['step_s'])}; loss {res['loss']:.4f}; "
          f"{res['params']:,} parameters")
    if res["steps"] != RUNNER_LM_STEPS or not np.isfinite(res["loss"]):
        fail(f"runner synthetic train_lm: {res['steps']} steps, loss {res['loss']}")
    for label, extra in (("greedy", []), ("beam", ["--beam"]),
                         ("beam + LM", ["--beam", "--lm-ckpt", lm_run])):
        out_dir = os.path.join(root, "eval_" + label.replace(" + ", "_"))
        summary, counts_e, secs, peak = run_stage(f"synthetic evaluate {label}", evaluate.main, [
            recipe, "--test-manifest", corpus["test"], "--ckpt", os.path.join(run, "save"),
            "--avg", "2", "--output", out_dir] + extra)
        check_eval(f"synthetic evaluate {label}", summary, n_test)
        if not os.path.exists(os.path.join(out_dir, "wer_details.txt")):
            fail(f"runner synthetic evaluate {label}: no wer_details.txt")
        print(f"runner synthetic evaluate {label}: WER {summary['WER']:.2f} over "
              f"{summary['utterances']} utterances, decode {summary['decode']}, "
              f"{secs * 1e3:.1f} ms")
        for name, c in counts_e.items():
            plain_total[name] += c[1]
            if c[0]:
                fail(f"runner synthetic evaluate {label}: {name} launched {c[0]} times")
    for name, n in plain_total.items():
        kernel_rows[name]["launches_by_path"]["runner_synthetic"] = 0
        kernel_rows[name]["plain_calls_by_path"]["runner_synthetic"] = n


def phase_runner_flagship(kernel_rows, here: str, corpus: dict, root: str) -> None:
    """recipes/LibriSpeech/branchformer_summarymixing.yaml at full width and
    depth through the train runner for a few steps on the synthetic corpus
    (its own unigram tokenizer of up to 5000 pieces), then the evaluate
    runner, greedy, on one batch: both kernels at the bucketed batches'
    shapes, no plain call."""
    import csv

    from summarymixing_tpu_torch.config import load_recipe
    from summarymixing_tpu_torch.data.batching import DynamicBucketBatcher
    from summarymixing_tpu_torch.data.dataio import read_manifest_csv
    from summarymixing_tpu_torch.recipes import common, evaluate, train

    recipe = os.path.join(here, FLAGSHIP_RECIPE)
    run = os.path.join(root, "flagship")
    overrides = ["--set", f"training.max_batch_length={RUNNER_FLAGSHIP_BATCH_S}"]
    cfg = load_recipe(recipe, overrides=common.parse_overrides(
        [f"training.max_batch_length={RUNNER_FLAGSHIP_BATCH_S}",
         f"training.num_buckets={RUNNER_FLAGSHIP_BUCKETS}"]))
    n_layers = cfg.model.num_encoder_layers
    dev = read_manifest_csv(corpus["dev"])
    lengths, buckets = common.build_buckets(dev, cfg, valid=True)
    n_valid = DynamicBucketBatcher(lengths, buckets, shuffle=False, drop_last=False).num_batches()
    res, counts, secs, peak = run_stage("flagship train", train.main, [
        recipe, "--train-manifest", corpus["train"], "--valid-manifest", corpus["dev"],
        "--output", run, "--steps", str(RUNNER_FLAGSHIP_STEPS),
        "--num-buckets", str(RUNNER_FLAGSHIP_BUCKETS)] + overrides)
    print(f"runner flagship train: {step_ms(res['step_s'])}; tokenizer {res['tokenizer_size']} "
          f"pieces; valid {res['valid']} over {n_valid} batches; peak memory {peak:.2f} GiB")
    want = {name: (n_layers * (RUNNER_FLAGSHIP_STEPS + n_valid), 0,
                   n_layers * RUNNER_FLAGSHIP_STEPS) for name in counts}
    if res["steps"] != RUNNER_FLAGSHIP_STEPS or counts != want:
        fail(f"runner flagship train: {res['steps']} steps, (launches, plain calls, backwards) "
             f"{counts}, expected {want}")
    one = os.path.join(root, "one_batch.csv")
    with open(corpus["dev"], newline="") as f:
        rows = list(csv.DictReader(f))[:RUNNER_FLAGSHIP_EVAL_UTTS]
    with open(one, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    summary, counts_e, secs, peak_e = run_stage("flagship evaluate greedy", evaluate.main, [
        recipe, "--test-manifest", one, "--ckpt", os.path.join(run, "save")] + overrides
        + ["--set", "training.num_buckets=1"])
    check_eval("flagship evaluate greedy", summary, len(rows))
    print(f"runner flagship evaluate greedy: one batch of {len(rows)} utterances, WER "
          f"{summary['WER']:.2f} (a few steps of training), {secs * 1e3:.1f} ms")
    want_e = {name: (n_layers, 0, 0) for name in counts_e}
    if counts_e != want_e:
        fail(f"runner flagship evaluate: (launches, plain calls, backwards) {counts_e}, "
             f"expected {want_e}")
    for name in counts:
        kernel_rows[name]["launches_by_path"]["runner_flagship"] = (counts[name][0]
                                                                    + counts_e[name][0])
        kernel_rows[name]["plain_calls_by_path"]["runner_flagship"] = (counts[name][1]
                                                                       + counts_e[name][1])


def main() -> int:
    wall0 = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import summarymixing_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not next to this script: {e}")
    smi = phase_device()
    phase_build()
    kernel_rows = phase_kernels()
    phase_masked_kernels(kernel_rows)
    model, fbank, stats, batches, results, n_params = phase_main_path(kernel_rows)
    phase_plain_path(model, fbank, stats, batches, results)
    phase_profile(model, fbank, stats, batches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"decode: peak memory allocated {peak:.2f} GiB; parameters: {n_params:,}")
    if n_params != FLAGSHIP_PARAMS:
        fail(f"parameter count {n_params} != {FLAGSHIP_PARAMS}")
    del model, fbank, batches, results
    torch.cuda.empty_cache()
    train = phase_train(kernel_rows)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        phase_checkpoints(train, ckpt_dir)
        del train
        torch.cuda.empty_cache()
        phase_beam(kernel_rows, ckpt_dir)
    torch.cuda.empty_cache()
    phase_transducer(kernel_rows)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as root:
        corpus = make_corpus(here, os.path.join(root, "corpus"))
        phase_runner_synthetic(kernel_rows, here, corpus, root)
        phase_runner_flagship(kernel_rows, here, corpus, root)
    for row in kernel_rows.values():
        row["launches"] = sum(row["launches_by_path"].values())
        row["plain_calls"] = sum(row["plain_calls_by_path"].values())
    print(f"wall {time.perf_counter() - wall0:.1f} s; nvidia-smi: {smi}")
    print(json.dumps({"kernels": [kernel_rows["summary_mixing"], kernel_rows["csgu"]]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
