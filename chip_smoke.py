#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`summarymixing_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py                  # every phase, on one card
    python3 chip_smoke.py --processes 4    # phase 25 alone, 4 processes, one card each

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
   that the cell's autograd Function's gradients equal its plain version's
   autograd gradients bit for bit and the cgMLP's backward kernel's those
   of its plain backward within CSGU_BWD_TOL, and times the masked passes, the cell's
   pooled pass beside its bound. (c) RelPosMHAXL's attention kernel at the
   long-form cell's shapes (B=4, 8 heads, T = 1,500 and 3,000 with every key
   valid, and T = 3,000 at the cell's ragged lengths) against its plain
   version: the error, its graph ms beside its bound and the plain
   version's ms.
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
   3407). The first 2 of phase 4's 4 requests of 8 (the 16 longest of the 32
   utterances) go through `transcribe.transducer_greedy_transcribe` (each
   shape warmed up once):
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
14. Transducer training at full width: the transducer recipe as written
   (bf16 encoder compute, dropout, SpecAugment, speed perturbation, Dynamic
   Chunk Training, gradient accumulation 4, the warm-up + exponential
   decay) on request 0 (T = 751) with 40-120 random target tokens per
   utterance: 8 micro steps through `TransducerTrainer.train_step`, ms per
   micro step and peak memory. Held: every loss finite; the parameters bit
   for bit the same after micro steps 1-7 (the update of micro step 4 fires
   at the warm-up's rate 0: the optimizer's count and moments move, the
   parameters do not) and changed after 8, the inner count rising at 4 and
   8 only; `transducer_loss_chunked` (chunks of 64) against
   `transducer_loss` on the card at that shape (value and the gradients of
   both projections and the joint), each timed on its second call; the
   card's float32 lattice against float64 on the CPU on a small random
   lattice. Device time by kernel over one more micro step.
15. Transducer beam at full width: request 0 through the batched beam
   search (beam 10, state and expand beam 2.3), with the RNNLM at
   `LMConfig(model_type="rnn")` (emb 128, 2 x 2048 LSTM, dnn 512) fused at
   0.5: wall ms, the encoder/search split, rounds per second, peak memory,
   and device time by kernel over the first 40 frames. Held: on the first 40 frames of each row the
   batched search (every expansion within the expand beam kept) gives the
   sequential `transducer_beam_search`'s tokens, with and without the LM.
16. Runners, synthetic transducer recipe
   (`recipes/Synthetic/hard_synthetic_transducer.yaml`, d128, float32) on
   phase 12's corpus: `train` for 30 steps with the beam test stage,
   `train_lm --model-type rnn` for 30 steps, and `evaluate` greedy,
   `--beam`, `--beam --lm-ckpt`, `--streaming` and `--streaming-full` at
   chunks of 8 with 4 of left context: finite losses, a WER and a
   `wer_details.txt` from each, no launch, the fast cells counted in
   `plain_calls`.
Neither kernel lies on phases 14-16: both launch counters must stay 0.
17. Kernels at the serving shapes: both against their plain versions (phase
   3's tolerances) at B=1, T=126 (a 5 s request of `transcribe
   --batch-size 1`) and B=8, T=3001 (the server's 120 s bucket, ragged),
   graph ms beside the bound and the plain version's ms.
18. Serving: phase 13's flagship run through `recipes.serve.build_infer`,
   warmed up at every bucket edge, behind `serving.DynamicBatchingServer`
   (batches of 8) and `recipes.serve`'s HTTP handler on a free port in
   this process: /healthz; 8 requests one at a time, each reply equal to
   `infer` called directly on the batch the server formed for it; 32
   concurrent 5-30 s requests from 32 threads with one of 100 s and one
   FLAC body (its samples equal to its WAV twin's bit for bit, its text
   equal to the twin's); a malformed body answered 400. Prints p50/p95
   latency, mean batch, audio-s/s, the FLAC decode seconds and peak
   memory; each kernel launches 18 times per batch, no plain call. Then
   the transcribe runner at `--batch-size 1` on 5 files (one FLAC): 18
   launches per file.
19. Streaming server: the full-width transducer (phase 10's recipe, seed
   3407) in float32 behind `serving.StreamingSessionServer` with 8 slots:
   12 staggered sessions from threads over pieces of request 0's audio,
   slots reused, one session over the HTTP `/stream` endpoints; each
   session's tokens must equal `streaming.run_stream` on its audio alone.
   Median and max ms per tick; the same count in bf16 is reported, not
   held. No launch (the fast cell).
20. Export: `recipes.export_model --check` on phase 13's run (polymorphic,
   exported on the card); the artifact loaded in a fresh process that
   imports only the port, its ids, keep and encoder lengths bit-equal to
   the live inference function at (B=3, 2 s) and (B=8, 30 s: request 0),
   18 launches of each kernel per forward and no plain call; the
   streaming artifact of phase 19's float32 transducer (chunks of 8
   frames, 4 of left context) against `run_stream` on the live functions. Prints export seconds, artifact
   MB, load seconds and the artifact's latency on request 0 beside the
   live model's.
21. The Summary Decoder and the other recipes' training set-up. (a)
   `recipes/LibriSpeech/branchformer_summarymixing_summarydecoder.yaml` at
   full width (18-layer Branchformer, 6-layer Summary Decoder, seed 3407):
   one training step at B=16, T=751 after a warm-up (bf16, dropout,
   augmentation), its time and peak memory; each kernel launches and is
   differentiated 18 times, and the decoder's causal cells run the plain
   path, 6 plain calls; then request 0 through `evaluate.evaluate_beam` at
   beam 66 with the Transformer LM at `LMConfig()` (18 launches, no plain
   call), ms per step and peak memory beside the MHA decoder's step
   (printed, not compared); held: the cached step (the `(sum, denom)`
   carry) against the whole-prefix decode over 528 rows of 8 random
   positions in float32 with TF32 off, within SD_STEP_TOL. (b)
   `recipes/AISHELL-1/branchformer_summarymixing.yaml` at full width
   through the train runner on phase 12's corpus, 120 s batches in 2
   buckets, `stage_one_epochs` 1: a `--max-hours 0` call stops after one
   step with a checkpoint, the same command resumes there and runs to two
   steps past the two-stage switch; the stage of every step must be
   "adam" up to the switch and "sgd" after it, and every cell launch under
   autograd must run at twice a training batch's rows (`concat_original`);
   18 backwards per step, no plain call. (c) One flagship training step
   (with the decoder, dropout, augmentation off) with `model.remat` against
   the same step without it, the same dropout seed: loss and gradient norm
   within REMAT_TOL, 36 launches (forward and recompute) and 18 backwards
   with remat, and a lower peak memory.
22. A reference checkpoint on the card. (a) A SpeechBrain-layout
   `--ref-dir` in a temporary directory: `model.ckpt` from the clean-room
   oracle `tests/torch_full_oracle.py::build_oracle` at the flagship's
   widths (d 512, nhead 1, 18 encoder and 6 decoder layers, d_ffn 2048,
   vocabulary 5000, hidden widths 512, cgMLP 3072, kernel 31, frontend
   channels (64, 32), seed 3407), `lm.ckpt` from
   `tests/torch_lm_oracle.py` at `LMConfig()` widths (12 layers, d768,
   d_ffn 3072, the "sb" head), a seeded `normalizer.ckpt` over 80 mels and
   a 5000-piece unigram SentencePiece `tokenizer.ckpt` written by the
   port's `serialize_model_proto`. (b) `recipes.convert_checkpoint --ref-dir`,
   then `recipes.evaluate --beam --nbest 3 --lm-ckpt` on request 0 of
   phase 4 (written as 16-bit WAVs, one batch of 8, T = 751) at the
   recipe's beam 66, three times: without blank-skip, with
   `ctc_blank_skip=1.0` and no cap, and with 0.95 (the default cap); then
   one greedy `recipes.transcribe` call. (c) Held: every key of both
   checkpoints consumed; the converted model in float32 with the exact
   GELU (`--set model.activation=gelu_exact`: the plain path, the cgMLP
   kernel refuses it) against the oracle's forward on the card within
   REF_ORACLE_TOL; the recipe as written (bf16, tanh-GELU, both kernels)
   against its plain path at phase 5's tolerances; blank-skip at 1.0 the
   same hypotheses as no skip, the n-best scores within
   REF_SKIP_SCORE_TOL; `nbest.jsonl` 3 score-sorted entries per utterance,
   the first the scored hypothesis; 18 launches of each kernel per
   encoder forward and no plain call on the recipe-as-written runs. (d)
   Reported: conversion seconds, ms per beam step without and with
   blank-skip at 0.95, the CTC scorer's frames, the rows whose hypotheses
   the 0.95 skip leaves unchanged, peak memory and the phase's wall time.
23. The cell's lite and expdecay modes and the rest of the run tooling.
   (a) The flagship recipe with `mode: SummaryMixing-lite` (18 layers, d512,
   bf16, seed 3407; 70,052,072 parameters, the flax model's count): request
   0 decoded greedily 3 times, each forward launching the cgMLP kernel 18
   times and running the cell's counted plain path 18 times (the kernel
   computes full mode only), held against the same request with the
   cgMLP's plain version at phase 5's tolerances; then one training step at
   phase 7's B=16 batch with the decoder (ms, peak memory, every parameter
   a gradient; 18 cgMLP launches and backwards, 18 plain calls of the
   cell). (b) The same with `SummaryMixing-expdecay`, and the device time
   of the `[B, T, T]` float32 decay contraction at request 0's shapes from
   one torch.profiler pass, beside its bound. Both print full mode's decode
   and step from phases 4 and 7 beside theirs. (c) The Summary Decoder
   recipe with `model.mode=SummaryMixing-expdecay`: request 0 at beam 66
   with the LM (ms per step; the encoder's cells on the counted plain path,
   18 cgMLP launches) and the cached expdecay step against the
   whole-prefix decode in float32 within SD_STEP_TOL. (d) Phase 13's
   flagship run through `recipes.train --profile DIR --profile-steps 3`
   over 6 steps: the trace exists, the table names both kernels' passes
   (`branch_pass`, `gate_pass`), and `device_memory_stats` is printed.
   (e) The native loader: phase 4's 32 utterances as 16-bit WAVs in one
   batch, and one FLAC body through `dataio.load_audio_bytes`, each equal
   to the Python decoders bit for bit, with seconds both ways. (f) Phase
   10's transducer exported offline without `--fixed` (a symbolic batch and
   sample count), saved and loaded: its tokens, lengths and encoder lengths
   at request 0 and at a batch of one 13.5 s utterance equal to the live
   model's; export and load seconds, MB, and the artifact's latency beside
   the live model's.
24. The paper's self-attention and HyperMixer baselines, through the
   flagship recipe's functions with `attention_type` and `nhead`
   overridden (as `--set model.attention_type=... --set model.nhead=4`
   gives them to the runners), bf16, seeded random weights. (a) The
   Branchformer with regularMHA, RelPosMHAXL, hypermixing and cnnonly
   (nhead 4): the parameter count (flax's: 74,779,880, 79,516,904,
   98,418,920, 46,403,816), request 0 decoded greedily (one warm-up, the
   median of 5), 18 cgMLP launches per forward and no cell, held against
   the plain cgMLP at phase 5's tolerances. (b) Decode time against
   length after `benchmarks/rtf_sweep.py`: batch 4 of 10, 30, 60 and 120 s,
   the regularMHA Branchformer and the SummaryMixing flagship in turns: ms
   per batch (the median of 6, the two models in turns), audio-s/s, ms per
   audio-s and `max_memory_allocated`; at each length one regularMHA
   mixer's ms beside `F.scaled_dot_product_attention` on its q, k, v and
   that core's bound (a yardstick the port never calls), each from a CUDA
   graph of 20 calls. (c) Training steps (B=16, T=751, the decoder) of
   the SummaryMixing flagship and of the regularMHA one: a warm-up each,
   then 6 each in turns: the median ms, and each model's peak memory as if
   it were alone on the card. (d) The transducer recipe's
   Conformer with RelPosMHAXL (nhead 4): request 0 greedy; check (a) as
   in phase 10 (streamed chunks against the offline DCT encode, float32,
   within STREAM_TOL); the causal form offline; no kernel on this path.
   (e) `encoder_module="transformer"`, 12 layers d512 (47,039,720 and
   40,742,120 parameters): full-mode SummaryMixing (12 cell launches per
   forward and no plain call; held against the plain path at phase 5's
   tolerances) and causal regularMHA, request 0 greedy. Prints each
   section's seconds.

25. Several processes (`summarymixing_tpu_torch/parallel/`), two on the
   one card over gloo (NCCL refuses two processes on one device), started
   with `spawn` (CUDA cannot fork) after the kernels are built. First, in
   this process, both kernels at the sharded shapes against their plain
   versions: the cell's split route (`sm_partial` on each half of B=8,
   T=751, the sums and counts added, `sm_finish` on each; also against
   the whole-T kernel) and the cgMLP on T/2 + 30 frames (15 halo frames
   each side) against the whole-T plain version's frames, each timed by
   CUDA graph beside its bound. (a) The train runner on the flagship
   recipe (phase 12's corpus, 20-row buckets, dropout 0, no augmentation,
   4 steps) as one process and as two: each process's validation loss
   (the two within P25_RANK_AGREE, against the single run within
   TRAIN_LOSS_TOL), ms per step of both runs (two processes on one card:
   a correctness run, not a scaling number), peak memory and launches per
   process, the one-writer files. (b) Request 0 of phase 4 (waveform
   padded so the frame count is even) through
   `parallel.sequence.sequence_parallel_ctc_decode` in each process
   against the whole-T decode in that process: max |dlogp| over the
   valid frames and the greedy frame agreement at phase 5's tolerances,
   identical rows, both decodes' ms; 18 `sm_partial`, 18 `sm_finish`, 18
   halo cgMLP launches and no plain call per process and forward; the
   collectives of one sharded decode counted (the all-reduces, at least
   one per layer, and their bytes by `parallel.comm.COLLECTIVES`), and
   each kind timed alone (the flagship's gradient all-reduce, a cell's
   sums, a halo exchange).
   (c) `recipes.evaluate --seq-parallel 2` on (a)'s checkpoint against
   the single-process greedy run: the WER, the decode and the hypotheses
   row by row (at least P25_ROW_AGREE the same); beside it, as a witness
   of the batch shape alone, one process on the same checkpoint with
   the rows per batch of a data shard (half of them on one card) against
   the full batches, and the rows that differ in each. About 50 s. With
   `--processes N` the script runs phases 1, 2 and 25 alone with N
   processes, one card each over NCCL: (b) over N shards, (c) over
   P25_SEQ shards and a data axis of N / P25_SEQ.
26. The last slice. (a) W8A8: the int8 product (`ops/quant.py`,
   `torch._int_mm`) at the flagship cgMLP shapes (B=8, T=751: [6008, 512]
   x [512, 3072] and [6008, 1536] x [1536, 512]) with the card's int32
   accumulators equal to the CPU route's, each timed with the weight in
   the port's TN layout and in a row-major copy, beside the bf16 product
   (CUDA graph); request 0's greedy decode with `model.act_int8` (the
   same weights): in every W8A8 decode, counted from 0, 18 cell
   launches, 0 cgMLP launches, 18 `int8_calls` and no plain call; its
   time beside the bf16 decode's in turns, and its agreement with the
   bf16 decode (reported: the weights are random). Before (b) and (c):
   both kernels against their plain versions, forward and the Function's
   gradients, with no keep-mask, at each pipeline microbatch's shape
   ([2, 751, 512]) and each sharded process's rows at the training T (8
   and 16 rows). (b) The flagship training step (its decoder, dropout 0,
   no augmentation, phase 7's batch of 16) for P26_STEPS steps in this
   process (twice, to show whether one process repeats its own bits;
   cuDNN deterministic; both counted), then over four processes on the one card (gloo,
   `spawn`) under each rule of `parallel/mesh.py`: composite on a 2x2
   mesh, FSDP on 2x1 and tensor parallelism on 1x2 (processes 0 and 1):
   TP's losses equal the one process's bit for bit, FSDP's and
   composite's within P26_DP_TOL; each process keeps P26_SHARES of the
   parameter and moment elements (the JAX rules' shares on this model);
   18 launches and 18 backwards of each kernel per step and no plain
   call; step times and peak memory per process. (c) The flagship's
   18-layer encoder pipelined in two stages over processes 0 and 1
   (`parallel/pipeline.py`, 4 microbatches of B=8, T=751; activations
   staged through host memory under gloo): output bit-equal to the
   sequential encode of the same microbatches, 36 launches of each kernel
   per process, one backward's gradients within P26_PIPE_GRAD_TOL of the
   sequential ones, wall ms beside the sequential encode and the bubble
   M/(M+S-1). (d) A 6-layer d512 `ConformerDecoder` (d_ffn 2048, 8 heads,
   kernel 3, causal, regularMHA) on the card against its CPU forward in
   float32, and the uncached beam step (`evaluate.make_beam_step` for a
   decoder with no cached step) against the cached step on the flagship
   decoder's weights in float32, both within P26_F32_TOL. About 100-150 s.
   `--processes N` with N >= 4 also runs (b) and (c) over N cards (NCCL).

`plain_calls` (cells or cgMLP branches on the card whose configuration the
kernel does not take, run on the plain path) is set to 0 at phase 4 and
must still be 0 after phases 4, 7 and 9: the flagship takes both kernels
everywhere. The kernels line reports `launches` and `plain_calls` summed
over phases 4, 7, 9, 10, 12-16 and 18-24, and each by path (`serve`,
`transcribe`, `serve_streaming` and `export` for phases 18-20;
`summary_decoder`, `runner_aishell` and `remat` for phase 21;
`reference_checkpoint` for phase 22's runners; `lite`, `expdecay`,
`summary_decoder_expdecay`, `runner_profile` and `export_transducer` for
phase 23; `baselines`, `baseline_sweep`, `baseline_train` and
`transformer_encoder` for phase 24; `dist_train`, `seq_parallel` and
`seq_parallel_runner` for phase 25, both processes and the single-process
runs they are held against; `w8a8` (the cell only), `sharded_train`
(every process and the two single-process runs) and `pipeline` for phase
26), with the phase-17 rows under
`serving_shapes` and phase 25's under `split_route` and `halo_route`.

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
from typing import Optional

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
# The cgMLP's backward kernels against their plain version, on max |kernel -
# plain| / max |plain| per gradient: the same bf16 roundings (h, g, dh, dz)
# with sums in another order (tests/test_torch_card.py holds the same bound).
CSGU_BWD_TOL = 2.0 ** -6


def function_grads_ok(name, got, plain, backward):
    """Whether an autograd Function's gradients `got` pass: the cell's equal
    `plain` (its plain version's autograd gradients) bit for bit; the
    cgMLP's, whose backward is a kernel, lie within CSGU_BWD_TOL of
    `backward()` (its plain backward), max |got - want| / max |want| per
    gradient. Returns (ok, a note for the report)."""
    import torch

    if name == "summary_mixing":
        equal = all(torch.equal(a, b) for a, b in zip(got, plain))
        return equal, f"equal the plain version's bit for bit: {equal}"
    worst = max(float((a.float() - w.float()).abs().max() / w.float().abs().max())
                for a, w in zip(got, backward()))
    return worst <= CSGU_BWD_TOL, f"against the plain backward {worst:.3e} (tol {CSGU_BWD_TOL:.3e})"
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
TRANSDUCER_REQUESTS = 2   # of phase 4's 4 requests, decoded greedily (the longest first)
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
# transducer training at full width (phase 14)
TD_MICRO_STEPS = 8
TD_TOKENS = (40, 120)     # random target tokens per utterance
TD_JOINT_CHUNK = 64
# the chunked joint against the whole joint, float32 with TF32 off: the same
# products over chunks of T, one log-sum-exp each
TD_CHUNK_LOSS_TOL, TD_CHUNK_GRAD_TOL = 1e-5, 1e-4
# float32 on the card against float64 on the CPU over a 40-step lattice
TD_LATTICE_TOL, TD_LATTICE_GRAD_TOL = 1e-5, 1e-4
# transducer beam (phase 15): frames of each row the sequential oracle runs
TD_BEAM_CHECK_FRAMES = 40
# transducer runners (phase 16)
TRANSDUCER_SYNTH_RECIPE = "recipes/Synthetic/hard_synthetic_transducer.yaml"
RUNNER_STREAM_CHUNK, RUNNER_STREAM_LEFT = 8, 4
# serving, transcription and export (phases 17-20)
SERVE_SHAPES = ((1, 5.0), (8, 120.0))   # (B, seconds): transcribe --batch-size 1, the 120 s bucket
SERVE_SEQUENTIAL, SERVE_CONCURRENT, SERVE_LONG_S = 8, 32, 100.0
STREAM_SESSIONS, STREAM_SLOTS = 12, 8
EXPORT_SHAPES = ((3, 2.0), (8, 30.0))   # (B, seconds) the loaded artifact runs at
HTTP_TIMEOUT = 300.0
# the Summary Decoder and the other recipes' training set-up (phase 21)
SD_RECIPE = "recipes/LibriSpeech/branchformer_summarymixing_summarydecoder.yaml"
AISHELL_RECIPE = "recipes/AISHELL-1/branchformer_summarymixing.yaml"
# (a) the cached Summary Decoder step against the whole-prefix decode,
# float32 with TF32 off, on max |cached - prefix| / (1 + |prefix|) of the
# decoder's hidden states: the CPU parity tests' float32 tolerance
SD_STEP_TOL = 2e-5
SD_CHECK_POSITIONS = 8
# the MHA decoder's beam step on the same request, as PERF.md records it:
# printed beside the Summary Decoder's, not compared
MHA_BEAM_STEP_MS, MHA_GATHER_MS = (27.35, 30.97), 6.38
# (b) AISHELL-1 through the train runner: batches of 120 s in 2 buckets
# (about 8 steps per epoch of the 320 training utterances), one Adam epoch
AISHELL_BATCH_S, AISHELL_BUCKETS = 120.0, 2
# (c) remat against none: one bf16 training step with the same dropout
# masks; loss and gradient norm within one bf16 step of each other
REMAT_TOL = 2.0 ** -8
# a reference (SpeechBrain-layout) checkpoint on the card (phase 22)
REF_SEED = 3407
REF_NBEST = 3
REF_SKIP = 0.95
# (c) the converted flagship in float32 (exact GELU, TF32 off, the plain path)
# against the clean-room oracle's own forward on the same features, relative
# L2 over the frames of full-length rows of the encoder output and the CTC
# log-probs: the same float32 arithmetic in another order, 18 layers deep
# (the JAX package's CPU test holds 1e-4 max abs at d16)
REF_ORACLE_TOL = 1e-4
# (c) blank-skip at 1.0 with no cap against no skip: the same hypotheses, the
# n-best's length-normalised scores within this (the scorer's reductions
# run over a longer, padded time axis)
REF_SKIP_SCORE_TOL = 1e-3
# the cell's lite and expdecay modes and the rest of the run tooling (phase 23)
LITE, EXPDECAY = "SummaryMixing-lite", "SummaryMixing-expdecay"
# the flagship in lite mode, as flax counts it (tests/test_torch_modes.py):
# 88,954,088 less 18 x (local_proj 525,312 + summary_local_merging 524,800)
FLAGSHIP_LITE_PARAMS = 70_052_072
MODE_DECODES = 3        # timed greedy decodes of request 0 per mode
PROFILE_STEPS = 6       # (d): 3 steps skipped, 3 traced
# full mode's request-0 decode and training step of this run (phases 4 and
# 7), printed beside the modes' (not compared: the same card, one call)
FULL_MODE_MS = {}
# the paper's baselines (phase 24): the flagship Branchformer with each other
# mixer at nhead 4 (bench.py's and benchmarks/rtf_sweep.py's configuration),
# its parameters as flax counts them (tests/test_torch_baselines.py)
BASELINES = {"regularMHA": 74_779_880, "RelPosMHAXL": 79_516_904, "hypermixing": 98_418_920,
             "cnnonly": 46_403_816}
BASELINE_NHEAD = 4
BASELINE_DECODES = 5    # timed greedy decodes of request 0 per baseline, after one warm-up
BASELINE_STEPS = 6      # timed training steps per model, after one warm-up, the two in turns
SWEEP_BATCH, SWEEP_SECONDS = 4, (10, 30, 60, 120)   # benchmarks/rtf_sweep.py's defaults
SWEEP_DECODES = 6       # per model and length, the two models in turns
# the Transformer encoder at 12 layers, d512 (the flagship's other widths)
TRANSFORMER_LAYERS = 12
TRANSFORMER_PARAMS = {"SummaryMixing": 47_039_720, "regularMHA": 40_742_120}
# phase 25: two processes on the one card (gloo), the flagship recipe at
# dropout 0 without augmentation; 20-row buckets, so the bucket sizes of one
# process already divide by two and both runs draw the same batches
P25_RANKS = 2               # processes on the one card; `--processes N`: one card each
P25_SEQ = 2                 # (c): `evaluate --seq-parallel`, the rest a data axis
P25_STEPS = 4
P25_MAX_BATCH = 20
P25_SETTINGS = ("training.max_batch_length=72.0", "training.num_buckets=2",
                f"training.max_batch_ex={P25_MAX_BATCH}", "model.transformer_dropout=0.0",
                "augment.speed_perturb=false", "augment.fea_augment=false")
P25_RANK_AGREE = 1e-6       # |valid loss rank 0 - rank 1|: one all-reduced value
# phase 5's tolerances of the kernel path against the plain path (a sharded
# decode sums the pooled mean in another order and rounds it to bf16 again)
PATH_LOGP_TOL, PATH_FRAME_AGREE = 1.0, 0.95
P25_ROW_AGREE = 0.95        # (c): share of utterances with the same hypothesis
P25_TIMEOUT = 300
# phase 26: W8A8, the sharding rules, the pipeline, the Conformer decoder
# and the uncached beam step
P26_STEPS = 3
P26_GRIDS = (("composite", 2, 2), ("fsdp", 2, 1), ("tp", 1, 2))   # (rule, data, model)
# the share of parameter elements each process keeps, from the JAX rules
# on the flagship training model (jax.eval_shape of the recipe, default
# thresholds): FSDP 2x1 226 of 643 leaves, TP 1x2 44, composite 2x2 244
P26_SHARES = {"fsdp": 0.5050, "tp": 0.8299, "composite": 0.5014}
P26_DP_TOL = 2.5e-5         # (b): FSDP and composite losses, relative to one process's
P26_MICRO, P26_STAGES = 4, 2
P26_DECODES = 3             # (a): timed greedy decodes of request 0 each, bf16 and W8A8 in turns
P26_PIPE_GRAD_TOL = 1e-3    # (c): per-tensor relative L2, pipelined against sequential gradients
P26_F32_TOL = 1e-4          # (d): float32 card against CPU, and uncached against cached steps
P26_DECODER = dict(num_layers=6, d_model=512, d_ffn=2048, nhead=8, kernel_size=3, causal=True,
                   attention_type="regularMHA")
P26_TIMEOUT = 400


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


RELPOS_TOL = 2.0 ** -7     # tests/test_torch_card.py states its reason
# (T, valid keys per row or None for every key): the long-form cell's 60 s
# and 120 s segments, B = 4, and a batch of its ragged lengths
RELPOS_SHAPES = ((1500, None), (3000, None), (3000, (3000, 2712, 2100, 1499)))


def phase_relpos_kernel(kernel_rows):
    """Phase 3 (c): RelPosMHAXL's attention kernel at the long-form shapes
    (B=4, 8 heads, hd=64) against its plain version: the error, the
    kernel's graph ms beside its bound and the plain version's ms. The
    bound counts the operations the function needs: per utterance and head
    three products of T queries by its valid keys (content, the rel_shift
    band of the position scores, value); the kernel's own position product
    is twice the content's, printed beside it. Adds the `relpos_attention`
    row to `kernel_rows`."""
    import torch

    from summarymixing_tpu_torch.ops import attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    b, h, hd = 4, 8, 64
    fn = attention.fused_relpos_attention
    launches0 = fn.launches
    timings = []
    for t, lengths in RELPOS_SHAPES:
        q, k, v = (torch.randn(b, t, h, hd, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        p = torch.randn(1, 2 * t - 1, h, hd, generator=g, device=dev).to(torch.bfloat16)
        u, vb = (0.3 * torch.randn(h, hd, generator=g, device=dev) for _ in range(2))
        keys = lengths or (t,) * b
        pad = None if lengths is None else (
            torch.arange(t, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None]).float()
        label = f"B={b}, T={t}" + ("" if lengths is None else f", lengths {list(lengths)}")
        with torch.no_grad():
            got = fn(q, k, v, p, u, vb, pad)
            want = attention.relpos_attention_reference(q, k, v, p, u, vb, None, pad)
            torch.cuda.synchronize()
            abs_err, err = rel_err(got, want)
            ok = err <= RELPOS_TOL
            print(f"kernel relpos_attention ({label}): max_abs_err {abs_err:.3e} "
                  f"max_rel_err {err:.3e} tol {RELPOS_TOL:.3e} {'ok' if ok else 'FAILED'}")
            if not ok:
                fail("relpos_attention disagrees with its plain version")
            ms = graph_ms(lambda: fn(q, k, v, p, u, vb, pad))
            plain_ms = cuda_ms(
                lambda: attention.relpos_attention_reference(q, k, v, p, u, vb, None, pad),
                iters=5, warmup=1)
        flops = 2 * h * hd * 3 * t * sum(keys)
        design_flops = 4 * flops // 3   # its position product: 128 columns a 64-key tile
        nbytes = 2 * (4 * b * t * h * hd + (2 * t - 1) * h * hd)   # q, k, v, out; p
        bound_ms, by = bound(nbytes, flops)
        print(f"kernel relpos_attention ({label}): {ms:.4f} ms (graph), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), {100 * bound_ms / ms:.1f}% of bound; the kernel "
              f"computes {design_flops / 1e9:.1f} GFLOP")
        timings.append(dict(b=b, t=t, lengths=keys, max_abs_err=abs_err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                            design_gflop=design_flops / 1e9))
    kernel_rows["relpos_attention"] = dict(
        name="relpos_attention", route="cuda",
        source="summarymixing_tpu_torch/csrc/relpos_attention.cu", replaces=None,
        shapes=timings, library_ms=None,
        launches_by_path={"relpos_kernel": fn.launches - launches0}, plain_calls_by_path={})


def phase_masked_kernels(kernel_rows):
    """Both kernels with a dropout keep-mask at the training shapes: forward
    against the plain version, the autograd Functions' gradients against
    the cell's plain autograd gradients (bit for bit) and the cgMLP's plain
    backward (within CSGU_BWD_TOL), and the masked forward's time, the
    cell's pooled pass beside its bound."""
    import torch

    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    dev = torch.device("cuda")
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
        grad_ok, grad_note = function_grads_ok(
            name, grads[0][1], grads[1][1],
            lambda: fused_csgu.convolution_branch_backward_reference(
                g_out, x, mask, fused_csgu.kernel_weights(weights), 1e-5, keep_branch, keep_prob))
        ok = err <= tol and grad_ok
        print(f"masked kernel {name} (B={b}, T={t}, dropout {DROPOUT}): max_abs_err {abs_err:.3e} "
              f"max_rel_err {err:.3e} tol {tol:.3e}; Function gradients {grad_note} "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            fail(f"masked {name} disagrees with its plain version")
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
                                           grad_ok=grad_ok, ms=ms, eager_ms=eager,
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
    FULL_MODE_MS["decode"] = results[0][0] * 1e3
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


def plain_kernels():
    """Both wrappers swapped for their plain versions (`ops/plain.py`)."""
    from summarymixing_tpu_torch.ops.plain import plain_kernels as swapped

    return swapped()


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
    FULL_MODE_MS["train_step"] = float(np.median(times)) * 1e3
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


def stream_vs_offline(model, fbank, stats, wav, lens) -> float:
    """Check (a): a Conformer recognizer's `encode_streaming` chunk by chunk
    (chunks of STREAM_CHUNK frames, STREAM_LEFT chunks of left context)
    against its offline encode under the matching `DynChunkTrainConfig`, on
    the same CNN output: max |stream - offline| / (1 + |offline|) over the
    valid frames."""
    import torch

    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.models.asr import DynChunkTrainConfig
    from summarymixing_tpu_torch.ops.masks import length_to_mask

    with torch.inference_mode():
        feats, _ = InputNormalization()(fbank(wav), stats)
        src = model.frontend(feats)
        enc_lens = model.subsampled_length(fbank.frame_lengths(lens))
        t_enc = src.shape[1]
        n_chunks = -(-t_enc // STREAM_CHUNK)
        src = torch.nn.functional.pad(src, (0, 0, 0, n_chunks * STREAM_CHUNK - t_enc))
        dct = DynChunkTrainConfig(STREAM_CHUNK, STREAM_LEFT)
        offline = model.asr.encode(src, dynchunktrain=dct)
        state = model.streaming_init(wav.shape[0], dct)
        outs = []
        for c in range(n_chunks):
            out, state = model.encode_streaming_chunk(
                src[:, c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK], state)
            outs.append(out)
        valid = length_to_mask(enc_lens, offline.shape[1]) > 0
        return max_rel(torch.cat(outs, dim=1), offline, valid)


def phase_transducer(kernel_rows) -> None:
    """The transducer recipe's inference: offline greedy over 4 requests,
    chunked streaming and the raw-audio pipeline over request 0, check (a)
    and the reports listed in the module docstring."""
    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.evaluate import streaming_decode
    from summarymixing_tpu_torch.frontend.features import InputNormalization
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

    for _, wav, lens in batches[:TRANSDUCER_REQUESTS]:   # warm-up: library kernels pick algorithms per shape
        transcribe(wav, lens)
    total_dt = total_audio = 0.0
    for r, (idx, wav, lens) in enumerate(batches[:TRANSDUCER_REQUESTS]):
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
    print(f"transducer greedy: {TRANSDUCER_REQUESTS} requests, {total_audio:.2f} audio-s in "
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
    set_compute_dtype(model, None)
    err_fp32 = stream_vs_offline(model, fbank, stats, wav, lens)
    agree32 = agreement(
        *streaming_decode(model, td, fbank, stats, wav, lens, STREAM_CHUNK, STREAM_LEFT),
        *run_stream(init_fn, step_fn, wav, lens, info["chunk_samples"]))
    print(f"transducer run_stream vs streaming_decode in float32 (TF32 off): {agree32} "
          "(reported, not held)")
    with torch.inference_mode():
        feats, _ = InputNormalization()(fbank(wav), stats)
        enc32, enc_lens = model.encode(feats, fbank.frame_lengths(lens))
    set_compute_dtype(model, torch.bfloat16)
    err_bf16 = stream_vs_offline(model, fbank, stats, wav, lens)
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


def request0(sample_rate: int) -> tuple:
    """Request 0 of phases 4 and 10 (the 8 longest of the 32 synthetic
    utterances, T = 751 encoder frames): `(wav [8, N], wav_lens [8])`."""
    from summarymixing_tpu_torch.transcribe import batch_waveforms

    _, wav, lens = next(iter(batch_waveforms(synthetic_waveforms(N_REQUESTS * BATCH, seed=11),
                                             BATCH, pad_quantum=sample_rate // 2)))
    return wav, lens


def transducer_batch(wav, lens, vocab: int, seed: int = 41) -> dict:
    """Request 0's waveforms with random token ids in [1, vocab), 40-120 per
    utterance, padded with 0."""
    import torch

    rng = np.random.default_rng(seed)
    token_lens = rng.integers(TD_TOKENS[0], TD_TOKENS[1] + 1, wav.shape[0]).astype(np.int32)
    tokens = np.zeros((wav.shape[0], int(token_lens.max())), np.int32)
    for i, u in enumerate(token_lens):
        tokens[i, :u] = rng.integers(1, vocab, u)
    return {"wav": wav, "wav_lens": lens, "tokens": torch.from_numpy(tokens).cuda(),
            "token_lens": torch.from_numpy(token_lens).cuda()}


def rel_l2(got, want) -> float:
    import torch

    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def phase_transducer_train(kernel_rows) -> None:
    """The transducer recipe's training at full width (bf16 encoder,
    dropout, SpecAugment, speed perturbation, DCT, accumulation 4) on
    request 0 with random targets: 8 micro steps through
    `TransducerTrainer.train_step`, the accumulation held bit for bit, the
    chunked joint against the whole joint, and the card's lattice against
    float64 on the CPU."""
    import torch

    from summarymixing_tpu_torch.config import build_model, build_transducer_trainer
    from summarymixing_tpu_torch.losses.transducer import (
        transducer_loss,
        transducer_loss_chunked,
    )
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    cfg = transducer_config()
    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    for fn in kernels:
        fn.launches, fn.plain_calls = 0, 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, fbank, td = build_model(cfg)
    trainer = build_transducer_trainer(cfg, model, fbank, td)
    state = trainer.init_state(cfg.seed)
    wav, lens = request0(cfg.features.sample_rate)
    batch = transducer_batch(wav, lens, cfg.model.output_neurons)
    k = cfg.training.grad_accumulation_factor
    print(f"transducer train: recipe {cfg.name}, bf16 encoder compute, dropout "
          f"{cfg.model.transformer_dropout}, speed perturbation and SpecAugment on, DCT "
          f"(chunkwise p {cfg.transducer.chunkwise_prob}), accumulation {k}, "
          f"{cfg.training.scheduler}; batch {BATCH} utterances, "
          f"{float(lens.sum()) / cfg.features.sample_rate:.2f} audio-s, target tokens "
          f"{batch['token_lens'].tolist()}")
    inner = lambda st: st["opt_state"]["inner"]   # noqa: E731
    times = []
    for i in range(1, TD_MICRO_STEPS + 1):
        before = [p.detach().clone() for p in trainer.params]
        count0 = int(inner(state)["count"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        same = all(torch.equal(p, q) for p, q in zip(trainer.params, before))
        fired = i % k == 0
        loss = float(metrics["loss"])
        print(f"transducer train micro step {i}: {times[-1] * 1e3:.1f} ms, loss {loss:.4f} "
              f"(rnnt {float(metrics['transducer']):.4f}, ctc {float(metrics['ctc']):.4f}), "
              f"micro grad norm {float(metrics['grad_norm']):.4f}, mini_step "
              f"{state['opt_state']['mini_step']}, inner count {int(inner(state)['count'])}, "
              f"parameters {'unchanged' if same else 'changed'}")
        if not np.isfinite(loss) or metrics["nonfinite_skipped"]:
            fail(f"transducer train micro step {i}: loss {loss}")
        if int(inner(state)["count"]) != count0 + fired:
            fail(f"transducer train micro step {i}: the inner optimizer stepped "
                 f"{int(inner(state)['count']) - count0} times, expected {int(fired)}")
        # the warm-up's rate at count 0 is 0: the first update moves the
        # moments and the count, not the parameters
        if same != (not fired or i == k):
            fail(f"transducer train micro step {i}: parameters "
                 f"{'unchanged' if same else 'changed'}; they must change only when the "
                 f"accumulated update fires with a positive rate (micro steps {2 * k}, ...)")
    ms = np.asarray(times[1:]) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"transducer train: {TD_MICRO_STEPS} micro steps, median {np.median(ms):.1f} ms, min "
          f"{ms.min():.1f}, max {ms.max():.1f} ms per micro step (the first left out); peak "
          f"memory allocated {peak:.2f} GiB; accumulation held: parameters bit for bit the "
          f"same after micro steps 1-{k - 1}, {k} (rate 0 at count 0) and {k + 1}-{2 * k - 1}, "
          f"changed after {2 * k}")
    rose = [fn.launches for fn in kernels]
    plain = [fn.plain_calls for fn in kernels]
    if rose != [0, 0]:
        fail(f"transducer train: a hand-written kernel was launched: {rose}")
    # one more micro step (not counted above) under the profiler
    device_profile(lambda: trainer.train_step(state, batch), "transducer train micro step",
                   top=16)
    for name, n in zip(("summary_mixing", "csgu"), plain):
        kernel_rows[name]["launches_by_path"]["transducer_train"] = 0
        kernel_rows[name]["plain_calls_by_path"]["transducer_train"] = n

    # the chunked joint against the whole joint, in float32 with TF32 off
    with torch.no_grad():
        _, (_, _, (enc_out, enc_lens)) = trainer._forward_loss(state["norm_stats"], batch,
                                                               False, 0)
    tokens, token_lens = batch["tokens"], batch["token_lens"]
    results = []
    for chunked in (False, False, True, True):   # each timed on its second call
        e = td.encode_proj(enc_out).detach().requires_grad_(True)
        with torch.no_grad():
            d0 = td.predictor(trainer._add_blank_bos(tokens))
        d = d0.detach().requires_grad_(True)
        td.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if chunked:
            loss = transducer_loss_chunked(e, d, td.joint, tokens, enc_lens, token_lens,
                                           chunk_size=TD_JOINT_CHUNK)
        else:
            loss = transducer_loss(td.joint(e, d), tokens, enc_lens, token_lens)
        loss.backward()
        torch.cuda.synchronize()
        results.append((float(loss.detach()), e.grad, d.grad,
                        td.joint.transducer_lin.weight.grad.clone(),
                        time.perf_counter() - t0))
    (lw, *gw, tw), (lc, *gc, tc) = results[1], results[3]
    loss_rel = abs(lc - lw) / abs(lw)
    grad_rel = max(rel_l2(a, b) for a, b in zip(gc, gw))
    ok = loss_rel <= TD_CHUNK_LOSS_TOL and grad_rel <= TD_CHUNK_GRAD_TOL
    print(f"transducer train check: transducer_loss_chunked (chunks of {TD_JOINT_CHUNK}) vs "
          f"transducer_loss at B={BATCH}, T={enc_out.shape[1]}, U+1={tokens.shape[1] + 1}, "
          f"V={cfg.model.output_neurons}: loss {lc:.6f} vs {lw:.6f}, rel {loss_rel:.3e} (tol "
          f"{TD_CHUNK_LOSS_TOL:.0e}); gradients (enc_proj, dec_proj, joint) max rel L2 "
          f"{grad_rel:.3e} (tol {TD_CHUNK_GRAD_TOL:.0e}) {'ok' if ok else 'FAILED'}; forward + "
          f"backward {tw * 1e3:.1f} ms whole, {tc * 1e3:.1f} ms chunked")
    if not ok:
        fail("transducer train: the chunked joint's loss disagrees with the whole joint's")

    # a small random lattice on the card against float64 on the CPU
    g = torch.Generator().manual_seed(5)
    logits = 2.0 * torch.randn(3, 40, 12, 30, generator=g)
    targets = torch.randint(1, 30, (3, 11), generator=g)
    il, tl = torch.tensor([40, 33, 17]), torch.tensor([11, 7, 0])
    x64 = logits.double().requires_grad_(True)
    want = transducer_loss(x64, targets, il, tl, reduction="none")
    want.sum().backward()
    x32 = logits.cuda().requires_grad_(True)
    got = transducer_loss(x32, targets.cuda(), il.cuda(), tl.cuda(), reduction="none")
    got.sum().backward()
    l_err = float(((got.detach().double().cpu() - want.detach()).abs()
                   / want.detach().abs()).max())
    g_err = rel_l2(x32.grad.cpu().double(), x64.grad)
    ok = l_err <= TD_LATTICE_TOL and g_err <= TD_LATTICE_GRAD_TOL
    print(f"transducer train check: a random lattice (B=3, T=40, U+1=12, V=30) on the card in "
          f"float32 vs the CPU in float64: loss max rel {l_err:.3e} (tol {TD_LATTICE_TOL:.0e}), "
          f"gradient rel L2 {g_err:.3e} (tol {TD_LATTICE_GRAD_TOL:.0e}) "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("transducer train: the card's lattice disagrees with float64")
    del trainer, model, td, state, results
    torch.cuda.empty_cache()


def phase_transducer_beam(kernel_rows) -> None:
    """The transducer recipe's test decode at full width: request 0 through
    the batched beam search (beam 10, state and expand beam 2.3) with the
    RNNLM at `LMConfig(model_type="rnn")` fused at 0.5, and without it; the
    batched search against the sequential one on the first frames."""
    import torch

    from summarymixing_tpu_torch.config import LMConfig, build_lm, build_model
    from summarymixing_tpu_torch.decoding.transducer_search import (
        transducer_beam_search,
        transducer_beam_search_batched,
    )
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    cfg = transducer_config()
    dec = cfg.decoding
    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    for fn in kernels:
        fn.launches, fn.plain_calls = 0, 0
    torch.cuda.reset_peak_memory_stats()
    model, fbank, td = build_model(cfg)
    lm = build_lm(LMConfig(model_type="rnn"), cfg.model.output_neurons, seed=cfg.seed)
    n_lm = sum(p.numel() for p in lm.parameters())
    stats = seeded_norm_stats()
    wav, lens = request0(cfg.features.sample_rate)
    kw = dict(blank_id=cfg.model.blank_index, bos_id=cfg.model.bos_index,
              beam_size=dec.beam_size, state_beam=dec.state_beam, expand_beam=dec.expand_beam)
    lm_kw = dict(lm_step=lm.step, lm_init=lm.initial_state, lm_weight=dec.lm_weight)
    fns = (td.predictor_init, td.predictor_step, td.joint_step)
    print(f"transducer beam: beam {dec.beam_size}, state beam {dec.state_beam}, expand beam "
          f"{dec.expand_beam}; RNNLM (emb 128, 2 x 2048 LSTM, dnn 512) {n_lm:,} float32 "
          f"parameters at LM weight {dec.lm_weight}")

    def encode():
        with torch.inference_mode():
            feats, _ = InputNormalization()(fbank(wav), stats)
            enc, enc_lens = model.encode(feats, fbank.frame_lengths(lens))
            return td.encode_proj(enc), enc_lens

    def search(enc_proj, enc_lens, with_lm, **extra):
        with torch.inference_mode():
            return transducer_beam_search_batched(enc_proj, enc_lens, *fns, **kw, **extra,
                                                  **(lm_kw if with_lm else {}))

    enc_proj, enc_lens = encode()
    search(enc_proj[:, :8], torch.clamp(enc_lens, max=8), True)   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_proj, enc_lens = encode()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks, tlens, scores = search(enc_proj, enc_lens, True)
    hyp_lens = tlens.tolist()
    t2 = time.perf_counter()
    rounds = enc_proj.shape[1] * dec.beam_size
    if not torch.isfinite(scores).all() or min(hyp_lens) < 0:
        fail(f"transducer beam: scores {scores.tolist()}, lengths {hyp_lens}")
    if any(t <= 0 or t >= cfg.model.output_neurons
           for i, n in enumerate(hyp_lens) for t in toks[i, :n].tolist()):
        fail("transducer beam: token ids outside [1, vocabulary)")
    print(f"transducer beam request 0 (with the RNNLM): "
          f"{(t2 - t0) * 1e3:.1f} ms wall, encoder {(t1 - t0) * 1e3:.1f} ms, search "
          f"{(t2 - t1) * 1e3:.1f} ms ({rounds} rounds over T={enc_proj.shape[1]}, "
          f"{rounds / (t2 - t1):.1f} rounds/s, {(t2 - t1) * 1e3 / rounds:.3f} ms per "
          f"round); tokens per row {hyp_lens}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"transducer beam: peak memory allocated {peak:.2f} GiB")

    # batched against sequential over the first frames of each row; the
    # batched search keeps every expansion within expand_beam (max_expand =
    # vocab - 1), as the sequential one does
    n_frames = min(TD_BEAM_CHECK_FRAMES, enc_proj.shape[1])
    short = torch.clamp(enc_lens, max=n_frames)
    device_profile(lambda: search(enc_proj[:, :n_frames], short, True),
                   f"transducer beam with the RNNLM, the first {n_frames} frames", top=16)
    for with_lm in (False, True):
        t0 = time.perf_counter()
        btoks, blens, _ = search(enc_proj[:, :n_frames], short, with_lm,
                                 max_expand=cfg.model.output_neurons - 1)
        batched = [btoks[i, :int(blens[i])].tolist() for i in range(BATCH)]
        t1 = time.perf_counter()
        seq = [transducer_beam_search(enc_proj[i, :n_frames], int(short[i]), *fns, **kw,
                                      **(lm_kw if with_lm else {}))[0][0]
               for i in range(BATCH)]
        t2 = time.perf_counter()
        same = sum(a == b for a, b in zip(batched, seq))
        print(f"transducer beam check ({'with' if with_lm else 'without'} the RNNLM): batched "
              f"(max_expand {cfg.model.output_neurons - 1}) vs sequential over the first "
              f"{n_frames} frames: {same}/{BATCH} rows with the same tokens; batched "
              f"{(t1 - t0) * 1e3:.1f} ms, sequential {(t2 - t1) * 1e3:.1f} ms; tokens per row "
              f"{[len(h) for h in seq]}")
        if same != BATCH:
            fail("transducer beam: the batched search disagrees with the sequential search")
    rose = [fn.launches for fn in kernels]
    plain = [fn.plain_calls for fn in kernels]
    if rose != [0, 0]:
        fail(f"transducer beam: a hand-written kernel was launched: {rose}")
    for name, n in zip(("summary_mixing", "csgu"), plain):
        kernel_rows[name]["launches_by_path"]["transducer_beam"] = 0
        kernel_rows[name]["plain_calls_by_path"]["transducer_beam"] = n
    del model, td, lm
    torch.cuda.empty_cache()


def phase_runner_transducer(kernel_rows, here: str, corpus: dict, root: str) -> None:
    """The three runners on recipes/Synthetic/hard_synthetic_transducer.yaml
    (d128, float32, the fast cell): the plain path, counted."""
    from summarymixing_tpu_torch.data.dataio import read_manifest_csv
    from summarymixing_tpu_torch.recipes import evaluate, train, train_lm

    recipe = os.path.join(here, TRANSDUCER_SYNTH_RECIPE)
    run, lm_run = os.path.join(root, "transducer"), os.path.join(root, "transducer_lm")
    n_test = len(read_manifest_csv(corpus["test"]))
    plain_total = {}

    def no_launch(label, counts):
        for name, c in counts.items():
            plain_total[name] = plain_total.get(name, 0) + c[1]
            if c[0]:
                fail(f"runner {label}: {name} launched {c[0]} times")

    res, counts, secs, peak = run_stage("transducer train", train.main, [
        recipe, "--train-manifest", corpus["train"], "--valid-manifest", corpus["dev"],
        "--test-manifest", corpus["test"], "--output", run, "--steps",
        str(RUNNER_SYNTH_STEPS)])
    print(f"runner transducer train: {step_ms(res['step_s'])}; {res['epochs']} epochs; valid "
          f"{res['valid']}; test (beam 10) WER {res['test']['WER']:.2f}")
    if (res["steps"] != RUNNER_SYNTH_STEPS or not np.isfinite(res["valid"]["loss"])
            or not np.isfinite(res["test"]["WER"])):
        fail(f"runner transducer train: {res['steps']} steps, valid {res['valid']}")
    no_launch("transducer train", counts)
    res, counts, secs, peak = run_stage("transducer train_lm", train_lm.main, [
        recipe, "--text", corpus["lm_text"], "--tokenizer-dir", run, "--output", lm_run,
        "--steps", str(RUNNER_LM_STEPS), "--model-type", "rnn"])
    print(f"runner transducer train_lm (RNNLM): {step_ms(res['step_s'])}; loss "
          f"{res['loss']:.4f}; {res['params']:,} parameters")
    if res["steps"] != RUNNER_LM_STEPS or not np.isfinite(res["loss"]):
        fail(f"runner transducer train_lm: {res['steps']} steps, loss {res['loss']}")
    stream = ["--chunk-size", str(RUNNER_STREAM_CHUNK), "--left-context",
              str(RUNNER_STREAM_LEFT)]
    for label, extra in (("greedy", []), ("beam", ["--beam"]),
                         ("beam + RNNLM", ["--beam", "--lm-ckpt", lm_run]),
                         ("streaming", ["--streaming"] + stream),
                         ("streaming-full", ["--streaming-full"] + stream)):
        out_dir = os.path.join(root, "eval_transducer_" + label.replace(" + ", "_"))
        summary, counts_e, secs, peak = run_stage(f"transducer evaluate {label}", evaluate.main, [
            recipe, "--test-manifest", corpus["test"], "--ckpt", os.path.join(run, "save"),
            "--avg", "2", "--output", out_dir] + extra)
        check_eval(f"transducer evaluate {label}", summary, n_test)
        if not os.path.exists(os.path.join(out_dir, "wer_details.txt")):
            fail(f"runner transducer evaluate {label}: no wer_details.txt")
        timing = {k: summary[k] for k in ("chunk_latency_ms_p50", "chunk_latency_ms_p90",
                                          "chunk_ms_mean") if k in summary}
        print(f"runner transducer evaluate {label}: WER {summary['WER']:.2f} over "
              f"{summary['utterances']} utterances, decode {summary['decode']}, "
              f"{secs * 1e3:.1f} ms {timing}")
        no_launch(f"transducer evaluate {label}", counts_e)
    if not plain_total.get("summary_mixing"):
        fail(f"runner transducer: no fast-mode cell counted on the plain path: {plain_total}")
    for name, n in plain_total.items():
        kernel_rows[name]["launches_by_path"]["runner_transducer"] = 0
        kernel_rows[name]["plain_calls_by_path"]["runner_transducer"] = n


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
    """Run one runner's `main(argv)` in this process with the wrappers'
    counters at 0 and the peak-memory counter reset; returns its result,
    the cell's and the cgMLP's (launches, plain calls, backwards) and the
    seconds and peak GiB it took. The runner's report must equal what every
    wrapper counted, RelPosMHAXL's too."""
    import torch

    from summarymixing_tpu_torch.ops import attention, fused_csgu, fused_summary

    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    relpos = attention.fused_relpos_attention
    for k in kernels + (relpos,):
        k.launches, k.plain_calls, k.backwards = 0, 0, 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: (k.launches, k.plain_calls, k.backwards)
              for name, k in zip(("summary_mixing", "csgu"), kernels)}
    counted = {name: c[:2] for name, c in counts.items()}
    counted["relpos_attention"] = (relpos.launches, relpos.plain_calls)
    reported = {name: (c["launches"], c["plain_calls"])
                for name, c in result.get("kernels", {}).items()}
    if reported and reported != counted:
        fail(f"runner {label} reported (launches, plain calls) {reported}, the wrappers "
             f"counted {counted}")
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


def encoder_frames(n_samples: int, hop: int = 160) -> int:
    """Encoder frames of `n_samples` samples: Fbank frames through the CNN's two stride-2 blocks."""
    frames = 1 + n_samples // hop
    for _ in range(2):
        frames = -(-frames // 2)
    return frames


def phase_serving_kernels(kernel_rows) -> None:
    """Phase 17: both kernels against their plain versions at the serving
    shapes (phase 3's tolerances), graph ms beside the bound and the plain
    version's ms."""
    import torch

    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    d, c2, k, bf = 512, 3072, 31, torch.bfloat16

    def w(*shape, scale=None, dtype=bf):
        s = scale if scale is not None else (shape[-1] if len(shape) > 1 else 512) ** -0.5
        return ((torch.rand(*shape, generator=g, device=dev) * 2 - 1) * s).to(dtype)

    merge = w(d, 2 * d)
    cell = (w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1),
            w(d, d), w(d, scale=0.1), merge[:, :d], merge[:, d:], w(d, scale=0.1))
    branch = (w(c2, d), w(c2, scale=0.1, dtype=torch.float32),
              1.0 + w(c2 // 2, scale=0.1, dtype=torch.float32),
              w(c2 // 2, scale=0.1, dtype=torch.float32),
              w(k, c2 // 2, scale=k ** -0.5, dtype=torch.float32),
              1.0 + w(c2 // 2, scale=0.1, dtype=torch.float32), w(d, c2 // 2),
              w(d, scale=0.1, dtype=torch.float32))
    for b, secs in SERVE_SHAPES:
        t = encoder_frames(int(secs * 16000))
        # ragged rows in the batch of 8: the server pads requests of 40-120 s to this bucket
        lens = torch.tensor([t] if b == 1 else [t, t, 2600, 2001, 1500, 1001, t, 2900],
                            device=dev)
        x = torch.randn(b, t, d, generator=g, device=dev).to(bf)
        mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(torch.float32)
        pad = mask[..., None].contiguous()
        m, valid = b * t, int(mask.sum())
        cases = (
            ("summary_mixing", CELL_TOL,
             lambda: fused_summary.fused_summary_mixing(x, pad, cell, "gelu"),
             lambda: fused_summary.summary_mixing_reference(x, pad, cell, "gelu"),
             bound(x.numel() * 2 + pad.numel() * 4 + m * d * 2
                   + sum(v.numel() * v.element_size() for v in cell),
                   2 * valid * d * d * 5 + 2 * b * d * d)),
            ("csgu", CSGU_TOL,
             lambda: fused_csgu.fused_convolution_branch(x, mask, branch),
             lambda: fused_csgu.convolution_branch_reference(x, mask, branch),
             bound(x.numel() * 2 + mask.numel() * 4 + m * d * 2
                   + sum(v.numel() * v.element_size() for v in branch),
                   2 * m * d * c2 + 2 * m * (c2 // 2) * d, 2 * m * (c2 // 2) * k)))
        for name, tol, kernel, plain, (bound_ms, by) in cases:
            abs_err, err = rel_err(kernel(), plain())
            ok = err <= tol
            ms, plain_ms = graph_ms(kernel), cuda_ms(plain)
            print(f"serving shape {name} B={b} T={t} ({secs:g} s, {valid} valid frames): "
                  f"max_abs_err {abs_err:.3e} max_rel_err {err:.3e} tol {tol:.3e} "
                  f"{'ok' if ok else 'FAILED'}; {ms:.4f} ms (graph), plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({by}), {100 * bound_ms / ms:.1f}% of bound")
            if not ok:
                fail(f"{name} disagrees with its plain version at B={b}, T={t}")
            kernel_rows[name].setdefault("serving_shapes", []).append(dict(
                batch=b, frames=t, seconds=secs, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by))
        del x, mask, pad
    torch.cuda.empty_cache()


def zero_counts() -> tuple:
    """Both wrappers with their launch, plain-call and backward counters at 0."""
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    for fn in kernels:
        fn.launches, fn.plain_calls, fn.backwards = 0, 0, 0
    return kernels


def read_counts(kernels) -> dict:
    return {name: (fn.launches, fn.plain_calls)
            for name, fn in zip(("summary_mixing", "csgu"), kernels)}


def wav_bytes(audio: np.ndarray, sample_rate: int = 16000) -> bytes:
    import io
    import wave

    pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()


class HttpServer:
    """A handler on a ThreadingHTTPServer at a free port, served from a thread."""

    def __init__(self, handler):
        import threading
        from http.server import ThreadingHTTPServer

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def request(self, path: str, data: bytes = None) -> tuple:
        """(HTTP status, JSON reply)."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + path, data=data,
                                     method="GET" if data is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)


def flagship_run(here: str, root: str) -> tuple:
    """Phase 13's run: (recipe path, save directory, --set overrides, config)."""
    from summarymixing_tpu_torch.config import load_recipe
    from summarymixing_tpu_torch.recipes import common

    sets = [f"training.max_batch_length={RUNNER_FLAGSHIP_BATCH_S}",
            f"training.num_buckets={RUNNER_FLAGSHIP_BUCKETS}"]
    recipe = os.path.join(here, FLAGSHIP_RECIPE)
    cfg = load_recipe(recipe, overrides=common.parse_overrides(sets))
    return recipe, os.path.join(root, "flagship", "save"), \
        [a for s in sets for a in ("--set", s)], cfg


def phase_serve(kernel_rows, here: str, root: str) -> None:
    """Phase 18: phase 13's flagship run behind `recipes.serve`'s CTC handler
    in this process (dynamic batches of 8, warmed up at every bucket edge),
    then the transcribe runner at --batch-size 1."""
    import threading

    import torch

    from summarymixing_tpu_torch.data.dataio import load_audio_bytes
    from summarymixing_tpu_torch.data.flac import encode_flac
    from summarymixing_tpu_torch.recipes import serve, transcribe
    from summarymixing_tpu_torch.serving import DynamicBatchingServer, ServingConfig

    recipe, save, sets, cfg = flagship_run(here, root)
    sr = cfg.features.sample_rate
    dev = torch.device("cuda")
    infer, _ = serve.build_infer(cfg, save, 0, dev)
    scfg = ServingConfig(batch_size=BATCH, max_wait_ms=20.0, sample_rate=sr)
    t0 = time.perf_counter()
    with torch.inference_mode():
        serve.warmup(infer, scfg)
    torch.cuda.synchronize()
    print(f"serve: warm-up of {len(scfg.bucket_edges_s)} batches of {BATCH} (bucket edges "
          f"{list(scfg.bucket_edges_s)} s) in {time.perf_counter() - t0:.1f} s")
    batches = []   # (wav, lens, texts) of every batch the worker formed

    def recording(wav, lens):
        texts = infer(wav, lens)
        batches.append((wav, lens, texts))
        return texts

    wavs = synthetic_waveforms(SERVE_SEQUENTIAL + SERVE_CONCURRENT, seed=23)
    rng = np.random.default_rng(29)
    long = rng.standard_normal(int(SERVE_LONG_S * sr)).astype(np.float32) * 0.05
    long += 0.1 * np.sin(2 * np.pi * 440.0 * np.arange(len(long)) / sr).astype(np.float32)
    twin = wavs[SERVE_SEQUENTIAL]   # the FLAC body's WAV twin, one of the concurrent requests
    twin_pcm = np.clip(np.round(twin * 32768.0), -32768, 32767).astype(np.int64)
    flac_body = encode_flac(twin_pcm, sr)
    t0 = time.perf_counter()
    flac_audio = load_audio_bytes(flac_body, sr)
    flac_s = time.perf_counter() - t0
    if not np.array_equal(flac_audio, load_audio_bytes(wav_bytes(twin), sr)):
        fail("serve: the FLAC body's samples differ from its WAV twin's")
    print(f"serve: FLAC body of {len(twin) / sr:.2f} s ({len(flac_body) / 1e6:.2f} MB) decoded "
          f"in {flac_s:.3f} s on the host (the native loader), samples equal to its WAV "
          "twin's bit for bit")

    kernels = zero_counts()
    torch.cuda.reset_peak_memory_stats()
    server = DynamicBatchingServer(recording, scfg, device=dev)
    http = HttpServer(serve.make_handler(server, sr))
    try:
        if http.request("/healthz") != (200, {"ok": True}):
            fail("serve: /healthz did not answer ok")
        sequential = []
        for i in range(SERVE_SEQUENTIAL):
            code, reply = http.request("/transcribe", wav_bytes(wavs[i]))
            if code != 200:
                fail(f"serve: sequential request {i} got HTTP {code}: {reply}")
            sequential.append((reply["text"], batches[-1]))
        bodies = ([wav_bytes(a) for a in wavs[SERVE_SEQUENTIAL:]]
                  + [wav_bytes(long), flac_body])
        replies, lat = [None] * len(bodies), [0.0] * len(bodies)

        def client(i):
            t = time.perf_counter()
            replies[i] = http.request("/transcribe", bodies[i])
            lat[i] = time.perf_counter() - t

        n_before = len(batches)
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=HTTP_TIMEOUT)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or any(r is None or r[0] != 200 for r in replies):
            fail(f"serve: concurrent requests failed: {[r for r in replies if r and r[0] != 200]}")
        code, reply = http.request("/transcribe", b"RIFF\x10\x00\x00\x00WAVEjunk")
        if code != 400:
            fail(f"serve: a malformed body got HTTP {code}, not 400")
        stats = http.request("/stats")[1]
    finally:
        http.close()
        server.close()
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    n_batches = len(batches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if replies[-1][1]["text"] != replies[0][1]["text"]:
        fail(f"serve: the FLAC body's text {replies[-1][1]['text']!r} differs from its WAV "
             f"twin's {replies[0][1]['text']!r}")
    conc_batches = n_batches - n_before
    audio_s = (sum(len(a) for a in wavs[SERVE_SEQUENTIAL:]) + len(long) + len(twin)) / sr
    ms = sorted(1e3 * v for v in lat)
    print(f"serve: {len(bodies)} concurrent requests ({SERVE_CONCURRENT} of 5-30 s from "
          f"{SERVE_CONCURRENT} threads, one of {SERVE_LONG_S:g} s, one FLAC body) in "
          f"{wall:.2f} s: p50 {ms[len(ms) // 2]:.1f} ms, p95 {ms[int(len(ms) * 0.95)]:.1f} ms, "
          f"{conc_batches} batches (mean batch {len(bodies) / conc_batches:.2f}), "
          f"{audio_s:.1f} audio-s, {audio_s / wall:.1f} audio-s/s; server stats {stats}; peak "
          f"memory {peak:.2f} GiB")
    want = {name: (cfg.model.num_encoder_layers * n_batches, 0) for name in counts}
    print(f"serve: {n_batches} batches, (launches, plain calls) {counts}")
    if counts != want:
        fail(f"serve: (launches, plain calls) {counts}, expected {want}")
    # held after the counts are read: each sequential reply against `infer`
    # called directly on the batch the server formed for it
    with torch.inference_mode():
        for i, (text, (wav, lens, _)) in enumerate(sequential):
            direct = infer(wav, lens)[0]
            if direct != text:
                fail(f"serve: sequential reply {i} {text!r} != infer on its batch {direct!r}")
    print(f"serve: {SERVE_SEQUENTIAL} sequential replies equal infer on the batches the server "
          "formed; the FLAC body's text equals its WAV twin's; malformed body HTTP 400")
    for name, c in counts.items():
        kernel_rows[name]["launches_by_path"]["serve"] = c[0]
        kernel_rows[name]["plain_calls_by_path"]["serve"] = c[1]

    files = []
    for i, audio in enumerate(wavs[:3]):
        files.append(os.path.join(root, f"transcribe_{i}.wav"))
        with open(files[-1], "wb") as f:
            f.write(wav_bytes(audio))
    files.append(os.path.join(root, "transcribe_twin.flac"))
    with open(files[-1], "wb") as f:
        f.write(flac_body)
    files.append(os.path.join(root, "transcribe_twin.wav"))
    with open(files[-1], "wb") as f:
        f.write(wav_bytes(twin))
    out = os.path.join(root, "transcribe.jsonl")
    res, counts_t, secs, peak = run_stage("transcribe --batch-size 1", transcribe.main, [
        recipe, *files, "--ckpt", save, "--batch-size", "1", "--output", out] + sets)
    texts = [json.loads(line)["text"] for line in open(out)]
    if len(texts) != len(files) or texts[-1] != texts[-2]:
        fail(f"transcribe: {len(texts)} lines for {len(files)} files, or the FLAC file's text "
             "differs from its WAV twin's")
    want = {name: (cfg.model.num_encoder_layers * len(files), 0, 0) for name in counts_t}
    if counts_t != want:
        fail(f"transcribe: (launches, plain calls, backwards) {counts_t}, expected {want}")
    audio_s = (sum(len(a) for a in wavs[:3]) + 2 * len(twin)) / sr
    print(f"transcribe --batch-size 1: {len(files)} files ({audio_s:.1f} audio-s) in "
          f"{secs:.2f} s, the FLAC file's text equal to its WAV twin's")
    for name, c in counts_t.items():
        kernel_rows[name]["launches_by_path"]["transcribe"] = c[0]
        kernel_rows[name]["plain_calls_by_path"]["transcribe"] = c[1]


class TokenIds:
    """Writes token ids as text: the transducer phases have no tokenizer."""

    @staticmethod
    def decode(ids):
        return " ".join(str(int(i)) for i in ids)


def stream_sessions(wav, lens, sr: int) -> list:
    """STREAM_SESSIONS pieces of request 0's audio, 4-8 s each, from its 8 utterances."""
    rng = np.random.default_rng(37)
    out = []
    for i in range(STREAM_SESSIONS):
        row = i % wav.shape[0]
        n = int(rng.uniform(4.0, 8.0) * sr)
        start = int(rng.integers(0, max(int(lens[row]) - n, 1)))
        out.append(wav[row, start:start + n].cpu().numpy())
    return out


def phase_streaming(kernel_rows) -> tuple:
    """Phase 19: the full-width transducer (phase 10's build, seed 3407) in
    float32 behind `serving.StreamingSessionServer` with 8 slots: 12
    staggered sessions from threads (slots reused), one of them over the
    HTTP session endpoints; each session's tokens against `run_stream` on
    its audio alone. The same sessions in bf16 are reported. Returns what
    phase 20 exports."""
    import threading

    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype
    from summarymixing_tpu_torch.recipes import serve
    from summarymixing_tpu_torch.serving import StreamingSessionServer
    from summarymixing_tpu_torch.streaming import make_streaming_infer_fns, run_stream

    cfg = transducer_config()
    sr = cfg.features.sample_rate
    model, fbank, td = build_model(cfg)
    stats = seeded_norm_stats()
    wav, lens = request0(sr)
    sessions = stream_sessions(wav, lens, sr)
    init_fn, step_fn, info = make_streaming_infer_fns(
        model, td, fbank, InputNormalization(), stats, chunk_frames=STREAM_CHUNK,
        left_context_chunks=STREAM_LEFT, blank_id=cfg.model.blank_index)
    cs = info["chunk_samples"]
    tick_s = []

    def timed_step(carry, chunk, n_valid):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(carry, chunk, n_valid)
        torch.cuda.synchronize()
        tick_s.append(time.perf_counter() - t)
        return out

    def alone(audio):
        toks, n = run_stream(init_fn, step_fn, torch.from_numpy(audio[None]).cuda(),
                             torch.tensor([len(audio)], device="cuda"), cs)
        return toks[0, :int(n[0])].tolist()

    def run_sessions(label):
        got, errors = [None] * len(sessions), []
        server = StreamingSessionServer(init_fn, timed_step, cs, slots=STREAM_SLOTS,
                                        max_wait_ms=10.0)
        http = HttpServer(serve.make_streaming_handler(server, TokenIds(), sr))

        def open_slot():
            deadline = time.monotonic() + HTTP_TIMEOUT
            while True:
                try:
                    return server.open()
                except RuntimeError:   # every slot busy: wait for a stream to end
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)

        def client(i):
            try:
                time.sleep(0.15 * i)   # staggered starts
                audio = sessions[i]
                if i == len(sessions) - 1:   # this one over HTTP, raw float32 chunks
                    deadline = time.monotonic() + HTTP_TIMEOUT
                    code, r = http.request("/stream/start", b"")
                    while code == 400 and "busy" in r["error"] and time.monotonic() < deadline:
                        time.sleep(0.05)
                        code, r = http.request("/stream/start", b"")
                    sid = r["id"]
                    for s in range(0, len(audio), cs):
                        code, r = http.request(f"/stream/{sid}", audio[s:s + cs].tobytes())
                        if code != 200:
                            raise RuntimeError(f"HTTP {code}: {r}")
                    code, r = http.request(f"/stream/{sid}/end", b"")
                    got[i] = [int(t) for t in r["text"].split()]
                    return
                sid = open_slot()
                toks, piece = [], cs // 2 + 123   # feeds that do not align with chunks
                for s in range(0, len(audio), piece):
                    toks += server.feed(sid, audio[s:s + piece], timeout=HTTP_TIMEOUT)
                got[i] = toks + server.close(sid, timeout=HTTP_TIMEOUT)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"session {i}: {e!r}")

        tick_s.clear()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(sessions))]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=HTTP_TIMEOUT)
        wall = time.perf_counter() - t0
        stats_ = server.stats()
        http.close()
        server.shutdown()
        if errors or any(th.is_alive() for th in threads):
            fail(f"streaming ({label}): {errors or 'a session did not finish'}")
        ms = sorted(1e3 * t for t in tick_s)
        same = sum(a == alone(s) for a, s in zip(got, sessions))
        print(f"streaming ({label}): {len(sessions)} sessions over {STREAM_SLOTS} slots in "
              f"{wall:.2f} s, {stats_['ticks']} ticks (mean {stats_['mean_ready_per_tick']} "
              f"streams a tick), median {ms[len(ms) // 2]:.2f} ms, max {ms[-1]:.2f} ms per tick "
              f"(chunks of {STREAM_CHUNK} frames = {1e3 * cs / sr:.0f} ms of audio); sessions "
              f"equal to run_stream alone {same}/{len(sessions)}")
        return same, got

    kernels = zero_counts()
    set_compute_dtype(model, None)
    same, got = run_sessions("float32, TF32 off")
    counts = read_counts(kernels)
    if same != len(sessions) or not any(got):
        fail(f"streaming: {same}/{len(sessions)} sessions equal run_stream alone in float32")
    set_compute_dtype(model, torch.bfloat16)
    run_sessions("bf16 encoder, reported, not held")
    set_compute_dtype(model, None)
    if any(c[0] for c in counts.values()):
        fail(f"streaming: a hand-written kernel was launched: {counts}")
    for name, c in counts.items():
        kernel_rows[name]["launches_by_path"]["serve_streaming"] = c[0]
        kernel_rows[name]["plain_calls_by_path"]["serve_streaming"] = c[1]
    return model, fbank, td, stats, wav, lens


ARTIFACT_CHECK = """
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
from summarymixing_tpu_torch.utils.export import ExportedASR
t0 = time.perf_counter()
asr = ExportedASR.load(sys.argv[2])
load_s = time.perf_counter() - t0
ref = torch.load(sys.argv[3])
kernels = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
out = {"load_s": load_s, "equal": [], "launches": [], "plain_calls": []}
for wav, lens, want in ref["cases"]:
    before = [k.launches for k in kernels]
    got = asr(wav, lens)
    torch.cuda.synchronize()
    out["launches"].append([k.launches - b for k, b in zip(kernels, before)])
    out["equal"].append([bool(torch.equal(g.cpu(), w)) for g, w in zip(got, want)])
out["plain_calls"] = [k.plain_calls for k in kernels]
wav, lens, _ = ref["cases"][-1]
ms = []
for _ in range(4):
    torch.cuda.synchronize()
    t = time.perf_counter()
    asr(wav, lens)
    torch.cuda.synchronize()
    ms.append(1e3 * (time.perf_counter() - t))
out["ms"] = sorted(ms[1:])[1]
print(json.dumps(out))
"""


def phase_export(kernel_rows, here: str, root: str, streaming) -> None:
    """Phase 20: `export_model --check` on phase 13's run (polymorphic, on
    the card); the artifact loaded in a fresh process that imports only
    the port, bit-equal to the live inference function at (B=3, 2 s) and
    (B=8, 30 s = request 0), launching 18 of each kernel per forward; and
    the streaming artifact of phase 19's transducer against `run_stream`."""
    import torch

    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.recipes import common, export_model
    from summarymixing_tpu_torch.streaming import make_streaming_infer_fns, run_stream
    from summarymixing_tpu_torch.utils.export import (
        ExportedStreamingASR,
        decode_token_rows,
        export_streaming,
        make_ctc_infer_fn,
        save_artifact,
    )

    recipe, save, sets, cfg = flagship_run(here, root)
    sr, n_layers = cfg.features.sample_rate, cfg.model.num_encoder_layers
    art = os.path.join(root, "flagship.smt")
    res, counts, secs, peak = run_stage("export_model --check", export_model.main, [
        recipe, "--ckpt", save, "--output", art, "--check"] + sets)
    # --check runs the artifact and the live model once each
    if not res.get("check") or counts != {name: (2 * n_layers, 0, 0) for name in counts}:
        fail(f"export: check {res.get('check')}, (launches, plain calls, backwards) {counts}")
    print(f"export: polymorphic CTC artifact of {res['mb']:.1f} MB exported on the card in "
          f"{res['export_s']:.1f} s, checked against the live model at (3, 2 s)")

    model, fbank, _, stats = common.restore_inference(cfg, save, 0, torch.device("cuda"))
    infer = make_ctc_infer_fn(model, fbank, InputNormalization(), stats, cfg.model.blank_index)
    rng = np.random.default_rng(43)
    wav0, lens0 = request0(sr)
    cases = []
    for b, secs in EXPORT_SHAPES:
        if (b, secs) == (BATCH, 30.0):
            wav, lens = wav0, lens0
        else:
            n = int(secs * sr)
            wav = torch.from_numpy((rng.standard_normal((b, n)) * 0.1).astype(np.float32)).cuda()
            lens = torch.tensor([n] * (b - 1) + [n - 5000], dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            want = infer(wav, lens.to(torch.int32))
        cases.append((wav.cpu(), lens.to(torch.int32).cpu(), [w.cpu() for w in want]))
    live_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.inference_mode():
            infer(wav0, lens0.to(torch.int32))
        torch.cuda.synchronize()
        live_ms.append(1e3 * (time.perf_counter() - t))
    ref = os.path.join(root, "export_ref.pt")
    torch.save({"cases": cases}, ref)
    del model, fbank, infer
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-c", ARTIFACT_CHECK, here, art, ref],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"export: the loading process failed: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"export: loaded in a fresh process in {out['load_s']:.1f} s; outputs equal per case "
          f"{out['equal']}; launches per forward {out['launches']}; plain calls "
          f"{out['plain_calls']}; request 0 (8 x 30 s): artifact {out['ms']:.1f} ms, live model "
          f"{sorted(live_ms[1:])[1]:.1f} ms (median of 3 after one warm-up)")
    if not all(all(e) for e in out["equal"]):
        fail("export: the loaded artifact's outputs differ from the live model's")
    if any(n != [n_layers, n_layers] for n in out["launches"]) or any(out["plain_calls"]):
        fail(f"export: the artifact launched {out['launches']} per forward, plain calls "
             f"{out['plain_calls']}; expected {n_layers} of each kernel and none")
    for i, name in enumerate(("summary_mixing", "csgu")):
        kernel_rows[name]["launches_by_path"]["export"] = (
            counts[name][0] + sum(n[i] for n in out["launches"]))
        kernel_rows[name]["plain_calls_by_path"]["export"] = out["plain_calls"][i]

    # chunks of 8 frames (the runners' streaming chunk): the step's greedy
    # loop unrolls 3 emit steps per frame into the graph, so the export's
    # tracing time grows with the chunk
    model, fbank, td, stats, wav, lens = streaming
    init_fn, step_fn, info = make_streaming_infer_fns(
        model, td, fbank, InputNormalization(), stats, chunk_frames=RUNNER_STREAM_CHUNK,
        left_context_chunks=RUNNER_STREAM_LEFT)
    t0 = time.perf_counter()
    payloads = export_streaming(init_fn, step_fn, info["chunk_samples"], model, td, fbank)
    export_s = time.perf_counter() - t0
    path = os.path.join(root, "transducer_stream.smt")
    meta = {"family": "transducer_streaming", "token_type": "ids", "vocab": None,
            "device": "cuda", **info}
    save_artifact(path, payloads, meta)
    t0 = time.perf_counter()
    stream_art = ExportedStreamingASR.load(path)
    load_s = time.perf_counter() - t0
    n = 6 * sr   # two rows of request 0, the first 6 s
    w2 = wav[:2, :n].cpu().numpy()
    l2 = np.minimum(lens[:2].cpu().numpy(), n)
    got = stream_art.transcribe(w2, l2)
    toks, tl = run_stream(init_fn, step_fn, torch.from_numpy(w2).cuda(),
                          torch.from_numpy(l2).cuda(), info["chunk_samples"])
    want = decode_token_rows(meta, [toks[i, :int(tl[i])].tolist() for i in range(2)])
    mb = sum(len(v) for v in payloads.values()) / 1e6
    print(f"export: streaming artifact of the float32 transducer (chunks of "
          f"{RUNNER_STREAM_CHUNK} frames, {mb:.1f} MB) exported in "
          f"{export_s:.1f} s, loaded in {load_s:.1f} s; its transcribe equals run_stream with the "
          f"live functions on 2 x 6 s: {got == want}")
    if got != want:
        fail("export: the streaming artifact disagrees with run_stream on the live functions")


def summary_decoder_train_step(cfg, model, fbank) -> tuple:
    """Phase 21 (a)'s training step of the Summary Decoder recipe (after a
    warm-up step): its time, loss and peak memory; each kernel launched
    and differentiated once per encoder layer, the decoder's causal cells
    on the counted plain path. Returns the launches and plain calls by
    kernel."""
    import torch

    from summarymixing_tpu_torch.config import build_trainer

    m = cfg.model
    n_params = sum(p.numel() for p in model.parameters())
    trainer = build_trainer(cfg, model, fbank)
    state = trainer.init_state(cfg.seed)
    batch = training_batch()
    state, metrics = trainer.train_step(state, batch)        # warm-up
    kernels = zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = [(k.launches, k.backwards, k.plain_calls) for k in kernels]
    loss = float(metrics["loss"])
    print(f"summary decoder train: {SD_RECIPE}, {n_params:,} float32 parameters, "
          f"{m.num_decoder_layers} Summary Decoder layers; one step at B={TRAIN_BATCH}, "
          f"T=751 (bf16, dropout {m.transformer_dropout}, augmentation on): {dt * 1e3:.2f} ms, "
          f"loss {loss:.4f} (ctc {float(metrics['ctc']):.4f}, att {float(metrics['att']):.4f}), "
          f"grad norm {float(metrics['grad_norm']):.4f}, peak memory {peak:.2f} GiB; "
          f"(launches, backwards, plain calls) summary_mixing {counts[0]} csgu {counts[1]}")
    n_layers = m.num_encoder_layers
    if not np.isfinite(loss) or metrics["nonfinite_skipped"]:
        fail(f"summary decoder train: loss {loss}, skipped {metrics['nonfinite_skipped']}")
    if counts != [(n_layers, n_layers, m.num_decoder_layers), (n_layers, n_layers, 0)]:
        fail(f"summary decoder train: counts {counts}, expected {n_layers} launches and "
             f"backwards of each kernel and {m.num_decoder_layers} plain calls of the cell "
             "(the decoder's causal cells)")
    del trainer, state, metrics
    torch.cuda.empty_cache()
    return ({"summary_mixing": counts[0][0], "csgu": counts[1][0]},
            {"summary_mixing": counts[0][2], "csgu": counts[1][2]})


def phase_summary_decoder(kernel_rows, here: str, mode: Optional[str] = None) -> None:
    """Phase 21 (a): the Summary Decoder recipe at full width (18-layer
    Branchformer, 6-layer Summary Decoder), random weights from its seed:
    one training step at B=16, T=751 (bf16, dropout, speed perturbation and
    SpecAugment), the joint CTC/attention beam search at beam 66 on request
    0 with the Transformer LM at `LMConfig()`, and the cached step against
    the whole-prefix decode in float32 on every row of a short prefix.
    Phase 23 (c), with `mode`: the recipe with `model.mode` set, every cell
    in that mode (the encoder's on the cell's counted plain path), the beam
    and the cached-step check without the training step."""
    import torch

    from summarymixing_tpu_torch.config import LMConfig, build_lm, build_model
    from summarymixing_tpu_torch.config import load_recipe
    from summarymixing_tpu_torch.decoding.s2s_beam import tile_for_beam
    from summarymixing_tpu_torch.evaluate import evaluate_beam
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype
    from summarymixing_tpu_torch.ops.masks import length_to_mask
    from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing
    from summarymixing_tpu_torch.transcribe import batch_waveforms

    cfg = load_recipe(os.path.join(here, SD_RECIPE))
    m, dec = cfg.model, cfg.decoding
    m.mode = mode or m.mode
    path = "summary_decoder" if mode is None else f"summary_decoder_{mode.split('-')[1]}"
    torch.cuda.reset_peak_memory_stats()
    model, fbank = build_model(cfg)
    dev = next(model.parameters()).device
    cells = [layer.self_attn for layer in model.asr.decoder.layers()]
    if len(cells) != m.num_decoder_layers or not all(isinstance(c, SummaryMixing)
                                                     and c.mode == m.mode for c in cells):
        fail(f"{path}: the decoder's self-attention is not SummaryMixing in {m.mode} mode")
    n_layers = m.num_encoder_layers
    if mode is None:
        launches, plain = summary_decoder_train_step(cfg, model, fbank)
    else:
        launches = plain = {"summary_mixing": 0, "csgu": 0}
        print(f"{path}: {SD_RECIPE} with model.mode={mode}")
    # the beam test stage on request 0 with the LM at LMConfig()
    model.eval()
    lm = build_lm(LMConfig(), m.output_neurons, seed=cfg.seed)
    norm_stats = seeded_norm_stats()
    wavs = synthetic_waveforms(N_REQUESTS * BATCH, seed=11)
    idx, wav, wav_lens = next(iter(batch_waveforms(wavs, BATCH,
                                                   pad_quantum=cfg.features.sample_rate // 2,
                                                   device=dev)))
    audio_s = sum(len(wavs[i]) / cfg.features.sample_rate for i in idx)
    kernels = zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = evaluate_beam(model, fbank, norm_stats, [(idx, wav, wav_lens)], cfg, lm=lm)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rose = [(k.launches, k.plain_calls) for k in kernels]
    step_ms_ = out["search_s"] * 1e3 / max(out["steps"], 1)
    print(f"{path} beam: request 0 ({BATCH} utterances, {audio_s:.2f} audio-s), beam "
          f"{dec.test_beam_size} ({BATCH * dec.test_beam_size} rows), LM at LMConfig() fused at "
          f"{dec.lm_weight}, temperatures {dec.test_temperature}/{dec.lm_temperature}: latency "
          f"{latency * 1e3:.1f} ms, {out['steps']} steps, {step_ms_:.2f} ms per step, encoder "
          f"{out['encode_s'] * 1e3:.1f} ms, search {out['search_s'] * 1e3:.1f} ms, peak memory "
          f"{peak:.2f} GiB; (launches, plain calls) summary_mixing {rose[0]} csgu {rose[1]}; "
          f"beside it, the MHA decoder's beam step on this request (PERF.md): "
          f"{MHA_BEAM_STEP_MS[0]}-{MHA_BEAM_STEP_MS[1]} ms, of which the cache gather "
          f"{MHA_GATHER_MS} ms (not compared)")
    # the encoder's cells launch the kernel in full mode, and take the
    # counted plain path in any other
    full = m.mode == "SummaryMixing"
    want = [(n_layers, 0) if full else (0, n_layers), (n_layers, 0)]
    if rose != want:
        fail(f"{path} beam: (launches, plain calls) {rose}, expected {want}")
    if not all(np.isfinite(out["scores"][i]) for i in idx):
        fail(f"{path} beam: a non-finite score")
    for name, (n, p) in zip(("summary_mixing", "csgu"), rose):
        kernel_rows[name]["launches_by_path"][path] = launches[name] + n
        kernel_rows[name]["plain_calls_by_path"][path] = plain[name] + p

    # the cached step against the whole-prefix decode, float32, every row
    with torch.inference_mode():
        feats, _ = InputNormalization()(fbank(wav), norm_stats)
        enc, enc_lens = model.encode(feats, fbank.frame_lengths(wav_lens))
        enc = enc.float()
        set_compute_dtype(model, None)
        beam = dec.test_beam_size
        n_rows = BATCH * beam
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        toks = torch.randint(3, m.output_neurons, (n_rows, SD_CHECK_POSITIONS), generator=g,
                             device=dev)
        toks[:, 0] = m.bos_index
        whole = model.asr.decode_prefix(toks, tile_for_beam(enc, beam),
                                        tile_for_beam(enc_lens, beam))
        cache = model.asr.decode_cache_init(enc, SD_CHECK_POSITIONS, n_rows)
        pad = length_to_mask(enc_lens, enc.shape[1])
        err = 0.0
        for pos in range(SD_CHECK_POSITIONS):
            h, cache = model.asr.decode_step_cached(toks[:, pos], pos, cache, pad)
            ref = whole[:, pos]
            err = max(err, float(((h - ref).abs() / (1 + ref.abs())).max()))
        set_compute_dtype(model, torch.bfloat16)
    ok = err <= SD_STEP_TOL
    print(f"{path} check: cached step ((sum, denom) carry) vs whole-prefix decode over "
          f"{n_rows} rows x {SD_CHECK_POSITIONS} positions (float32, TF32 off): max "
          f"|dh|/(1+|h|) {err:.3e} (tol {SD_STEP_TOL:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail(f"{path}: the cached step disagrees with the whole-prefix decode")


def phase_runner_aishell(kernel_rows, here: str, corpus: dict, root: str) -> None:
    """Phase 21 (b): recipes/AISHELL-1/branchformer_summarymixing.yaml at
    full width (two-stage Adam -> SGD, concat_original) through the train
    runner on phase 12's corpus, with one Adam epoch: a `--max-hours 0`
    run checkpoints after one step and stops; the same command without it
    resumes there and runs past the switch. The kernels launch at twice
    each training batch's rows."""
    import torch

    from summarymixing_tpu_torch.config import load_recipe
    from summarymixing_tpu_torch.data.dataio import read_manifest_csv
    from summarymixing_tpu_torch.ops import fused_summary
    from summarymixing_tpu_torch.recipes import common, train

    recipe = os.path.join(here, AISHELL_RECIPE)
    run = os.path.join(root, "aishell")
    sets = [f"training.max_batch_length={AISHELL_BATCH_S}", "training.stage_one_epochs=1",
            f"training.num_buckets={AISHELL_BUCKETS}"]
    cfg = load_recipe(recipe, overrides=common.parse_overrides(sets))
    switch = common.estimate_steps_per_epoch(read_manifest_csv(corpus["train"]), cfg)
    argv = [recipe, "--train-manifest", corpus["train"], "--valid-manifest", corpus["dev"],
            "--output", run] + [a for s_ in sets for a in ("--set", s_)]
    n_layers = cfg.model.num_encoder_layers
    batch_rows, kernel_rows_seen = [], []
    batches, cell = common.batches, fused_summary.kernel_call

    def counted_batches(manifest, tokenizer, cfg_, shuffle, seed, device):
        for batch, idx in batches(manifest, tokenizer, cfg_, shuffle, seed, device):
            if shuffle:
                batch_rows.append(int(batch["wav"].shape[0]))
            yield batch, idx

    def counted_cell(x, *args, **kw):
        if torch.is_grad_enabled():
            kernel_rows_seen.append(int(x.shape[0]))
        return cell(x, *args, **kw)

    # the training batches' rows, and the rows of each cell launch autograd
    # records (the training forwards; validation runs without autograd)
    common.batches, fused_summary.kernel_call = counted_batches, counted_cell
    try:
        first, counts1, secs1, _ = run_stage("aishell train --max-hours 0", train.main,
                                             argv + ["--max-hours", "0"])
        second, counts2, secs2, peak = run_stage("aishell train (resumed)", train.main,
                                                 argv + ["--steps", str(switch + 2)])
    finally:
        common.batches, fused_summary.kernel_call = batches, cell
    stages = first["opt_stages"] + second["opt_stages"]
    print(f"runner aishell: {AISHELL_RECIPE} (two_stage, stage_one_epochs 1 = {switch} steps "
          f"at {AISHELL_BATCH_S:.0f} s batches; concat_original): the first call stopped "
          f"({first.get('stopped')}) after {first['steps']} step in {secs1:.1f} s; the second "
          f"resumed and ran to step {second['steps']} in {secs2:.1f} s, {step_ms(second['step_s'])}"
          f", peak memory {peak:.2f} GiB; optimizer stage per step {stages}; training batch "
          f"rows {batch_rows}, kernel rows with autograd {sorted(set(kernel_rows_seen))}")
    want_stages = ["adam"] * switch + ["sgd"] * 2
    if first.get("stopped") != "WALLCLOCK" or first["steps"] != 1:
        fail(f"runner aishell: --max-hours 0 gave {first.get('stopped')} at step "
             f"{first['steps']}, expected a WALLCLOCK stop after step 1")
    if second["steps"] != switch + 2 or stages != want_stages:
        fail(f"runner aishell: steps {second['steps']}, stages {stages}, expected "
             f"{want_stages}")
    # the batch iterator runs ahead of the steps (prefetch), so some batches
    # it made were not trained on: every launch's rows must be twice some
    # batch's rows
    doubled = sorted({2 * b for b in batch_rows})
    if not kernel_rows_seen or not set(kernel_rows_seen) <= set(doubled):
        fail(f"runner aishell: the cell kernel ran at {sorted(set(kernel_rows_seen))} rows in "
             f"training, expected twice a batch's rows, one of {doubled} (concat_original)")
    for name in counts1:
        launched = counts1[name][0] + counts2[name][0]
        backwards = counts1[name][2] + counts2[name][2]
        if counts1[name][1] or counts2[name][1] or backwards != n_layers * (switch + 2):
            fail(f"runner aishell: {name} (launches, plain calls, backwards) {counts1[name]} "
                 f"then {counts2[name]}, expected no plain call and "
                 f"{n_layers * (switch + 2)} backwards")
        kernel_rows[name]["launches_by_path"]["runner_aishell"] = launched
        kernel_rows[name]["plain_calls_by_path"]["runner_aishell"] = 0


def phase_remat(kernel_rows) -> None:
    """Phase 21 (c): one flagship training step (with its 6-layer decoder,
    bf16, dropout; augmentation off so both steps see the same features)
    with `model.remat` against the same step without it: the same dropout
    masks from one seed; loss and gradient norm within REMAT_TOL; lower
    peak memory with remat."""
    import dataclasses

    import torch

    from summarymixing_tpu_torch.config import build_model, build_trainer
    from summarymixing_tpu_torch.ops.layers import set_dropout_generator

    cfg = flagship_config(decoder_layers=6)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True))
    model, fbank = build_model(cfg)
    if not model.asr.encoder.remat:
        fail("remat: model.remat did not reach the encoder")
    trainer = build_trainer(cfg, model, fbank)
    trainer.config = dataclasses.replace(trainer.config, augment=None, speed_perturb=False)
    state = trainer.init_state(cfg.seed)
    batch = training_batch()
    n_layers = cfg.model.num_encoder_layers

    def one_step(remat: bool):
        model.asr.encoder.remat = remat
        gen = torch.Generator(device=next(model.parameters()).device)
        gen.manual_seed(99)
        set_dropout_generator(model, gen)
        for p in model.parameters():
            p.grad = None
        kernels = zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = trainer._forward_loss(state["norm_stats"], batch, True, 0, gen)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        norm = float(torch.linalg.vector_norm(torch.stack(
            [p.grad.float().norm() for p in model.parameters()])))
        return (float(loss.detach()), norm, peak, ms, [(k.launches, k.backwards) for k in kernels],
                [p.grad.clone() for p in model.parameters()])

    one_step(False)                                   # warm-up
    plain = one_step(False)
    remat = one_step(True)
    rel_loss = abs(remat[0] - plain[0]) / abs(plain[0])
    rel_norm = abs(remat[1] - plain[1]) / plain[1]
    worst = max(float((a - b).norm() / max(float(b.norm()), 1e-30))
                for a, b in zip(remat[5], plain[5]) if float(b.norm()) > 1e-6 * plain[1])
    ok = rel_loss <= REMAT_TOL and rel_norm <= REMAT_TOL and remat[2] < plain[2]
    print(f"remat: one flagship training step (B={TRAIN_BATCH}, T=751, bf16, dropout "
          f"{DROPOUT}, the same masks) with model.remat vs without: loss {remat[0]:.6f} vs "
          f"{plain[0]:.6f} (relative {rel_loss:.2e}), grad norm {remat[1]:.6f} vs {plain[1]:.6f} "
          f"(relative {rel_norm:.2e}; tol {REMAT_TOL:.2e}), worst per-tensor relative L2 "
          f"gradient difference {worst:.2e}; peak memory {remat[2]:.2f} vs {plain[2]:.2f} GiB; "
          f"{remat[3]:.1f} vs {plain[3]:.1f} ms; (launches, backwards) with remat "
          f"{remat[4]}, without {plain[4]} {'ok' if ok else 'FAILED'}")
    if remat[4] != [(2 * n_layers, n_layers)] * 2 or plain[4] != [(n_layers, n_layers)] * 2:
        fail(f"remat: kernel counts {remat[4]} with remat, {plain[4]} without; expected "
             f"{2 * n_layers} launches (forward and recompute) and {n_layers} backwards with "
             f"it, {n_layers} each without")
    if not ok:
        fail("remat: the step with remat disagrees with the step without it, or its peak "
             "memory is not lower")
    for i, name in enumerate(("summary_mixing", "csgu")):
        kernel_rows[name]["launches_by_path"]["remat"] = remat[4][i][0] + plain[4][i][0]
        kernel_rows[name]["plain_calls_by_path"]["remat"] = 0


def spm_pieces(n: int, seed: int) -> list:
    """A unigram SentencePiece table of `n` pieces, the ids the recipes
    expect: <unk>, <s>, </s>, then word-initial and inner pieces over a-z
    (1-3 letters), scores drawn from `seed`."""
    import itertools

    rng = np.random.default_rng(seed)
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    for length in (1, 2, 3):
        for letters in itertools.product("abcdefghijklmnopqrstuvwxyz", repeat=length):
            for text in ("▁" + "".join(letters), "".join(letters)):
                if len(pieces) < n:
                    pieces.append((text, -float(rng.uniform(1.0, 12.0)), 1))
    return pieces


def write_reference_dir(ref: str, oracle, lm_oracle, n_mels: int, vocab: int) -> None:
    """The Pretrainer's `collect_in` layout of a SpeechBrain run:
    `model.ckpt`, `lm.ckpt`, `normalizer.ckpt` (InputNormalization's
    `glob_mean`, `glob_std`, `count`, seeded) and `tokenizer.ckpt` (a
    SentencePiece ModelProto under the Pretrainer's name)."""
    import torch

    from summarymixing_tpu_torch.data.sentencepiece_model import serialize_model_proto

    os.makedirs(ref, exist_ok=True)
    torch.save(oracle.state_dict(), os.path.join(ref, "model.ckpt"))
    torch.save(lm_oracle.state_dict(), os.path.join(ref, "lm.ckpt"))
    g = torch.Generator().manual_seed(REF_SEED)
    torch.save({"glob_mean": -10.0 + 5.0 * torch.randn(n_mels, generator=g),
                "glob_std": 4.0 + 4.0 * torch.rand(n_mels, generator=g),
                "count": torch.tensor(1.0e5)}, os.path.join(ref, "normalizer.ckpt"))
    with open(os.path.join(ref, "tokenizer.ckpt"), "wb") as f:
        f.write(serialize_model_proto(spm_pieces(vocab, REF_SEED)))


def read_nbest(path: str) -> dict:
    """`nbest.jsonl` as {utterance ID: [(text, score), ...]}."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {r["id"]: [(h["text"], h["score"]) for h in r["nbest"]] for r in rows}


def phase_reference_checkpoint(kernel_rows, here: str, root: str) -> None:
    """Phase 22: a SpeechBrain-layout checkpoint of the flagship (the
    clean-room oracles' weights) through the port's own entry points on the
    card: `convert_checkpoint --ref-dir`, `evaluate --beam --nbest 3
    --lm-ckpt` with and without blank-skip, and `transcribe`; the
    converted model against the oracle's forward, the kernel path against
    the plain path."""
    import csv
    import io

    import torch

    from summarymixing_tpu_torch.config import LMConfig, load_recipe
    from summarymixing_tpu_torch.data.batching import DynamicBucketBatcher
    from summarymixing_tpu_torch.data.dataio import load_wav, read_manifest_csv
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.recipes import common, convert_checkpoint, evaluate, transcribe
    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    sys.path.insert(0, os.path.join(here, "tests"))
    from torch_full_oracle import build_oracle
    from torch_lm_oracle import TransformerLMTorch

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    recipe = os.path.join(here, FLAGSHIP_RECIPE)
    cfg = load_recipe(recipe)
    m, lm_cfg = cfg.model, cfg.lm or LMConfig()
    n_layers = m.num_encoder_layers
    work = os.path.join(root, "reference")
    ref, run = os.path.join(work, "ref"), os.path.join(work, "run")

    # (a) the SpeechBrain-layout directory
    t0 = time.perf_counter()
    oracle = build_oracle(
        input_size=m.input_size, d_model=m.d_model, nhead=m.nhead, n_enc=n_layers,
        n_dec=m.num_decoder_layers, d_ffn=m.d_ffn, vocab=m.output_neurons,
        hid=tuple(m.local_proj_hid_dim), local_out=m.local_proj_out_dim,
        sum_hid=tuple(m.summary_hid_dim), sum_out=m.summary_out_dim,
        csgu_units=m.csgu_linear_units, kernel_size=m.csgu_kernel_size,
        frontend_channels=tuple(m.frontend_channels), seed=REF_SEED)
    torch.manual_seed(REF_SEED)
    lm_oracle = TransformerLMTorch(m.output_neurons, d_model=lm_cfg.d_model, nhead=lm_cfg.nhead,
                                   n_layers=lm_cfg.num_layers, d_ffn=lm_cfg.d_ffn)
    write_reference_dir(ref, oracle, lm_oracle, cfg.features.n_mels, m.output_neurons)
    del lm_oracle
    print(f"reference checkpoint: oracle {sum(p.numel() for p in oracle.parameters()):,} "
          f"parameters, written with its LM, normaliser and {m.output_neurons}-piece tokenizer "
          f"in {time.perf_counter() - t0:.1f} s")

    # request 0 of phase 4 as 16-bit WAV files and a manifest
    sr = cfg.features.sample_rate
    wav, lens = request0(sr)
    dev = wav.device
    wav_np, lens_np = wav.cpu().numpy(), lens.cpu().numpy()
    files, rows = [], []
    for i in range(wav_np.shape[0]):
        files.append(os.path.join(work, f"request0_{i}.wav"))
        with open(files[-1], "wb") as f:
            f.write(wav_bytes(wav_np[i, :lens_np[i]], sr))
        rows.append({"ID": f"r0u{i}", "duration": lens_np[i] / sr, "wav": files[-1],
                     "spk_id": "s0", "wrd": "ab cd ef"})
    manifest = os.path.join(work, "request0.csv")
    with open(manifest, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    one_batch = [f"training.max_batch_length_val={len(rows) * float(lens_np.max()) / sr}",
                 "training.num_buckets=1"]
    lengths, buckets = common.build_buckets(
        read_manifest_csv(manifest), load_recipe(recipe, common.parse_overrides(one_batch)),
        valid=True)
    batched = list(DynamicBucketBatcher(lengths, buckets, shuffle=False, drop_last=False))
    if len(batched) != 1 or len(batched[0][1]) != len(rows):
        fail(f"reference: request 0 forms {[len(b[1]) for b in batched]} evaluation batches, "
             f"not one of {len(rows)}")
    sets = [a for kv in one_batch for a in ("--set", kv)]

    # (b) convert
    res, counts, convert_s, peak_c = run_stage("convert_checkpoint --ref-dir",
                                               convert_checkpoint.main,
                                               [recipe, "--ref-dir", ref, "--output", run])
    if res["keys"]["unconsumed"] or res["lm"]["keys"]["unconsumed"]:
        fail(f"reference: conversion left keys unread: model {res['keys']}, "
             f"LM {res['lm']['keys']}")
    if res["tokenizer"] != "tokenizer.model" or res["params"] != FLAGSHIP_TRAIN_PARAMS:
        fail(f"reference: tokenizer placed as {res['tokenizer']}, {res['params']:,} parameters "
             f"(expected tokenizer.model, {FLAGSHIP_TRAIN_PARAMS:,})")
    print(f"reference convert: {convert_s:.2f} s; model keys {res['keys']}, LM keys "
          f"{res['lm']['keys']} ({res['lm']['params']:,} LM parameters); "
          f"{res['params']:,} parameters")

    # (c) the converted model in float32 with the exact GELU against the oracle, on the card
    save = os.path.join(run, "save")
    audio = [load_wav(p, sr) for p in files]
    wav_f = torch.zeros(len(audio), max(len(a) for a in audio), device=dev)
    for i, a in enumerate(audio):
        wav_f[i, :len(a)] = torch.from_numpy(a)
    lens_f = torch.tensor([len(a) for a in audio], device=dev)
    f32 = load_recipe(recipe, common.parse_overrides(["model.activation=gelu_exact",
                                                      "training.precision=fp32"]))
    model32, fbank, _, stats = common.restore_inference(f32, save, 0, dev)
    kernels = zero_counts()
    oracle = oracle.to(dev).eval()
    cnn, asr, _, ctc_lin = oracle
    rel_enc, rel_ctc, frames = [], [], []
    with torch.no_grad():
        # one utterance at a time, unpadded: the oracle's encoder has no pad mask
        for a in audio:
            row = torch.from_numpy(a).to(dev)[None]
            feats, _ = InputNormalization()(fbank(row), stats)
            enc, _ = model32.encode(feats, fbank.frame_lengths(torch.tensor([len(a)], device=dev)))
            with dev:   # the oracle builds its sine table on the default device
                enc_o = asr.encode(cnn(feats))
            rel_enc.append(rel_l2(enc, enc_o))
            rel_ctc.append(rel_l2(model32.ctc_head(enc), torch.log_softmax(ctc_lin(enc_o), -1)))
            frames.append(enc.shape[1])
    plain32 = read_counts(kernels)
    del model32, oracle, cnn, asr, ctc_lin, enc, enc_o
    peaks = [peak_c, torch.cuda.max_memory_allocated() / 2 ** 30]
    torch.cuda.empty_cache()
    ok = max(rel_enc + rel_ctc) <= REF_ORACLE_TOL
    print(f"reference (c): converted model in float32 (exact GELU, plain path: "
          f"(launches, plain calls) {plain32}) vs the oracle's forward, each of the "
          f"{len(audio)} utterances alone (T = {min(frames)}-{max(frames)}): relative L2 "
          f"encoder at most {max(rel_enc):.3e}, CTC log-probs at most {max(rel_ctc):.3e} "
          f"(tol {REF_ORACLE_TOL:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("reference: the converted model disagrees with the oracle")

    # (c) the recipe as written (bf16, tanh-GELU, both kernels) against its plain path
    model, fbank, _, stats = common.restore_inference(cfg, save, 0, dev)
    kernels = zero_counts()
    with torch.no_grad():
        hyps_k, out_k = greedy_ctc_decode(model, fbank, stats, wav_f, lens_f)
        counted = read_counts(kernels)
        with plain_kernels():
            hyps_p, out_p = greedy_ctc_decode(model, fbank, stats, wav_f, lens_f)
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    valid = (torch.arange(out_k["ctc_log_probs"].shape[1], device=dev)[None, :]
             < out_k["enc_lengths"][:, None])
    max_diff = float((out_k["ctc_log_probs"] - out_p["ctc_log_probs"]).abs().amax(-1)[valid].max())
    frac = float((out_k["ctc_log_probs"].argmax(-1)
                  == out_p["ctc_log_probs"].argmax(-1))[valid].float().mean())
    ok = frac >= 0.95 and max_diff <= 1.0 and counted == {"summary_mixing": (n_layers, 0),
                                                          "csgu": (n_layers, 0)}
    print(f"reference (c): recipe as written, kernel path vs plain path on request 0: max "
          f"|dlogp| {max_diff:.4f} (tol 1.0), greedy frame agreement {frac:.4f} (tol >= 0.95), "
          f"identical token rows {sum(a == b for a, b in zip(hyps_k, hyps_p))}/{len(hyps_k)}, "
          f"(launches, plain calls) {counted} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("reference: the converted recipe's kernel path disagrees with its plain path")
    del model, out_k, out_p
    torch.cuda.empty_cache()

    # (b) evaluate three times and transcribe once, through the runners
    lm_dir = os.path.join(run, "lm")
    runs = {}
    for label, skip in (("no skip", []),
                        ("skip 1.0", ["decoding.ctc_blank_skip=1.0",
                                      "decoding.ctc_frame_cap=1000000"]),
                        (f"skip {REF_SKIP}", [f"decoding.ctc_blank_skip={REF_SKIP}"])):
        out_dir = os.path.join(work, "eval_" + label.replace(" ", "_"))
        summary, counts_e, secs, peak = run_stage(
            f"evaluate --beam --nbest {REF_NBEST} ({label})", evaluate.main,
            [recipe, "--test-manifest", manifest, "--ckpt", save, "--beam", "--nbest",
             str(REF_NBEST), "--lm-ckpt", lm_dir, "--output", out_dir] + sets
            + [a for kv in skip for a in ("--set", kv)])
        check_eval(label, summary, len(rows))
        want = {name: (n_layers, 0, 0) for name in counts_e}
        if counts_e != want or summary["decode"] != "beam+lm" or summary["nbest"] != REF_NBEST:
            fail(f"reference evaluate ({label}): (launches, plain calls, backwards) {counts_e}, "
                 f"expected {want}; decode {summary['decode']}, nbest {summary.get('nbest')}")
        nbest = read_nbest(os.path.join(out_dir, "nbest.jsonl"))
        for utt, ranked in nbest.items():
            scores = [sc for _, sc in ranked]
            if (len(ranked) != REF_NBEST or scores != sorted(scores, reverse=True)
                    or ranked[0][0].split() != summary["hyps"][utt]):
                fail(f"reference evaluate ({label}): nbest.jsonl row {utt} is not {REF_NBEST} "
                     "score-sorted entries led by the scored hypothesis")
        if sorted(nbest) != sorted(r["ID"] for r in rows):
            fail(f"reference evaluate ({label}): nbest.jsonl holds {sorted(nbest)}")
        step = 1e3 * summary["search_s"] / max(summary["beam_steps"], 1)
        runs[label] = dict(summary=summary, nbest=nbest, counts=counts_e, step_ms=step,
                           seconds=secs)
        peaks.append(peak)
        print(f"reference evaluate ({label}): {summary['beam_steps']} steps, {step:.2f} ms per "
              f"step, CTC scorer frames {summary['ctc_frames']}, {secs:.1f} s, WER "
              f"{summary['WER']:.2f} (random weights), peak {peak:.2f} GiB")
    base, exact = runs["no skip"], runs["skip 1.0"]
    same = all(exact["summary"]["hyps"][u] == base["summary"]["hyps"][u]
               and [t for t, _ in exact["nbest"][u]] == [t for t, _ in base["nbest"][u]]
               for u in base["nbest"])
    score_diff = max(abs(a - b) for u in base["nbest"]
                     for (_, a), (_, b) in zip(base["nbest"][u], exact["nbest"][u]))
    ok = same and score_diff <= REF_SKIP_SCORE_TOL
    print(f"reference (c): blank-skip 1.0 (no cap) vs no skip: the same hypotheses and n-best "
          f"texts {same}, max |dscore| {score_diff:.3e} (tol {REF_SKIP_SCORE_TOL:.0e}) "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        fail("reference: blank-skip at 1.0 changed the search")
    skip = runs[f"skip {REF_SKIP}"]
    kept = sum(skip["summary"]["hyps"][u] == base["summary"]["hyps"][u] for u in base["nbest"])
    print(f"reference (d): blank-skip {REF_SKIP} (cap min(max(T // 4, 32), T)): "
          f"{skip['step_ms']:.2f} ms per step against {base['step_ms']:.2f} without, CTC scorer "
          f"frames {skip['summary']['ctc_frames']} against {base['summary']['ctc_frames']}; "
          f"rows whose hypothesis is unchanged {kept}/{len(base['nbest'])} (random weights are "
          "not peaky: the cap, not the threshold, sets what is kept)")
    out = os.path.join(work, "transcribe.jsonl")
    with contextlib.redirect_stdout(io.StringIO()):   # its JSONL goes to --output too
        res_t, counts_t, secs_t, peak_t = run_stage(
            "transcribe (reference)", transcribe.main,
            [recipe, *files, "--ckpt", save, "--batch-size", str(len(files)), "--output", out])
    peaks.append(peak_t)
    with open(out) as f:
        texts = [json.loads(line)["text"] for line in f]
    want = {name: (n_layers, 0, 0) for name in counts_t}
    if len(texts) != len(files) or counts_t != want:
        fail(f"reference transcribe: {len(texts)} lines for {len(files)} files, (launches, "
             f"plain calls, backwards) {counts_t}, expected {want}")
    print(f"reference transcribe: {len(files)} files greedy in {secs_t:.2f} s through "
          f"tokenizer.model, (launches, plain calls, backwards) {counts_t}; first text "
          f"{texts[0][:60]!r}")
    for name in counts_t:
        kernel_rows[name]["launches_by_path"]["reference_checkpoint"] = (
            sum(r["counts"][name][0] for r in runs.values()) + counts_t[name][0])
        kernel_rows[name]["plain_calls_by_path"]["reference_checkpoint"] = (
            sum(r["counts"][name][1] for r in runs.values()) + counts_t[name][1])
    print(f"phase 22 (reference checkpoint): peak memory {max(peaks):.2f} GiB, "
          f"{time.perf_counter() - t_phase:.1f} s wall")


def phase_mode(kernel_rows, mode: str) -> None:
    """Phase 23 (a) and (b): the flagship recipe with its cells in `mode`,
    random weights from its seed: request 0 decoded greedily (launches and
    counted plain calls per forward, against the same request with the
    cgMLP's plain version at phase 5's tolerances), one training step at
    B=16 with every parameter getting a gradient, and for expdecay the
    device time of the `[B, T, T]` float32 decay contraction."""
    import torch

    from summarymixing_tpu_torch.config import build_model, build_trainer
    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    label = mode.split("-")[1]
    cfg = flagship_config()
    cfg.model.mode = mode
    n_layers = cfg.model.num_encoder_layers
    torch.cuda.reset_peak_memory_stats()
    model, fbank = build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    if mode == LITE and n_params != FLAGSHIP_LITE_PARAMS:
        fail(f"{label}: parameter count {n_params:,} != {FLAGSHIP_LITE_PARAMS:,} (flax's)")
    stats = seeded_norm_stats()
    wav, lens = request0(cfg.features.sample_rate)
    greedy_ctc_decode(model, fbank, stats, wav, lens)   # warm-up
    kernels = zero_counts()
    times = []
    for _ in range(MODE_DECODES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps, out = greedy_ctc_decode(model, fbank, stats, wav, lens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = read_counts(kernels)
    want = {"summary_mixing": (0, MODE_DECODES * n_layers),
            "csgu": (MODE_DECODES * n_layers, 0)}
    lp = out["ctc_log_probs"]
    ms = float(np.median(times)) * 1e3
    print(f"{label}: flagship in {mode} mode, {n_params:,} parameters; request 0 greedy "
          f"({tuple(wav.shape)}, T={lp.shape[1]}): {ms:.2f} ms median of {MODE_DECODES} "
          f"(full mode in phase 4: {FULL_MODE_MS.get('decode', float('nan')):.2f} ms); "
          f"(launches, plain calls) {counts} over {MODE_DECODES} forwards")
    if counts != want:
        fail(f"{label}: (launches, plain calls) {counts}, expected {want}: the cgMLP kernel "
             f"{n_layers} times and the cell's counted plain path {n_layers} times per forward")
    if not torch.isfinite(lp).all():
        fail(f"{label}: non-finite CTC log-probs")
    phase_plain_path(model, fbank, stats, [(None, wav, lens)], [(0.0, 0.0, out, hyps)])
    for name, (n, p) in counts.items():
        kernel_rows[name]["launches_by_path"][label] = n
        kernel_rows[name]["plain_calls_by_path"][label] = p

    # one cell's plain path at request 0's shapes, beside its bound: x and
    # the pad mask read once, the float32 weights read once, the output
    # written once; its bf16 products, and expdecay's float32 contraction
    cell = model.asr.encoder.layer_0.mixer
    b, t, d = wav.shape[0], lp.shape[1], cfg.model.d_model
    pad = (torch.arange(t, device="cuda")[None, :] < out["enc_lengths"][:, None]).float()
    x = torch.randn(b, t, d, device="cuda").to(torch.bfloat16)
    weights = sum(p.numel() for p in cell.parameters())
    mats = sum(p.numel() for p in cell.parameters() if p.dim() > 1)
    n = cfg.model.summary_out_dim
    fp32 = 2 * b * t * t * n if mode == EXPDECAY else 0
    cell_bound, cell_by = bound(b * t * d * 2 + b * t * 4 + weights * 4 + b * t * n * 2,
                                2 * b * t * mats, fp32)
    with torch.no_grad():
        cell_ms = sum(pass_us(lambda: cell(x, pad_mask=pad), calls=5).values()) / 1e3
    print(f"{label}: one cell's plain path (B={b}, T={t}, d={d}, bf16): {cell_ms:.4f} ms device "
          f"per call from torch.profiler, bound {cell_bound:.4f} ms ({cell_by}); the full-mode "
          f"kernel's row of phase 3 is beside it in PERF.md")

    if mode == EXPDECAY:
        from summarymixing_tpu_torch.ops.summary_mixing import laplace_weights, summary_matmul

        b, t = wav.shape[0], lp.shape[1]
        f = cfg.model.summary_out_dim
        pad = (torch.arange(t, device="cuda")[None, :] < out["enc_lengths"][:, None]).float()
        summ = torch.randn(b, t, f, device="cuda").to(torch.bfloat16)

        def contraction():
            decay = laplace_weights(t, 0.995, "cuda")
            return summary_matmul(decay[None] * pad[:, None, :], summ)

        us = pass_us(contraction, calls=5)
        dev_ms = sum(us.values()) / 1e3
        bound_ms, by = bound(b * t * t * 4 + b * t * f * 2 * 2, 0, 2 * b * t * t * f)
        print(f"{label}: the [B, T, T] float32 decay contraction (B={b}, T={t}, F={f}, TF32 "
              f"off), one torch.profiler pass of 5 calls: {dev_ms:.4f} ms device per cell, "
              f"{n_layers * dev_ms:.3f} ms per forward, bound {bound_ms:.4f} ms ({by}); "
              f"kernels {[(k[:40], round(v / 1e3, 4)) for k, v in sorted(us.items())]}")
    del model, out
    torch.cuda.empty_cache()

    cfg = flagship_config(decoder_layers=6)
    cfg.model.mode = mode
    model, fbank = build_model(cfg)
    trainer = build_trainer(cfg, model, fbank)
    state = trainer.init_state(cfg.seed)
    batch = training_batch()
    state, metrics = trainer.train_step(state, batch)      # warm-up
    kernels = zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    no_grad = [n for n, p in model.named_parameters() if p.grad is None]
    counts = [(k.launches, k.backwards, k.plain_calls) for k in kernels]
    loss = float(metrics["loss"])
    print(f"{label} train: one step at B={TRAIN_BATCH}, T=751 (bf16, dropout, augmentation): "
          f"{dt:.2f} ms (full mode in phase 7: {FULL_MODE_MS.get('train_step', float('nan')):.2f}"
          f" ms median), loss {loss:.4f}, grad norm {float(metrics['grad_norm']):.4f}, peak "
          f"memory {peak:.2f} GiB; (launches, backwards, plain calls) summary_mixing "
          f"{counts[0]} csgu {counts[1]}; parameters without a gradient: {len(no_grad)}")
    if not np.isfinite(loss) or metrics["nonfinite_skipped"] or no_grad:
        fail(f"{label} train: loss {loss}, skipped {metrics['nonfinite_skipped']}, no gradient "
             f"for {no_grad[:6]}")
    if counts != [(0, 0, n_layers), (n_layers, n_layers, 0)]:
        fail(f"{label} train: counts {counts}, expected the cell's plain path {n_layers} times "
             f"and the cgMLP kernel {n_layers} times forward and backward")
    for name, (n, _, p) in zip(("summary_mixing", "csgu"), counts):
        kernel_rows[name]["launches_by_path"][label] += n
        kernel_rows[name]["plain_calls_by_path"][label] += p
    del model, trainer, state, metrics
    torch.cuda.empty_cache()


def phase_profile_runner(kernel_rows, here: str, corpus: dict, root: str) -> None:
    """Phase 23 (d): phase 13's flagship run with `--profile DIR
    --profile-steps 3` over 6 steps: the trace and the table exist, the
    table names both kernels' passes, and `device_memory_stats` is read."""
    from summarymixing_tpu_torch.recipes import train
    from summarymixing_tpu_torch.training.profiling import TABLE_FILE, device_memory_stats

    recipe, _, sets, cfg = flagship_run(here, root)
    prof = os.path.join(root, "flagship_profile")
    res, counts, secs, peak = run_stage("flagship train --profile", train.main, [
        recipe, "--train-manifest", corpus["train"], "--valid-manifest", corpus["dev"],
        "--output", os.path.join(root, "flagship_profiled"), "--steps", str(PROFILE_STEPS),
        "--profile", prof, "--profile-steps", "3"] + sets)
    table = open(os.path.join(prof, TABLE_FILE)).read()
    names = {"summary_mixing": "branch_pass", "csgu": "gate_pass"}
    rows = {k: [line.strip() for line in table.splitlines() if v in line] for k, v in names.items()}
    if res.get("profile") != os.path.join(prof, "trace.json") or not os.path.getsize(
            res["profile"]):
        fail(f"profile: no trace at {res.get('profile')}")
    if not all(rows.values()):
        fail(f"profile: the table names {[k for k, v in rows.items() if v]} of both kernels")
    mem = device_memory_stats()["cuda:0"]
    print(f"profile: {res['profile']} ({os.path.getsize(res['profile']) / 1e6:.1f} MB), "
          f"steps 4-6 of {res['steps']}; the table's rows of the kernels: {rows}")
    print("profile: device_memory_stats cuda:0: " + ", ".join(
        f"{k} {mem.get(k, 0):,}" for k in ("allocated_bytes.all.peak", "reserved_bytes.all.peak",
                                          "num_alloc_retries", "num_ooms")))
    n_layers = cfg.model.num_encoder_layers
    if counts["summary_mixing"][1] or counts["csgu"][1] or \
            counts["csgu"][2] != n_layers * PROFILE_STEPS:
        fail(f"profile: (launches, plain calls, backwards) {counts}")
    for name in counts:
        kernel_rows[name]["launches_by_path"]["runner_profile"] = counts[name][0]
        kernel_rows[name]["plain_calls_by_path"]["runner_profile"] = counts[name][1]


def phase_native_loader(root: str) -> None:
    """Phase 23 (e): phase 4's 32 utterances as 16-bit WAVs through the
    native loader in one batch, and one FLAC body through
    `load_audio_bytes`, each against the Python decoders bit for bit."""
    from summarymixing_tpu_torch.data import dataio, native_loader
    from summarymixing_tpu_torch.data.flac import decode_flac, encode_flac

    sr = 16000
    folder = os.path.join(root, "native_wavs")
    os.makedirs(folder, exist_ok=True)
    wavs = synthetic_waveforms(N_REQUESTS * BATCH, seed=11)
    paths = []
    for i, w in enumerate(wavs):
        paths.append(os.path.join(folder, f"u{i}.wav"))
        with open(paths[-1], "wb") as f:
            f.write(wav_bytes(w, sr))
    t0 = time.perf_counter()
    native_loader.build()
    build_s = time.perf_counter() - t0
    max_len = max(len(w) for w in wavs)
    t0 = time.perf_counter()
    out, lens = native_loader.load_wav_batch(paths, max_len, sr)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = [dataio.load_wav(p, sr) for p in paths]
    python_s = time.perf_counter() - t0
    same = all(np.array_equal(out[i, :lens[i]], r) and len(r) == lens[i] and
               not out[i, lens[i]:].any() for i, r in enumerate(ref))
    audio_s = sum(len(r) for r in ref) / sr
    print(f"native loader: built in {build_s:.2f} s; {len(paths)} 16-bit WAVs "
          f"({audio_s:.1f} audio-s) in one batch: native {native_s:.4f} s, Python "
          f"{python_s:.4f} s; equal bit for bit: {same}")
    if not same:
        fail("native loader: a WAV row differs from the Python decoder's")
    twin = min(wavs, key=lambda w: abs(len(w) - 17.7 * sr))
    pcm = np.clip(np.round(twin * 32768.0), -32768, 32767).astype(np.int64)
    body = encode_flac(pcm, sr)
    t0 = time.perf_counter()
    got = dataio.load_audio_bytes(body, sr)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples, _, bps = decode_flac(body)
    want = samples.astype(np.float32) / float(1 << (bps - 1))
    python_s = time.perf_counter() - t0
    same = np.array_equal(got, want)
    print(f"native loader: a FLAC body of {len(twin) / sr:.2f} s ({len(body) / 1e6:.2f} MB) "
          f"through load_audio_bytes {native_s:.4f} s, the Python codec {python_s:.4f} s; "
          f"equal bit for bit: {same}; rows retried in Python "
          f"{native_loader.load_wav_batch.python_retries}")
    if not same:
        fail("native loader: the FLAC body differs from the Python codec's samples")


def phase_export_transducer(kernel_rows, root: str) -> None:
    """Phase 23 (f): the full-width transducer (phase 10's recipe, seed
    3407) exported offline without `--fixed` on the card, saved, loaded
    and run at request 0 (B=8, 30 s) and at one 13.5 s utterance: tokens,
    lengths and encoder lengths equal to the live inference function's."""
    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.utils.export import (
        ExportedASR,
        export_ctc_infer,
        make_transducer_infer_fn,
        save_artifact,
    )

    cfg = transducer_config()
    model, fbank, td = build_model(cfg)
    live = make_transducer_infer_fn(model, td, fbank, InputNormalization(), seeded_norm_stats(),
                                    cfg.model.blank_index)
    kernels = zero_counts()
    t0 = time.perf_counter()
    payload = export_ctc_infer(live)
    export_s = time.perf_counter() - t0
    path = os.path.join(root, "transducer.smt")
    save_artifact(path, payload, {"family": "transducer", "sample_rate": 16000,
                                  "blank_id": cfg.model.blank_index, "time_multiple": 320,
                                  "polymorphic": True,
                                  "device": next(model.parameters()).device.type})
    t0 = time.perf_counter()
    art = ExportedASR.load(path)
    load_s = time.perf_counter() - t0
    wav0, lens0 = request0(16000)
    one = torch.from_numpy(synthetic_waveforms(1, seed=5)[0][:int(13.5 * 16000)]).cuda()[None]
    cases = ((wav0, lens0), (one, torch.tensor([one.shape[1]], dtype=torch.int32).cuda()))
    for wav, lens in cases:
        art(wav, lens)   # warm-up of each shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = art(wav, lens)
        torch.cuda.synchronize()
        art_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        with torch.inference_mode():
            want = live(wav, lens)
        torch.cuda.synchronize()
        live_ms = (time.perf_counter() - t0) * 1e3
        same = all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
        print(f"export transducer: {tuple(wav.shape)} -> tokens {tuple(got[0].shape)}, "
              f"lengths {got[1].tolist()}; equal to the live model: {same}; artifact "
              f"{art_ms:.1f} ms, live {live_ms:.1f} ms")
        if not same:
            fail(f"export transducer: the artifact's outputs differ from the live model's at "
                 f"{tuple(wav.shape)}")
    counts = read_counts(kernels)
    print(f"export transducer: polymorphic artifact of {os.path.getsize(path) / 1e6:.1f} MB "
          f"exported in {export_s:.1f} s, loaded in {load_s:.1f} s; (launches, plain calls) "
          f"{counts} (the fast cells take the counted plain path)")
    if counts["summary_mixing"][0] or counts["csgu"] != (0, 0):
        fail(f"export transducer: a kernel was launched on the transducer path: {counts}")
    for name, (n, p) in counts.items():
        kernel_rows[name]["launches_by_path"]["export_transducer"] = n
        kernel_rows[name]["plain_calls_by_path"]["export_transducer"] = p
    del model, td, live, art
    torch.cuda.empty_cache()


def phase_modes_and_tooling(kernel_rows, here: str, corpus: dict, root: str) -> None:
    """Phase 23: (a) lite, (b) expdecay, (c) the Summary Decoder recipe in
    expdecay mode, (d) `--profile`, (e) the native loader and (f) the
    polymorphic transducer artifact."""
    import torch

    t0 = time.perf_counter()
    phase_mode(kernel_rows, LITE)
    phase_mode(kernel_rows, EXPDECAY)
    phase_summary_decoder(kernel_rows, here, mode=EXPDECAY)
    torch.cuda.empty_cache()
    phase_profile_runner(kernel_rows, here, corpus, root)
    torch.cuda.empty_cache()
    phase_native_loader(root)
    phase_export_transducer(kernel_rows, root)
    print(f"phase 23 (lite, expdecay, the expdecay Summary Decoder, --profile, the native "
          f"loader, the transducer artifact): {time.perf_counter() - t0:.1f} s wall")


def baseline_config(attention_type: str, encoder: str = "branchformer", layers: int = 18,
                    causal: bool = False, decoder_layers: int = 0):
    """The flagship recipe with another mixer (nhead 4 for the attention
    mixers, 1 for SummaryMixing), encoder, depth or causality, as `--set
    model.attention_type=... --set model.nhead=4` gives it to the runners."""
    cfg = flagship_config(decoder_layers)
    m = cfg.model
    m.attention_type, m.encoder_module = attention_type, encoder
    m.nhead = 1 if attention_type == "SummaryMixing" else BASELINE_NHEAD
    m.num_encoder_layers, m.causal = layers, causal
    return cfg


def timed_decodes(model, fbank, stats, wav, lens, n: int) -> tuple:
    """One warm-up greedy decode, then `n` timed: (median ms, hyps, out)."""
    import torch

    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    greedy_ctc_decode(model, fbank, stats, wav, lens)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps, out = greedy_ctc_decode(model, fbank, stats, wav, lens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not torch.isfinite(out["ctc_log_probs"]).all():
        fail("non-finite CTC log-probs")
    return float(np.median(times)) * 1e3, hyps, out


def add_counts(kernel_rows, path: str, counts: dict) -> None:
    for name, (n, p) in counts.items():
        kernel_rows[name]["launches_by_path"][path] = (
            kernel_rows[name]["launches_by_path"].get(path, 0) + n)
        kernel_rows[name]["plain_calls_by_path"][path] = (
            kernel_rows[name]["plain_calls_by_path"].get(path, 0) + p)


def phase_baselines_decode(kernel_rows, stats, wav, lens):
    """Phase 24 (a): each Branchformer baseline at full width, bf16, seeded
    random weights: its parameter count (flax's), request 0 decoded greedily
    (the cgMLP kernel 18 times per forward, no cell), held against the same
    request with the cgMLP's plain version at phase 5's tolerances. Returns
    the regularMHA model for (b)."""
    import torch

    from summarymixing_tpu_torch.config import build_model

    kept = None
    for at, want_params in BASELINES.items():
        cfg = baseline_config(at)
        n_layers = cfg.model.num_encoder_layers
        model, fbank = build_model(cfg)
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != want_params:
            fail(f"baseline {at}: parameter count {n_params:,} != {want_params:,} (flax's)")
        kernels = zero_counts()
        ms, hyps, out = timed_decodes(model, fbank, stats, wav, lens, BASELINE_DECODES)
        counts = read_counts(kernels)
        forwards = BASELINE_DECODES + 1
        lp = out["ctc_log_probs"]
        print(f"baseline {at} (nhead {cfg.model.nhead}): {n_params:,} parameters; request 0 "
              f"greedy ({tuple(wav.shape)}, T={lp.shape[1]}): {ms:.2f} ms median of "
              f"{BASELINE_DECODES} (SummaryMixing in phase 4: "
              f"{FULL_MODE_MS.get('decode', float('nan')):.2f} ms); (launches, plain calls) "
              f"{counts} over {forwards} forwards")
        if counts != {"summary_mixing": (0, 0), "csgu": (forwards * n_layers, 0)}:
            fail(f"baseline {at}: (launches, plain calls) {counts}, expected the cgMLP kernel "
                 f"{n_layers} times per forward and no cell")
        phase_plain_path(model, fbank, stats, [(None, wav, lens)], [(0.0, 0.0, out, hyps)])
        add_counts(kernel_rows, "baselines", counts)
        if at == "regularMHA":
            kept = (model, fbank)
        else:
            del model
        torch.cuda.empty_cache()
    return kept


def phase_baselines_sweep(kernel_rows, stats, mha):
    """Phase 24 (b): decode time against utterance length after
    `benchmarks/rtf_sweep.py` (batch 4 of full-length noise, 10-120 s), the
    regularMHA Branchformer against the SummaryMixing flagship in turns
    (one warm-up each, then alternating which goes first); at each length
    one regularMHA mixer's plain path beside `F.scaled_dot_product_attention`
    on the same q, k, v (a yardstick the port never calls), each timed as a
    CUDA graph of 20 calls."""
    import torch
    import torch.nn.functional as F

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    models = {"SummaryMixing": build_model(flagship_config()), "regularMHA": mha}
    mixer = mha[0].asr.encoder.layer_0.mixer
    h, d = mixer.nhead, mixer.d_model
    kernels = zero_counts()
    rows = {}
    for secs in SWEEP_SECONDS:
        n = secs * 16000
        rng = np.random.default_rng(secs)
        wav = torch.from_numpy(0.1 * rng.standard_normal((SWEEP_BATCH, n)).astype(np.float32))
        wav = wav.cuda()
        lens = torch.full((SWEEP_BATCH,), n, dtype=torch.int32).cuda()
        audio_s = SWEEP_BATCH * secs
        times = {label: [] for label in models}
        peaks = dict.fromkeys(models, 0.0)
        for label, (model, fbank) in models.items():   # warm-up
            _, out = greedy_ctc_decode(model, fbank, stats, wav, lens)
        t = out["ctc_log_probs"].shape[1]
        for i in range(SWEEP_DECODES):
            for label in (list(models) if i % 2 == 0 else list(models)[::-1]):
                model, fbank = models[label]
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, out = greedy_ctc_decode(model, fbank, stats, wav, lens)
                torch.cuda.synchronize()
                times[label].append(time.perf_counter() - t0)
                peaks[label] = max(peaks[label], torch.cuda.max_memory_allocated() / 2 ** 30)
                if not torch.isfinite(out["ctc_log_probs"]).all():
                    fail(f"sweep {label} {secs} s: non-finite CTC log-probs")
        for label in models:
            ms = float(np.median(times[label])) * 1e3
            rows[(label, secs)] = ms
            print(f"sweep {label} {secs} s x {SWEEP_BATCH} (T={t}): {ms:.2f} ms per batch "
                  f"(median of {SWEEP_DECODES}, in turns), {audio_s / ms * 1e3:.1f} audio-s/s, "
                  f"{ms / audio_s:.4f} ms per audio-s, peak memory {peaks[label]:.2f} GiB")
        x = torch.randn(SWEEP_BATCH, t, d).to(torch.bfloat16).cuda()

        def heads(y):
            return y.reshape(SWEEP_BATCH, t, h, d // h).transpose(1, 2)

        with torch.inference_mode():
            q, k, v = (heads(proj(x)) for proj in (mixer.q_proj, mixer.k_proj, mixer.v_proj))
            plain = mixer(x, x, x)
            sdpa = mixer.out_proj(F.scaled_dot_product_attention(q, k, v).transpose(1, 2)
                                  .reshape(SWEEP_BATCH, t, d))
            _, err = rel_err(sdpa, plain)
            plain_ms = graph_ms(lambda: mixer(x, x, x))
            core_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        flops = 4 * SWEEP_BATCH * t * t * d
        core_bound, core_by = bound(4 * SWEEP_BATCH * t * d * 2, flops)
        print(f"sweep {secs} s: one regularMHA mixer (B={SWEEP_BATCH}, T={t}, {h} heads, bf16 "
              f"operands, float32 scores and softmax, TF32 off) {plain_ms:.4f} ms (graph); "
              f"F.scaled_dot_product_attention on its q, k, v {core_ms:.4f} ms (graph; the "
              f"core's bound {core_bound:.4f} ms, {core_by}), {plain_ms / core_ms:.1f}x less; "
              f"the mixer through SDPA against the plain mixer: max |diff|/(1+|plain|) "
              f"{err:.3e} (a yardstick, not on the port's path)")
    counts = read_counts(kernels)
    n_layers = 18
    forwards = len(SWEEP_SECONDS) * (SWEEP_DECODES + 1)
    if counts != {"summary_mixing": (forwards * n_layers, 0),
                  "csgu": (2 * forwards * n_layers, 0)}:
        fail(f"sweep: (launches, plain calls) {counts}, expected the cell {n_layers} times per "
             "SummaryMixing forward and the cgMLP 18 times per forward of either model")
    add_counts(kernel_rows, "baseline_sweep", counts)
    for secs in SWEEP_SECONDS:
        r = {label: rows[(label, secs)] / rows[(label, SWEEP_SECONDS[0])] * SWEEP_SECONDS[0]
             / secs for label in models}
        ratio = rows[("regularMHA", secs)] / rows[("SummaryMixing", secs)]
        print(f"sweep: cost per audio-second at {secs} s over that at {SWEEP_SECONDS[0]} s: "
              + ", ".join(f"{k} {v:.3f}" for k, v in r.items())
              + f"; regularMHA over SummaryMixing per batch {ratio:.3f}")
    del models
    torch.cuda.empty_cache()


def phase_baselines_train(kernel_rows):
    """Phase 24 (c): training steps of the SummaryMixing flagship and of the
    regularMHA one (both with the 6-layer decoder) on phase 7's batch: one
    warm-up step each, then `BASELINE_STEPS` each in turns (alternating
    which goes first): the median ms, and each model's peak memory as if it
    were alone on the card (its resident state after the warm-up plus its
    steps' high-water mark above the memory in use when each began)."""
    import torch

    from summarymixing_tpu_torch.config import build_model, build_trainer

    batch = training_batch()
    base = torch.cuda.memory_allocated()
    runs = {}
    for at in ("SummaryMixing", "regularMHA"):
        before = torch.cuda.memory_allocated()
        cfg = baseline_config(at, decoder_layers=6)
        model, fbank = build_model(cfg)
        trainer = build_trainer(cfg, model, fbank)
        state, _ = trainer.train_step(trainer.init_state(cfg.seed), batch)   # warm-up
        torch.cuda.synchronize()
        runs[at] = dict(model=model, trainer=trainer, state=state,
                        layers=cfg.model.num_encoder_layers, nhead=cfg.model.nhead,
                        resident=torch.cuda.memory_allocated() - before, times=[], transient=0,
                        losses=[], skipped=0, counts=[(0, 0, 0), (0, 0, 0)])
    for i in range(BASELINE_STEPS):
        for at in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            r = runs[at]
            kernels = zero_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            r["state"], metrics = r["trainer"].train_step(r["state"], batch)
            torch.cuda.synchronize()
            r["times"].append(time.perf_counter() - t0)
            r["transient"] = max(r["transient"], torch.cuda.max_memory_allocated() - start)
            r["losses"].append(float(metrics["loss"]))
            r["skipped"] += metrics["nonfinite_skipped"]
            r["counts"] = [tuple(a + b for a, b in zip(c, (k.launches, k.backwards, k.plain_calls)))
                           for c, k in zip(r["counts"], kernels)]
    ms = {}
    for at, r in runs.items():
        n_layers, n = r["layers"], BASELINE_STEPS
        ms[at] = float(np.median(r["times"])) * 1e3
        peak = (base + r["resident"] + r["transient"]) / 2 ** 30
        no_grad = [name for name, p in r["model"].named_parameters() if p.grad is None]
        counts = r["counts"]
        print(f"baseline train {at} (nhead {r['nhead']}): {n} steps at B={TRAIN_BATCH}, T=751 "
              f"(bf16, dropout, augmentation, the decoder), in turns: {ms[at]:.2f} ms median "
              f"(range {min(r['times']) * 1e3:.2f}-{max(r['times']) * 1e3:.2f}), last loss "
              f"{r['losses'][-1]:.4f}, peak memory alone {peak:.2f} GiB (resident "
              f"{r['resident'] / 2 ** 30:.2f}; phase 7's SummaryMixing step: "
              f"{FULL_MODE_MS.get('train_step', float('nan')):.2f} ms median); (launches, "
              f"backwards, plain calls) summary_mixing {counts[0]} csgu {counts[1]}")
        want_cell = (n * n_layers, n * n_layers, 0) if at == "SummaryMixing" else (0, 0, 0)
        if not np.isfinite(r["losses"]).all() or r["skipped"] or no_grad:
            fail(f"baseline train {at}: losses {r['losses']}, {r['skipped']} steps skipped, no "
                 f"gradient for {no_grad[:6]}")
        if counts != [want_cell, (n * n_layers, n * n_layers, 0)]:
            fail(f"baseline train {at}: counts {counts}, expected the cell {want_cell} and "
                 f"the cgMLP {n_layers} times per step forward and backward")
        add_counts(kernel_rows, "baseline_train",
                   {"summary_mixing": counts[0][::2], "csgu": counts[1][::2]})
    print(f"baseline train: regularMHA's median step over SummaryMixing's "
          f"{ms['regularMHA'] / ms['SummaryMixing']:.3f}")
    del runs
    torch.cuda.empty_cache()


def phase_baselines_conformer(kernel_rows, stats, wav, lens):
    """Phase 24 (d): the transducer recipe's Conformer with RelPosMHAXL at
    nhead 4: offline greedy on request 0, check (a) (streamed chunk by
    chunk against the offline DCT encode, float32, TF32 off), and the
    causal form offline. No hand-written kernel lies on this path."""
    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype
    from summarymixing_tpu_torch.transcribe import transducer_greedy_transcribe

    kernels = zero_counts()
    for causal in (False, True):
        cfg = transducer_config()
        cfg.model.attention_type, cfg.model.nhead, cfg.model.causal = "RelPosMHAXL", 4, causal
        model, fbank, td = build_model(cfg)
        n_params = sum(p.numel() for p in model.parameters()) + sum(
            p.numel() for p in td.parameters())
        transducer_greedy_transcribe(model, td, fbank, stats, wav, lens)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps, out = transducer_greedy_transcribe(model, td, fbank, stats, wav, lens)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        enc = out["enc_out"]
        if not torch.isfinite(enc).all() or enc.shape[:2] != (BATCH, 751):
            fail(f"conformer RelPosMHAXL causal={causal}: encoder output "
                 f"{tuple(enc.shape)} not finite or not [8, 751, .]")
        line = (f"conformer RelPosMHAXL (nhead 4, causal {causal}): {n_params:,} parameters; "
                f"request 0 greedy transducer decode {ms:.2f} ms, tokens per row "
                f"{[len(x) for x in hyps]}")
        if not causal:
            set_compute_dtype(model, None)
            err = stream_vs_offline(model, fbank, stats, wav, lens)
            set_compute_dtype(model, torch.bfloat16)
            ok = err <= STREAM_TOL
            line += (f"; check (a) streamed chunks of {STREAM_CHUNK} with {STREAM_LEFT} of left "
                     f"context against the offline DCT encode, float32: {err:.3e} (tol "
                     f"{STREAM_TOL:.0e}) {'ok' if ok else 'FAILED'}")
        print(line)
        if not causal and not ok:
            fail("conformer RelPosMHAXL: chunked streaming disagrees with the offline DCT encode")
        del model, td
        torch.cuda.empty_cache()
    counts = read_counts(kernels)
    if counts != {"summary_mixing": (0, 0), "csgu": (0, 0)}:
        fail(f"conformer RelPosMHAXL: a kernel or its plain path ran: {counts}")


def phase_baselines_transformer(kernel_rows, stats, wav, lens):
    """Phase 24 (e): `encoder_module="transformer"`, 12 layers d512, with
    the full-mode SummaryMixing mixer (every cell launches the kernel)
    against its plain version, and with causal regularMHA: request 0
    greedy."""
    import torch

    from summarymixing_tpu_torch.config import build_model

    for at, causal in (("SummaryMixing", False), ("regularMHA", True)):
        cfg = baseline_config(at, encoder="transformer", layers=TRANSFORMER_LAYERS, causal=causal)
        model, fbank = build_model(cfg)
        n_params = sum(p.numel() for p in model.parameters())
        if n_params != TRANSFORMER_PARAMS[at]:
            fail(f"transformer {at}: parameter count {n_params:,} != "
                 f"{TRANSFORMER_PARAMS[at]:,} (flax's)")
        kernels = zero_counts()
        ms, hyps, out = timed_decodes(model, fbank, stats, wav, lens, BASELINE_DECODES)
        counts = read_counts(kernels)
        forwards = BASELINE_DECODES + 1
        print(f"transformer encoder {at} (nhead {cfg.model.nhead}, causal {causal}, "
              f"{TRANSFORMER_LAYERS} layers): {n_params:,} parameters; request 0 greedy "
              f"{ms:.2f} ms median of {BASELINE_DECODES}; (launches, plain calls) {counts} over "
              f"{forwards} forwards")
        if at == "SummaryMixing":
            if counts != {"summary_mixing": (forwards * TRANSFORMER_LAYERS, 0), "csgu": (0, 0)}:
                fail(f"transformer {at}: counts {counts}, expected the cell kernel "
                     f"{TRANSFORMER_LAYERS} times per forward, no plain call and no cgMLP")
            phase_plain_path(model, fbank, stats, [(None, wav, lens)], [(0.0, 0.0, out, hyps)])
        elif counts != {"summary_mixing": (0, 0), "csgu": (0, 0)}:
            fail(f"transformer {at}: a kernel or its plain path ran: {counts}")
        add_counts(kernel_rows, "transformer_encoder", counts)
        del model
        torch.cuda.empty_cache()


def phase_baselines(kernel_rows) -> None:
    """Phase 24: the paper's self-attention and HyperMixer baselines."""
    stats = seeded_norm_stats()
    wav, lens = request0(16000)
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    mha = phase_baselines_decode(kernel_rows, stats, wav, lens)
    print(f"phase 24 (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_baselines_sweep(kernel_rows, stats, mha)
    del mha
    print(f"phase 24 (b): {time.perf_counter() - t0:.1f} s")
    for label, fn in (("c", lambda: phase_baselines_train(kernel_rows)),
                      ("d", lambda: phase_baselines_conformer(kernel_rows, stats, wav, lens)),
                      ("e", lambda: phase_baselines_transformer(kernel_rows, stats, wav, lens))):
        t0 = time.perf_counter()
        fn()
        print(f"phase 24 ({label}): {time.perf_counter() - t0:.1f} s")
    print(f"phase 24 (the paper's baselines): {time.perf_counter() - t_all:.1f} s wall")


def phase_split_kernels(kernel_rows) -> None:
    """The kernels at phase 25's shapes against their plain versions: the
    cell's split route (`sm_partial` on each of two time shards of B=8,
    T=751, the sums and counts added, `sm_finish` on each) and the cgMLP
    on a shard extended by 15 halo frames each side (T/2 + 30 = 406
    frames), into the kernels' rows under `split_route` and `halo_route`."""
    import torch

    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2525)
    b, t, d, c2, k = BATCH, max(LENGTHS), 512, 3072, 31
    bf = torch.bfloat16

    def w(*shape, scale=None, dtype=bf):
        s = scale if scale is not None else (shape[-1] if len(shape) > 1 else 512) ** -0.5
        return ((torch.rand(*shape, generator=g, device=dev) * 2 - 1) * s).to(dtype)

    x = torch.randn(b, t, d, generator=g, device=dev).to(bf)
    lens = torch.tensor(LENGTHS, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).to(torch.float32)
    pad = mask[..., None].contiguous()
    merge = w(d, 2 * d)
    cell = (w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1),
            w(d, d), w(d, scale=0.1), merge[:, :d], merge[:, d:], w(d, scale=0.1))
    half = -(-t // P25_RANKS)
    shards = [(x[:, i:i + half].contiguous(), pad[:, i:i + half].contiguous())
              for i in range(0, t, half)]

    def split(partial, finish):
        parts = [partial(xs, ps, cell, "gelu") for xs, ps in shards]
        total = sum(p[0] for p in parts)
        count = sum(p[1] for p in parts)
        return torch.cat([finish(p[2], ps, total, count, cell, "gelu", bf)
                          for p, (_, ps) in zip(parts, shards)], dim=1)

    got = split(fused_summary.fused_summary_partial, fused_summary.fused_summary_finish)
    want = split(fused_summary.summary_partial_reference,
                 lambda pre, _, total, count, *rest: fused_summary.summary_finish_reference(
                     pre, total, count, *rest))
    whole = fused_summary.fused_summary_mixing(x, pad, cell, "gelu")
    torch.cuda.synchronize()
    abs_err, err = rel_err(got, want)
    _, err_whole = rel_err(got, whole)
    ok = err <= CELL_TOL and err_whole <= CELL_TOL
    print(f"kernel summary_mixing split route (2 shards of B={b}, T={t}): max_abs_err "
          f"{abs_err:.3e} max_rel_err {err:.3e} against the plain split, {err_whole:.3e} against "
          f"the whole-T kernel, tol {CELL_TOL:.3e} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("the cell's split route disagrees with its plain version")
    xs0, ps0 = shards[0]
    pre0 = fused_summary.fused_summary_partial(xs0, ps0, cell, "gelu")
    one = lambda: fused_summary.fused_summary_finish(  # noqa: E731
        fused_summary.fused_summary_partial(xs0, ps0, cell, "gelu")[2], ps0, pre0[0], pre0[1],
        cell, "gelu", bf)
    ms = graph_ms(one)
    plain_ms = cuda_ms(lambda: fused_summary.summary_finish_reference(
        fused_summary.summary_partial_reference(xs0, ps0, cell, "gelu")[2], pre0[0], pre0[1],
        cell, "gelu", bf))
    valid0 = int(ps0.sum())
    split_bound = bound(xs0.numel() * 2 + ps0.numel() * 4 + xs0.numel() * 2
                        + sum(v.numel() * 2 for v in cell) + 2 * b * d * 4,
                        2 * valid0 * d * d * 5 + 2 * b * d * d)
    print(f"kernel summary_mixing split route, shard 0 (B={b}, T={half}, {valid0} valid frames): "
          f"{ms:.4f} ms (graph, sm_partial + sm_finish), plain {plain_ms:.4f} ms, bound "
          f"{split_bound[0]:.4f} ms ({split_bound[1]})")

    branch = (w(c2, d), w(c2, scale=0.1, dtype=torch.float32),
              1.0 + w(c2 // 2, scale=0.1, dtype=torch.float32),
              w(c2 // 2, scale=0.1, dtype=torch.float32),
              w(k, c2 // 2, scale=k ** -0.5, dtype=torch.float32),
              1.0 + w(c2 // 2, scale=0.1, dtype=torch.float32),
              w(d, c2 // 2), w(d, scale=0.1, dtype=torch.float32))
    h = (k - 1) // 2
    xw = torch.cat([x.new_zeros(b, h, d), x[:, :half + h]], dim=1).contiguous()
    mw = torch.cat([mask.new_zeros(b, h), mask[:, :half + h]], dim=1).contiguous()
    got = fused_csgu.fused_convolution_branch(xw, mw, branch)[:, h:h + half]
    want = fused_csgu.convolution_branch_reference(x, mask, branch)[:, :half]
    torch.cuda.synchronize()
    c_abs, c_err = rel_err(got, want)
    ok = c_err <= CSGU_TOL
    print(f"kernel csgu halo route (B={b}, T={half} + {2 * h} halo frames): max_abs_err "
          f"{c_abs:.3e} max_rel_err {c_err:.3e} against the whole-T plain version's frames, tol "
          f"{CSGU_TOL:.3e} {'ok' if ok else 'FAILED'}")
    if not ok:
        fail("the cgMLP halo route disagrees with its plain version")
    c_ms = graph_ms(lambda: fused_csgu.fused_convolution_branch(xw, mw, branch))
    c_plain = cuda_ms(lambda: fused_csgu.convolution_branch_reference(xw, mw, branch))
    m = b * xw.shape[1]
    halo_bound = bound(xw.numel() * 2 + mw.numel() * 4 + m * d * 2
                       + sum(v.numel() * v.element_size() for v in branch),
                       2 * m * d * c2 + 2 * m * (c2 // 2) * d, 2 * m * (c2 // 2) * k)
    print(f"kernel csgu halo route: {c_ms:.4f} ms (graph), plain {c_plain:.4f} ms, bound "
          f"{halo_bound[0]:.4f} ms ({halo_bound[1]})")
    kernel_rows["summary_mixing"]["split_route"] = dict(
        shape=f"B={b}, T={t} on {P25_RANKS} shards", max_abs_err=abs_err, ms=ms,
        plain_ms=plain_ms, bound_ms=split_bound[0], bound_by=split_bound[1])
    kernel_rows["csgu"]["halo_route"] = dict(
        shape=f"B={b}, T={half}+{2 * h}", max_abs_err=c_abs, ms=c_ms, plain_ms=c_plain,
        bound_ms=halo_bound[0], bound_by=halo_bound[1])


def p25_train_args(here: str, corpus: dict, out: str) -> list:
    sets = [a for kv in P25_SETTINGS for a in ("--set", kv)]
    return [os.path.join(here, FLAGSHIP_RECIPE), "--train-manifest", corpus["train"],
            "--valid-manifest", corpus["dev"], "--output", out, "--steps", str(P25_STEPS)] + sets


def p25_eval_args(here: str, corpus: dict, ckpt: str) -> list:
    sets = [a for kv in P25_SETTINGS for a in ("--set", kv)]
    return [os.path.join(here, FLAGSHIP_RECIPE), "--test-manifest", corpus["test"],
            "--ckpt", ckpt] + sets


def p25_counters() -> dict:
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    cell, branch = fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch
    return {"summary_mixing": {"launches": cell.launches, "plain_calls": cell.plain_calls,
                               "backwards": cell.backwards, "partial": cell.partial_launches,
                               "finish": cell.finish_launches},
            "csgu": {"launches": branch.launches, "plain_calls": branch.plain_calls,
                     "backwards": branch.backwards, "halo": branch.halo_launches}}


def p25_zero_counters() -> None:
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    for fn in (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch):
        for key in ("launches", "plain_calls", "backwards", "partial_launches",
                    "finish_launches", "halo_launches"):
            if hasattr(fn, key):
                setattr(fn, key, 0)


def p25_seq_decode(rank: int, ranks: int) -> dict:
    """(b), in each process: request 0 through the time-sharded greedy CTC
    decode, and the whole-T decode on this process for comparison."""
    import torch
    import torch.nn.functional as F

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.decoding.ctc import collapse_ctc, ctc_greedy_decode
    from summarymixing_tpu_torch.frontend.features import InputNormalization
    from summarymixing_tpu_torch.parallel import sequence

    cfg = flagship_config()
    model, fbank = build_model(cfg)
    model.eval()
    wav, lens = request0(cfg.features.sample_rate)
    rem = (-(1 + wav.shape[1] // fbank.hop_length)) % ranks
    wav = F.pad(wav, (0, rem * fbank.hop_length))
    with torch.no_grad():
        feats, _ = InputNormalization()(fbank(wav), seeded_norm_stats())
    feat_lens = fbank.frame_lengths(lens)
    mesh = sequence.make_seq_mesh(n_data=1, n_seq=ranks, device="cuda")
    decode = sequence.sequence_parallel_ctc_decode(model, mesh)
    encode = sequence.sequence_parallel_encode(model, mesh)
    decode(feats, feat_lens)
    torch.cuda.synchronize()
    p25_zero_counters()
    t0 = time.perf_counter()
    ids, keep, enc_len = decode(feats, feat_lens)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1e3
    counts = p25_counters()

    def whole():
        with torch.no_grad():
            enc, out_len = model.encode(feats, feat_lens)
            return model.ctc_head(enc), out_len

    whole()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, out_len = whole()
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    w_ids, w_keep = ctc_greedy_decode(lp, out_len)
    enc_local, _ = encode(feats, feat_lens)
    with torch.no_grad():
        lp_local = model.ctc_head(enc_local)
    start = rank * -(-lp.shape[1] // ranks)
    pos = start + torch.arange(lp_local.shape[1], device=lp.device)
    valid = pos[None, :] < out_len[:, None]
    seg = lp[:, start:start + lp_local.shape[1]]
    dlogp = float((lp_local - seg).abs().amax(-1)[valid].max())
    frames = float((lp_local.argmax(-1) == seg.argmax(-1))[valid].float().mean())
    hyps, w_hyps = collapse_ctc(ids, keep), collapse_ctc(w_ids, w_keep)
    collectives = p25_collectives(lambda: decode(feats, feat_lens))
    return {"collectives": collectives, "frames": int(lp.shape[1]), "local_frames": int(lp_local.shape[1]),
            "lengths_equal": bool((enc_len == out_len).all()), "max_dlogp": dlogp,
            "frame_agree": frames, "same_rows": sum(a == b for a, b in zip(hyps, w_hyps)),
            "rows": len(hyps), "sharded_ms": sharded_ms, "whole_ms": whole_ms,
            "counts": counts}


def p25_collectives(decode) -> dict:
    """The collectives of one sharded decode (`decode()`): the all-reduces
    and their bytes as the rise of `parallel.comm.COLLECTIVES`, the
    all-gathers counted by wrapping `comm.all_gather_rows`; and each kind
    timed alone between the two processes: the flagship's gradient
    all-reduce (float32, as many values as its trainable parameters with
    the decoder), one cell's `[8, 512]` sums and `[8]` counts, and one
    cgMLP halo exchange (`[1, 8, 30, 512]` bf16 edges)."""
    import torch
    import torch.distributed as dist

    from summarymixing_tpu_torch.parallel import comm

    gathers = [0]
    real = comm.all_gather_rows

    def counted(*args, **kwargs):
        gathers[0] += 1
        return real(*args, **kwargs)

    before = dict(comm.COLLECTIVES)
    comm.all_gather_rows = counted
    try:
        decode()
    finally:
        comm.all_gather_rows = real
    calls = {"all_reduce_": comm.COLLECTIVES["calls"] - before["calls"],
             "all_reduce_bytes": comm.COLLECTIVES["bytes"] - before["bytes"],
             "all_gather_rows": gathers[0]}

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    grads = torch.zeros(FLAGSHIP_TRAIN_PARAMS, device="cuda")
    sums = torch.zeros(BATCH * 512 + BATCH, device="cuda")
    edges = torch.zeros(1, BATCH, 30, 512, dtype=torch.bfloat16, device="cuda")
    return {"per_decode": calls, "grad_allreduce_ms": timed(lambda: comm.all_reduce_(grads), 3),
            "sum_allreduce_ms": timed(lambda: comm.all_reduce_(sums), 20),
            "halo_allgather_ms": timed(lambda: comm.all_gather_rows(edges), 20)}


def p25_rank(rank: int, ranks: int, port: int, here: str, corpus: dict, root: str) -> None:
    """One of phase 25's `ranks` processes (started with `spawn`): (a) the
    train runner, (b) the time-sharded decode over every process, (c)
    `evaluate --seq-parallel P25_SEQ`; writes its results to
    `root/p25_rank<rank>.json`."""
    os.environ.update(SMT_COORDINATOR=f"127.0.0.1:{port}", SMT_NUM_PROCESSES=str(ranks),
                      SMT_PROCESS_ID=str(rank))
    sys.path.insert(0, here)
    import torch
    import torch.distributed as dist

    from summarymixing_tpu_torch.recipes import evaluate, train

    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank}
    p25_zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(p25_train_args(here, corpus, os.path.join(root, "p25_dist")))
    torch.cuda.synchronize()
    out["a"] = {"valid_loss": res["valid"]["loss"], "steps": res["steps"], "step_s": res["step_s"],
                "dist": res["dist"], "seconds": time.perf_counter() - t0,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "counts": p25_counters()}
    out["b"] = p25_seq_decode(rank, ranks)
    p25_zero_counters()
    summary = evaluate.main(p25_eval_args(here, corpus, os.path.join(root, "p25_dist", "save"))
                            + ["--seq-parallel", str(P25_SEQ)])
    out["c"] = {"WER": summary["WER"], "decode": summary["decode"],
                "seq_parallel": summary.get("seq_parallel"), "hyps": summary["hyps"],
                "utterances": summary["utterances"], "counts": p25_counters()}
    with open(os.path.join(root, f"p25_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_distributed(kernel_rows, here: str, corpus: dict, root: str,
                      ranks: int = P25_RANKS) -> None:
    """Phase 25: multi-process training and sequence-parallel decoding,
    `ranks` processes: two on the one card over gloo (NCCL refuses two
    processes on one device), or one per card (`--processes N`)."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from summarymixing_tpu_torch.config import load_recipe
    from summarymixing_tpu_torch.data.batching import DynamicBucketBatcher
    from summarymixing_tpu_torch.data.dataio import read_manifest_csv
    from summarymixing_tpu_torch.recipes import common, evaluate, train

    t_all = time.perf_counter()
    phase_split_kernels(kernel_rows)
    single, counts_1, secs_1, peak_1 = run_stage(
        "p25 single-process train", train.main,
        p25_train_args(here, corpus, os.path.join(root, "p25_single")))
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    # spawn: CUDA cannot fork; the kernels are already built (phase 2)
    ctx = mp.start_processes(p25_rank, args=(ranks, port, here, corpus, root), nprocs=ranks,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + P25_TIMEOUT
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for proc in ctx.processes:
                proc.kill()
            fail(f"phase 25: the {ranks} processes did not finish in {P25_TIMEOUT} s")
    spawn_s = time.perf_counter() - t0
    procs = []
    for r in range(ranks):
        with open(os.path.join(root, f"p25_rank{r}.json")) as f:
            procs.append(json.load(f))
    n_layers = 18
    # (a)
    cfg = load_recipe(os.path.join(here, FLAGSHIP_RECIPE),
                      overrides=common.parse_overrides(list(P25_SETTINGS)))
    dev = read_manifest_csv(corpus["dev"])
    lengths, buckets = common.build_buckets(dev, cfg, valid=True, batch_multiple=ranks)
    n_valid = DynamicBucketBatcher(lengths, buckets, shuffle=False, drop_last=False).num_batches()
    want = n_layers * (P25_STEPS + n_valid)
    losses = [rk["a"]["valid_loss"] for rk in procs]
    base = single["valid"]["loss"]
    rel = abs(losses[0] - base) / abs(base)
    for rk in procs:
        a = rk["a"]
        print(f"p25 (a) rank {rk['rank']}: {a['dist']}, valid loss {a['valid_loss']:.8f}, "
              f"{step_ms(a['step_s'])}, peak memory {a['peak_gib']:.2f} GiB, counts {a['counts']}")
    spread = max(losses) - min(losses)
    print(f"p25 (a) single process: valid loss {base:.8f}, {step_ms(single['step_s'])}, peak "
          f"memory {peak_1:.2f} GiB; the processes differ by {spread:.3e} (tol "
          f"{P25_RANK_AGREE:g}), against the single run {rel:.3e} relative (tol "
          f"{TRAIN_LOSS_TOL:g}); {n_valid} validation batches; "
          + ("two processes on one card: a correctness run, not a scaling number"
             if torch.cuda.device_count() < ranks else f"{ranks} cards"))
    if spread > P25_RANK_AGREE or rel > TRAIN_LOSS_TOL:
        fail("phase 25 (a): the processes disagree with each other or with the single run")
    for rk in procs:
        c = rk["a"]["counts"]
        got = [(c[k]["launches"], c[k]["plain_calls"], c[k]["backwards"]) for k in c]
        if (rk["a"]["steps"] != P25_STEPS or rk["a"]["dist"]["processes"] != ranks
                or got != [(want, 0, n_layers * P25_STEPS)] * 2):
            fail(f"phase 25 (a) rank {rk['rank']}: steps {rk['a']['steps']}, counts {c}, "
                 f"expected {want} launches and {n_layers * P25_STEPS} backwards each")
    dist_dir = os.path.join(root, "p25_dist")
    files = {name: os.path.exists(os.path.join(dist_dir, name))
             for name in ["train_log.txt", "save"] + [f"train_log.p{r}.txt"
                                                      for r in range(1, ranks)]}
    print(f"p25 (a) one-writer files: {files}; save steps "
          f"{sorted(os.listdir(os.path.join(dist_dir, 'save')))}")
    if not all(files.values()):
        fail(f"phase 25 (a): one-writer files {files}")
    # (b)
    for rk in procs:
        bb = rk["b"]
        cs, cc = bb["counts"]["summary_mixing"], bb["counts"]["csgu"]
        ok = (bb["lengths_equal"] and bb["max_dlogp"] <= PATH_LOGP_TOL
              and bb["frame_agree"] >= PATH_FRAME_AGREE)
        print(f"p25 (b) rank {rk['rank']}: T'={bb['frames']} ({bb['local_frames']} here), max "
              f"|dlogp| {bb['max_dlogp']:.4f} (tol {PATH_LOGP_TOL}), frame agreement "
              f"{bb['frame_agree']:.4f} (tol >= {PATH_FRAME_AGREE}), identical rows "
              f"{bb['same_rows']}/{bb['rows']}, sharded {bb['sharded_ms']:.2f} ms, whole-T "
              f"{bb['whole_ms']:.2f} ms, launches {cs['launches']} + {cc['launches']}: sm_partial "
              f"{cs['partial']}, sm_finish {cs['finish']}, halo cgMLP {cc['halo']}, plain calls "
              f"{cs['plain_calls']} + {cc['plain_calls']} "
              f"{'ok' if ok else 'FAILED'}")
        print(f"p25 (b) rank {rk['rank']}: collectives {bb['collectives']}")
        per = bb["collectives"]["per_decode"]
        if per["all_reduce_"] < n_layers or per["all_reduce_bytes"] <= 0:
            fail(f"phase 25 (b) rank {rk['rank']}: comm.COLLECTIVES rose by {per} in one "
                 f"sharded decode, expected at least one all-reduce per layer ({n_layers})")
        if not ok:
            fail("phase 25 (b): the sharded decode disagrees with the whole-T decode")
        if (cs["launches"], cs["partial"], cs["finish"], cc["launches"], cc["halo"],
                cs["plain_calls"], cc["plain_calls"]) != (
                2 * n_layers, n_layers, n_layers, n_layers, n_layers, 0, 0):
            fail(f"phase 25 (b) rank {rk['rank']}: counts {bb['counts']}, expected "
                 f"{n_layers} of each route and no plain call")
    # (c)
    ref, counts_r, secs_r, peak_r = run_stage(
        "p25 single-process evaluate greedy", evaluate.main,
        p25_eval_args(here, corpus, os.path.join(dist_dir, "save")))
    # a witness of the batch shape alone: one process, the same checkpoint,
    # the data shard's rows per batch (half of them on one card)
    half_rows = P25_MAX_BATCH // max(2, ranks // P25_SEQ)
    half, counts_h, _, _ = run_stage(
        f"p25 single-process evaluate greedy, {half_rows}-row batches", evaluate.main,
        p25_eval_args(here, corpus, os.path.join(dist_dir, "save"))
        + ["--set", f"training.max_batch_ex={half_rows}"])
    c0 = procs[0]["c"]
    same = sum(ref["hyps"][u] == h for u, h in c0["hyps"].items())
    share = same / max(len(c0["hyps"]), 1)
    agree = all(rk["c"]["hyps"] == c0["hyps"] for rk in procs)
    flipped = sorted(u for u, h in c0["hyps"].items() if ref["hyps"][u] != h)
    flipped_h = sorted(u for u, h in half["hyps"].items() if ref["hyps"][u] != h)
    print(f"p25 (c) evaluate --seq-parallel {P25_SEQ} over {ranks} processes: WER "
          f"{c0['WER']:.2f} over "
          f"{c0['utterances']} utterances ({c0['decode']}, seq_parallel {c0['seq_parallel']}) "
          f"against the single process's {ref['WER']:.2f}; identical hypotheses {same}/"
          f"{len(c0['hyps'])} (tol >= {P25_ROW_AGREE}); the processes agree: {agree}; counts "
          f"{[rk['c']['counts'] for rk in procs]}")
    print(f"p25 (c) witness, one process: {half_rows}-row batches against "
          f"{P25_MAX_BATCH}-row ones, WER {half['WER']:.2f}, identical hypotheses "
          f"{len(half['hyps']) - len(flipped_h)}/{len(half['hyps'])}; rows that differ from "
          f"the {P25_MAX_BATCH}-row run: sharded {flipped}, {half_rows}-row {flipped_h}, both "
          f"{sorted(set(flipped) & set(flipped_h))}")
    if (c0["decode"] != "greedy_ctc_seq_parallel" or c0["seq_parallel"] != P25_SEQ
            or share < P25_ROW_AGREE or not agree or c0["utterances"] != ref["utterances"]):
        fail("phase 25 (c): the sharded evaluation disagrees with the single process")
    print(f"p25: backend {procs[0]['a']['dist']['backend']} on CUDA tensors (torch "
          f"{torch.__version__}); the {ranks} processes took {spawn_s:.1f} s; phase 25 "
          f"{time.perf_counter() - t_all:.1f} s wall")
    for name in ("summary_mixing", "csgu"):
        rows = kernel_rows[name]
        rows["launches_by_path"]["dist_train"] = counts_1[name][0] + sum(
            rk["a"]["counts"][name]["launches"] for rk in procs)
        rows["plain_calls_by_path"]["dist_train"] = counts_1[name][1] + sum(
            rk["a"]["counts"][name]["plain_calls"] for rk in procs)
        rows["launches_by_path"]["seq_parallel"] = sum(
            rk["b"]["counts"][name]["launches"] for rk in procs)
        rows["plain_calls_by_path"]["seq_parallel"] = 0
        rows["launches_by_path"]["seq_parallel_runner"] = counts_r[name][0] + counts_h[name][
            0] + sum(rk["c"]["counts"][name]["launches"] for rk in procs)
        rows["plain_calls_by_path"]["seq_parallel_runner"] = counts_r[name][1] + counts_h[name][
            1] + sum(rk["c"]["counts"][name]["plain_calls"] for rk in procs)


def phase_w8a8(kernel_rows) -> None:
    """Phase 26 (a): the int8 product on the card against the CPU route at
    the flagship cgMLP shapes, and request 0's greedy decode with
    `model.act_int8` beside the bf16 decode."""
    import dataclasses

    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary, quant
    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    t0 = time.perf_counter()
    g = torch.Generator()
    g.manual_seed(26)
    rows = BATCH * max(LENGTHS)
    for k, n in ((512, 3072), (1536, 512)):
        x = torch.randn(rows, k, generator=g) * 2.0
        w = torch.randn(n, k, generator=g) * 0.05
        qa, _ = quant.quantize_act(x)
        qw, _ = quant.quantize_weight(w)
        cpu = quant.int8_accumulate(qa, qw)
        qa_c, qw_c = qa.cuda(), qw.cuda()
        qw_nn = qw_c.t().contiguous()
        card = quant.int8_accumulate(qa_c, qw_c).cpu()
        exact = bool(torch.equal(card, cpu)) and bool(
            torch.equal(torch._int_mm(qa_c, qw_nn).cpu(), cpu))
        # the port's layout (the cached [N, K] weight's transposed view, TN)
        # beside a row-major [K, N] copy (NN)
        int_ms = graph_ms(lambda: torch._int_mm(qa_c, qw_c.t()))
        nn_ms = graph_ms(lambda: torch._int_mm(qa_c, qw_nn))
        xb, wb = x.to(torch.bfloat16).cuda(), w.to(torch.bfloat16).cuda()
        bf_ms = graph_ms(lambda: torch.nn.functional.linear(xb, wb))
        ops = 2.0 * rows * k * n
        print(f"p26 (a) int8 product [{rows}, {k}] x [{k}, {n}]: card accumulators equal the "
              f"CPU route's in both layouts: {exact}; torch._int_mm with the weight "
              f"[{n}, {k}] transposed (TN, the port's) {int_ms:.4f} ms "
              f"({ops / int_ms / 1e9:.1f} TOPS), with a row-major [{k}, {n}] copy (NN) "
              f"{nn_ms:.4f} ms ({ops / nn_ms / 1e9:.1f} TOPS), the bf16 product {bf_ms:.4f} ms "
              f"({ops / bf_ms / 1e9:.1f} TFLOP/s) (CUDA graph)")
        if not exact:
            fail("phase 26 (a): the card's int8 accumulators differ from the CPU route's")

    cfg = flagship_config()
    cfg8 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, act_int8=True))
    model, fbank = build_model(cfg)
    model8, _ = build_model(cfg8)
    same = all(torch.equal(a, b) for a, b in zip(model.parameters(), model8.parameters()))
    if not same:
        fail("phase 26 (a): the act_int8 model's weights differ from the bf16 model's")
    wav, lens = request0(cfg.features.sample_rate)
    stats = seeded_norm_stats()
    cell, branch = fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch

    def w8a8_decode():
        """One W8A8 decode with the counters at 0 before it: (hyps, out,
        the counts it read)."""
        cell.launches = cell.plain_calls = branch.launches = branch.plain_calls = 0
        branch.int8_calls = 0
        result = greedy_ctc_decode(model8, fbank, stats, wav, lens)
        return (*result, (cell.launches, cell.plain_calls, branch.launches, branch.plain_calls,
                          branch.int8_calls))

    with torch.inference_mode():
        greedy_ctc_decode(model, fbank, stats, wav, lens)
        # every W8A8 decode below is counted, the warm-up included
        per_decode = [w8a8_decode()[2]]
        hyps8, out8, counts = w8a8_decode()
        per_decode.append(counts)
        hyps, out = greedy_ctc_decode(model, fbank, stats, wav, lens)
        times = {"bf16": [], "w8a8": []}
        for _ in range(P26_DECODES):
            for name in ("bf16", "w8a8"):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if name == "bf16":
                    greedy_ctc_decode(model, fbank, stats, wav, lens)
                else:
                    per_decode.append(w8a8_decode()[2])
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t1) * 1e3)
    lp, lp8 = out["ctc_log_probs"], out8["ctc_log_probs"]
    n_layers = cfg.model.num_encoder_layers
    valid = torch.arange(lp.shape[1], device=lp.device)[None, :] < out["enc_lengths"][:, None]
    frames = float((lp.argmax(-1) == lp8.argmax(-1))[valid].float().mean())
    tokens = sum(a == b for h, h8 in zip(hyps, hyps8) for a, b in zip(h, h8))
    n_tok = sum(max(len(h), len(h8)) for h, h8 in zip(hyps, hyps8))
    print(f"p26 (a) request 0 greedy, W8A8 cgMLP: per forward cell launches {counts[0]}, cgMLP "
          f"launches {counts[2]}, int8_calls {counts[4]}, plain calls {counts[1]} + "
          f"{counts[3]}; {np.median(times['w8a8']):.2f} ms median "
          f"({', '.join(f'{t:.2f}' for t in times['w8a8'])}) against bf16 "
          f"{np.median(times['bf16']):.2f} ms ({', '.join(f'{t:.2f}' for t in times['bf16'])}), "
          f"in turns; agreement with the bf16 decode (random weights, reported, not gated): "
          f"greedy frames {frames:.4f}, tokens {tokens}/{n_tok}, identical rows "
          f"{sum(a == b for a, b in zip(hyps, hyps8))}/{len(hyps)}, max |dlogp| "
          f"{float((lp - lp8).abs().amax(-1)[valid].max()):.4f}; finite "
          f"{bool(torch.isfinite(lp8).all())}")
    want = (n_layers, 0, 0, 0, n_layers)
    print(f"p26 (a) counts read in each of the {len(per_decode)} W8A8 decodes (cell launches, "
          f"cell plain, cgMLP launches, cgMLP plain, int8 calls): {per_decode}")
    if any(c != want for c in per_decode) or not torch.isfinite(lp8).all():
        fail(f"phase 26 (a): W8A8 decode counts {per_decode}, each expected {want} (cell "
             f"launches, cell plain, cgMLP launches, cgMLP plain, int8 calls)")
    for name, (k_launch, k_plain) in (("summary_mixing", (0, 1)), ("csgu", (2, 3))):
        kernel_rows[name]["launches_by_path"]["w8a8"] = sum(c[k_launch] for c in per_decode)
        kernel_rows[name]["plain_calls_by_path"]["w8a8"] = sum(c[k_plain] for c in per_decode)
    kernel_rows["csgu"]["int8_calls_w8a8"] = sum(c[4] for c in per_decode)
    del model, model8
    torch.cuda.empty_cache()
    print(f"p26 (a): {time.perf_counter() - t0:.1f} s wall")


def p26_trainer(mesh=None, rule=None):
    """The flagship with its decoder, dropout 0 and no augmentation (phase
    25's settings), and its `ASRTrainer` on `mesh` under `rule`."""
    import dataclasses

    from summarymixing_tpu_torch.config import build_model, build_trainer

    cfg = flagship_config(decoder_layers=6)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, transformer_dropout=0.0))
    model, fbank = build_model(cfg)
    plain = build_trainer(cfg, model, fbank)
    config = dataclasses.replace(plain.config, augment=None, speed_perturb=False)
    trainer = type(plain)(model, plain.optimizer, fbank, config, mesh=mesh,
                          param_sharding_fn=rule)
    return cfg, model, trainer


def p26_steps(trainer, state, batch) -> tuple:
    """P26_STEPS train steps: (losses, ms per step)."""
    import torch

    losses, ms = [], []
    for _ in range(P26_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        if metrics["nonfinite_skipped"]:
            fail(f"phase 26: a sharded step was skipped, loss {losses[-1]}")
    return losses, ms


def p26_pipeline(rank: int) -> dict:
    """(c), on processes 0 and 1: the flagship encoder's 18 layers in two
    stages, 4 microbatches of request 0's shapes (B=8, T=751)."""
    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
    from summarymixing_tpu_torch.parallel import pipeline

    mesh = pipeline.make_pipeline_mesh(1, P26_STAGES, devices=list(range(P26_STAGES)),
                                       device="cuda")
    if mesh.get_coordinate() is None:
        return {}
    cfg = flagship_config()
    model, _ = build_model(cfg)
    enc = model.asr.encoder
    enc.eval()
    g = torch.Generator(device="cuda")
    g.manual_seed(261)
    x = torch.randn(BATCH, max(LENGTHS), 512, generator=g, device="cuda")
    pad = (torch.arange(max(LENGTHS), device="cuda")[None, :]
           < torch.tensor(LENGTHS, device="cuda")[:, None]).float()
    encode = pipeline.pipeline_branchformer_encode(enc, mesh, P26_MICRO)
    stage = pipeline.stacked_params(enc, stage_of=mesh)
    with torch.no_grad():
        encode(stage, x, None, pad)
        torch.cuda.synchronize()
        cell, branch = fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch
        cell.launches = cell.plain_calls = branch.launches = branch.plain_calls = 0
        t0 = time.perf_counter()
        out = encode(stage, x, None, pad)
        torch.cuda.synchronize()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        counts = [cell.launches, branch.launches, cell.plain_calls, branch.plain_calls]
        mbs = list(zip(x.chunk(P26_MICRO), pad.chunk(P26_MICRO)))
        torch.cat([enc(xm, None, pm) for xm, pm in mbs])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = torch.cat([enc(xm, None, pm) for xm, pm in mbs])
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
    # one backward: a fixed random projection of the output
    w = torch.randn(out.shape, generator=g, device="cuda") / 512 ** 0.5
    leaves = {k: v.detach().requires_grad_() for k, v in stage["layers"].items()}
    norm = {k: v.detach().requires_grad_() for k, v in stage["norm"].items()}
    (encode({"layers": leaves, "norm": norm}, x, None, pad).float() * w).sum().backward()
    for p in enc.parameters():
        p.grad = None
    sum(((enc(xm, None, pm).float() * wm).sum() for (xm, pm), wm in zip(mbs, w.chunk(P26_MICRO))),
        torch.zeros((), device="cuda")).backward()
    per = cfg.model.num_encoder_layers // P26_STAGES
    errs = []
    for name, gp in leaves.items():
        for j in range(per):
            ref = dict(getattr(enc, f"layer_{rank * per + j}").named_parameters())[name].grad
            errs.append(float((gp.grad[j] - ref).norm()) / max(float(ref.norm()), 1e-30))
    for name, gp in norm.items():
        ref = dict(enc.norm.named_parameters())[name].grad
        errs.append(float((gp.grad - ref).norm()) / max(float(ref.norm()), 1e-30))
    return {"equal": bool(torch.equal(out, seq)), "counts": counts, "pipe_ms": pipe_ms,
            "seq_ms": seq_ms, "grad_err": max(errs), "grad_tensors": len(errs),
            "finite": bool(torch.isfinite(out).all())}


def p26_rank(rank: int, ranks: int, port: int, here: str, root: str) -> None:
    """One of phase 26's processes (started with `spawn`): (b) three
    training steps under each grid it belongs to, then (c) the pipeline
    on processes 0 and 1; writes `root/p26_rank<rank>.json`."""
    os.environ.update(SMT_COORDINATOR=f"127.0.0.1:{port}", SMT_NUM_PROCESSES=str(ranks),
                      SMT_PROCESS_ID=str(rank))
    sys.path.insert(0, here)
    import torch
    import torch.distributed as dist

    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
    from summarymixing_tpu_torch.parallel import launch
    from summarymixing_tpu_torch.parallel import mesh as meshes

    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    launch.initialize(device="cuda")
    batch = training_batch()
    out = {"rank": rank, "backend": launch.backend()}
    cell, branch = fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch
    for rule_name, n_data, n_model in P26_GRIDS:
        if n_data * n_model > ranks:
            continue
        mesh = meshes.make_mesh(n_data, n_model, devices=list(range(n_data * n_model)),
                                device="cuda")
        if mesh.get_coordinate() is None:
            continue
        rule = {"fsdp": meshes.fsdp_param_sharding, "tp": meshes.tensor_parallel_param_sharding,
                "composite": meshes.composite_param_sharding}[rule_name](mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, model, trainer = p26_trainer(mesh, rule)
        state = trainer.init_state(3407)
        local = meshes.shard_batch(batch, mesh)
        for fn in (cell, branch):
            fn.launches, fn.plain_calls, fn.backwards = 0, 0, 0
        losses, ms = p26_steps(trainer, state, local)
        moments = state["opt_state"]["mu"]
        out[rule_name] = {
            "losses": losses, "ms": ms, "rows": int(local["wav"].shape[0]),
            "param_share": trainer.shards.held_share(),
            "moment_share": sum(m.to_local().numel() for m in moments)
            / sum(p.numel() for p in trainer.params),
            "sharded_leaves": sum(any(type(p).__name__ == "Shard" for p in d.placements)
                                  for d in state["params"].values()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "counts": [cell.launches, branch.launches, cell.backwards, branch.backwards,
                       cell.plain_calls, branch.plain_calls]}
        del model, trainer, state
    for fn in (cell, branch):
        fn.launches, fn.plain_calls = 0, 0
    torch.cuda.empty_cache()
    out["pipeline"] = p26_pipeline(rank)
    with open(os.path.join(root, f"p26_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def p26_spawn(ranks: int, here: str, root: str) -> list:
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.start_processes(p26_rank, args=(ranks, port, here, root), nprocs=ranks,
                             join=False, start_method="spawn")
    deadline = time.perf_counter() + P26_TIMEOUT
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for proc in ctx.processes:
                proc.kill()
            fail(f"phase 26: the {ranks} processes did not finish in {P26_TIMEOUT} s")
    procs = []
    for r in range(ranks):
        with open(os.path.join(root, f"p26_rank{r}.json")) as f:
            procs.append(json.load(f))
    return procs


def phase_sharded_kernel_shapes(kernel_rows) -> None:
    """Phase 26, before (b) and (c): both kernels against their plain
    versions at the shapes the new paths give them, with no keep-mask:
    each pipeline microbatch [B/M, T, 512] of request 0's lengths, and each
    sharded process's rows at the training T (8 rows for FSDP 2x1 and
    composite 2x2, 16 for TP 1x2, at dropout 0). The forward within phase
    3's tolerances; the autograd Functions' gradients as phase 3 holds them
    with a mask (`function_grads_ok`)."""
    import torch

    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

    dev = torch.device("cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    g = torch.Generator(device=dev)
    g.manual_seed(2626)
    d, c2, k = 512, 3072, 31
    c = c2 // 2

    def w(*shape, scale=None):
        s_ = scale if scale is not None else (shape[-1] if len(shape) > 1 else 512) ** -0.5
        return (torch.rand(*shape, generator=g, device=dev) * 2 - 1) * s_

    merge = w(d, 2 * d)
    cell = (w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1), w(d, d), w(d, scale=0.1),
            w(d, d), w(d, scale=0.1), merge[:, :d], merge[:, d:], w(d, scale=0.1))
    branch = (w(c2, d), w(c2, scale=0.1), 1.0 + w(c, scale=0.1), w(c, scale=0.1),
              w(k, c, scale=k ** -0.5), 1.0 + w(c, scale=0.1), w(d, c), w(d, scale=0.1))
    micro = BATCH // P26_MICRO
    shapes = [(f"pipeline microbatch {i}", LENGTHS[i * micro:(i + 1) * micro], max(LENGTHS))
              for i in range(P26_MICRO)]
    # (b)'s batch: the encoder frames of its utterances, padded to the longest
    train = [encoder_frames(int(n)) for n in training_batch()["wav_lens"].tolist()]
    half = TRAIN_BATCH // 2
    shapes += [("FSDP/composite data index 0", train[:half], max(train)),
               ("FSDP/composite data index 1", train[half:], max(train)),
               ("TP", train, max(train))]
    results = []
    for label, lengths, t in shapes:
        b = len(lengths)
        x = torch.randn(b, t, d, generator=g, device=dev).to(torch.bfloat16)
        mask = (torch.arange(t, device=dev)[None, :]
                < torch.tensor(lengths, device=dev)[:, None]).to(torch.float32)
        pad = mask[..., None].contiguous()
        g_out = torch.randn(b, t, d, generator=g, device=dev).to(torch.bfloat16)
        specs = (
            ("summary_mixing", cell, CELL_TOL,
             lambda xx, ws: fused_summary.fused_summary_mixing(xx, pad, ws, "gelu"),
             lambda xx, ws: fused_summary.summary_mixing_reference(
                 xx, pad, fused_summary.kernel_weights(ws), "gelu")),
            ("csgu", branch, CSGU_TOL,
             lambda xx, ws: fused_csgu.fused_convolution_branch(xx, mask, ws),
             lambda xx, ws: fused_csgu.convolution_branch_reference(
                 xx, mask, fused_csgu.kernel_weights(ws))))
        for name, weights, tol, kern, plain in specs:
            outs = []
            for fn in (kern, plain):
                xx = x.detach().requires_grad_()
                ws = [v.detach().requires_grad_() for v in weights]
                out = fn(xx, ws)
                outs.append((out.detach(), torch.autograd.grad(out, [xx] + ws, g_out)))
            torch.cuda.synchronize()
            abs_err, err = rel_err(outs[0][0], outs[1][0])
            grad_ok, grad_note = function_grads_ok(
                name, outs[0][1], outs[1][1],
                lambda: fused_csgu.convolution_branch_backward_reference(
                    g_out, x, mask, fused_csgu.kernel_weights(branch)))
            ok = err <= tol and grad_ok
            print(f"p26 kernel shapes: {name} {label} [{b}, {t}, {d}], no keep-mask: "
                  f"max_abs_err {abs_err:.3e} max_rel_err {err:.3e} tol {tol:.3e}; Function "
                  f"gradients {grad_note} {'ok' if ok else 'FAILED'}")
            if not ok:
                fail(f"phase 26: {name} disagrees with its plain version at {label} "
                     f"[{b}, {t}, {d}]")
            results.append((name, dict(shape=label, batch=b, frames=t, max_abs_err=abs_err,
                                       max_rel_err=err, grad_ok=grad_ok)))
    torch.backends.cudnn.deterministic = deterministic
    for name, row in results:
        kernel_rows[name].setdefault("p26_shapes", []).append(row)


def phase_sharded(kernel_rows, here: str, root: str, ranks: int = 4) -> None:
    """Phase 26 (b) and (c): the flagship training step under the three
    rules against one process, and the pipelined encoder, over `ranks`
    processes (4 on the one card over gloo, or one card each)."""
    import torch

    t0 = time.perf_counter()
    phase_sharded_kernel_shapes(kernel_rows)
    torch.backends.cudnn.deterministic = True
    batch = training_batch()
    single = {}
    for run in ("A", "B"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, model, trainer = p26_trainer()
        state = trainer.init_state(3407)
        kernels = zero_counts()
        losses, ms = p26_steps(trainer, state, batch)
        single[run] = {"losses": losses, "ms": ms,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "counts": [fn.launches for fn in kernels] + [fn.backwards for fn in kernels]
                       + [fn.plain_calls for fn in kernels]}
        del model, trainer, state
    torch.cuda.empty_cache()
    a, b = single["A"], single["B"]
    print(f"p26 (b) one process, {P26_STEPS} steps of phase 7's batch of {TRAIN_BATCH} (dropout "
          f"0, no augmentation): losses {['%.8f' % v for v in a['losses']]}, again "
          f"{['%.8f' % v for v in b['losses']]} (the same bits: {a['losses'] == b['losses']}); "
          f"{step_ms([m / 1e3 for m in a['ms']])}; peak memory {a['peak_gib']:.2f} GiB; "
          f"launches/backwards/plain {a['counts']}, again {b['counts']}")
    n_layers = 18
    if any(r["counts"] != [n_layers * P26_STEPS] * 4 + [0, 0] for r in (a, b)):
        fail("phase 26 (b): the one-process runs did not go through both kernels on every layer")
    t1 = time.perf_counter()
    procs = p26_spawn(ranks, here, root)
    spawn_s = time.perf_counter() - t1
    ok = True
    for rule_name, n_data, n_model in P26_GRIDS:
        runs = [(rk["rank"], rk[rule_name]) for rk in procs if rule_name in rk]
        if len(runs) != n_data * n_model:
            fail(f"phase 26 (b): {rule_name} ran on {len(runs)} processes")
        for r, res in runs:
            losses = res["losses"]
            rel = max(abs(x - y) / abs(y) for x, y in zip(losses, a["losses"]))
            bits = losses == a["losses"]
            counts_ok = res["counts"] == [n_layers * P26_STEPS] * 4 + [0, 0]
            share_ok = (round(res["param_share"], 4) == P26_SHARES[rule_name]
                        and round(res["moment_share"], 4) == P26_SHARES[rule_name])
            loss_ok = bits if rule_name == "tp" else rel <= P26_DP_TOL
            print(f"p26 (b) {rule_name} {n_data}x{n_model} rank {r} ({res['rows']} rows): losses "
                  f"{['%.8f' % v for v in losses]}, bit-equal to one process {bits}, max "
                  f"relative {rel:.3e}; parameter share {res['param_share']:.6f}, moment share "
                  f"{res['moment_share']:.6f} (want {P26_SHARES[rule_name]}), "
                  f"{res['sharded_leaves']} sharded leaves; "
                  f"{step_ms([m / 1e3 for m in res['ms']])}; "
                  f"peak memory {res['peak_gib']:.2f} GiB; launches/backwards/plain "
                  f"{res['counts']} {'ok' if loss_ok and counts_ok and share_ok else 'FAILED'}")
            ok = ok and loss_ok and counts_ok and share_ok
    if not ok:
        fail("phase 26 (b): a sharded run disagrees with one process, its shares or its counts")
    pipes = [rk["pipeline"] for rk in procs if rk["pipeline"]]
    bubble = P26_MICRO / (P26_MICRO + P26_STAGES - 1)
    for r, pp in enumerate(pipes):
        want = 9 * P26_MICRO
        good = (pp["equal"] and pp["finite"] and pp["counts"] == [want, want, 0, 0]
                and pp["grad_err"] <= P26_PIPE_GRAD_TOL)
        print(f"p26 (c) pipeline stage {r} of {P26_STAGES}, {P26_MICRO} microbatches of "
              f"[{BATCH // P26_MICRO}, {max(LENGTHS)}, 512]: output bit-equal to the sequential "
              f"encode of the same microbatches {pp['equal']}; launches cell/cgMLP "
              f"{pp['counts'][:2]} (want {want} each), plain {pp['counts'][2:]}; "
              f"{pp['pipe_ms']:.2f} ms against sequential {pp['seq_ms']:.2f} ms (wall); bubble "
              f"M/(M+S-1) = {bubble:.2f}; gradients max per-tensor relative L2 "
              f"{pp['grad_err']:.3e} over {pp['grad_tensors']} tensors (tol "
              f"{P26_PIPE_GRAD_TOL:g}) {'ok' if good else 'FAILED'}")
        if not good:
            fail("phase 26 (c): the pipelined encode disagrees with the sequential one")
    if len(pipes) != P26_STAGES:
        fail(f"phase 26 (c): {len(pipes)} pipeline stages reported")
    print(f"p26 (b, c): backend {procs[0]['backend']}; activations between stages staged "
          f"through host memory under gloo; the {ranks} processes took {spawn_s:.1f} s; "
          f"{time.perf_counter() - t0:.1f} s wall")
    for name, k in (("summary_mixing", 0), ("csgu", 1)):
        rows = kernel_rows[name]
        rows["launches_by_path"]["sharded_train"] = a["counts"][k] + b["counts"][k] + sum(
            rk[g[0]]["counts"][k] for rk in procs for g in P26_GRIDS if g[0] in rk)
        rows["plain_calls_by_path"]["sharded_train"] = (
            a["counts"][4 + k] + b["counts"][4 + k]
            + sum(rk[g[0]]["counts"][4 + k] for rk in procs for g in P26_GRIDS if g[0] in rk))
        rows["launches_by_path"]["pipeline"] = sum(pp["counts"][k] for pp in pipes)
        rows["plain_calls_by_path"]["pipeline"] = sum(pp["counts"][2 + k] for pp in pipes)


def phase_decoder_and_beam() -> None:
    """Phase 26 (d): a 6-layer d512 ConformerDecoder on the card against
    its CPU forward, and the uncached beam step against the cached one."""
    import copy
    import dataclasses

    import torch

    from summarymixing_tpu_torch.config import build_model
    from summarymixing_tpu_torch.decoding.s2s_beam import S2SBeamConfig
    from summarymixing_tpu_torch.evaluate import make_beam_step
    from summarymixing_tpu_torch.models import ConformerDecoder
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype
    from summarymixing_tpu_torch.utils.init import init_parameters

    t0 = time.perf_counter()
    dec = ConformerDecoder(**P26_DECODER)
    g = torch.Generator()
    g.manual_seed(262)
    init_parameters(dec, g)
    dec.eval()
    tgt = torch.randn(4, 60, 512, generator=g)
    mem = torch.randn(4, max(LENGTHS), 512, generator=g)
    pad = (torch.arange(max(LENGTHS))[None, :] < torch.tensor(LENGTHS[:4])[:, None]).float()
    with torch.no_grad():
        want = dec(tgt, mem, None, pad)
        card = copy.deepcopy(dec).cuda()
        got = card(tgt.cuda(), mem.cuda(), None, pad.cuda()).cpu()
        dec_ms = cuda_ms(lambda: card(tgt.cuda(), mem.cuda(), None, pad.cuda()), iters=5)
    err = float((got - want).abs().max()) / float(want.abs().max())
    print(f"p26 (d) ConformerDecoder {P26_DECODER}: {sum(p.numel() for p in dec.parameters()):,} "
          f"parameters, [4, 60] targets over [4, {max(LENGTHS)}] memory, float32 card against "
          f"CPU: max |d| / max |out| {err:.3e} (tol {P26_F32_TOL:g}); {dec_ms:.2f} ms on the card")
    if not err <= P26_F32_TOL:
        fail("phase 26 (d): the Conformer decoder on the card disagrees with the CPU")
    del dec, card
    cfg = flagship_config(decoder_layers=6)
    model, fbank = build_model(cfg)
    set_compute_dtype(model, None)
    model.eval()
    wav, lens = request0(cfg.features.sample_rate)
    from summarymixing_tpu_torch.frontend.features import InputNormalization

    b, beam, steps = 2, 4, 6
    with torch.no_grad():
        feats, _ = InputNormalization()(fbank(wav[:b]), seeded_norm_stats())
        enc, enc_len = model.encode(feats, fbank.frame_lengths(lens[:b]))
        other = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, decoder_attention_type="RelPosMHAXL"))
        bc = S2SBeamConfig(beam_size=beam, ctc_weight=0.4, max_length=steps, bos_id=1, eos_id=2)
        step, cache, _ = make_beam_step(other, model, enc, enc_len, beam, bc)
        c_step, c_cache, _ = make_beam_step(cfg, model, enc, enc_len, beam, bc)
        tok = torch.randint(3, cfg.model.output_neurons, (b * beam, steps + 1),
                            generator=torch.Generator().manual_seed(263)).cuda()
        tok[:, 0] = 1
        errs = []
        for pos in range(steps):
            lp = step(tok, pos)
            lp_c, c_cache = c_step(tok[:, pos], pos, c_cache)
            errs.append(float((lp - lp_c).abs().max()))
    print(f"p26 (d) uncached beam route (decode_position over the beam-tiled encoder output, "
          f"cache {cache}) against the cached step, flagship decoder in float32, B={b}, beam "
          f"{beam}, {steps} positions: max |dlogp| {max(errs):.3e} (tol {P26_F32_TOL:g}); "
          f"{time.perf_counter() - t0:.1f} s wall")
    if cache is not None or not max(errs) <= P26_F32_TOL:
        fail("phase 26 (d): the uncached beam step disagrees with the cached step")
    del model
    torch.cuda.empty_cache()


def phase_last_slice(kernel_rows, here: str, root: str) -> None:
    """Phase 26: W8A8, sharded training, the pipeline, the Conformer
    decoder and the uncached beam step."""
    t0 = time.perf_counter()
    phase_w8a8(kernel_rows)
    phase_sharded(kernel_rows, here, root)
    phase_decoder_and_beam()
    print(f"phase 26: {time.perf_counter() - t0:.1f} s wall")


def main_processes(n: int, smi: str, here: str) -> int:
    """`--processes N`: with N >= 4 phase 26 (b) and (c) over N processes,
    one card each (composite 2x2 over NCCL), then phase 25 alone with N
    processes, after the build; the same last lines as the whole
    script."""
    import torch

    if torch.cuda.device_count() < n:
        fail(f"--processes {n} needs {n} cards, found {torch.cuda.device_count()}")
    rows = {name: {"name": name, "launches_by_path": {}, "plain_calls_by_path": {}}
            for name in ("summary_mixing", "csgu")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as root:
        corpus = make_corpus(here, os.path.join(root, "corpus"))
        if n >= 4:
            phase_sharded(rows, here, root, ranks=n)
        phase_distributed(rows, here, corpus, root, ranks=n)
    print(json.dumps({"kernels": [rows["summary_mixing"], rows["csgu"]]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


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
    processes = 0
    if sys.argv[1:2] == ["--processes"] and len(sys.argv) == 3:
        processes = int(sys.argv[2])
    elif len(sys.argv) > 1:
        fail(f"usage: python3 chip_smoke.py [--processes N]; got {sys.argv[1:]}")
    smi = phase_device()
    phase_build()
    if processes:
        return main_processes(processes, smi, here)
    kernel_rows = phase_kernels()
    phase_masked_kernels(kernel_rows)
    phase_relpos_kernel(kernel_rows)
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
    phase_transducer_train(kernel_rows)
    phase_transducer_beam(kernel_rows)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as root:
        corpus = make_corpus(here, os.path.join(root, "corpus"))
        phase_runner_synthetic(kernel_rows, here, corpus, root)
        phase_runner_flagship(kernel_rows, here, corpus, root)
        phase_runner_transducer(kernel_rows, here, corpus, root)
        t_serve = time.perf_counter()
        phase_serving_kernels(kernel_rows)
        phase_serve(kernel_rows, here, root)
        torch.cuda.empty_cache()
        streaming = phase_streaming(kernel_rows)
        phase_export(kernel_rows, here, root, streaming)
        del streaming
        print(f"phases 17-20 (serving, streaming, export): "
              f"{time.perf_counter() - t_serve:.1f} s wall")
        torch.cuda.empty_cache()
        t_21 = time.perf_counter()
        phase_summary_decoder(kernel_rows, here)
        torch.cuda.empty_cache()
        phase_runner_aishell(kernel_rows, here, corpus, root)
        torch.cuda.empty_cache()
        phase_remat(kernel_rows)
        print(f"phase 21 (Summary Decoder, AISHELL-1 runner, remat): "
              f"{time.perf_counter() - t_21:.1f} s wall")
        torch.cuda.empty_cache()
        phase_reference_checkpoint(kernel_rows, here, root)
        torch.cuda.empty_cache()
        phase_modes_and_tooling(kernel_rows, here, corpus, root)
        torch.cuda.empty_cache()
        phase_distributed(kernel_rows, here, corpus, root)
        torch.cuda.empty_cache()
        phase_last_slice(kernel_rows, here, root)
    torch.cuda.empty_cache()
    phase_baselines(kernel_rows)
    for row in kernel_rows.values():
        row["launches"] = sum(row["launches_by_path"].values())
        row["plain_calls"] = sum(row["plain_calls_by_path"].values())
    print(f"wall {time.perf_counter() - wall0:.1f} s; nvidia-smi: {smi}")
    print(json.dumps({"kernels": [kernel_rows["summary_mixing"], kernel_rows["csgu"],
                                  kernel_rows["relpos_attention"]]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
