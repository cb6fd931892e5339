"""Word (or character) error rate of a trained recipe on a test manifest —
the port of the JAX package's `recipes/evaluate.py`, for CTC + attention
recipes and transducer recipes.

    python -m summarymixing_tpu_torch.recipes.evaluate recipes/Synthetic/hard_synthetic.yaml \\
        --test-manifest test.csv --ckpt RUN_DIR/save [--avg 10] [--beam [--nbest 3]] \\
        [--lm-ckpt LM_RUN_DIR] [--output EVAL_DIR] [--set decoding.lm_weight=0.2] [--device cpu]
    python -m summarymixing_tpu_torch.recipes.evaluate recipes/Synthetic/hard_synthetic_transducer.yaml \\
        --test-manifest test.csv --ckpt RUN_DIR/save [--beam [--lm-ckpt RNNLM_RUN_DIR]] \\
        [--streaming | --streaming-full] [--chunk-size 16] [--left-context 4]

The tokenizer is the one the training run wrote beside `--ckpt`. The
parameters are the latest checkpoint's, or the mean of the last `--avg`.
Greedy CTC runs through `ASRTrainer.eval_step`; `--beam` runs the joint
CTC/attention search at `test_beam_size` and `test_temperature` with the
KV-cached decoder (`evaluate.evaluate_beam`, batches wider than
`max_beam_rows` // beam searched in slices, one decode-length cap for the
run), and with `--lm-ckpt` the Transformer LM fused at `lm_weight`;
`--set decoding.ctc_blank_skip=0.95` has the CTC prefix scorer read a
blank-compacted lattice (`evaluate.maybe_compact_ctc`). A run directory
converted from a SpeechBrain checkpoint
(`recipes.convert_checkpoint`) evaluates as a trained one does.

A transducer recipe decodes through `TransducerTrainer.eval_step` (no
augmentation, no DCT): greedily (`transducer_greedy`); with `--beam` by
the batched beam search at `beam_size`, `state_beam` and `expand_beam`,
and with `--lm-ckpt` the RNNLM fused at `lm_weight`
(`transducer_beam`, `transducer_beam+lm`); with `--streaming` chunk by
chunk over the CNN output, `--chunk-size` encoder frames a chunk and
`--left-context` chunks of carried context, the greedy carry threaded
through (`evaluate.streaming_decode`: `transducer_streaming_greedy`, with
the chunks' p50 and p90 latency); with `--streaming-full` through the
raw-audio pipeline (`streaming.run_stream`:
`transducer_streaming_full_pipeline`, with the mean time per chunk of a
batch).

The last line of standard output is the summary as JSON: WER, SER, error
counts, utterances, wall_s, audio_s, rtf (wall over audio), the decode
(with `chunk_frames` and `left_context_chunks` when streaming) and
`kernels`, each kernel's launches and plain calls (cells or branches on
the card whose configuration it does not take) in the run; a CTC +
attention `--beam` adds `beam_steps` (search steps over all batches),
`search_s` and `ctc_frames` (the CTC scorer's largest time axis, smaller
with blank-skip); and with
`--nbest N` above 1 (with `--beam`) `nbest`: N. `--output` also gets it as
`eval.json`, with the per-utterance alignments in `wer_details.txt` (or
`cer_details.txt`) and, with `--nbest`, `nbest.jsonl`: one line per
utterance, `{"id", "nbest": [{"text", "score"}, ...]}`, score-sorted
(rank 0 is the hypothesis scored).

Several processes (`parallel/launch.py`: `SMT_COORDINATOR`,
`SMT_NUM_PROCESSES`, `SMT_PROCESS_ID`, one process per device): each
process decodes its rows of every batch and the rows are gathered, so
every process scores the whole set; process 0 prints the summary and
writes `--output`. `--seq-parallel N` (greedy CTC only) shards the
encoder's time axis over N processes instead (`parallel/sequence.py`):
N must divide the process count (the rest is a data axis over the
batch's rows); the waveforms are padded (not the features) so the frame
count divides N, every process of a seq group computes the features and
keeps its slice, and the decode is `greedy_ctc_seq_parallel` with
`seq_parallel`: N in the summary. One process with N > 1, a beam or a
transducer recipe are refused, as the JAX runner refuses them."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from summarymixing_tpu_torch.config import build_model, build_transducer_trainer, load_recipe
from summarymixing_tpu_torch.data.dataio import read_manifest_csv
from summarymixing_tpu_torch.data.subword import SubwordTokenizer
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer, SentencePieceTokenizer
from summarymixing_tpu_torch.decoding.ctc import collapse_ctc
from summarymixing_tpu_torch.evaluate import restore_eval_state, streaming_decode
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.parallel import launch, sequence
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.streaming import make_streaming_infer_fns, run_stream
from summarymixing_tpu_torch.training.trainer import ASRTrainer, TrainerConfig
from summarymixing_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe")
    ap.add_argument("--test-manifest", required=True)
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--beam", action="store_true",
                    help="beam search: joint CTC/attention (decoder models) or the transducer's")
    ap.add_argument("--avg", type=int, default=0, help="average the last N checkpoints")
    ap.add_argument("--lm-ckpt", default=None,
                    help="LM run directory (recipes.train_lm) fused at decoding.lm_weight")
    ap.add_argument("--output", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides", help="override a recipe value by dotted path")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless this says otherwise (e.g. cpu)")
    ap.add_argument("--nbest", type=int, default=1,
                    help="with --beam: also write the top N hypotheses per utterance "
                         "(nbest.jsonl under --output; rank 0 is scored)")
    ap.add_argument("--seq-parallel", type=int, default=0, metavar="N",
                    help="shard the encoder's time axis over N processes for the greedy CTC "
                         "decode (the process count must be a multiple of N)")
    ap.add_argument("--streaming", action="store_true",
                    help="transducer: chunked streaming encode + carried greedy decode")
    ap.add_argument("--streaming-full", action="store_true", dest="streaming_full",
                    help="transducer: the raw-audio streaming pipeline (streaming.run_stream)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="streaming chunk in encoder frames (16 = 640 ms)")
    ap.add_argument("--left-context", type=int, default=4,
                    help="streaming left context in chunks")
    return ap.parse_args(argv)


def refuse_unported(args: argparse.Namespace, cfg) -> None:
    """The flag combinations the JAX runner refuses, with its messages."""
    if args.nbest > 1 and not args.beam:
        raise SystemExit("--nbest requires --beam")
    if (args.streaming or args.streaming_full) and cfg.transducer is None:
        raise SystemExit("--streaming and --streaming-full decode a transducer recipe")
    if args.seq_parallel > 1:
        if cfg.transducer is not None:
            raise SystemExit(
                "--seq-parallel currently supports the attention recipes' "
                "greedy CTC decode only (the transducer decode loop is "
                "token-sequential)")
        if args.beam:
            raise SystemExit("--seq-parallel supports greedy decode only "
                             "(the beam loop is token-sequential)")
        n_dev = launch.process_count()
        if n_dev % args.seq_parallel:
            raise SystemExit(f"{n_dev} devices not divisible by "
                             f"--seq-parallel {args.seq_parallel}")


def resolve_tokenizer(cfg, run_dir: str, fallback_texts: Optional[List[str]] = None):
    """The tokenizer a training run (or `recipes.convert_checkpoint`) wrote
    in `run_dir`: subword (`tokenizer.json`), character map
    (`tokenizer_vocab.json`) or SentencePiece (`tokenizer.model`). A subword recipe
    without one stops: decoding its ids through a rebuilt character map
    would score garbage. A char recipe falls back to a map rebuilt from
    `fallback_texts`, with a warning."""
    subword_path = os.path.join(run_dir, "tokenizer.json")
    vocab_path = os.path.join(run_dir, "tokenizer_vocab.json")
    sp_path = os.path.join(run_dir, "tokenizer.model")
    if os.path.exists(subword_path):
        return SubwordTokenizer.load(subword_path)
    if os.path.exists(vocab_path):
        with open(vocab_path) as f:
            return CharTokenizer(vocab=json.load(f))
    if cfg.tokenizer_type != "char":
        if os.path.exists(sp_path):
            return SentencePieceTokenizer(sp_path)
        raise SystemExit(
            f"no persisted {cfg.tokenizer_type} tokenizer found in {run_dir} (expected "
            "tokenizer.json / tokenizer.model); refusing to fall back to a char map for a "
            "subword recipe")
    if not fallback_texts:
        raise SystemExit(f"no persisted tokenizer found in {run_dir}")
    print("WARNING: no persisted tokenizer found; rebuilding from the provided texts "
          "(char-id map may differ from training)")
    return CharTokenizer.build(list(fallback_texts))


def run_dir_of(ckpt_dir: str) -> str:
    """The run directory that owns a `--ckpt` save directory (the save
    directory itself or the run directory, with or without a trailing
    slash)."""
    path = os.path.normpath(ckpt_dir)
    return os.path.dirname(path) if os.path.basename(path) == "save" else path


def restore(args: argparse.Namespace, cfg, device):
    """`(trainer or model, fbank, state, lm)` for the recipe: the evaluation
    `TransducerTrainer` and the RNNLM of a transducer recipe, else the
    recognizer and the Transformer LM; the parameters from `--ckpt`
    (averaged over `--avg`)."""
    if cfg.transducer is not None:
        model, fbank, td = build_model(cfg, device=device)
        trainer = build_transducer_trainer(cfg, model, fbank, td, train=False)
        state = restore_eval_state(trainer.model, args.ckpt, args.avg, device=device)
        lm = common.load_rnnlm(cfg, args.lm_ckpt, device) if args.beam else None
        return trainer, fbank, state, lm
    model, fbank = build_model(cfg, device=device)
    state = restore_eval_state(model, args.ckpt, args.avg, device=device)
    lm = common.load_fusion_lm(cfg, args.lm_ckpt, device) if args.beam else None
    return model, fbank, state, lm


def decode_transducer(args: argparse.Namespace, cfg, device, trainer, state: Dict, lm,
                      test_set, tokenizer, stats, record: Dict, nbest_rows: Dict) -> Dict:
    """The transducer branch (the JAX `eval_transducer`): decode every batch
    as the flags say and score it; returns the decode's summary fields."""
    model, fbank, td = trainer.encoder_model, trainer.fbank, trainer.transducer_model
    blank = cfg.model.blank_index
    if args.beam:
        common.transducer_beam_score(stats, trainer, state, test_set, tokenizer, cfg, device, lm,
                                     record, nbest=args.nbest, nbest_rows=nbest_rows)
        return {"decode": "transducer_beam+lm" if lm is not None else "transducer_beam",
                **({"lm_weight": cfg.decoding.lm_weight} if lm is not None else {})}
    if not (args.streaming or args.streaming_full):
        common.transducer_greedy_score(stats, trainer, state, test_set, tokenizer, cfg, device,
                                       record)
        return {"decode": "transducer_greedy"}
    chunk_times: List[float] = []
    if args.streaming_full:
        init_fn, step_fn, info = make_streaming_infer_fns(
            model, td, fbank, InputNormalization(), state["norm_stats"],
            chunk_frames=args.chunk_size, left_context_chunks=args.left_context, blank_id=blank)
    seen: set = set()
    for batch, idx in common.batches(test_set, tokenizer, cfg, False, 0, device):
        if args.streaming_full:
            t0 = time.perf_counter()
            toks, lens = run_stream(init_fn, step_fn, batch["wav"], batch["wav_lens"],
                                    info["chunk_samples"])
            # run_stream runs ceil(n / chunk) + 2 steps (the two flush chunks)
            n_steps = -(-batch["wav"].shape[1] // info["chunk_samples"]) + 2
            chunk_times.extend([(time.perf_counter() - t0) / n_steps] * n_steps)
        else:
            toks, lens = streaming_decode(model, td, fbank, state["norm_stats"], batch["wav"],
                                          batch["wav_lens"], args.chunk_size, args.left_context,
                                          blank, chunk_times)
        hyps = common.gather_rows(common.token_rows(toks.cpu().numpy(), lens.cpu().numpy()))
        common.score_batch(stats, tokenizer, batch, idx, seen, hyps, record=record)
    out = {"decode": ("transducer_streaming_full_pipeline" if args.streaming_full
                      else "transducer_streaming_greedy"),
           "chunk_frames": args.chunk_size, "left_context_chunks": args.left_context}
    if chunk_times and args.streaming_full:
        # a batch mean: run_stream is driven a whole batch at a time here
        out["chunk_ms_mean"] = round(float(np.mean(chunk_times)) * 1e3, 2)
    elif chunk_times:
        ct = sorted(chunk_times)
        out["chunk_latency_ms_p50"] = round(ct[len(ct) // 2] * 1e3, 2)
        out["chunk_latency_ms_p90"] = round(ct[min(len(ct) - 1, int(len(ct) * 0.9))] * 1e3, 2)
    return out


def decode_seq_parallel(args: argparse.Namespace, cfg, device, model, fbank, state: Dict,
                        test_set, tokenizer, stats, record: Dict) -> Dict:
    """Greedy CTC with the encoder's time axis sharded over `--seq-parallel`
    processes (the JAX runner's `sequence_parallel_ctc_decode` branch),
    the rows of each batch over the data axis that the rest of the
    processes make; every process scores the whole set."""
    n = args.seq_parallel
    n_data = launch.process_count() // n
    mesh = sequence.make_seq_mesh(n_data=n_data, n_seq=n, device=device)
    data_index = mesh.get_coordinate()[0]
    decode = sequence.sequence_parallel_ctc_decode(model.eval(), mesh,
                                                   blank_id=cfg.model.blank_index)
    normalize = InputNormalization()
    seen: set = set()
    for batch, idx in common.batches(test_set, tokenizer, cfg, False, 0, device,
                                     shards=(n_data, data_index)):
        # pad the waveform (not the features) so the frame count divides
        # the seq axis: the appended zero samples only add silence frames
        # past each utterance's length (parallel/sequence.py)
        wav = batch["wav"]
        rem = (-(1 + wav.shape[1] // fbank.hop_length)) % n
        if rem:
            wav = F.pad(wav, (0, rem * fbank.hop_length))
        with torch.no_grad():
            feats, _ = normalize(fbank(wav), state["norm_stats"])
        ids, keep, _ = decode(feats, fbank.frame_lengths(batch["wav_lens"]))
        local = (batch["tokens"].cpu().numpy(), batch["token_lens"].cpu().numpy(),
                 collapse_ctc(ids, keep))
        # one copy of each data shard: the first process of its seq group
        parts = launch.gather_objects(local)[::n]
        full = {"tokens": np.concatenate([p[0] for p in parts]),
                "token_lens": np.concatenate([p[1] for p in parts])}
        common.score_batch(stats, tokenizer, full, idx, seen, [h for p in parts for h in p[2]],
                           record=record, gathered=True)
    return {"decode": "greedy_ctc_seq_parallel", "seq_parallel": n}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Evaluate; returns the summary (as printed) with `hyps`, each
    utterance ID's hypothesis words, added (on every process of a
    multi-process run; process 0 prints and writes)."""
    args = parse_args(argv)
    cfg = load_recipe(args.recipe, overrides=common.parse_overrides(args.overrides))
    common.start_processes(args.device)
    refuse_unported(args, cfg)
    device = resolve_device(args.device)
    test_set = read_manifest_csv(args.test_manifest)
    # the training run's tokenizer: one rebuilt from the test texts would
    # shift the ids
    tokenizer = resolve_tokenizer(cfg, run_dir_of(args.ckpt),
                                  fallback_texts=[u.text for u in test_set])
    stats = common.error_rate_stats(cfg, keep_details=bool(args.output))
    record: Dict[int, list] = {}
    nbest_rows: Dict[int, list] = {}
    model, fbank, state, lm = restore(args, cfg, device)
    counts0 = common.kernel_counts()
    t0 = time.time()
    if cfg.transducer is not None:
        decode = decode_transducer(args, cfg, device, model, state, lm, test_set, tokenizer,
                                   stats, record, nbest_rows)
        n_utts = len(record)
    else:
        if args.beam:
            totals: Dict = {}
            n_utts = common.beam_score(
                stats, cfg, model, fbank, state["norm_stats"], test_set, tokenizer, device, lm,
                beam_size=cfg.decoding.test_beam_size, temperature=cfg.decoding.test_temperature,
                record=record, nbest=args.nbest, nbest_rows=nbest_rows, totals=totals)
            decode = {"decode": "beam+lm" if lm is not None else "beam",
                      "beam_steps": totals["steps"], "search_s": round(totals["search_s"], 3),
                      "ctc_frames": totals["ctc_frames"]}
        elif args.seq_parallel > 1:
            decode = decode_seq_parallel(args, cfg, device, model, fbank, state, test_set,
                                         tokenizer, stats, record)
            n_utts = len(record)
        else:
            m = cfg.model
            trainer = ASRTrainer(model, None, fbank, TrainerConfig(
                ctc_weight=cfg.training.ctc_weight, augment=None, blank_id=m.blank_index,
                pad_id=m.pad_index, bos_id=m.bos_index, eos_id=m.eos_index))
            common.greedy_score(stats, trainer, state, test_set, tokenizer, cfg, device, record)
            n_utts = len(record)
            decode = {"decode": "greedy_ctc"}
        if lm is not None:
            decode["lm_weight"] = cfg.decoding.lm_weight
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    summary = stats.summarize()
    summary["utterances"] = n_utts
    summary["wall_s"] = round(time.time() - t0, 1)
    audio_s = sum(u.duration for u in test_set)
    summary["audio_s"] = round(audio_s, 1)
    summary["rtf"] = round(summary["wall_s"] / max(audio_s, 1e-9), 5)
    summary.update(decode)
    if nbest_rows:
        summary["nbest"] = args.nbest
    summary["kernels"] = common.kernel_counts(since=counts0)
    if not launch.is_coordinator():
        return dict(summary, hyps={test_set[i].utt_id: h for i, h in record.items()})
    print(json.dumps(summary), flush=True)
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "eval.json"), "w") as f:
            json.dump(summary, f, indent=2)
        path = os.path.join(args.output, f"{cfg.error_rate}_details.txt")
        stats.write_stats(path, id_map={i: u.utt_id for i, u in enumerate(test_set)})
        print("per-utterance details ->", path, file=sys.stderr)
        if nbest_rows:
            with open(os.path.join(args.output, "nbest.jsonl"), "w") as f:
                for u, hyps_n in sorted(nbest_rows.items()):
                    f.write(json.dumps({"id": test_set[u].utt_id, "nbest": hyps_n}) + "\n")
    return dict(summary, hyps={test_set[i].utt_id: h for i, h in record.items()})


if __name__ == "__main__":
    main()
