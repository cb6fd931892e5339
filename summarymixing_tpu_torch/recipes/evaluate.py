"""Word (or character) error rate of a trained CTC + attention recipe on a
test manifest — the port of the JAX package's `recipes/evaluate.py` (its
non-transducer branch).

    python -m summarymixing_tpu_torch.recipes.evaluate recipes/Synthetic/hard_synthetic.yaml \\
        --test-manifest test.csv --ckpt RUN_DIR/save [--avg 10] [--beam] \\
        [--lm-ckpt LM_RUN_DIR] [--output EVAL_DIR] [--set decoding.lm_weight=0.2] [--device cpu]

The tokenizer is the one the training run wrote beside `--ckpt`. The
parameters are the latest checkpoint's, or the mean of the last `--avg`.
Greedy CTC runs through `ASRTrainer.eval_step`; `--beam` runs the joint
CTC/attention search at `test_beam_size` and `test_temperature` with the
KV-cached decoder (`evaluate.evaluate_beam`, batches wider than
`max_beam_rows` // beam searched in slices, one decode-length cap for the
run), and with `--lm-ckpt` the Transformer LM fused at `lm_weight`. The
last line of standard output is the summary as JSON: WER, SER, error
counts, utterances, wall_s, audio_s, rtf (wall over audio), the decode
and `kernels`, each kernel's launches and plain calls (cells or branches
on the card whose configuration it does not take) in the run.
`--output` also gets it as `eval.json`, with the per-utterance
alignments in `wer_details.txt` (or `cer_details.txt`).

Not ported, and refused: `--nbest` above 1, `--seq-parallel`,
`--streaming`, `--streaming-full`, and recipes with a `transducer:`
section (ROADMAP.md)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.data.dataio import read_manifest_csv
from summarymixing_tpu_torch.data.subword import SubwordTokenizer
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer, SentencePieceTokenizer
from summarymixing_tpu_torch.evaluate import restore_eval_state
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.training.trainer import ASRTrainer, TrainerConfig
from summarymixing_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe")
    ap.add_argument("--test-manifest", required=True)
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--beam", action="store_true",
                    help="joint CTC/attention beam search (decoder models)")
    ap.add_argument("--avg", type=int, default=0, help="average the last N checkpoints")
    ap.add_argument("--lm-ckpt", default=None,
                    help="LM run directory (recipes.train_lm) fused at decoding.lm_weight")
    ap.add_argument("--output", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides", help="override a recipe value by dotted path")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless this says otherwise (e.g. cpu)")
    ap.add_argument("--nbest", type=int, default=1, help="above 1: not ported")
    ap.add_argument("--seq-parallel", type=int, default=0, metavar="N", help="not ported")
    ap.add_argument("--streaming", action="store_true", help="not ported")
    ap.add_argument("--streaming-full", action="store_true", dest="streaming_full",
                    help="not ported")
    return ap.parse_args(argv)


def refuse_unported(args: argparse.Namespace, cfg) -> None:
    if args.nbest > 1:
        if not args.beam:
            raise SystemExit("--nbest requires --beam")
        raise NotImplementedError("--nbest output is not ported; see ROADMAP.md queue 1 item 7")
    if args.seq_parallel > 1:
        raise NotImplementedError("--seq-parallel is not ported; see ROADMAP.md queue 1 item 10")
    if args.streaming or args.streaming_full or cfg.transducer is not None:
        raise NotImplementedError("the transducer test stage (--streaming, --streaming-full, "
                                  "transducer recipes) is not ported in this runner; see "
                                  "ROADMAP.md queue 1 item 3")


def resolve_tokenizer(cfg, run_dir: str, fallback_texts: Optional[List[str]] = None):
    """The tokenizer a training run wrote in `run_dir`: subword
    (`tokenizer.json`), character map (`tokenizer_vocab.json`) or
    SentencePiece (`tokenizer.model`, not ported: raises). A subword recipe
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


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Evaluate; returns the summary (as printed) with `hyps`, each
    utterance ID's hypothesis words, added."""
    args = parse_args(argv)
    cfg = load_recipe(args.recipe, overrides=common.parse_overrides(args.overrides))
    refuse_unported(args, cfg)
    device = resolve_device(args.device)
    test_set = read_manifest_csv(args.test_manifest)
    # the training run's tokenizer: one rebuilt from the test texts would
    # shift the ids
    tokenizer = resolve_tokenizer(cfg, run_dir_of(args.ckpt),
                                  fallback_texts=[u.text for u in test_set])
    model, fbank = build_model(cfg, device=device)
    state = restore_eval_state(model, args.ckpt, args.avg, device=device)
    stats = common.error_rate_stats(cfg, keep_details=bool(args.output))
    record: Dict[int, list] = {}
    lm = common.load_fusion_lm(cfg, args.lm_ckpt, device) if args.beam else None
    counts0 = common.kernel_counts()
    t0 = time.time()
    if args.beam:
        n_utts = common.beam_score(
            stats, cfg, model, fbank, state["norm_stats"], test_set, tokenizer, device, lm,
            beam_size=cfg.decoding.test_beam_size, temperature=cfg.decoding.test_temperature,
            record=record)
    else:
        m = cfg.model
        trainer = ASRTrainer(model, None, fbank, TrainerConfig(
            ctc_weight=cfg.training.ctc_weight, augment=None, blank_id=m.blank_index,
            pad_id=m.pad_index, bos_id=m.bos_index, eos_id=m.eos_index))
        common.greedy_score(stats, trainer, state, test_set, tokenizer, cfg, device, record)
        n_utts = len(record)
    summary = stats.summarize()
    summary["utterances"] = n_utts
    summary["wall_s"] = round(time.time() - t0, 1)
    audio_s = sum(u.duration for u in test_set)
    summary["audio_s"] = round(audio_s, 1)
    summary["rtf"] = round(summary["wall_s"] / max(audio_s, 1e-9), 5)
    summary["decode"] = ("beam+lm" if lm is not None else "beam") if args.beam else "greedy_ctc"
    if lm is not None:
        summary["lm_weight"] = cfg.decoding.lm_weight
    summary["kernels"] = common.kernel_counts(since=counts0)
    print(json.dumps(summary), flush=True)
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "eval.json"), "w") as f:
            json.dump(summary, f, indent=2)
        path = os.path.join(args.output, f"{cfg.error_rate}_details.txt")
        stats.write_stats(path, id_map={i: u.utt_id for i, u in enumerate(test_set)})
        print("per-utterance details ->", path, file=sys.stderr)
    return dict(summary, hyps={test_set[i].utt_id: h for i, h in record.items()})


if __name__ == "__main__":
    main()
