"""Batch transcription of audio files with a trained run — the port of the
JAX package's `recipes/transcribe.py`.

    python -m summarymixing_tpu_torch.recipes.transcribe RECIPE.yaml --ckpt RUN_DIR/save \\
        a.wav b.flac ... [--avg 10] [--batch-size 8] [--output out.jsonl] \\
        [--set KEY=VALUE] [--device cpu]

The files (WAV or FLAC) are sorted by length, longest first, batched
`--batch-size` at a time, padded to a multiple of half a second, and the
last batch is filled by repetition (`transcribe.batch_waveforms`). A CTC
recipe decodes greedily (`transcribe.greedy_ctc_decode`), a transducer
recipe by its greedy search (`transcribe.transducer_greedy_transcribe`);
the ids become text through the tokenizer the training run wrote. One
JSON line per file, in the order given, `{"wav": ..., "text": ...}`, on
standard output (and in `--output`); the summary (utterances, wall
seconds, each kernel's launches and plain calls) on standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional, Sequence

from summarymixing_tpu_torch.config import load_recipe
from summarymixing_tpu_torch.data.dataio import load_wav
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.recipes.evaluate import resolve_tokenizer, run_dir_of
from summarymixing_tpu_torch.transcribe import (
    batch_waveforms,
    greedy_ctc_decode,
    transducer_greedy_transcribe,
)
from summarymixing_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe")
    ap.add_argument("wavs", nargs="+", help="audio files (WAV or FLAC) to transcribe")
    ap.add_argument("--ckpt", required=True, help="checkpoint (save) directory")
    ap.add_argument("--avg", type=int, default=0, help="average the last N checkpoints")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--output", default=None, help="write the JSONL here too")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides", help="override a recipe value by dotted path")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless this says otherwise (e.g. cpu)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Transcribe; returns the summary with `texts`, file -> text."""
    args = parse_args(argv)
    cfg = load_recipe(args.recipe, overrides=common.parse_overrides(args.overrides))
    device = resolve_device(args.device)
    tokenizer = resolve_tokenizer(cfg, run_dir_of(args.ckpt))
    model, fbank, td, norm_stats = common.restore_inference(cfg, args.ckpt, args.avg, device)
    sr = cfg.features.sample_rate
    wavs = [load_wav(p, expected_rate=sr) for p in args.wavs]
    counts0 = common.kernel_counts()
    t0 = time.time()
    texts: Dict[int, str] = {}
    for idx, wav, lens in batch_waveforms(wavs, args.batch_size, sr // 2, device):
        if td is None:
            hyps, _ = greedy_ctc_decode(model, fbank, norm_stats, wav, lens)
        else:
            hyps, _ = transducer_greedy_transcribe(model, td, fbank, norm_stats, wav, lens,
                                                   blank_id=cfg.model.blank_index)
        for i, u in enumerate(idx):
            texts.setdefault(u, tokenizer.decode(hyps[i]))
    lines = [json.dumps({"wav": p, "text": texts[i]}) for i, p in enumerate(args.wavs)]
    print("\n".join(lines), flush=True)
    summary = {"utterances": len(args.wavs), "wall_s": round(time.time() - t0, 3),
               "kernels": common.kernel_counts(since=counts0)}
    print(json.dumps(summary), file=sys.stderr)
    if args.output:
        with open(args.output, "w") as f:
            f.write("\n".join(lines) + "\n")
    return dict(summary, texts={p: texts[i] for i, p in enumerate(args.wavs)})


if __name__ == "__main__":
    main()
