"""Export a trained run as one inference artifact with `torch.export` — the
port of the JAX package's `recipes/export_model.py`.

    python -m summarymixing_tpu_torch.recipes.export_model RECIPE.yaml --ckpt RUN_DIR/save \\
        --output model.smt [--avg 10] [--fixed B N] [--check] [--set KEY=VALUE] [--device cpu]
    python -m summarymixing_tpu_torch.recipes.export_model TRANSDUCER.yaml --ckpt RUN_DIR/save \\
        --output stream.smt --streaming [--chunk-frames 16] [--left-context 4] [--check]

The artifact (`utils/export.py`) holds the greedy inference graph with the
trained weights: Fbank -> normalisation -> encoder -> greedy CTC markers
(attention recipes) or the transducer's greedy decode (transducer
recipes), polymorphic in batch and samples unless `--fixed B N`, or with `--streaming` the chunked `init` / `step` pair of a transducer
recipe. Exported on the card (the default), the graph calls the two
kernels as registered ops; `--device cpu` exports the plain path. An
artifact runs only on the device type it was exported on.

`--check` loads the artifact again and compares it with the live model on
random audio: ids, keep and encoder lengths bit for bit (the streaming
artifact: its text against `streaming.run_stream` on the live functions).

Load side:

    from summarymixing_tpu_torch.utils.export import ExportedASR
    asr = ExportedASR.load("model.smt")          # on the card; device="cpu" for a CPU export
    print(asr.transcribe(wav))                   # wav: float32 [-1, 1] at 16 kHz
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from summarymixing_tpu_torch.config import load_recipe
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.recipes.evaluate import resolve_tokenizer, run_dir_of
from summarymixing_tpu_torch.streaming import make_streaming_infer_fns, run_stream
from summarymixing_tpu_torch.utils.device import resolve_device
from summarymixing_tpu_torch.utils.export import (
    ExportedASR,
    ExportedStreamingASR,
    decode_token_rows,
    export_ctc_infer,
    export_streaming,
    make_ctc_infer_fn,
    make_transducer_infer_fn,
    save_artifact,
)


def vocab_list(tokenizer) -> list:
    """id -> piece table (the reserved ids 0-3 map to '')."""
    out = [""] * tokenizer.vocab_size
    if hasattr(tokenizer, "vocab"):          # CharTokenizer
        for piece, i in tokenizer.vocab.items():
            out[i] = piece
    elif hasattr(tokenizer, "_id_of"):        # SubwordTokenizer
        for piece, i in tokenizer._id_of.items():
            out[i] = piece
    else:
        raise SystemExit(f"don't know how to extract a vocab from {type(tokenizer)}; the "
                         "artifact would decode every utterance to ''")
    return out


def token_type(cfg) -> str:
    return "char" if cfg.tokenizer_type == "char" else cfg.token_type


def export_streaming_artifact(args, cfg, model, td, fbank, normalizer, norm_stats, tokenizer,
                              device) -> Dict:
    """--streaming: the chunked init / step pair (raw audio in, tokens out,
    one chunk behind; `streaming.py`)."""
    init_fn, step_fn, info = make_streaming_infer_fns(
        model, td, fbank, normalizer, norm_stats, chunk_frames=args.chunk_frames,
        left_context_chunks=args.left_context, blank_id=cfg.model.blank_index)
    t0 = time.perf_counter()
    payloads = export_streaming(init_fn, step_fn, info["chunk_samples"], model, td, fbank,
                                fixed_batch=args.fixed[0] if args.fixed else None)
    export_s = time.perf_counter() - t0
    meta = {"recipe": cfg.name, "family": "transducer_streaming",
            "sample_rate": cfg.features.sample_rate, "token_type": token_type(cfg),
            "vocab": vocab_list(tokenizer), "polymorphic": args.fixed is None,
            "device": device.type, **info}
    save_artifact(args.output, payloads, meta)
    total = sum(len(v) for v in payloads.values())
    print(f"exported streaming artifact ({total / 1e6:.1f} MB, chunk {info['chunk_samples']} "
          f"samples = {args.chunk_frames} encoder frames, left context {args.left_context} "
          f"chunks) in {export_s:.1f} s -> {args.output}", flush=True)
    summary = {"family": meta["family"], "export_s": export_s, "mb": total / 1e6}
    if args.check:
        art = ExportedStreamingASR.load(args.output, device)
        rng = np.random.default_rng(0)
        b = args.fixed[0] if args.fixed else 2   # a --fixed export takes its batch only
        n = 3 * info["chunk_samples"] + 1000
        wav = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
        lens = np.full((b,), n, np.int64)
        if b > 1:
            lens[1] = n - 1500   # a ragged row: the valid-count masking
        got = art.transcribe(wav, lens)
        toks, tl = run_stream(init_fn, step_fn, torch.from_numpy(wav).to(device),
                              torch.from_numpy(lens).to(device), info["chunk_samples"])
        want = decode_token_rows(meta, [toks[i, :int(tl[i])].tolist() for i in range(b)])
        if got != want:
            raise SystemExit(f"check failed: the streaming artifact gives {got}, the live "
                             f"functions {want}")
        print(f"check ok: streaming artifact == live step functions on {wav.shape}")
        summary["check"] = True
    return summary


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe")
    ap.add_argument("--ckpt", required=True, help="checkpoint (save) directory")
    ap.add_argument("--output", required=True, help="artifact path")
    ap.add_argument("--avg", type=int, default=0, help="average the last N checkpoints first")
    ap.add_argument("--fixed", nargs=2, type=int, metavar=("B", "N"),
                    help="export one static (batch, samples) shape instead of the "
                         "polymorphic default")
    ap.add_argument("--streaming", action="store_true",
                    help="export a streaming artifact (transducer recipes): init and step "
                         "with a carried state, raw audio chunks in, tokens out")
    ap.add_argument("--chunk-frames", type=int, default=16,
                    help="encoder frames per streaming chunk (40 ms each)")
    ap.add_argument("--left-context", type=int, default=4,
                    help="left-context chunks carried across steps")
    ap.add_argument("--check", action="store_true",
                    help="load the artifact again and compare it with the live model on "
                         "random audio")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless this says otherwise (e.g. cpu)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Export (and check); returns a summary: family, export seconds, MB."""
    args = parse_args(argv)
    cfg = load_recipe(args.recipe, overrides=common.parse_overrides(args.overrides))
    device = resolve_device(args.device)
    tokenizer = resolve_tokenizer(cfg, run_dir_of(args.ckpt))
    model, fbank, td, norm_stats = common.restore_inference(cfg, args.ckpt, args.avg, device)
    normalizer = InputNormalization(update_until_epoch=cfg.features.normalize_update_until_epoch)
    sr = cfg.features.sample_rate
    if args.streaming:
        if td is None:
            raise SystemExit("--streaming requires a transducer recipe (the attention recipes' "
                             "encoder is not chunk-trained)")
        return export_streaming_artifact(args, cfg, model, td, fbank, normalizer, norm_stats,
                                         tokenizer, device)
    blank = cfg.model.blank_index
    if td is None:
        infer, family = make_ctc_infer_fn(model, fbank, normalizer, norm_stats, blank), "ctc"
    else:
        infer = make_transducer_infer_fn(model, td, fbank, normalizer, norm_stats, blank)
        family = "transducer"
    fixed = tuple(args.fixed) if args.fixed else None
    t0 = time.perf_counter()
    payload = export_ctc_infer(infer, fixed_shape=fixed)
    export_s = time.perf_counter() - t0
    meta = {"recipe": cfg.name, "family": family, "sample_rate": sr, "blank_id": blank,
            "time_multiple": 320, "token_type": token_type(cfg), "vocab": vocab_list(tokenizer),
            "polymorphic": fixed is None, "device": device.type}
    save_artifact(args.output, payload, meta)
    print(f"exported {len(payload) / 1e6:.1f} MB payload in {export_s:.1f} s -> {args.output} "
          f"({'polymorphic' if fixed is None else f'fixed {list(fixed)}'})", flush=True)
    summary = {"family": family, "export_s": export_s, "mb": os.path.getsize(args.output) / 1e6}
    if args.check:
        asr = ExportedASR.load(args.output, device)
        rng = np.random.default_rng(0)
        b, n = fixed if fixed else (3, sr * 2)
        wav = (rng.standard_normal((b, n)) * 0.1).astype(np.float32)
        lens = np.full((b,), n, np.int32)
        got = asr(wav, lens)
        with torch.inference_mode():
            want = infer(torch.from_numpy(wav).to(device), torch.from_numpy(lens).to(device))
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                raise SystemExit(f"check failed: the artifact's output {i} differs from the "
                                 "live model's")
        print(f"check ok: artifact == live model on {wav.shape}")
        summary["check"] = True
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
