"""Convert a reference-trained (SpeechBrain) checkpoint into a port run
directory — the port of the JAX package's `recipes/convert_checkpoint.py`.

    python -m summarymixing_tpu_torch.recipes.convert_checkpoint RECIPE.yaml \\
        --torch-ckpt save/model.ckpt [--norm-ckpt save/normalizer.ckpt] \\
        [--tokenizer save/tokenizer.ckpt] [--lm-ckpt save/lm.ckpt] --output RUN [--device cpu]
    python -m summarymixing_tpu_torch.recipes.convert_checkpoint RECIPE.yaml \\
        --ref-dir save --output RUN
    python -m summarymixing_tpu_torch.recipes.evaluate RECIPE.yaml --test-manifest test.csv \\
        --ckpt RUN/save [--beam [--nbest 3]] [--lm-ckpt RUN/lm]

`--ref-dir` picks up `model.ckpt`, `lm.ckpt`, `normalizer.ckpt` and
`tokenizer.ckpt` from a directory in the Pretrainer's `collect_in` layout.
The model's state dict (the `[CNN, Transformer, seq_lin, ctc_lin]`
ModuleList of the CTC + attention recipes, or the transducer recipes'
list) goes through the SpeechBrain converters of `utils/convert.py` into
a flax-layout tree, and `load_jax_params` fills the recipe's port model
from it: a key of the file that no converter read stops the run (unless
`--allow-unconsumed`; `--report` lists every key), and so does a port
parameter left unfilled. The run directory gets a checkpoint written by
`training.checkpoint.CheckpointManager` in `RUN/save` (the parameters,
the normaliser's statistics, step and epoch), which the `evaluate`,
`transcribe`, `serve` and `export_model` runners read as a trained run's.

`--norm-ckpt` maps the reference InputNormalization statistics
(`glob_mean`, `glob_std`, `count`) onto the port's `NormStats`; without it
the statistics are zero and the features unnormalised (a warning says so).
`--lm-ckpt` converts the fusion LM (the Transformer LM of the attention
recipes, the RNNLM of the transducer recipes) into `RUN/lm` with an
`lm_config.json` of the widths read from the weights, the layout
`--lm-ckpt RUN/lm` of `evaluate` reads. A SentencePiece model (a
`tokenizer.ckpt` is recognised by its content) is placed as
`tokenizer.model`, a subword `.json` as `tokenizer.json`, a character map
as `tokenizer_vocab.json`.

The model is built on the card unless `--device` says otherwise. The last
line of standard output is a JSON summary: parameters converted, keys
consumed and ignored, seconds, and where the run and LM went."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import struct
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.config.loader import build_lm
from summarymixing_tpu_torch.config.schema import LMConfig
from summarymixing_tpu_torch.data.sentencepiece_model import parse_model_proto
from summarymixing_tpu_torch.frontend.features import NormStats
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.utils.convert import (
    TrackedStateDict,
    consumption_report,
    convert_full_model,
    convert_rnnlm,
    convert_transducer_model,
    convert_transformer_lm,
    load_jax_params,
    load_torch_checkpoint,
)
from summarymixing_tpu_torch.utils.device import resolve_device

# what a converted run's counters say: fully trained, so the normaliser
# stays frozen
CONVERTED_STEP, CONVERTED_EPOCH = 10 ** 9, 10 ** 6


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe")
    ap.add_argument("--torch-ckpt", default=None, help="reference model.ckpt (a state dict)")
    ap.add_argument("--ref-dir", default=None,
                    help="reference checkpoint directory (the Pretrainer's collect_in layout): "
                         "model.ckpt, lm.ckpt, tokenizer.ckpt, normalizer.ckpt")
    ap.add_argument("--norm-ckpt", default=None,
                    help="reference normalizer.ckpt (InputNormalization's global statistics)")
    ap.add_argument("--lm-ckpt", default=None,
                    help="reference lm.ckpt (Transformer LM, or RNNLM for transducer recipes) "
                         "-> OUTPUT/lm")
    ap.add_argument("--tokenizer", default=None,
                    help="tokenizer file for the run directory: a SentencePiece .model/.ckpt, "
                         "a subword tokenizer.json or a character map .json")
    ap.add_argument("--output", required=True, help="run directory to write")
    ap.add_argument("--report", action="store_true",
                    help="print the consumed, ignored and unconsumed state-dict keys")
    ap.add_argument("--allow-unconsumed", action="store_true",
                    help="warn instead of stopping when the converter left keys unread")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless this says otherwise (e.g. cpu)")
    return ap.parse_args(argv)


def check_consumption(sd: TrackedStateDict, what: str, show_report: bool,
                      allow_unconsumed: bool) -> Dict[str, int]:
    """Every key of the file that is not a deterministic buffer must have
    been read by the converter, or the converted model would silently
    differ from the original: stop (or, with `allow_unconsumed`, warn).
    Returns the counts of consumed, ignored and unconsumed keys."""
    rep = consumption_report(sd)
    if show_report:
        print(f"--- {what} key-consumption report ---")
        for kind in ("consumed", "ignored", "unconsumed"):
            print(f"{kind} ({len(rep[kind])}):")
            for k in rep[kind]:
                print(f"  {k}")
    counts = {kind: len(keys) for kind, keys in rep.items()}
    line = (f"{what}: consumed {counts['consumed']} keys, ignored {counts['ignored']} buffers, "
            f"{counts['unconsumed']} unconsumed")
    if rep["unconsumed"]:
        msg = (line + "; the state dict holds parameters the converter did not map: "
               + ", ".join(rep["unconsumed"][:20])
               + (" ..." if len(rep["unconsumed"]) > 20 else ""))
        if not allow_unconsumed:
            raise SystemExit("ERROR: " + msg + "\n(--allow-unconsumed converts anyway, "
                             "--report lists every key)")
        print("WARNING:", msg)
    else:
        print(line)
    return counts


def norm_stats_from_reference(path: str, n_mels: int, device) -> Dict[str, torch.Tensor]:
    """A reference `normalizer.ckpt` (`glob_mean`, `glob_std` and a count)
    as the port's `NormStats`: m2 = std² · count."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    mean = np.asarray(sd["glob_mean"], np.float32).reshape(-1)
    std = np.asarray(sd["glob_std"], np.float32).reshape(-1)
    count = float(np.asarray(sd.get("count", 1e8)))
    if mean.shape[0] != n_mels:
        raise SystemExit(f"normalizer stats have {mean.shape[0]} dims, the recipe's n_mels "
                         f"is {n_mels}")
    m2 = (std.astype(np.float64) ** 2 * count).astype(np.float32)
    return {"count": torch.tensor(count, dtype=torch.float32, device=device),
            "mean": torch.from_numpy(mean).to(device), "m2": torch.from_numpy(m2).to(device)}


def convert_lm_ckpt(cfg, lm_path: str, out_dir: str, is_transducer: bool, device,
                    show_report: bool = False, allow_unconsumed: bool = False) -> Dict:
    """A published `lm.ckpt` as `<out_dir>/lm`: a checkpoint (`params`, the
    LM's state dict) in `lm/save` and `lm_config.json` with the widths read
    from the weights, what `evaluate.restore_lm` loads for fusion. nhead
    cannot be read from a fused q/k/v projection: it comes from the
    recipe's `lm:` block (the `LMConfig` default, 12, is the published
    768-wide LM's). Returns `{"dir", "params", "keys"}`."""
    sd = TrackedStateDict(load_torch_checkpoint(lm_path))
    base = dataclasses.asdict(cfg.lm or LMConfig(
        model_type="rnn" if is_transducer else "transformer"))
    if is_transducer:
        tree = convert_rnnlm(sd)
        base.update(model_type="rnn", embedding_dim=int(tree["emb"]["embedding"].shape[1]),
                    rnn_layers=sum(1 for k in tree if k.startswith("lstm_")),
                    rnn_neurons=int(tree["lstm_0"]["hi"]["kernel"].shape[0]),
                    dnn_neurons=int(tree["dnn"]["kernel"].shape[1]))
    else:
        tree = convert_transformer_lm(sd)
        base.update(model_type="transformer", output_proj=tree.pop("__output_proj__"),
                    d_model=int(tree["emb"]["emb"]["embedding"].shape[1]),
                    num_layers=sum(1 for k in tree["encoder"] if k.startswith("layer_")),
                    d_ffn=int(tree["encoder"]["layer_0"]["pos_ffn"]["ffn_in"]["kernel"].shape[1]))
    keys = check_consumption(sd, "lm.ckpt", show_report, allow_unconsumed)
    lm = build_lm(LMConfig(**base), cfg.model.output_neurons, device=device)
    load_jax_params(lm, tree)
    lm_dir = os.path.join(out_dir, "lm")
    CheckpointManager(os.path.join(lm_dir, "save")).save(0, {"params": lm.state_dict()})
    with open(os.path.join(lm_dir, "lm_config.json"), "w") as f:
        json.dump(base, f, indent=1)
    n = sum(p.numel() for p in lm.parameters())
    print(f"converted LM ({base['model_type']}, {n:,} params) -> {lm_dir} "
          f"(fuse with --lm-ckpt {lm_dir})")
    return {"dir": lm_dir, "params": n, "keys": keys}


def transducer_tree(tree: Dict) -> Tuple[Dict, Tuple[str, ...]]:
    """`convert_transducer_model`'s tree for the port's
    `{"encoder": SpeechRecognizer, "transducer": TransducerModel}`, and the
    port parameters it leaves as they are. The recognizer's own `ctc_lin`
    is not on a transducer's path (its CTC head is `proj_ctc` over
    `proj_enc`): the converter fills it from `proj_ctc` for the flax
    module, whose input is the joint width, not the encoder's, so it is
    dropped here. A checkpoint without the CE head (`dec_lin`, read by
    training only) leaves that too."""
    tree = {"encoder": {k: v for k, v in tree["encoder"].items() if k != "ctc_lin"},
            "transducer": tree["transducer"]}
    may_lack = ("encoder.ctc_lin.",)
    if "dec_lin" not in tree["transducer"]:
        may_lack += ("transducer.dec_lin.",)
    return tree, may_lack


def is_sentencepiece_model(path: str) -> bool:
    """Whether a file parses as a SentencePiece ModelProto with pieces."""
    try:
        with open(path, "rb") as f:
            return len(parse_model_proto(f.read())) > 0
    except (OSError, IndexError, ValueError, struct.error):   # not a ModelProto
        return False


def tokenizer_name(path: str) -> str:
    """The run directory's name for a tokenizer file: a SentencePiece model
    (a `.model`, or a `tokenizer.ckpt` by its content) is `tokenizer.model`;
    a `.json` holding `pieces` is the subword `tokenizer.json`, any other
    `.json` the character map `tokenizer_vocab.json`."""
    base = os.path.basename(path)
    if base in ("tokenizer.json", "tokenizer.model", "tokenizer_vocab.json"):
        return base
    ext = os.path.splitext(base)[1]
    if ext == ".model" or is_sentencepiece_model(path):
        return "tokenizer.model"
    if ext == ".json":
        with open(path) as f:
            data = json.load(f)
        return ("tokenizer.json" if isinstance(data, dict) and "pieces" in data
                else "tokenizer_vocab.json")
    raise SystemExit("--tokenizer must be a .json (subword or character map) or a "
                     "SentencePiece .model")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Convert; returns the summary (as printed)."""
    args = parse_args(argv)
    if args.ref_dir:
        def pick(current, name):
            path = os.path.join(args.ref_dir, name)
            return current or (path if os.path.exists(path) else None)

        args.torch_ckpt = pick(args.torch_ckpt, "model.ckpt")
        args.lm_ckpt = pick(args.lm_ckpt, "lm.ckpt")
        args.norm_ckpt = pick(args.norm_ckpt, "normalizer.ckpt")
        args.tokenizer = pick(args.tokenizer, "tokenizer.ckpt")
    if not args.torch_ckpt:
        raise SystemExit("need --torch-ckpt (or --ref-dir holding model.ckpt)")
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    cfg = load_recipe(args.recipe)
    m = cfg.model
    sd = TrackedStateDict(load_torch_checkpoint(args.torch_ckpt))
    if cfg.transducer is not None:
        model, fbank, td = build_model(cfg, device=device)
        tree = convert_transducer_model(sd, nhead=m.nhead, mode=m.mode,
                                        num_encoder_layers=m.num_encoder_layers)
        target = torch.nn.ModuleDict({"encoder": model, "transducer": td})
        tree, may_lack = transducer_tree(tree)
    else:
        model, fbank = build_model(cfg, device=device)
        tree = convert_full_model(sd, nhead=m.nhead, mode=m.mode,
                                  num_encoder_layers=m.num_encoder_layers,
                                  num_decoder_layers=m.num_decoder_layers)
        target, may_lack = model, ()
    keys = check_consumption(sd, "model.ckpt", args.report, args.allow_unconsumed)
    load_jax_params(target, tree, may_lack=may_lack)
    if may_lack:
        print(f"note: {', '.join(p.rstrip('.') for p in may_lack)} keep their initial weights "
              "(not on the transducer's decoding path)")

    if args.norm_ckpt:
        norm_stats = norm_stats_from_reference(args.norm_ckpt, cfg.features.n_mels, device)
    else:
        print("WARNING: no --norm-ckpt: saving zero input-normalisation statistics; decoding "
              "is wrong unless the training run did not normalise")
        norm_stats = NormStats.init(cfg.features.n_mels, device=device)
    save_dir = os.path.join(args.output, "save")
    CheckpointManager(save_dir).save(0, {"params": target.state_dict(), "norm_stats": norm_stats,
                                         "step": CONVERTED_STEP, "epoch": CONVERTED_EPOCH})
    if args.tokenizer:
        shutil.copy(args.tokenizer, os.path.join(args.output, tokenizer_name(args.tokenizer)))
    lm = None
    if args.lm_ckpt:
        lm = convert_lm_ckpt(cfg, args.lm_ckpt, args.output, cfg.transducer is not None, device,
                             args.report, args.allow_unconsumed)
    n_params = sum(p.numel() for p in target.parameters())
    summary = {"params": n_params, "keys": keys, "save": save_dir,
               "tokenizer": tokenizer_name(args.tokenizer) if args.tokenizer else None,
               "lm": lm, "seconds": round(time.perf_counter() - t0, 3)}
    print(f"converted {n_params:,} parameters -> {save_dir} (evaluate with --ckpt {save_dir})")
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
