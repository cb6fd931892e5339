"""Train a language model for shallow fusion on the card — the port of the
JAX package's `recipes/train_lm.py`: the Transformer LM of the attention
recipes (`lm.model_type: transformer`) or the RNNLM of the transducer
recipes (`rnn`).

    python -m summarymixing_tpu_torch.recipes.train_lm recipes/Synthetic/hard_synthetic.yaml \\
        [--train-manifest train.csv] [--text corpus.txt] --tokenizer-dir ASR_RUN_DIR \\
        --output LM_RUN_DIR [--epochs 5] [--steps N] [--set lm.lr=0.001] [--device cpu]

The LM shares the ASR run's tokenizer (`--tokenizer-dir`) and its bos and
eos ids: fusion starts every hypothesis from the recipe's bos. Sentences
are grouped into power-of-two length buckets of `lm.batch_tokens` tokens;
each step is the masked next-token cross-entropy under AdamW (weight decay
0.01, gradients clipped to norm 5) with the Noam schedule peaking at
`lm.lr` after 1000 steps. The run directory gets `lm_config.json`, a
checkpoint per epoch under `save/` (the last three kept) and
`train_log.txt`, the layout `evaluate.restore_lm` reads; `lm_config.json`
records the architecture. Without an `lm:` block the recipe's LM is
`LMConfig()`, the Transformer: pass `--model-type rnn` for the RNNLM."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from summarymixing_tpu_torch.config import build_lm, load_recipe
from summarymixing_tpu_torch.config.schema import LMConfig
from summarymixing_tpu_torch.data.dataio import Utterance, read_manifest_csv
from summarymixing_tpu_torch.ops.layers import set_dropout_generator
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.training.logger import FileTrainLogger
from summarymixing_tpu_torch.training.optim import AdamW, noam_schedule
from summarymixing_tpu_torch.utils.device import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe")
    ap.add_argument("--train-manifest", default=None)
    ap.add_argument("--text", default=None, help="plain-text corpus, one sentence per line")
    ap.add_argument("--tokenizer-dir", default=None,
                    help="ASR run directory whose tokenizer to reuse")
    ap.add_argument("--output", required=True)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--model-type", default=None, help="override lm.model_type")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides", help="override a recipe value by dotted path")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless this says otherwise (e.g. cpu)")
    return ap.parse_args(argv)


def load_texts(args: argparse.Namespace) -> List[str]:
    texts = []
    if args.train_manifest:
        texts += [u.text for u in read_manifest_csv(args.train_manifest)]
    if args.text:
        with open(args.text) as f:
            texts += [line.strip() for line in f if line.strip()]
    if not texts:
        raise SystemExit("no training text (--train-manifest / --text)")
    return texts


def lm_batches(token_seqs: Sequence[np.ndarray], max_seq_len: int, batch_tokens: int,
               shuffle_seed: int, bos_id: int = 1, eos_id: int = 2,
               device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Length-bucketed batches of `(input, target, length)` on `device`:
    input `[bos, t...]`, target `[t..., eos]`, lengths in tokens + 1. A
    sentence goes to the power-of-two bucket above its length (at least
    8); a bucket's batches hold `batch_tokens // bucket` sentences, the
    last filled by repetition. bos and eos must be the ASR recipe's."""
    rng = np.random.default_rng(shuffle_seed)
    order = rng.permutation(len(token_seqs))
    by_bucket: Dict[int, List[np.ndarray]] = {}
    for i in order:
        toks = token_seqs[i][:max_seq_len - 1]
        length = max(len(toks) + 1, 8)
        by_bucket.setdefault(1 << (length - 1).bit_length(), []).append(toks)
    for b, seqs in sorted(by_bucket.items()):
        bs = max(batch_tokens // b, 1)
        for k in range(0, len(seqs), bs):
            chunk = seqs[k:k + bs]
            while len(chunk) < bs:
                chunk = chunk + chunk[:bs - len(chunk)]
            inp = np.zeros((bs, b), np.int64)
            tgt = np.zeros((bs, b), np.int64)
            lens = np.zeros((bs,), np.int64)
            for j, toks in enumerate(chunk):
                n = len(toks)
                inp[j, 0] = bos_id
                inp[j, 1:n + 1] = toks
                tgt[j, :n] = toks
                tgt[j, n] = eos_id
                lens[j] = n + 1
            yield tuple(torch.from_numpy(a).to(device) for a in (inp, tgt, lens))


def lm_loss(lm, inp: torch.Tensor, tgt: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Mean next-token negative log-likelihood over the valid positions."""
    lp = torch.log_softmax(lm(inp).to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    mask = (torch.arange(inp.shape[1], device=inp.device)[None, :] < lens[:, None]).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train the LM; returns `steps`, `step_s` (host time of each step,
    each ending in a device synchronisation), `loss` (the last epoch's mean)
    and `params`."""
    args = parse_args(argv)
    cfg = load_recipe(args.recipe, overrides=common.parse_overrides(args.overrides))
    lm_cfg = cfg.lm or LMConfig()
    if args.model_type:
        lm_cfg.model_type = args.model_type
    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    # the architecture goes with the run: evaluate.restore_lm rebuilds the
    # LM from this file, so a decoding recipe without an lm: block works
    with open(os.path.join(args.output, "lm_config.json"), "w") as f:
        json.dump(dataclasses.asdict(lm_cfg), f, indent=1)

    texts = load_texts(args)
    tokenizer = common.build_or_load_tokenizer(
        cfg, args.tokenizer_dir or args.output, [Utterance("", "", 0.0, t) for t in texts])
    token_seqs = [np.asarray(tokenizer.encode(t), np.int64) for t in texts]
    lm = build_lm(lm_cfg, cfg.model.output_neurons, device=device, seed=cfg.seed)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    set_dropout_generator(lm, generator)
    params = [p for p in lm.parameters() if p.requires_grad]
    optimizer = AdamW(noam_schedule(lm_cfg.lr, 1000), weight_decay=0.01)
    opt_state = optimizer.init(params)
    bos_id, eos_id = cfg.model.bos_index, cfg.model.eos_index

    logger = FileTrainLogger(os.path.join(args.output, "train_log.txt"))
    ckpt = CheckpointManager(os.path.join(args.output, "save"), max_to_keep=3)
    step, step_s, mean_loss = 0, [], 0.0
    lm.train()
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        losses = []
        for inp, tgt, lens in lm_batches(token_seqs, lm_cfg.max_seq_len, lm_cfg.batch_tokens,
                                         cfg.seed + epoch, bos_id, eos_id, device):
            ts = time.perf_counter()
            for p in params:
                p.grad = None
            loss = lm_loss(lm, inp, tgt, lens)
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            opt_state = optimizer.step(params, grads, opt_state)
            losses.append(float(loss.detach()))
            step_s.append(time.perf_counter() - ts)
            step += 1
            if args.steps and step >= args.steps:
                break
        mean_loss = float(np.mean(losses)) if losses else 0.0
        logger.log_stats({"epoch": epoch, "steps": step, "epoch_s": round(time.time() - t0, 1)},
                         {"loss": mean_loss, "ppl": round(float(np.exp(min(mean_loss, 20.0))), 2)})
        ckpt.save(step, {"params": lm.state_dict()})
        if args.steps and step >= args.steps:
            break
    lm.eval()
    print("lm training done:", step, "steps; ckpt in", os.path.join(args.output, "save"),
          flush=True)
    return {"steps": step, "step_s": step_s, "loss": mean_loss,
            "params": sum(p.numel() for p in params)}


if __name__ == "__main__":
    main()
