"""Pieces the port's runners share — the port of the helpers of the JAX
package's `recipes/train.py`: bucket construction and the steps-per-epoch
estimate, the batch iterator (WAV files in, tensors on the run's device
out), scoring of decoded batches, greedy and beam decoding of a manifest,
the fusion LM, the training run's tokenizer, and `--set` overrides.

One card, so batches are not split over devices (`batch_multiple` 1), and
the JAX loader's multi-process row split has no counterpart."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from summarymixing_tpu_torch.config import yaml_lite
from summarymixing_tpu_torch.data.batching import DynamicBucketBatcher, make_buckets, pad_batch
from summarymixing_tpu_torch.data.dataio import Utterance, load_wav
from summarymixing_tpu_torch.data.subword import SubwordTokenizer, train_subword
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer, SentencePieceTokenizer
from summarymixing_tpu_torch.evaluate import evaluate_beam, restore_lm, static_decode_length
from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
from summarymixing_tpu_torch.training.metrics import ErrorRateStats

KERNELS = (("summary_mixing", fused_summary.fused_summary_mixing),
           ("csgu", fused_csgu.fused_convolution_branch))


def kernel_counts(since: Optional[Dict] = None) -> Dict[str, Dict[str, int]]:
    """Each kernel wrapper's `launches`, and its `plain_calls`: the cells
    or cgMLP branches on the card whose configuration the kernel does not
    take (a float32 recipe, a sum mask, ...), run on the plain path. With
    `since`, an earlier reading, their rise since then. Both stay 0 on the
    CPU."""
    now = {name: {"launches": fn.launches, "plain_calls": fn.plain_calls}
           for name, fn in KERNELS}
    if since is None:
        return now
    return {name: {k: v - since[name][k] for k, v in c.items()} for name, c in now.items()}


def parse_overrides(pairs: Optional[Sequence[str]]) -> Dict:
    """`--set key=value` pairs -> dotted-path overrides for `load_recipe`.
    Values are read as a recipe's values are (`yaml_lite.parse_value`), so
    ints, floats, booleans and flow lists work: `--set training.lr_adam=0.0005`."""
    out = {}
    for kv in pairs or []:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        out[key] = yaml_lite.parse_value(val)
    return out


def build_buckets(manifest: Sequence[Utterance], cfg, valid: bool = False):
    """`(lengths in samples, buckets)` for a manifest: the training budget
    `max_batch_length`, or with `valid` the smaller `max_batch_length_val`
    when the recipe sets one (the evaluation beam is wider)."""
    sr = cfg.features.sample_rate
    lengths = [int(u.duration * sr) for u in manifest]
    budget = cfg.training.max_batch_length
    if valid and cfg.training.max_batch_length_val is not None:
        budget = cfg.training.max_batch_length_val
    buckets = make_buckets(
        max_batch_length=budget * sr, num_buckets=cfg.training.num_buckets,
        min_len=max(min(lengths), sr // 4), max_len=max(lengths),
        max_batch_size=cfg.training.max_batch_ex, batch_multiple=1,
        quantize=cfg.training.bucket_shape_grid)
    return lengths, buckets


def estimate_steps_per_epoch(manifest: Sequence[Utterance], cfg) -> int:
    """Full training batches per epoch (the last short batch of each bucket
    is dropped); 0 when the corpus is smaller than one batch."""
    lengths, buckets = build_buckets(manifest, cfg)
    return DynamicBucketBatcher(lengths, buckets).num_batches()


def batches(manifest: Sequence[Utterance], tokenizer, cfg, shuffle: bool, seed: int,
            device) -> Iterator[Tuple[Dict[str, torch.Tensor], np.ndarray]]:
    """Yield `(batch, indices)`: `batch` holds `wav` `[B, max_len]` float32,
    `wav_lens`, `tokens` `[B, U]` and `token_lens` (int32) on `device`.
    Training (`shuffle`) shuffles within buckets from `seed` and drops each
    bucket's short last batch; evaluation keeps every utterance, fills the
    last batch of a bucket by repetition, and pads the token axis to a
    multiple of `eval_token_multiple`."""
    sr = cfg.features.sample_rate
    lengths, buckets = build_buckets(manifest, cfg, valid=not shuffle)
    batcher = DynamicBucketBatcher(lengths, buckets, shuffle=shuffle, seed=seed,
                                   drop_last=shuffle)
    for spec, idx in batcher:
        toks = [np.asarray(tokenizer.encode(manifest[i].text), np.int32) for i in idx]
        umax = max(max(len(t) for t in toks), 1)
        if not shuffle:
            m = max(int(cfg.training.eval_token_multiple), 1)
            umax = -(-umax // m) * m
        tokens, token_lens = pad_batch(toks, umax)
        wav = np.zeros((len(idx), spec.max_len), np.float32)
        wav_lens = np.zeros((len(idx),), np.int32)
        for row, i in enumerate(idx):
            audio = load_wav(manifest[i].wav_path, sr)[:spec.max_len]
            wav[row, :len(audio)] = audio
            wav_lens[row] = len(audio)
        host = {"wav": wav, "wav_lens": wav_lens, "tokens": tokens.astype(np.int32),
                "token_lens": token_lens}
        yield {k: torch.from_numpy(v).to(device) for k, v in host.items()}, idx


def error_rate_stats(cfg, keep_details: bool = False) -> ErrorRateStats:
    return ErrorRateStats(split_tokens=(cfg.error_rate == "cer"),
                          remove_spaces=cfg.remove_spaces, keep_details=keep_details)


def score_batch(stats: ErrorRateStats, tokenizer, batch: Dict, idx: Sequence[int], seen: set,
                hyp_tokens, hyp_lens=None, record: Optional[Dict] = None) -> int:
    """Score one decoded batch into `stats`, each utterance once (evaluation
    batches repeat utterances to fill the last batch of a bucket; `seen`
    holds the indices scored so far). `hyp_tokens` is a ragged list of
    token-id lists (greedy CTC), or a `[B, U]` array with `hyp_lens` `[B]`.
    With `record`, each scored utterance's hypothesis words are stored
    there under its index. Returns the number of newly scored utterances."""
    keep = []
    for i, u in enumerate(idx):
        if int(u) not in seen:
            seen.add(int(u))
            keep.append(i)
    toks = batch["tokens"].cpu().numpy()
    tlens = batch["token_lens"].cpu().numpy()
    refs = [tokenizer.decode(toks[i, :int(tlens[i])]).split() for i in keep]
    if hyp_lens is None:
        hyps = [tokenizer.decode(hyp_tokens[i]).split() for i in keep]
    else:
        hyp_np, hlens = np.asarray(hyp_tokens), np.asarray(hyp_lens)
        hyps = [tokenizer.decode(hyp_np[i, :int(hlens[i])]).split() for i in keep]
    stats.append(refs, hyps, ids=[int(idx[i]) for i in keep])
    if record is not None:
        record.update({int(idx[i]): hyp for i, hyp in zip(keep, hyps)})
    return len(keep)


def greedy_score(stats: ErrorRateStats, trainer, state: Dict, manifest: Sequence[Utterance],
                 tokenizer, cfg, device, record: Optional[Dict] = None) -> float:
    """Greedy CTC over a manifest through `ASRTrainer.eval_step`, scored
    into `stats` (and each hypothesis into `record`, see `score_batch`);
    returns the mean loss."""
    losses, seen = [], set()
    for batch, idx in batches(manifest, tokenizer, cfg, False, 0, device):
        out, hyps = trainer.eval_step(state, batch)
        losses.append(float(out["loss"]))
        score_batch(stats, tokenizer, batch, idx, seen, hyps, record=record)
    return float(np.mean(losses)) if losses else 0.0


def load_fusion_lm(cfg, lm_ckpt: Optional[str], device):
    """The fusion LM of `lm_ckpt` (`evaluate.restore_lm`), or None without
    one or at `lm_weight` 0."""
    if not lm_ckpt or cfg.decoding.lm_weight <= 0.0:
        return None
    restored = restore_lm(cfg, lm_ckpt, device=device)
    if restored is None:
        print(f"WARNING: no LM checkpoint in {lm_ckpt}; decoding without LM fusion")
        return None
    return restored[1]


def decode_length(cfg, manifest: Sequence[Utterance], fbank) -> int:
    """One decode-length cap per run, from the largest evaluation bucket
    (`evaluate.static_decode_length` of its padded length)."""
    _, buckets = build_buckets(manifest, cfg, valid=True)
    return static_decode_length(cfg, max(spec.max_len for spec in buckets), fbank)


def beam_score(stats: ErrorRateStats, cfg, model, fbank, norm_stats: Dict,
               manifest: Sequence[Utterance], tokenizer, device, lm=None,
               beam_size: Optional[int] = None, temperature: float = 1.0,
               record: Optional[Dict] = None) -> int:
    """Joint CTC/attention beam search over a manifest, scored into
    `stats`: the JAX `recipes/train.py::beam_validate` (valid stage at
    `valid_beam_size` and temperature 1; with `test_beam_size` and
    `test_temperature`, the test stage), through `evaluate.evaluate_beam`
    batch by batch with one decode-length cap for the run, the KV-cached
    decoder and, given an LM, its fusion at `lm_weight`. `record` as in
    `score_batch`. Returns the number of utterances scored."""
    beam = beam_size or cfg.decoding.valid_beam_size
    lmax = decode_length(cfg, manifest, fbank)
    seen: set = set()
    n = 0
    for batch, idx in batches(manifest, tokenizer, cfg, False, 0, device):
        out = evaluate_beam(model, fbank, norm_stats, [(idx, batch["wav"], batch["wav_lens"])],
                            cfg, lm, beam_size=beam, temperature=temperature,
                            max_length=lmax)
        n += score_batch(stats, tokenizer, batch, idx, seen, [out["hyps"][int(u)] for u in idx],
                         record=record)
    return n


def build_or_load_tokenizer(cfg, out_dir: str, train_set: Sequence[Utterance]):
    """The run's tokenizer (the JAX `recipes/train.py` order): 1) a subword
    model trained earlier in `out_dir` (`tokenizer.json`); 2) a
    SentencePiece `tokenizer.model` there (not ported: raises); 3) a
    unigram or BPE model trained now from the transcripts to
    `model.output_neurons` pieces; char recipes load or build a character
    map (`tokenizer_vocab.json`). What is built is written to `out_dir`, so
    evaluation decodes with the same ids."""
    os.makedirs(out_dir, exist_ok=True)
    if cfg.tokenizer_type == "char":
        vocab_path = os.path.join(out_dir, "tokenizer_vocab.json")
        if os.path.exists(vocab_path):
            with open(vocab_path) as f:
                return CharTokenizer(vocab=json.load(f))
        tokenizer = CharTokenizer.build([u.text for u in train_set])
        tmp = vocab_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(tokenizer.vocab, f)
        os.replace(tmp, vocab_path)
        return tokenizer
    json_path = os.path.join(out_dir, "tokenizer.json")
    if os.path.exists(json_path):
        return SubwordTokenizer.load(json_path)
    sp_path = os.path.join(out_dir, "tokenizer.model")
    if os.path.exists(sp_path):
        return SentencePieceTokenizer(sp_path)
    tokenizer = train_subword([u.text for u in train_set], cfg.model.output_neurons,
                              cfg.token_type)
    tokenizer.save(json_path + ".tmp")
    os.replace(json_path + ".tmp", json_path)
    print(f"trained {cfg.token_type} tokenizer: {tokenizer.vocab_size} pieces -> {json_path}")
    return tokenizer
