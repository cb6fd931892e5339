"""Pieces the port's runners share — the port of the helpers of the JAX
package's `recipes/train.py`: bucket construction and the steps-per-epoch
estimate, the batch iterator (WAV files in, tensors on the run's device
out), scoring of decoded batches, greedy and beam decoding of a manifest (CTC,
attention and transducer), a trained run restored for inference, the fusion LMs (the Transformer LM of the
attention recipes and the RNNLM of the transducer recipes), the training
run's tokenizer, `--set` overrides, and the runners' multi-process start
(`start_processes`).

In a multi-process run (`parallel/launch.py`) bucket sizes are a multiple
of the process count (`batch_multiple`, the JAX runner's global device
count), every process iterates the same batches and tokenises every row,
and loads only its own rows (`launch.local_rows`); decoded rows are
gathered so every process scores the whole batch (greedy CTC's ids and
marks with `launch.fetch_global`, token lists otherwise), and validation
losses are summed over the processes (`launch.allreduce_counts`)."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from summarymixing_tpu_torch.config import yaml_lite
from summarymixing_tpu_torch.data.batching import DynamicBucketBatcher, make_buckets, pad_batch
from summarymixing_tpu_torch.data import native_loader
from summarymixing_tpu_torch.decoding.ctc import collapse_ctc
from summarymixing_tpu_torch.data.dataio import Utterance
from summarymixing_tpu_torch.data.subword import SubwordTokenizer, train_subword
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer, SentencePieceTokenizer
from summarymixing_tpu_torch.decoding.transducer_search import (
    transducer_beam_search_batched,
    transducer_greedy_decode,
)
from summarymixing_tpu_torch.evaluate import (
    evaluate_beam,
    restore_eval_state,
    restore_lm,
    static_decode_length,
)
from summarymixing_tpu_torch.ops import attention, fused_csgu, fused_summary
from summarymixing_tpu_torch.parallel import launch
from summarymixing_tpu_torch.training.metrics import ErrorRateStats
from summarymixing_tpu_torch.utils.device import resolve_device

KERNELS = (("summary_mixing", fused_summary.fused_summary_mixing),
           ("csgu", fused_csgu.fused_convolution_branch),
           ("relpos_attention", attention.fused_relpos_attention))


def kernel_counts(since: Optional[Dict] = None) -> Dict[str, Dict[str, int]]:
    """Each kernel wrapper's `launches`, and its `plain_calls`: the cells,
    cgMLP branches or RelPosMHAXL calls on the card that the kernel does not
    take (a float32 recipe, a sum mask, an attn_mask, ...), run on the plain
    path. With
    `since`, an earlier reading, their rise since then. Both stay 0 on the
    CPU. The cgMLP's entry also has `int8_calls`: the branches of an
    `act_int8` model, which run the W8A8 route on any device and are
    neither launches nor plain calls."""
    now = {name: {"launches": fn.launches, "plain_calls": fn.plain_calls,
                  **({"int8_calls": fn.int8_calls} if hasattr(fn, "int8_calls") else {})}
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


def start_processes(device: Optional[str]) -> Dict:
    """Join a multi-process launch (`launch.initialize`, a no-op without
    the `SMT_*` variables) on the runner's `--device` (None: the card);
    print and return the `[dist]` facts."""
    if not launch.initialize(device=device or "cuda"):
        return {"processes": 1, "index": 0, "backend": None}
    info = {"processes": launch.process_count(), "index": launch.process_index(),
            "backend": launch.backend()}
    print(f"[dist] process {info['index']}/{info['processes']}, backend {info['backend']}, "
          f"device {resolve_device(device)}", flush=True)
    return info


def data_shards(shards: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """`(count, index)` of the data axis: the processes, unless given."""
    return shards or (launch.process_count(), launch.process_index())


def build_buckets(manifest: Sequence[Utterance], cfg, valid: bool = False,
                  batch_multiple: Optional[int] = None):
    """`(lengths in samples, buckets)` for a manifest: the training budget
    `max_batch_length`, or with `valid` the smaller `max_batch_length_val`
    when the recipe sets one (the evaluation beam is wider); batch sizes a
    multiple of `batch_multiple`, the process count by default."""
    sr = cfg.features.sample_rate
    lengths = [int(u.duration * sr) for u in manifest]
    budget = cfg.training.max_batch_length
    if valid and cfg.training.max_batch_length_val is not None:
        budget = cfg.training.max_batch_length_val
    buckets = make_buckets(
        max_batch_length=budget * sr, num_buckets=cfg.training.num_buckets,
        min_len=max(min(lengths), sr // 4), max_len=max(lengths),
        max_batch_size=cfg.training.max_batch_ex,
        batch_multiple=launch.process_count() if batch_multiple is None else batch_multiple,
        quantize=cfg.training.bucket_shape_grid)
    return lengths, buckets


def estimate_steps_per_epoch(manifest: Sequence[Utterance], cfg) -> int:
    """Full training batches per epoch (the last short batch of each bucket
    is dropped); 0 when the corpus is smaller than one batch."""
    lengths, buckets = build_buckets(manifest, cfg)
    return DynamicBucketBatcher(lengths, buckets).num_batches()


def batches(manifest: Sequence[Utterance], tokenizer, cfg, shuffle: bool, seed: int,
            device, shards: Optional[Tuple[int, int]] = None
            ) -> Iterator[Tuple[Dict[str, torch.Tensor], np.ndarray]]:
    """Yield `(batch, indices)`: `batch` holds `wav` `[B, max_len]` float32,
    `wav_lens`, `tokens` `[B, U]` and `token_lens` (int32) on `device`,
    the audio decoded by the native loader (`data/native_loader.py`).
    Training (`shuffle`) shuffles within buckets from `seed` and drops each
    bucket's short last batch; evaluation keeps every utterance, fills the
    last batch of a bucket by repetition, and pads the token axis to a
    multiple of `eval_token_multiple`. On a data axis of `shards` =
    `(count, index)` (`data_shards`) `batch` holds this shard's rows of the
    global batch and `indices` all of the global batch's."""
    sr = cfg.features.sample_rate
    count, index = data_shards(shards)
    lengths, buckets = build_buckets(manifest, cfg, valid=not shuffle, batch_multiple=count)
    batcher = DynamicBucketBatcher(lengths, buckets, shuffle=shuffle, seed=seed,
                                   drop_last=shuffle)
    for spec, idx in batcher:
        toks = [np.asarray(tokenizer.encode(manifest[i].text), np.int32) for i in idx]
        umax = max(max(len(t) for t in toks), 1)
        if not shuffle:
            m = max(int(cfg.training.eval_token_multiple), 1)
            umax = -(-umax // m) * m
        tokens, token_lens = pad_batch(toks, umax)
        rows = launch.local_rows(len(idx), count, index) if count > 1 else slice(None)
        wav, wav_lens = native_loader.load_wav_batch([manifest[i].wav_path for i in idx[rows]],
                                                     spec.max_len, sr)
        host = {"wav": wav, "wav_lens": wav_lens, "tokens": tokens[rows].astype(np.int32),
                "token_lens": token_lens[rows]}
        yield {k: torch.from_numpy(v).to(device) for k, v in host.items()}, idx


def error_rate_stats(cfg, keep_details: bool = False) -> ErrorRateStats:
    return ErrorRateStats(split_tokens=(cfg.error_rate == "cer"),
                          remove_spaces=cfg.remove_spaces, keep_details=keep_details)


def record_nbest(nbest_rows: Optional[Dict], tokenizer, idx: Sequence[int],
                 ranked: Sequence[Sequence[Tuple[Sequence[int], float]]]) -> None:
    """Store each utterance's n-best, `ranked[i]` a score-sorted list of
    `(token ids, score)` for the utterance of index `idx[i]`, in
    `nbest_rows` under that index as `[{"text", "score"}, ...]`, each
    utterance once (the rows of the JAX runner's `nbest.jsonl`)."""
    if nbest_rows is None:
        return
    for u, hyps in zip(idx, ranked):
        if int(u) not in nbest_rows:
            nbest_rows[int(u)] = [{"text": tokenizer.decode(h), "score": float(sc)}
                                  for h, sc in hyps]


def gather_rows(rows: Sequence) -> list:
    """Every process's rows (per-utterance items of its slice of a batch),
    in process order: the whole batch's. One process: `rows`."""
    if launch.process_count() == 1:
        return list(rows)
    return [r for part in launch.gather_objects(list(rows)) for r in part]


def score_batch(stats: ErrorRateStats, tokenizer, batch: Dict, idx: Sequence[int], seen: set,
                hyp_tokens: Sequence[Sequence[int]], record: Optional[Dict] = None,
                gathered: bool = False) -> int:
    """Score one decoded batch into `stats`, each utterance once (evaluation
    batches repeat utterances to fill the last batch of a bucket; `seen`
    holds the indices scored so far). `hyp_tokens` holds the token ids of
    every row of the whole batch; `batch`'s references are gathered from
    every process (`launch.fetch_global`), unless `gathered` says `batch`
    already holds the whole batch's. With `record`, each scored
    utterance's hypothesis words are stored there under its index.
    Returns the number of newly scored utterances."""
    keep = []
    for i, u in enumerate(idx):
        if int(u) not in seen:
            seen.add(int(u))
            keep.append(i)
    fetch = np.asarray if gathered else launch.fetch_global
    toks, tlens = fetch(batch["tokens"]), fetch(batch["token_lens"])
    refs = [tokenizer.decode(toks[i, :int(tlens[i])]).split() for i in keep]
    hyps = [tokenizer.decode(hyp_tokens[i]).split() for i in keep]
    stats.append(refs, hyps, ids=[int(idx[i]) for i in keep])
    if record is not None:
        record.update({int(idx[i]): hyp for i, hyp in zip(keep, hyps)})
    return len(keep)


def greedy_score(stats: ErrorRateStats, trainer, state: Dict, manifest: Sequence[Utterance],
                 tokenizer, cfg, device, record: Optional[Dict] = None) -> float:
    """Greedy CTC over a manifest through `ASRTrainer.eval_greedy`, scored
    into `stats` (and each hypothesis into `record`, see `score_batch`);
    returns the mean loss (over the batches and, in a multi-process run,
    the processes: the same on each)."""
    losses, seen = [], set()
    for batch, idx in batches(manifest, tokenizer, cfg, False, 0, device):
        out, ids, keep = trainer.eval_greedy(state, batch)
        losses.append(float(out["loss"]))
        hyps = collapse_ctc(launch.fetch_global(ids), launch.fetch_global(keep))
        score_batch(stats, tokenizer, batch, idx, seen, hyps, record=record)
    return mean_over_processes(losses)


def mean_over_processes(values: Sequence[float]) -> float:
    """The mean of per-batch values (each a mean over this process's rows)
    over the batches and the processes; 0 without a batch."""
    if not values:
        return 0.0
    if launch.process_count() == 1:
        return float(np.mean(values))
    (total,) = launch.allreduce_counts(float(np.sum(values, dtype=np.float64)))
    return total / (len(values) * launch.process_count())


def restore_inference(cfg, ckpt: str, avg: int, device):
    """`(model, fbank, transducer or None, norm_stats)` of a trained run for
    greedy inference (the serve, transcribe and export runners): the
    recipe's modules on `device`, in eval mode, with the parameters of
    `ckpt` (the mean of the last `avg` checkpoints when `avg` > 1)."""
    from summarymixing_tpu_torch.config import build_model

    if cfg.transducer is None:
        model, fbank = build_model(cfg, device=device)
        state = restore_eval_state(model, ckpt, avg, device=device)
        return model.eval(), fbank, None, state["norm_stats"]
    model, fbank, td = build_model(cfg, device=device)
    # a transducer run saves {"encoder": ..., "transducer": ...} (TransducerTrainer.model)
    state = restore_eval_state(torch.nn.ModuleDict({"encoder": model, "transducer": td}), ckpt,
                               avg, device=device)
    return model.eval(), fbank, td.eval(), state["norm_stats"]


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


def load_rnnlm(cfg, lm_ckpt: Optional[str], device):
    """The transducer recipes' fusion RNNLM of `lm_ckpt` (the JAX
    `recipes/train.py::load_rnnlm`), or None without one, at `lm_weight` 0,
    or (with a warning) when the run's LM is not an RNNLM."""
    if not lm_ckpt or cfg.decoding.lm_weight <= 0.0:
        return None
    restored = restore_lm(cfg, lm_ckpt, device=device, default_model_type="rnn")
    if restored is None:
        print(f"WARNING: no LM checkpoint in {lm_ckpt}; decoding without LM fusion")
        return None
    if restored[0].model_type != "rnn":
        print("WARNING: transducer fusion expects an RNNLM (lm.model_type rnn); "
              "decoding without LM fusion")
        return None
    return restored[1]


@torch.no_grad()
def transducer_greedy_score(stats: ErrorRateStats, trainer, state: Dict,
                            manifest: Sequence[Utterance], tokenizer, cfg, device,
                            record: Optional[Dict] = None) -> float:
    """Greedy transducer decoding of a manifest through
    `TransducerTrainer.eval_step` (the JAX `run_valid`), scored into
    `stats`; returns the mean loss."""
    td = trainer.transducer_model
    losses, seen = [], set()
    for batch, idx in batches(manifest, tokenizer, cfg, False, 0, device):
        out, (enc_out, enc_lens) = trainer.eval_step(state, batch)
        losses.append(float(out["loss"]))
        toks, lens = transducer_greedy_decode(td.encode_proj(enc_out), enc_lens,
                                              td.predictor_init, td.predictor_step,
                                              td.joint_step, blank_id=cfg.model.blank_index)
        hyps = gather_rows(token_rows(toks.cpu().numpy(), lens.cpu().numpy()))
        score_batch(stats, tokenizer, batch, idx, seen, hyps, record=record)
    return mean_over_processes(losses)


def token_rows(toks: np.ndarray, lens: np.ndarray) -> list:
    """`[B, U]` tokens and `[B]` lengths -> B token-id lists."""
    return [[int(t) for t in toks[i, :int(lens[i])]] for i in range(len(lens))]


@torch.no_grad()
def transducer_beam_score(stats: ErrorRateStats, trainer, state: Dict,
                          manifest: Sequence[Utterance], tokenizer, cfg, device, lm=None,
                          record: Optional[Dict] = None, nbest: int = 1,
                          nbest_rows: Optional[Dict] = None) -> int:
    """The transducer recipes' test decode over a manifest: the batched
    beam search at `decoding.beam_size`, `state_beam` and `expand_beam`,
    with `lm` (an RNNLM) fused at `lm_weight`, scored into `stats`. With
    `nbest` > 1 each utterance's top `nbest` go into `nbest_rows`
    (`record_nbest`) and rank 0 is scored. Returns the number of
    utterances scored."""
    td, dec = trainer.transducer_model, cfg.decoding
    seen: set = set()
    n = 0
    for batch, idx in batches(manifest, tokenizer, cfg, False, 0, device):
        _, (enc_out, enc_lens) = trainer.eval_step(state, batch)
        toks, lens, scores = (a.cpu().numpy() for a in transducer_beam_search_batched(
            td.encode_proj(enc_out), enc_lens, td.predictor_init, td.predictor_step,
            td.joint_step, blank_id=cfg.model.blank_index, bos_id=cfg.model.bos_index,
            beam_size=dec.beam_size, state_beam=dec.state_beam, expand_beam=dec.expand_beam,
            lm_step=None if lm is None else lm.step,
            lm_init=None if lm is None else lm.initial_state,
            lm_weight=dec.lm_weight if lm is not None else 0.0, nbest=nbest))
        if nbest > 1:
            ranked = gather_rows([[(toks[i, r, :lens[i, r]], scores[i, r])
                                   for r in range(toks.shape[1])] for i in range(len(lens))])
            record_nbest(nbest_rows, tokenizer, idx, ranked)
            toks, lens = toks[:, 0], lens[:, 0]
        hyps = gather_rows(token_rows(toks, lens))
        n += score_batch(stats, tokenizer, batch, idx, seen, hyps, record=record)
    return n


def decode_length(cfg, manifest: Sequence[Utterance], fbank) -> int:
    """One decode-length cap per run, from the largest evaluation bucket
    (`evaluate.static_decode_length` of its padded length)."""
    _, buckets = build_buckets(manifest, cfg, valid=True)
    return static_decode_length(cfg, max(spec.max_len for spec in buckets), fbank)


def beam_score(stats: ErrorRateStats, cfg, model, fbank, norm_stats: Dict,
               manifest: Sequence[Utterance], tokenizer, device, lm=None,
               beam_size: Optional[int] = None, temperature: float = 1.0,
               record: Optional[Dict] = None, nbest: int = 1,
               nbest_rows: Optional[Dict] = None, totals: Optional[Dict] = None) -> int:
    """Joint CTC/attention beam search over a manifest, scored into
    `stats`: the JAX `recipes/train.py::beam_validate` (valid stage at
    `valid_beam_size` and temperature 1; with `test_beam_size` and
    `test_temperature`, the test stage), through `evaluate.evaluate_beam`
    batch by batch with one decode-length cap for the run, the KV-cached
    decoder and, given an LM, its fusion at `lm_weight`; with
    `decoding.ctc_blank_skip` > 0 the CTC scorer reads the blank-compacted
    lattice. `record` as in `score_batch`; with `nbest` > 1 each
    utterance's top `nbest` go into `nbest_rows` (`record_nbest`) and rank
    0 is scored. `totals`, when given, gathers the search steps run
    (`steps`), the search's seconds (`search_s`) and the CTC scorer's
    largest time axis (`ctc_frames`). Returns the number of utterances
    scored."""
    beam = beam_size or cfg.decoding.valid_beam_size
    lmax = decode_length(cfg, manifest, fbank)
    seen: set = set()
    n = 0
    count, index = data_shards()
    for batch, idx in batches(manifest, tokenizer, cfg, False, 0, device):
        rows = launch.local_rows(len(idx), count, index) if count > 1 else slice(None)
        out = evaluate_beam(model, fbank, norm_stats,
                            [(idx[rows], batch["wav"], batch["wav_lens"])],
                            cfg, lm, beam_size=beam, temperature=temperature,
                            max_length=lmax, nbest=nbest)
        for key in ("hyps", "nbest"):
            if count > 1 and key in out:
                out[key] = {u: h for part in launch.gather_objects(out[key])
                            for u, h in part.items()}
        if nbest > 1:
            record_nbest(nbest_rows, tokenizer, idx, [out["nbest"][int(u)] for u in idx])
        if totals is not None:
            for key in ("steps", "search_s"):
                totals[key] = totals.get(key, 0) + out[key]
            totals["ctc_frames"] = max(totals.get("ctc_frames", 0), out["ctc_frames"])
        n += score_batch(stats, tokenizer, batch, idx, seen, [out["hyps"][int(u)] for u in idx],
                         record=record)
    return n


def build_or_load_tokenizer(cfg, out_dir: str, train_set: Sequence[Utterance]):
    """The run's tokenizer (the JAX `recipes/train.py` order): 1) a subword
    model trained earlier in `out_dir` (`tokenizer.json`); 2) a
    SentencePiece `tokenizer.model` there; 3) a
    unigram or BPE model trained now from the transcripts to
    `model.output_neurons` pieces; char recipes load or build a character
    map (`tokenizer_vocab.json`). What is built is written to `out_dir`, so
    evaluation decodes with the same ids (by process 0 alone in a
    multi-process run: every process builds the same tokenizer from the
    same transcripts)."""
    os.makedirs(out_dir, exist_ok=True)
    if cfg.tokenizer_type == "char":
        vocab_path = os.path.join(out_dir, "tokenizer_vocab.json")
        if os.path.exists(vocab_path):
            with open(vocab_path) as f:
                return CharTokenizer(vocab=json.load(f))
        tokenizer = CharTokenizer.build([u.text for u in train_set])
        if launch.is_coordinator():   # one writer on a shared run directory
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
    if launch.is_coordinator():
        tokenizer.save(json_path + ".tmp")
        os.replace(json_path + ".tmp", json_path)
    print(f"trained {cfg.token_type} tokenizer: {tokenizer.vocab_size} pieces -> {json_path}")
    return tokenizer
