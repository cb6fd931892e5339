"""Evaluation of the port: the attention-recipe branch of the JAX
package's `recipes/evaluate.py --beam` with the evaluation helpers of
`recipes/train.py`, and the transducer's chunked streaming decode (its
`--streaming` branch, `streaming_decode`).

    model, fbank = build_model(cfg)                          # on the card
    state = restore_eval_state(model, "results/save", avg=10)
    lm = restore_lm(cfg, "results_lm")                       # or None
    batches = list(batch_waveforms(wavs, 8, 8000))
    out = evaluate_beam(model, fbank, state["norm_stats"], batches, cfg, lm, refs)

Per batch: Fbank -> InputNormalization with frozen statistics -> the
encoder and the CTC head -> a joint CTC/attention beam search
(`decoding.s2s_beam`) at `decoding.test_beam_size`, `ctc_weight_decode`
and `test_temperature`, with the KV-cached decoder step and, given an LM,
its KV-cached step fused at `lm_weight` after a log-softmax at
`lm_temperature`. Batches wider than `decoding.max_beam_rows` // beam
utterances are searched in slices. `evaluate_beam` scores token ids as
words; the runners (`recipes/evaluate.py`, `recipes/train.py`) score text
through the run's tokenizer. Blank-skip compaction
(`decoding.ctc_blank_skip` > 0) is not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from summarymixing_tpu_torch.decoding.s2s_beam import S2SBeamConfig, s2s_beam_search, tile_for_beam
from summarymixing_tpu_torch.decoding.transducer_search import transducer_greedy_decode
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.models.asr import DynChunkTrainConfig
from summarymixing_tpu_torch.ops.masks import length_to_mask
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager, average_checkpoints
from summarymixing_tpu_torch.training.metrics import ErrorRateStats


def static_decode_length(cfg, max_samples: int, fbank) -> int:
    """One decode-length cap per run, from the longest waveform: its
    encoder frames (Fbank frames through the frontend's strides) times
    `max_decode_ratio`, clamped to [8, 256]."""
    frames = int(fbank.frame_lengths(torch.tensor([int(max_samples)]))[0])
    for stride in cfg.model.frontend_strides:
        frames = -(-frames // stride)
    return min(max(int(frames * cfg.decoding.max_decode_ratio), 8), 256)


def restore_lm(cfg, lm_ckpt_dir: str, device=None):
    """The fusion LM of a run directory, `(lm_cfg, lm)` on `device` (the
    card unless told otherwise), or None when it holds no checkpoint. An
    `lm_config.json` beside its `save/` directory takes precedence over the
    recipe's `lm:` block (the weights fix the architecture); without
    either, `LMConfig()` applies."""
    from summarymixing_tpu_torch.config.loader import build_lm
    from summarymixing_tpu_torch.config.schema import LMConfig

    lm_cfg = cfg.lm or LMConfig()
    save_dir = (lm_ckpt_dir if os.path.basename(lm_ckpt_dir) == "save"
                else os.path.join(lm_ckpt_dir, "save"))
    cfg_path = os.path.join(os.path.dirname(save_dir), "lm_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(LMConfig)}
        lm_cfg = LMConfig(**{k: v for k, v in data.items() if k in known})
    if not os.path.isdir(save_dir):
        return None
    raw = CheckpointManager(save_dir).restore({"params": None}, partial=True, device=device)
    if raw is None:
        return None
    lm = build_lm(lm_cfg, cfg.model.output_neurons, device=device)
    lm.load_state_dict(raw["params"])
    return lm_cfg, lm


def make_lm_fusion(cfg, lm):
    """`(lm_step, make_cache)` for KV-cached shallow fusion, or `(None,
    None)` without an LM or with `lm_weight` 0. `lm_step(last_tokens [N],
    step, cache)` returns `(log_softmax(logits / lm_temperature), cache)`;
    `make_cache(rows, max_len)` builds the float32 cache."""
    if lm is None or cfg.decoding.lm_weight <= 0.0:
        return None, None
    temp = cfg.decoding.lm_temperature

    def make_cache(n_rows: int, max_len: int):
        return lm.init_cache(n_rows, max_len)

    def lm_step(last_tok, step_i, cache):
        logits, cache = lm.step(last_tok, step_i, cache)
        return torch.log_softmax(logits / temp, dim=-1), cache

    return lm_step, make_cache


def beam_config(cfg, max_length: int, lm_step=None, beam_size: Optional[int] = None,
                temperature: Optional[float] = None) -> S2SBeamConfig:
    """The search's settings from the recipe's `decoding` and `model`
    sections: beam `test_beam_size`, CTC weight `ctc_weight_decode`,
    decoder temperature `test_temperature` (the test stage; `beam_size`
    and `temperature` replace them, for the valid stage), and `lm_weight`
    when an LM step (`make_lm_fusion`) is fused, 0 otherwise."""
    dec, m = cfg.decoding, cfg.model
    return S2SBeamConfig(
        beam_size=dec.test_beam_size if beam_size is None else beam_size,
        ctc_weight=dec.ctc_weight_decode, lm_weight=dec.lm_weight if lm_step else 0.0,
        blank_id=m.blank_index, bos_id=m.bos_index, eos_id=m.eos_index, max_length=max_length,
        temperature=dec.test_temperature if temperature is None else temperature)


def make_beam_step(cfg, model, enc_out: torch.Tensor, enc_lens: torch.Tensor, beam: int,
                   bc: S2SBeamConfig, lm_step=None, lm_make_cache=None):
    """The KV-cached search step over UNtiled `enc_out` `[B, T, D]`:
    self-attention (and LM) caches at N = B·beam rows and `max_length` + 1
    positions, the cross-attention K/V and the encoder pad mask at B rows.
    Returns `(step, cache, lm_cache)`."""
    if cfg.model.decoder_attention_type not in ("regularMHA", "vanillaMHA"):
        raise NotImplementedError(
            f"decoder {cfg.model.decoder_attention_type!r} is not ported; see ROADMAP.md")
    n = enc_out.shape[0] * beam
    lm_cache = lm_make_cache(n, bc.max_length + 1) if lm_step else None
    cache = model.decode_cache_init(enc_out, bc.max_length + 1, n)
    enc_pad = length_to_mask(enc_lens, enc_out.shape[1])

    def step(last_tok, step_i, cache):
        return model.decode_step_cached(last_tok, step_i, cache, enc_pad)

    return step, cache, lm_cache


def beam_slices(max_rows: int, beam: int, idx: Sequence, *tensors: torch.Tensor):
    """Row-capped slices of one batch: `(sub_idx, *sliced_tensors)` with at
    most `max_rows` // beam utterances each (all of them when `max_rows`
    is 0); the last slice holds what is left."""
    b = len(idx)
    size = b if max_rows <= 0 else max(1, min(b, max_rows // max(beam, 1)))
    for lo in range(0, b, size):
        yield list(idx[lo:lo + size]), *(t[lo:lo + size] for t in tensors)


def restore_eval_state(model, ckpt_dir: str, avg: int, device=None) -> Dict:
    """Load the parameters of a checkpoint directory into `model`, the mean
    of the last `avg` checkpoints when `avg` > 1 (the recipes'
    `avg_checkpoints`); return the rest of the evaluation state
    (`norm_stats`, `step`, `epoch`) from the latest. The optimizer state
    is not read."""
    mgr = CheckpointManager(ckpt_dir)
    subset = dict.fromkeys(("params", "norm_stats", "step", "epoch"))
    if avg > 1:
        restored = average_checkpoints(mgr, subset, num=avg, device=device)
    else:
        restored = mgr.restore(subset, partial=True, device=device)
    if restored is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    model.load_state_dict(restored.pop("params"))
    return restored


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def evaluate_beam(model, fbank, norm_stats: Mapping, batches: Sequence, cfg, lm=None,
                  references: Optional[Mapping[int, Sequence[int]]] = None,
                  beam_size: Optional[int] = None, temperature: Optional[float] = None,
                  max_length: Optional[int] = None) -> Dict:
    """Beam-search `batches` of `(indices, wav [B, N], wav_lens [B])` (as
    `transcribe.batch_waveforms` yields them) and score them. The search
    runs at `beam_config(cfg, ...)`: the test stage's beam and temperature
    unless `beam_size` and `temperature` say otherwise, and a decode-length
    cap of `max_length`, by default `static_decode_length` of the longest
    waveform.

    Returns a dict: `hyps` (utterance index -> token ids, without bos and
    eos), `scores` (index -> length-normalised score), `summary`
    (`ErrorRateStats.summarize()` against `references`, index -> token
    ids, or None without them), `max_length`, `steps` (search steps run,
    over all slices), and `encode_s`/`search_s`, the seconds spent in the
    encoder and in the search on the host clock, each ending in a device
    synchronisation."""
    dec = cfg.decoding
    if dec.ctc_blank_skip > 0.0:
        raise NotImplementedError("ctc_blank_skip (compact_blank_frames) is not ported; "
                                  "see ROADMAP.md")
    lmax = max_length
    if lmax is None:
        max_samples = max(int(lens.max()) for _, _, lens in batches)
        lmax = static_decode_length(cfg, max_samples, fbank)
    lm_step, lm_make_cache = make_lm_fusion(cfg, lm)
    bc = beam_config(cfg, lmax, lm_step, beam_size, temperature)
    beam = bc.beam_size
    normalize = InputNormalization()
    hyps: Dict[int, List[int]] = {}
    scores: Dict[int, float] = {}
    steps = 0
    encode_s = search_s = 0.0
    for idx, wav, wav_lens in batches:
        device = wav.device
        _sync(device)
        t0 = time.perf_counter()
        feats, _ = normalize(fbank(wav), norm_stats)
        enc_out, enc_lens = model.encode(feats, fbank.frame_lengths(wav_lens))
        ctc_lp = model.ctc_head(enc_out)
        _sync(device)
        t1 = time.perf_counter()
        encode_s += t1 - t0
        for sub_idx, eo, el, cl in beam_slices(dec.max_beam_rows, beam, list(idx), enc_out,
                                               enc_lens, ctc_lp):
            step, cache, lm_cache = make_beam_step(cfg, model, eo, el, beam, bc, lm_step,
                                                   lm_make_cache)
            calls = [0]

            def counted(tok, i, c, step=step, calls=calls):
                calls[0] += 1
                return step(tok, i, c)

            toks, lens, best = s2s_beam_search(counted, eo, tile_for_beam(el, beam), cl, bc,
                                               lm_step_fn=lm_step, cache=cache,
                                               lm_cache=lm_cache)
            steps += calls[0]
            toks, lens, best = toks.cpu().numpy(), lens.cpu().numpy(), best.cpu().numpy()
            for i, u in enumerate(sub_idx):
                hyps[int(u)] = [int(t) for t in toks[i, :lens[i]]]
                scores[int(u)] = float(best[i])
        _sync(device)
        search_s += time.perf_counter() - t1
    summary = None
    if references is not None:
        stats = ErrorRateStats()
        order = sorted(hyps)
        stats.append([[str(t) for t in references[u]] for u in order],
                     [[str(t) for t in hyps[u]] for u in order], ids=order)
        summary = stats.summarize()
    return {"hyps": hyps, "scores": scores, "summary": summary, "max_length": lmax,
            "steps": steps, "encode_s": encode_s, "search_s": search_s}


@torch.inference_mode()
def streaming_decode(model, transducer, fbank, norm_stats: Mapping, wav: torch.Tensor,
                     wav_lens: torch.Tensor, chunk_size: int = 16, left_context: int = 4,
                     blank_id: int = 0, chunk_times: Optional[List[float]] = None):
    """Chunked streaming decode of one batch (the JAX `recipes/evaluate.py
    --streaming`): Fbank, normalisation and the CNN over the whole batch
    once, then per chunk of `chunk_size` encoder frames
    `encode_streaming_chunk` with `left_context` chunks of carried context,
    and the transducer's greedy decode with its carry threaded across
    chunks. Returns (tokens `[B, 2T']`, lengths `[B]`) on the device. With
    `chunk_times`, each chunk's wall time (ending in a device
    synchronisation) is appended to it."""
    feats, _ = InputNormalization()(fbank(wav), norm_stats)
    src = model.frontend(feats)
    enc_lens = model.subsampled_length(fbank.frame_lengths(wav_lens))
    b, t_enc = src.shape[0], src.shape[1]
    state = model.streaming_init(b, DynChunkTrainConfig(chunk_size, left_context))
    n_chunks = -(-t_enc // chunk_size)
    src = torch.nn.functional.pad(src, (0, 0, 0, n_chunks * chunk_size - t_enc))
    carry = toks = lens = None
    for c in range(n_chunks):
        if chunk_times is not None:
            _sync(wav.device)
            t0 = time.perf_counter()
        enc_c, state = model.encode_streaming_chunk(src[:, c * chunk_size:(c + 1) * chunk_size],
                                                    state)
        valid = torch.clamp(enc_lens - c * chunk_size, 0, chunk_size)
        toks, lens, carry = transducer_greedy_decode(
            transducer.encode_proj(enc_c), valid, transducer.predictor_init,
            transducer.predictor_step, transducer.joint_step, blank_id=blank_id,
            max_tokens=2 * t_enc, carry=carry, return_carry=True)
        if chunk_times is not None:
            _sync(wav.device)
            chunk_times.append(time.perf_counter() - t0)
    return toks, lens
