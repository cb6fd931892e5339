"""Raw-audio streaming inference: audio chunks in, transducer tokens out —
the port of `summarymixing_tpu/streaming.py`.

    init_fn, step_fn, info = make_streaming_infer_fns(model, transducer, fbank,
                                                      InputNormalization(), norm_stats)
    carry = init_fn(batch)
    carry, tokens, n_new = step_fn(carry, wav_chunk, n_valid)   # per chunk

Each step takes the next `chunk_samples` samples of every stream and
emits the tokens the transducer produced for ONE encoder chunk; `n_valid`
says how many of the samples are real. Every piece of cross-chunk state
(the sample buffer, the running log-mel peak, the Conformer's buffers, the
predictor state) is in the carry, and rows are independent streams.

Exactness. The chunked Fbank + CNN reproduce the offline ones on the
chunk's frames from a receptive-field window (recipe frontend: window 512,
hop 160, centred frames; CNN of two stride-2 kernel-3 blocks, so sub = 4):

- encoder frames [a, b) need Fbank frames [4a - 3, 4b + 1); one encoder
  frame of extension on each side keeps the CNN's own zero padding outside
  the slice, so the chunked CNN runs on Fbank frames [4(a-1), 4(b+1)) and
  keeps its outputs [1, 1 + C);
- Fbank frame g covers samples [g·hop - win/2, g·hop + win/2), so the
  sample window is [s0 - lead, s0 + chunk + lookahead);
- the lookahead must have arrived, so step k processes encoder chunk
  k - 1: decoding lags input by one chunk, and a row's first step only
  primes its buffer (its outputs are selected away per row);
- Fbank frames before the stream start are computed from buffer zeros,
  which is not what the offline CNN sees (it zero-pads in the feature
  domain): `ConvolutionFrontEnd`'s `input_frame_offset` zeroes them by
  global frame index after normalisation, at the input and after every
  block.

One approximation, as in the JAX package: the top-dB clamp takes each
row's running log-mel peak, not the utterance's (a stream cannot know a
later peak); it is exact when the peak lies in or before the processed
window.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Callable, List, Tuple

import torch

from summarymixing_tpu_torch.decoding.transducer_search import (
    MAX_SYMBOLS_PER_FRAME,
    transducer_greedy_decode,
)
from summarymixing_tpu_torch.frontend.features import clamp_top_db
from summarymixing_tpu_torch.models.asr import DynChunkTrainConfig


@dataclass(frozen=True)
class StreamGeometry:
    """Sample and frame arithmetic of the chunked frontend."""

    chunk_frames: int          # encoder frames per chunk (C)
    hop: int                   # Fbank hop, samples
    win: int                   # Fbank window, samples
    sub: int                   # frontend time subsampling (product of strides)
    ext: int = 1               # encoder-frame extension on each side

    @property
    def chunk_samples(self) -> int:
        return self.chunk_frames * self.sub * self.hop

    @property
    def lead(self) -> int:
        return (self.sub * self.ext + math.ceil(self.win // 2 / self.hop)) * self.hop

    @property
    def lookahead(self) -> int:
        return (self.sub * self.ext - 1) * self.hop + self.win // 2

    @property
    def buf_len(self) -> int:
        return 2 * self.chunk_samples + self.lead

    @property
    def window_len(self) -> int:
        return self.chunk_samples + self.lead + self.lookahead

    @property
    def n_fbank_frames(self) -> int:
        return self.sub * (self.chunk_frames + 2 * self.ext)

    @property
    def first_window_frame(self) -> int:
        """Window-local index of the extended chunk's first Fbank frame."""
        return self.lead // self.hop - self.sub * self.ext


def streamed_frontend_chunk(fbank, normalizer, norm_stats: dict, cnn_apply: Callable,
                            geom: StreamGeometry, window: torch.Tensor, chunk_index,
                            db_max: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The offline Fbank + normalisation + CNN of encoder chunk
    `chunk_index` (`[B]`, per row) from its sample window `[B, window_len]`
    (samples [s0 - lead, s0 + chunk + lookahead), s0 = chunk_index ·
    chunk_samples). `db_max` `[B]` is each row's running peak of the
    unclamped log-mel. Returns (CNN chunk `[B, C, F']`, db_max')."""
    spec = fbank.stft_magnitude(window)
    j0 = geom.first_window_frame
    db = fbank.log_mel(spec[:, j0:j0 + geom.n_fbank_frames])
    db_max = torch.maximum(db_max, db.amax(dim=(1, 2)))
    feats, _ = normalizer(clamp_top_db(db, db_max), norm_stats)
    index = torch.as_tensor(chunk_index, device=window.device).reshape(-1)
    cnn_out = cnn_apply(feats, geom.sub * (index * geom.chunk_frames - geom.ext))
    return cnn_out[:, geom.ext:geom.ext + geom.chunk_frames], db_max


def _select(active: torch.Tensor, new, old):
    """Per row: `new` where `active`, else `old`, through dicts, tuples and
    dataclasses of tensors (a whole carry); other leaves (a state's chunk
    size) are kept from `new`."""
    if isinstance(new, torch.Tensor):
        return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
    if isinstance(new, dict):
        return {k: _select(active, v, old[k]) for k, v in new.items()}
    if isinstance(new, tuple):
        return tuple(_select(active, a, b) for a, b in zip(new, old))
    if is_dataclass(new):
        return replace(new, **{f.name: _select(active, getattr(new, f.name),
                                               getattr(old, f.name)) for f in fields(new)})
    return new


def carry_tensors(carry) -> List[torch.Tensor]:
    """The tensors of a carry (dicts, tuples and dataclasses of tensors) in
    one fixed order: the flat form an exported streaming step takes."""
    if isinstance(carry, torch.Tensor):
        return [carry]
    if isinstance(carry, dict):
        return [t for v in carry.values() for t in carry_tensors(v)]
    if isinstance(carry, tuple):
        return [t for v in carry for t in carry_tensors(v)]
    if is_dataclass(carry):
        return [t for f in fields(carry) for t in carry_tensors(getattr(carry, f.name))]
    return []


def carry_like(template, tensors):
    """`template`'s structure with its tensors replaced, in `carry_tensors`
    order, by those of the iterator `tensors`."""
    if isinstance(template, torch.Tensor):
        return next(tensors)
    if isinstance(template, dict):
        return {k: carry_like(v, tensors) for k, v in template.items()}
    if isinstance(template, tuple):
        return tuple(carry_like(v, tensors) for v in template)
    if is_dataclass(template):
        return replace(template, **{f.name: carry_like(getattr(template, f.name), tensors)
                                    for f in fields(template)})
    return template


def make_streaming_infer_fns(model, transducer, fbank, normalizer, norm_stats: dict, *,
                             chunk_frames: int = 16, left_context_chunks: int = 4,
                             blank_id: int = 0):
    """`(init_fn, step_fn, info)` for a Conformer transducer on the model's
    device.

    init_fn(batch) -> carry;
    step_fn(carry, wav `[B, chunk_samples]` float32, n_valid `[B]` int) ->
    (carry', tokens `[B, C·MAX_SYMBOLS_PER_FRAME]`, n_new `[B]`)."""
    if tuple(model.frontend_strides) != (2, 2):
        raise ValueError("the streaming frontend supports the recipe CNN (strides (2, 2), "
                         f"kernel 3); got strides {tuple(model.frontend_strides)}")
    geom = StreamGeometry(chunk_frames=chunk_frames, hop=fbank.hop_length,
                          win=fbank.win_length, sub=4)
    if geom.chunk_samples < geom.lookahead:
        raise ValueError(f"chunk_frames {chunk_frames} too small: the {geom.lookahead}-sample "
                         f"lookahead must fit in one {geom.chunk_samples}-sample chunk")
    dynchunk = DynChunkTrainConfig(chunk_size=chunk_frames, left_context_size=left_context_chunks)
    umax = chunk_frames * MAX_SYMBOLS_PER_FRAME
    device = next(model.parameters()).device

    @torch.inference_mode()
    def init_fn(batch: int) -> dict:
        pred, dec_proj = transducer.predictor_step(
            transducer.predictor_init(batch),
            torch.full((batch,), blank_id, dtype=torch.long, device=device))
        return {"buf": torch.zeros(batch, geom.buf_len, device=device),
                "db_max": torch.full((batch,), -math.inf, device=device),
                "valid_samples": torch.zeros(batch, dtype=torch.long, device=device),
                "chunks": torch.zeros(batch, dtype=torch.long, device=device),
                "enc": model.streaming_init(batch, dynchunk),
                "pred": pred, "dec_proj": dec_proj}

    @torch.inference_mode()
    def step_fn(carry: dict, wav: torch.Tensor, n_valid: torch.Tensor):
        if wav.shape[-1] != geom.chunk_samples:
            raise ValueError(f"step expects {geom.chunk_samples} samples per chunk "
                             f"({chunk_frames} encoder frames), got {wav.shape[-1]}")
        b = wav.shape[0]
        buf = torch.cat([carry["buf"][:, geom.chunk_samples:], wav.to(torch.float32)], dim=1)
        valid_samples = carry["valid_samples"] + torch.clamp(n_valid.long(),
                                                             max=geom.chunk_samples)
        p = carry["chunks"] - 1   # the chunk this step processes, per row
        cnn_chunk, db_max = streamed_frontend_chunk(
            fbank, normalizer, norm_stats, model.frontend, geom, buf[:, :geom.window_len], p,
            carry["db_max"])
        enc_chunk, enc_state = model.encode_streaming_chunk(cnn_chunk, carry["enc"])
        enc_total = model.subsampled_length(fbank.frame_lengths(valid_samples))
        chunk_valid = torch.clamp(enc_total - p * chunk_frames, 0, chunk_frames)
        dec_carry = (carry["pred"], carry["dec_proj"],
                     torch.zeros(b, umax, dtype=torch.long, device=device),
                     torch.zeros(b, dtype=torch.long, device=device))
        tokens, n_new, (pred, dec_proj, _, _) = transducer_greedy_decode(
            transducer.encode_proj(enc_chunk), chunk_valid, transducer.predictor_init,
            transducer.predictor_step, transducer.joint_step, blank_id=blank_id,
            carry=dec_carry, return_carry=True)
        # a row's first step only primes its buffer: chunk -1 does not exist
        active = carry["chunks"] > 0
        new_carry = {"buf": buf, "db_max": _select(active, db_max, carry["db_max"]),
                     "valid_samples": valid_samples, "chunks": carry["chunks"] + 1,
                     "enc": _select(active, enc_state, carry["enc"]),
                     "pred": _select(active, pred, carry["pred"]),
                     "dec_proj": _select(active, dec_proj, carry["dec_proj"])}
        return (new_carry, torch.where(active[:, None], tokens, 0),
                torch.where(active, n_new, 0))

    info = {"chunk_samples": geom.chunk_samples, "chunk_frames": chunk_frames,
            "left_context_chunks": left_context_chunks, "lookahead_samples": geom.lookahead,
            "max_new_tokens": umax, "blank_id": blank_id}
    return init_fn, step_fn, info


@torch.inference_mode()
def run_stream(init_fn: Callable, step_fn: Callable, wav: torch.Tensor, wav_lens: torch.Tensor,
               chunk_samples: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drive a whole batch `[B, N]` through the chunked pipeline: the tail
    padded to a whole chunk, then two flush chunks (one for the pipeline's
    one-chunk lag, one because a row whose length is a whole number of
    chunks has one encoder frame past its last chunk). Returns (tokens
    `[B, U]`, lengths `[B]`) on the CPU, read once at the end."""
    b, n = wav.shape
    n_chunks = -(-n // chunk_samples)
    wav = torch.nn.functional.pad(wav, (0, n_chunks * chunk_samples - n))
    carry = init_fn(b)
    toks, counts = [], []
    silence = torch.zeros(b, chunk_samples, dtype=wav.dtype, device=wav.device)
    for k in range(n_chunks + 2):
        if k < n_chunks:
            chunk = wav[:, k * chunk_samples:(k + 1) * chunk_samples]
            nv = torch.clamp(wav_lens - k * chunk_samples, 0, chunk_samples)
        else:
            chunk, nv = silence, torch.zeros_like(wav_lens)
        carry, t, c = step_fn(carry, chunk, nv)
        toks.append(t)
        counts.append(c)
    toks, counts = torch.stack(toks, dim=1).cpu(), torch.stack(counts, dim=1).cpu()
    lens = counts.sum(dim=1)
    final = torch.zeros(b, max(int(lens.max()), 1), dtype=torch.long)
    for i in range(b):
        final[i, :int(lens[i])] = torch.cat([toks[i, k, :int(counts[i, k])]
                                             for k in range(toks.shape[1])])
    return final, lens
