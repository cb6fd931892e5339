"""Inference artifacts with `torch.export` — the port of
`summarymixing_tpu/utils/export.py`.

One file per trained run holds the greedy inference graph (Fbank ->
InputNormalization with frozen statistics -> CNN -> encoder -> CTC head
-> greedy collapse markers, or the transducer's greedy decode), the
trained weights inside it. Loading needs the port's package for its two
registered kernel ops (`summarymixing_torch::summary_mixing` and
`::convolution_branch`), and no recipe, model code or checkpoint.

Both offline graphs are polymorphic by default: a symbolic batch `b` and
a sample axis of `time_multiple · n`, so one artifact serves every bucket
a server or batch decoder forms (the transducer's greedy loop over the
encoder frames is a `scan` under export: `decoding/transducer_search.py`).
`fixed_shape=(B, N)` exports one static shape instead. The streaming pair (`init`, `step`)
has a fixed chunk and a symbolic batch; its carry crosses the boundary as
a flat list of tensors (`streaming.carry_tensors`).

The device is part of the graph: exported on the card, the graph holds
the kernel ops and the card's tensors; exported on the CPU, the plain
path. `meta["device"]` records it, and a loader refuses an artifact for
another device.

File format (magic "SMTORCH1", so each package's loader refuses the
other's files):
  [8 bytes magic][4 bytes LE header length][header JSON][payload(s)]
header = {"meta": {...}, "payload_len": N} or {"meta": ..., "payloads":
[[name, length], ...]}; each payload is `torch.export.save` bytes; meta
carries recipe, family, sample_rate, blank_id, time_multiple, token_type,
the id -> piece vocab, polymorphic, device (and chunk_samples when
streaming)."""

from __future__ import annotations

import copy
import io
import json
import struct
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from summarymixing_tpu_torch.decoding.ctc import ctc_greedy_decode
from summarymixing_tpu_torch.decoding.transducer_search import transducer_greedy_decode
from summarymixing_tpu_torch.streaming import carry_like, carry_tensors, run_stream
from summarymixing_tpu_torch.utils.device import resolve_device

MAGIC = b"SMTORCH1"
JAX_MAGIC = b"SMTEXP01"    # the JAX package's artifacts
MAX_BATCH, MAX_N = 4096, 100_000   # ranges of the symbolic dims (n: 320 · 100000 ≈ 33 min)


class _NormStats(nn.Module):
    """Frozen InputNormalization statistics as buffers of the graph."""

    def __init__(self, norm_stats: Dict[str, torch.Tensor]):
        super().__init__()
        for k in ("count", "mean", "m2"):
            self.register_buffer(k, norm_stats[k].detach().clone())

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}


def _without_decoder(model):
    """`model` (a `SpeechRecognizer`) as the CTC path sees it: a shallow
    copy sharing every parameter but the attention decoder's, which the
    path never calls and an exported graph would otherwise carry."""
    if model.asr.num_decoder_layers == 0:
        return model
    asr = copy.copy(model.asr)
    asr._modules = {k: v for k, v in model.asr._modules.items()
                    if k not in ("decoder", "tgt_emb")}
    out = copy.copy(model)
    out._modules = {k: (asr if k == "asr" else v) for k, v in model._modules.items()
                    if k != "seq_lin"}
    return out


class CTCInfer(nn.Module):
    """(wav [B, N] float32, wav_lens [B] int) -> (ids [B, T'], keep [B, T']
    bool, enc_lengths [B]): the greedy CTC evaluation path
    (`transcribe.greedy_ctc_decode`) without the host read."""

    def __init__(self, model, fbank, normalizer, norm_stats, blank_id: int = 0):
        super().__init__()
        self.model, self.fbank = _without_decoder(model), fbank
        self.stats = _NormStats(norm_stats)
        self.normalizer, self.blank_id = normalizer, blank_id

    def forward(self, wav: torch.Tensor, wav_lens: torch.Tensor):
        feats, _ = self.normalizer(self.fbank(wav), self.stats.as_dict())
        out = self.model(feats, self.fbank.frame_lengths(wav_lens))
        ids, keep = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"], self.blank_id)
        return ids, keep, out["enc_lengths"]


class TransducerInfer(nn.Module):
    """(wav [B, N], wav_lens [B]) -> (tokens [B, Umax], token_lens [B],
    enc_lengths [B]): the transducer recipes' greedy decode
    (`transcribe.transducer_greedy_transcribe`) without the host read."""

    def __init__(self, model, transducer, fbank, normalizer, norm_stats, blank_id: int = 0):
        super().__init__()
        self.model, self.transducer, self.fbank = model, transducer, fbank
        self.stats, self.normalizer, self.blank_id = _NormStats(norm_stats), normalizer, blank_id

    def forward(self, wav: torch.Tensor, wav_lens: torch.Tensor):
        feats, _ = self.normalizer(self.fbank(wav), self.stats.as_dict())
        enc_out, enc_lens = self.model.encode(feats, self.fbank.frame_lengths(wav_lens))
        td = self.transducer
        toks, lens = transducer_greedy_decode(td.encode_proj(enc_out), enc_lens, td.predictor_init,
                                              td.predictor_step, td.joint_step,
                                              blank_id=self.blank_id)
        return toks, lens, enc_lens


def make_ctc_infer_fn(model, fbank, normalizer, norm_stats, blank_id: int = 0) -> CTCInfer:
    """The inference function of a CTC recipe (a module, in eval mode)."""
    return CTCInfer(model, fbank, normalizer, norm_stats, blank_id).eval()


def make_transducer_infer_fn(model, transducer, fbank, normalizer, norm_stats,
                             blank_id: int = 0) -> TransducerInfer:
    """The inference function of a transducer recipe (a module, in eval mode)."""
    return TransducerInfer(model, transducer, fbank, normalizer, norm_stats, blank_id).eval()


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _save(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_ctc_infer(infer_fn: nn.Module, *, time_multiple: int = 320,
                     fixed_shape: Optional[Sequence[int]] = None) -> bytes:
    """`torch.export` the inference module, under `no_grad` so the kernel
    route records the bare ops, to `torch.export.save` bytes: a CTC or a
    transducer module. Polymorphic by default: batch `b` and samples
    `time_multiple · n`, both symbolic; `fixed_shape=(B, N)` exports one
    static shape."""
    device = _device_of(infer_fn)
    b, n = fixed_shape if fixed_shape is not None else (2, time_multiple * 50)
    wav = torch.zeros(b, n, device=device)
    lens = torch.full((b,), n, dtype=torch.int32, device=device)
    dynamic = None
    if fixed_shape is None:
        bd = torch.export.Dim("b", min=1, max=MAX_BATCH)
        nd = torch.export.Dim("n", min=2, max=MAX_N)
        dynamic = ({0: bd, 1: time_multiple * nd}, {0: bd})
    with torch.no_grad():
        program = torch.export.export(infer_fn, (wav, lens), dynamic_shapes=dynamic)
    return _save(program)


class _StreamInit(nn.Module):
    def __init__(self, init_fn, owner: nn.Module):
        super().__init__()
        self.owner, self.init_fn = owner, init_fn

    def forward(self, ref: torch.Tensor):
        return tuple(carry_tensors(self.init_fn(ref.shape[0])))


class _StreamStep(nn.Module):
    def __init__(self, step_fn, template, owner: nn.Module):
        super().__init__()
        self.owner, self.step_fn, self.template = owner, step_fn, template

    def forward(self, carry: List[torch.Tensor], wav: torch.Tensor, n_valid: torch.Tensor):
        new, toks, n_new = self.step_fn(carry_like(self.template, iter(carry)), wav, n_valid)
        return tuple(carry_tensors(new)) + (toks, n_new)


def export_streaming(init_fn: Callable, step_fn: Callable, chunk_samples: int, model, transducer,
                     fbank, fixed_batch: Optional[int] = None) -> Dict[str, bytes]:
    """Export a streaming `(init_fn, step_fn)` pair
    (`streaming.make_streaming_infer_fns` over `model`, `transducer` and
    `fbank`) as two payloads sharing one symbolic batch (or `fixed_batch`).
    The modules' parameters become the graphs' weights: the transducer's in
    the init (its predictor primes the carry), all of them in the step. The
    exported init takes a `[B]` int tensor and returns the flat carry; the
    step takes the flat carry, a `[B, chunk_samples]` chunk and `[B]` valid
    counts and returns the flat carry, the tokens and their counts."""
    device = _device_of(transducer)
    b = fixed_batch or 2
    template = init_fn(b)
    flat = carry_tensors(template)
    ref = torch.zeros(b, dtype=torch.int32, device=device)
    wav = torch.zeros(b, chunk_samples, device=device)
    nv = torch.full((b,), chunk_samples, dtype=torch.int64, device=device)
    init_dyn = step_dyn = None
    if fixed_batch is None:
        bd = torch.export.Dim("b", min=1, max=MAX_BATCH)
        init_dyn = ({0: bd},)
        step_dyn = ([{0: bd}] * len(flat), {0: bd}, {0: bd})
    owner = nn.ModuleDict({"model": model, "transducer": transducer, "fbank": fbank})
    with torch.no_grad():
        init_p = torch.export.export(_StreamInit(init_fn, transducer), (ref,),
                                     dynamic_shapes=init_dyn)
        step_p = torch.export.export(_StreamStep(step_fn, template, owner),
                                     ([t.clone() for t in flat], wav, nv),
                                     dynamic_shapes=step_dyn)
    return {"init": _save(init_p), "step": _save(step_p)}


def pack_artifact(payload, meta: Dict) -> bytes:
    """payload: bytes (one exported function) or {name: bytes} (several,
    recorded as an ordered [name, length] list in the header)."""
    if isinstance(payload, dict):
        names = list(payload)
        header = json.dumps({"meta": meta,
                             "payloads": [[n, len(payload[n])] for n in names]}).encode()
        body = b"".join(payload[n] for n in names)
    else:
        header = json.dumps({"meta": meta, "payload_len": len(payload)}).encode()
        body = payload
    return MAGIC + struct.pack("<I", len(header)) + header + body


def unpack_artifact(data: bytes):
    """(meta, payload bytes) for a single-function artifact, (meta, {name:
    bytes}) for a multi-function one."""
    if data[:8] == JAX_MAGIC:
        raise ValueError("this is an artifact of the JAX package (summarymixing_tpu."
                         "utils.export, jax.export StableHLO), not of the PyTorch port: "
                         "load it with summarymixing_tpu.utils.export.ExportedASR")
    if data[:8] != MAGIC:
        raise ValueError(f"not a summarymixing_tpu_torch export artifact (magic {data[:8]!r})")
    (hlen,) = struct.unpack("<I", data[8:12])
    header = json.loads(data[12:12 + hlen].decode())
    body = data[12 + hlen:]
    if "payloads" in header:
        out, off = {}, 0
        for name, ln in header["payloads"]:
            out[name] = body[off:off + ln]
            off += ln
        return header["meta"], out
    return header["meta"], body[:header["payload_len"]]


def save_artifact(path: str, payload, meta: Dict) -> None:
    with open(path, "wb") as f:
        f.write(pack_artifact(payload, meta))


def decode_token_rows(meta: Dict, rows: List[List[int]]) -> List[str]:
    """Token ids -> text through the vocab and token type of an artifact's
    meta (one decode path for both loaders)."""
    vocab = meta.get("vocab")
    out = []
    for toks in rows:
        if vocab is None:
            out.append(" ".join(map(str, toks)))
        elif meta.get("token_type") == "char":
            out.append("".join(vocab[t] for t in toks if 0 <= t < len(vocab)))
        else:   # subword pieces with the sentencepiece space marker
            text = "".join(vocab[t] for t in toks if 0 <= t < len(vocab))
            out.append(text.replace("▁", " ").strip())
    return out


def _load(path: str, device):
    """(meta, payload(s), device) of an artifact for `device` (the card
    unless told otherwise); refuses one exported for another device."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        meta, payload = unpack_artifact(f.read())
    made_for = torch.device(meta.get("device", "cpu")).type
    if made_for != device.type:
        raise ValueError(f"{path} was exported on {made_for!r} (its graph holds that device's "
                         f"route and tensors); it cannot run on {device.type!r}: export it "
                         f"again there")
    # the graph calls the kernels' registered ops: register them first
    from summarymixing_tpu_torch.ops import fused_csgu, fused_summary  # noqa: F401
    return meta, payload, device


def _program(data: bytes):
    return torch.export.load(io.BytesIO(data)).module()


@dataclass
class ExportedASR:
    """A loaded artifact: the graph and the meta that turns its ids into text."""

    meta: Dict
    _call: Callable
    device: torch.device

    @classmethod
    def load(cls, path: str, device=None) -> "ExportedASR":
        meta, payload, device = _load(path, device)
        if isinstance(payload, dict):
            raise ValueError(f"{path} is a streaming artifact: load it with ExportedStreamingASR")
        return cls(meta=meta, _call=_program(payload), device=device)

    def __call__(self, wav, wav_lens):
        """wav [B, N] float32 (N a multiple of `meta["time_multiple"]`) and
        wav_lens [B], numpy or tensors -> the graph's outputs on the device."""
        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        lens = torch.as_tensor(wav_lens, dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            return self._call(wav, lens)

    def _pad(self, wav: np.ndarray) -> np.ndarray:
        pad = (-wav.shape[-1]) % int(self.meta.get("time_multiple", 320))
        return np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, pad)]) if pad else wav

    def transcribe(self, wav: np.ndarray) -> List[str]:
        """wav [B, N] or [N] float32 -> text per utterance, through the
        artifact's vocab."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        lens = np.full((wav.shape[0],), wav.shape[1], np.int32)
        a, b, _ = self(self._pad(wav), lens)
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if self.meta.get("family") == "transducer":
            rows = [[int(t) for t in a[i, :b[i]]] for i in range(len(a))]
        else:
            rows = [[int(i) for i in ids[keep.astype(bool)]] for ids, keep in zip(a, b)]
        return decode_token_rows(self.meta, rows)


@dataclass
class ExportedStreamingASR:
    """A loaded streaming artifact: `init` and `step` for a streaming caller,
    and a batch `transcribe` on the same step. The step takes
    `meta["chunk_samples"]` samples per row and emits the tokens of the
    previous chunk (`streaming.py`); `transcribe` adds the flush chunks."""

    meta: Dict
    _init: Callable
    _step: Callable
    device: torch.device

    @classmethod
    def load(cls, path: str, device=None) -> "ExportedStreamingASR":
        meta, payloads, device = _load(path, device)
        if not isinstance(payloads, dict) or "step" not in payloads:
            raise ValueError("not a streaming artifact (single payload)")
        return cls(meta=meta, _init=_program(payloads["init"]),
                   _step=_program(payloads["step"]), device=device)

    def init(self, batch: int) -> List[torch.Tensor]:
        return list(self._init(torch.zeros(batch, dtype=torch.int32, device=self.device)))

    def step(self, carry: List[torch.Tensor], wav_chunk, n_valid):
        out = self._step(list(carry), torch.as_tensor(wav_chunk).to(self.device, torch.float32),
                         torch.as_tensor(n_valid).to(self.device, torch.int64))
        return list(out[:-2]), out[-2], out[-1]

    def transcribe(self, wav: np.ndarray, wav_lens: Optional[np.ndarray] = None) -> List[str]:
        """Stream [B, N] (or [N]) audio through the step with
        `streaming.run_stream`; `wav_lens` marks each row's valid samples
        (all N by default). Returns text per utterance."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        b, n = wav.shape
        lens = np.full((b,), n, np.int64) if wav_lens is None else np.asarray(wav_lens, np.int64)
        toks, tok_lens = run_stream(self.init, self.step, torch.from_numpy(wav).to(self.device),
                                    torch.from_numpy(lens).to(self.device),
                                    int(self.meta["chunk_samples"]))
        return decode_token_rows(self.meta, [toks[i, :int(tok_lens[i])].tolist()
                                             for i in range(b)])
