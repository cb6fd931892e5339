"""Transformer encoder and decoder — the port of `Conv1dFFN`,
`TransformerEncoderLayer`, `TransformerEncoder` (any token mixer of
`models.mixers`: the causal LM's regularMHA stack, and the ASR encoder with
regularMHA, RelPosMHAXL, hypermixing or SummaryMixing; the "1dcnn"
feed-forward; layerdrop), `TransformerDecoderLayer` (the regularMHA route,
the RelPosMHAXL route with `mask_pos_future` when causal, whose position
tables come as `pos_embs_tgt` and `pos_embs_src` and whose rel-shift is
square attention only, and the Summary Decoder's SummaryMixing route),
`TransformerDecoder` and
`NormalizedEmbedding` from `summarymixing_tpu/models/transformer.py`, with
the cached `init_cache`/`step` of beam search.

The encoder layer's mixer is `self_att`; a SummaryMixing mixer's output is
d_model wide (it feeds the residual) and keeps the erf GELU, HyperMixing's
hypernetwork is d_ffn wide, and with `causal` RelPosMHAXL masks future
keys and the "1dcnn" convolutions pad on the left only. Layerdrop skips
each layer of a training forward with probability `layerdrop_prob`, drawn
once per forward from the model's dropout generator; the layer is still
computed and its output dropped, as the JAX encoder does.

A cache is a list with one dict of tensors per layer. Self-attention
caches are head-major `[rows, H, max_len, hd]` (`ops/attention.py`); the
Summary Decoder's layer carries instead the running `(sum, denom)` pair
of its causal summary (`"sm"`: `[rows, d_model]` and `[rows, 1]`, float32),
O(1) per step where the KV cache is O(max_len). The decoder's
cross-attention K/V (`mem_k`, `mem_v`) keeps the memory's B rows when
`rows` = B·beam, and beam search gathers only the leaves with `rows` rows.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from summarymixing_tpu_torch.models.mixers import apply_mixer, make_mixer
from summarymixing_tpu_torch.ops.attention import (
    MultiheadAttention,
    PositionalwiseFeedForward,
    RelPosMHAXL,
)
from summarymixing_tpu_torch.ops.layers import Conv1d, Dropout, LayerNorm, remat_call

_MHA = ("regularMHA", "vanillaMHA")


def _self_attn_cache(rows: int, max_len: int, nhead: int, d_model: int, dtype,
                     device) -> dict:
    shape = (rows, nhead, max_len, d_model // nhead)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class Conv1dFFN(nn.Module):
    """The "1dcnn" feed-forward: Conv1d(d -> d_ffn, k0) -> ReLU ->
    Conv1d(d_ffn -> d, k1) over `[B, T, D]`, each padded SAME (flax's
    (k-1)//2 frames before) or, with `causal`, k-1 frames before."""

    def __init__(self, d_ffn: int, d_model: int, kernel_sizes: Sequence[int] = (3, 3),
                 causal: bool = False):
        super().__init__()
        self.causal = causal
        self.conv_0 = Conv1d(d_model, d_ffn, kernel_sizes[0])
        self.conv_1 = Conv1d(d_ffn, d_model, kernel_sizes[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for i, conv in enumerate((self.conv_0, self.conv_1)):
            k = conv.kernel_size[0]
            left = k - 1 if self.causal else (k - 1) // 2
            x = conv(F.pad(x, (left, k - 1 - left)))
            if i == 0:
                x = F.relu(x)
        return x.transpose(1, 2)


class TransformerEncoderLayer(nn.Module):
    """The mixer (`self_att`) and the feed-forward block (`pos_ffn`), each
    with a LayerNorm (eps 1e-6) before it, or after it without
    `normalize_before` (the LM's post-LN), and dropout before its
    residual."""

    def __init__(self, d_model: int, d_ffn: int, nhead: int, dropout_rate: float = 0.0,
                 activation: str = "gelu", normalize_before: bool = True,
                 attention_type: str = "regularMHA", ffn_type: str = "regularFFN",
                 ffn_cnn_kernel_size_list: Sequence[int] = (3, 3), causal: bool = False,
                 local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
                 summary_hid_dim: Sequence[int] = (1024,), mode: str = "SummaryMixing"):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.attention_type = attention_type
        self.normalize_before = normalize_before
        self.self_att = make_mixer(
            attention_type, d_model, nhead, local_proj_hid_dim=local_proj_hid_dim,
            local_proj_out_dim=local_proj_out_dim, summary_hid_dim=summary_hid_dim,
            summary_out_dim=d_model, mode=mode, hypernet_size=d_ffn, mask_pos_future=causal,
            dropout_rate=dropout_rate)
        if ffn_type == "regularFFN":
            self.pos_ffn = PositionalwiseFeedForward(d_ffn, d_model, dropout_rate, activation)
        elif ffn_type == "1dcnn":
            self.pos_ffn = Conv1dFFN(d_ffn, d_model, tuple(ffn_cnn_kernel_size_list), causal)
        else:
            raise ValueError(f"unknown ffn_type {ffn_type!r}")
        self.norm1 = LayerNorm(d_model, eps=1e-6)
        self.norm2 = LayerNorm(d_model, eps=1e-6)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        pre = self.normalize_before
        src1 = self.norm1(x) if pre else x
        x = x + self.dropout(apply_mixer(self.self_att, self.attention_type, src1,
                                         attn_mask=src_mask, pad_mask=pad_mask,
                                         pos_embs=pos_embs))
        if not pre:
            x = self.norm1(x)
        src1 = self.norm2(x) if pre else x
        x = x + self.dropout(self.pos_ffn(src1))
        return x if pre else self.norm2(x)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None) -> dict:
        if self.attention_type not in _MHA:
            raise ValueError("KV-cached stepping requires regularMHA")
        return _self_attn_cache(batch, max_len, self.nhead, self.d_model, dtype, device)

    def step(self, x_t: torch.Tensor, pos: int, cache: dict):
        """One causal position: x_t `[B, D]` -> (`[B, D]`, cache)."""
        pre = self.normalize_before
        src1 = self.norm1(x_t) if pre else x_t
        out, k, v = self.self_att.step(src1, cache["k"], cache["v"], pos, append=True)
        x = x_t + out
        if not pre:
            x = self.norm1(x)
        src1 = self.norm2(x) if pre else x
        x = x + self.pos_ffn(src1)
        return (x if pre else self.norm2(x)), {"k": k, "v": v}


class TransformerEncoder(nn.Module):
    """`layer_0` ... `layer_{n-1}`, then a LayerNorm (eps 1e-6). `layer_kwargs`:
    `TransformerEncoderLayer`'s keywords past `attention_type`."""

    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 dropout_rate: float = 0.0, activation: str = "gelu",
                 normalize_before: bool = True, attention_type: str = "regularMHA",
                 layerdrop_prob: float = 0.0, remat: bool = False, **layer_kwargs):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, d_ffn, nhead, dropout_rate, activation, normalize_before,
                attention_type, **layer_kwargs))
        self.layerdrop = Dropout(layerdrop_prob)
        self.norm = LayerNorm(d_model, eps=1e-6)

    def layers(self) -> List[TransformerEncoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        keep = self.layerdrop.keep_mask((self.num_layers,), x.device)
        for i, layer in enumerate(self.layers()):
            out = (remat_call(layer, x, src_mask, pad_mask, pos_embs) if self.remat
                   else layer(x, src_mask, pad_mask, pos_embs))
            x = out if keep is None else torch.where(keep[i], out, x)
        return self.norm(x)

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32, device=None) -> list:
        return [layer.init_cache(batch, max_len, dtype, device) for layer in self.layers()]

    def step(self, x_t: torch.Tensor, pos: int, cache: list):
        new_cache = []
        for layer, c in zip(self.layers(), cache):
            x_t, c = layer.step(x_t, pos, c)
            new_cache.append(c)
        return self.norm(x_t), new_cache


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention and the feed-forward block, each
    with a LayerNorm (eps 1e-6) before it (or after, without
    `normalize_before`) and dropout before its residual. With
    `attention_type="SummaryMixing"` (the paper's Summary Decoder) the
    self-attention is a SummaryMixing cell (`summary_out_dim` = d_model,
    erf GELU, as the flax layer builds it) under the lookahead mask as its
    `sum_mask`; cross-attention and the feed-forward block stay as they are."""

    def __init__(self, d_model: int, d_ffn: int, nhead: int, dropout_rate: float = 0.0,
                 activation: str = "gelu", normalize_before: bool = True,
                 attention_type: str = "regularMHA",
                 local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
                 summary_hid_dim: Sequence[int] = (1024,), mode: str = "SummaryMixing",
                 causal: bool = True):
        super().__init__()
        if attention_type not in _MHA + ("SummaryMixing", "RelPosMHAXL"):
            raise ValueError(f"decoder supports regularMHA/RelPosMHAXL/SummaryMixing, got "
                             f"{attention_type!r}")
        self.d_model, self.nhead = d_model, nhead
        self.attention_type = attention_type
        self.normalize_before = normalize_before
        if attention_type == "SummaryMixing":
            self.self_attn = make_mixer(
                "SummaryMixing", d_model, nhead, local_proj_hid_dim=local_proj_hid_dim,
                local_proj_out_dim=local_proj_out_dim, summary_hid_dim=summary_hid_dim,
                summary_out_dim=d_model, mode=mode, dropout_rate=dropout_rate)
        elif attention_type == "RelPosMHAXL":
            self.self_attn = RelPosMHAXL(d_model, nhead, dropout_rate, mask_pos_future=causal)
        else:
            self.self_attn = MultiheadAttention(d_model, nhead, dropout_rate)
        self.cross_attn = (RelPosMHAXL(d_model, nhead, dropout_rate, mask_pos_future=causal)
                           if attention_type == "RelPosMHAXL"
                           else MultiheadAttention(d_model, nhead, dropout_rate))
        self.pos_ffn = PositionalwiseFeedForward(d_ffn, d_model, dropout_rate, activation)
        self.norm1 = LayerNorm(d_model, eps=1e-6)
        self.norm2 = LayerNorm(d_model, eps=1e-6)
        self.norm3 = LayerNorm(d_model, eps=1e-6)
        self.dropout = Dropout(dropout_rate)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                tgt_pad_mask: Optional[torch.Tensor] = None,
                memory_pad_mask: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None,
                pos_embs_tgt: Optional[torch.Tensor] = None,
                pos_embs_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        pre = self.normalize_before
        rel = self.attention_type == "RelPosMHAXL"
        t1 = self.norm1(tgt) if pre else tgt
        if self.attention_type == "SummaryMixing":
            out = apply_mixer(self.self_attn, "SummaryMixing", t1, attn_mask=tgt_mask,
                              pad_mask=tgt_pad_mask)
        else:
            out = self.self_attn(t1, t1, t1, attn_mask=tgt_mask, pad_mask=tgt_pad_mask,
                                 **({"pos_embs": pos_embs_tgt} if rel else {}))
        tgt = tgt + self.dropout(out)
        if not pre:
            tgt = self.norm1(tgt)
        t1 = self.norm2(tgt) if pre else tgt
        tgt = tgt + self.dropout(self.cross_attn(
            t1, memory, memory, attn_mask=memory_mask, pad_mask=memory_pad_mask,
            **({"pos_embs": pos_embs_src} if rel else {})))
        if not pre:
            tgt = self.norm2(tgt)
        t1 = self.norm3(tgt) if pre else tgt
        tgt = tgt + self.dropout(self.pos_ffn(t1))
        return tgt if pre else self.norm3(tgt)

    def init_cache(self, memory: torch.Tensor, max_len: int, rows: Optional[int] = None) -> dict:
        """The layer's decode cache: cross-attention K/V from `memory`
        `[B, T, D]` at B rows, and at `rows` (B·beam in beam search; B by
        default) zeroed self-attention K/V in the K/V dtype, as the JAX
        layer makes them, or the Summary Decoder's float32 `(sum, denom)`
        carry (`"sm"`)."""
        if self.attention_type == "RelPosMHAXL":
            raise ValueError("cached decoding supports regularMHA and SummaryMixing")
        mem_k, mem_v = self.cross_attn.kv(memory)
        rows = rows or memory.shape[0]
        if self.attention_type == "SummaryMixing":
            return {"sm": self.self_attn.decode_init(rows, memory.device),
                    "mem_k": mem_k, "mem_v": mem_v}
        self_kv = _self_attn_cache(rows, max_len, self.nhead, self.d_model, mem_k.dtype,
                                   memory.device)
        return {"self_k": self_kv["k"], "self_v": self_kv["v"], "mem_k": mem_k, "mem_v": mem_v}

    def step(self, x_t: torch.Tensor, pos: int, cache: dict,
             memory_pad_mask: Optional[torch.Tensor] = None):
        """One decoding position: x_t `[N, D]` -> (`[N, D]`, cache)."""
        pre = self.normalize_before
        t1 = self.norm1(x_t) if pre else x_t
        if self.attention_type == "SummaryMixing":
            out, sm = self.self_attn.decode_step(t1, cache["sm"])
            cache = dict(cache, sm=sm)
        else:
            out, sk, sv = self.self_attn.step(t1, cache["self_k"], cache["self_v"], pos,
                                              append=True)
            cache = dict(cache, self_k=sk, self_v=sv)
        x = x_t + out
        if not pre:
            x = self.norm1(x)
        t1 = self.norm2(x) if pre else x
        out, _, _ = self.cross_attn.step(t1, cache["mem_k"], cache["mem_v"], pos,
                                         pad_mask=memory_pad_mask, append=False)
        x = x + out
        if not pre:
            x = self.norm2(x)
        t1 = self.norm3(x) if pre else x
        x = x + self.pos_ffn(t1)
        if not pre:
            x = self.norm3(x)
        return x, cache


class TransformerDecoder(nn.Module):
    """`layer_0` ... `layer_{n-1}`, then a LayerNorm (eps 1e-6)."""

    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 dropout_rate: float = 0.0, activation: str = "gelu",
                 normalize_before: bool = True, attention_type: str = "regularMHA",
                 **summary_kwargs):
        """`summary_kwargs`: `causal` (RelPosMHAXL's future mask) and the Summary
        Decoder cell's `local_proj_hid_dim`,
        `local_proj_out_dim`, `summary_hid_dim` and `mode`."""
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(
                d_model, d_ffn, nhead, dropout_rate, activation, normalize_before,
                attention_type, **summary_kwargs))
        self.norm = LayerNorm(d_model, eps=1e-6)

    def layers(self) -> List[TransformerDecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                tgt_pad_mask: Optional[torch.Tensor] = None,
                memory_pad_mask: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None,
                pos_embs_tgt: Optional[torch.Tensor] = None,
                pos_embs_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers():
            tgt = layer(tgt, memory, tgt_mask, tgt_pad_mask, memory_pad_mask, memory_mask,
                        pos_embs_tgt, pos_embs_src)
        return self.norm(tgt)

    def init_cache(self, memory: torch.Tensor, max_len: int, rows: Optional[int] = None) -> list:
        return [layer.init_cache(memory, max_len, rows) for layer in self.layers()]

    def step(self, x_t: torch.Tensor, pos: int, cache: list,
             memory_pad_mask: Optional[torch.Tensor] = None):
        """x_t `[N, D]` at position `pos` -> (normed hidden `[N, D]`, cache)."""
        new_cache = []
        for layer, c in zip(self.layers(), cache):
            x_t, c = layer.step(x_t, pos, c, memory_pad_mask)
            new_cache.append(c)
        return self.norm(x_t), new_cache


class NormalizedEmbedding(nn.Module):
    """Token embedding `emb` scaled by sqrt(d_model), in float32 (the flax
    module takes no compute dtype)."""

    def __init__(self, d_model: int, vocab: int):
        super().__init__()
        self.d_model = d_model
        self.emb = nn.Embedding(vocab, d_model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.emb(tokens) * math.sqrt(self.d_model)
