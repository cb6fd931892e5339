"""The attention decoder — the port of `TransformerDecoderLayer` (the
regularMHA route), `TransformerDecoder` and `NormalizedEmbedding` from
`summarymixing_tpu/models/transformer.py`. The KV cache and `step` of
the JAX modules serve beam search and are still to port, as are the
RelPosMHAXL and Summary Decoder routes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from summarymixing_tpu_torch.ops.attention import MultiheadAttention, PositionalwiseFeedForward
from summarymixing_tpu_torch.ops.layers import Dropout, LayerNorm


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention and the feed-forward block, each
    with a LayerNorm (eps 1e-6) before it (or after, without
    `normalize_before`) and dropout before its residual."""

    def __init__(self, d_model: int, d_ffn: int, nhead: int, dropout_rate: float = 0.0,
                 activation: str = "gelu", normalize_before: bool = True,
                 attention_type: str = "regularMHA"):
        super().__init__()
        if attention_type not in ("regularMHA", "vanillaMHA"):
            raise NotImplementedError(
                f"decoder attention {attention_type!r} is not ported; see ROADMAP.md")
        self.normalize_before = normalize_before
        self.self_attn = MultiheadAttention(d_model, nhead, dropout_rate)
        self.cross_attn = MultiheadAttention(d_model, nhead, dropout_rate)
        self.pos_ffn = PositionalwiseFeedForward(d_ffn, d_model, dropout_rate, activation)
        self.norm1 = LayerNorm(d_model, eps=1e-6)
        self.norm2 = LayerNorm(d_model, eps=1e-6)
        self.norm3 = LayerNorm(d_model, eps=1e-6)
        self.dropout = Dropout(dropout_rate)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                tgt_pad_mask: Optional[torch.Tensor] = None,
                memory_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        pre = self.normalize_before
        t1 = self.norm1(tgt) if pre else tgt
        tgt = tgt + self.dropout(self.self_attn(t1, t1, t1, attn_mask=tgt_mask,
                                                pad_mask=tgt_pad_mask))
        if not pre:
            tgt = self.norm1(tgt)
        t1 = self.norm2(tgt) if pre else tgt
        tgt = tgt + self.dropout(self.cross_attn(t1, memory, memory, pad_mask=memory_pad_mask))
        if not pre:
            tgt = self.norm2(tgt)
        t1 = self.norm3(tgt) if pre else tgt
        tgt = tgt + self.dropout(self.pos_ffn(t1))
        return tgt if pre else self.norm3(tgt)


class TransformerDecoder(nn.Module):
    """`layer_0` ... `layer_{n-1}`, then a LayerNorm (eps 1e-6)."""

    def __init__(self, num_layers: int, d_model: int, d_ffn: int, nhead: int,
                 dropout_rate: float = 0.0, activation: str = "gelu",
                 normalize_before: bool = True, attention_type: str = "regularMHA"):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerDecoderLayer(
                d_model, d_ffn, nhead, dropout_rate, activation, normalize_before,
                attention_type))
        self.norm = LayerNorm(d_model, eps=1e-6)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_mask: Optional[torch.Tensor] = None,
                tgt_pad_mask: Optional[torch.Tensor] = None,
                memory_pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer_{i}")(tgt, memory, tgt_mask, tgt_pad_mask,
                                              memory_pad_mask)
        return self.norm(tgt)


class NormalizedEmbedding(nn.Module):
    """Token embedding `emb` scaled by sqrt(d_model), in float32 (the flax
    module takes no compute dtype)."""

    def __init__(self, d_model: int, vocab: int):
        super().__init__()
        self.d_model = d_model
        self.emb = nn.Embedding(vocab, d_model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.emb(tokens) * math.sqrt(self.d_model)
