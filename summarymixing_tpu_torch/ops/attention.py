"""Multi-head attention ("regularMHA") and the position-wise feed-forward
block — the port of `MultiheadAttention.__call__` and
`PositionalwiseFeedForward` from `summarymixing_tpu/ops/attention.py`.

Plain PyTorch, as in the JAX package (neither is a Pallas kernel). The
scores are taken in float32 from the projections' dtype, the attention
mask and the key padding mask merge into one additive float32 bias
(`merge_masks`, the JAX `_merge_masks`), the softmax is float32, and the
probabilities are cast back to the values' dtype for the weighted sum,
which accumulates in float32. The KV-cached `step` of the JAX module is
for beam search and is still to port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from summarymixing_tpu_torch.ops.layers import Dense, Dropout
from summarymixing_tpu_torch.ops.linear import get_activation
from summarymixing_tpu_torch.ops.masks import mask_to_additive


def merge_masks(attn_mask: Optional[torch.Tensor], pad_mask: Optional[torch.Tensor],
                batch: int, tgt_len: int, src_len: int) -> Optional[torch.Tensor]:
    """`[T, S]` or `[B, T, S]` attn_mask and `[B, S]` pad_mask (1 = allowed)
    -> one `[B, 1, T, S]` additive float32 bias, or None."""
    allowed = None
    if attn_mask is not None:
        allowed = (attn_mask[None].expand(batch, tgt_len, src_len) if attn_mask.dim() == 2
                   else attn_mask)
    if pad_mask is not None:
        pm = pad_mask[:, None, :].expand(batch, tgt_len, src_len)
        allowed = pm if allowed is None else allowed * pm
    if allowed is None:
        return None
    return mask_to_additive(allowed)[:, None]


def _mm32(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of two operands with float32 accumulation and result."""
    return torch.einsum(equation, a.to(torch.float32), b.to(torch.float32))


class MultiheadAttention(nn.Module):
    """Scaled dot-product attention over `nhead` heads with q/k/v/out
    projections named as in the flax module."""

    def __init__(self, d_model: int, nhead: int, dropout_rate: float = 0.0):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.q_proj = Dense(d_model, d_model)
        self.k_proj = Dense(d_model, d_model)
        self.v_proj = Dense(d_model, d_model)
        self.out_proj = Dense(d_model, d_model)
        self.attn_dropout = Dropout(dropout_rate)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.nhead, self.d_model // self.nhead)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t, _ = query.shape
        s = key.shape[1]
        q = self._heads(self.q_proj(query))
        k = self._heads(self.k_proj(key))
        v = self._heads(self.v_proj(value))
        scores = _mm32("bthd,bshd->bhts", q, k) / math.sqrt(self.d_model // self.nhead)
        bias = merge_masks(attn_mask, pad_mask, b, t, s)
        if bias is not None:
            scores = scores + bias
        probs = self.attn_dropout(torch.softmax(scores, dim=-1))
        ctx = _mm32("bhts,bshd->bthd", probs.to(v.dtype), v).to(v.dtype)
        return self.out_proj(ctx.reshape(b, t, self.d_model))


class PositionalwiseFeedForward(nn.Module):
    """Linear(d -> d_ffn) -> activation -> dropout -> Linear(d_ffn -> d)."""

    def __init__(self, d_ffn: int, d_model: int, dropout_rate: float = 0.0,
                 activation: str = "gelu"):
        super().__init__()
        self.ffn_in = Dense(d_model, d_ffn)
        self.ffn_out = Dense(d_ffn, d_model)
        self.dropout = Dropout(dropout_rate)
        self._act = get_activation(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn_out(self.dropout(self._act(self.ffn_in(x))))
