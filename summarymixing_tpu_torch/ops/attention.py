"""The attention-family mixers and the position-wise feed-forward block —
the port of `MultiheadAttention` ("regularMHA"), `rel_shift`,
`RelPosMHAXL`, `HyperMixing` and `PositionalwiseFeedForward` from
`summarymixing_tpu/ops/attention.py`.

Plain PyTorch, as in the JAX package (none is a Pallas kernel). The
products take their operands in the projections' dtype and accumulate in
float32 (`_mm32`), the attention mask and the key padding mask merge into
one additive float32 bias (`merge_masks`, the JAX `_merge_masks`), the
softmax is float32, and the probabilities are cast back to the values'
dtype for the weighted sum.

`RelPosMHAXL` is Transformer-XL attention over relative positions: score =
((q + u)·kᵀ + rel_shift((q + v)·pᵀ)) / sqrt(hd), p the projected
`relpos_xl_table`; with `mask_pos_future` a lower-triangular mask joins the
attention mask. `HyperMixing` (HyperMixer token mixing) builds its
token-mixing MLP's weights from the inputs: out = W2 · GELU(W1ᵀ · v) per
head, W1 = hyper_in(x), W2 = hyper_out(x), over the valid frames (padded
frames are zeroed; an attention mask does not reach it, as in the JAX
module).

`MultiheadAttention.step` is the KV-cached one-position attention of beam
search (the JAX `step` and `_step_grouped`). Its caches are laid out
head-major, `[B, H, S, hd]` (the JAX package keeps `[B, S, H, hd]`), so
that each product reads a cache slice without a copy; the self-attention
step attends over `cache[:, :, :pos+1]` only, where the JAX step masks the
positions past `pos` out of a softmax over all S: they take probability 0
there, so the result is the same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
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

    def _cache_heads(self, x: torch.Tensor) -> torch.Tensor:
        """`[B, T, D]` -> head-major `[B, H, T, hd]`."""
        return self._heads(x).transpose(1, 2).contiguous()

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

    # -- incremental decoding ---------------------------------------------
    def kv(self, x: torch.Tensor):
        """K/V heads of a static memory `[B, S, D]`: `[B, H, S, hd]` each."""
        return self._cache_heads(self.k_proj(x)), self._cache_heads(self.v_proj(x))

    def step(self, x_t: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
             pad_mask: Optional[torch.Tensor] = None, append: bool = True):
        """One-position attention. x_t `[N, D]`; caches `[B, H, S, hd]`.

        With `append` (self-attention) the position's K/V are written into
        the caches at `pos`, in place, and the query attends over positions
        0..pos (under `pad_mask` `[N, S]`, if given). Without it
        (cross-attention) the query attends over the whole cache, under
        `pad_mask` `[B, S]` (1 = valid); when the caches hold B < N rows,
        row n attends over row n // (N / B) (beam search: the encoder-side
        K/V is never tiled by beam). Returns `(out [N, D], k_cache,
        v_cache)`."""
        h, hd = self.nhead, self.d_model // self.nhead
        n = x_t.shape[0]
        if not append and k_cache.shape[0] != n:
            return self._step_grouped(x_t, k_cache, v_cache, pad_mask)
        q = self.q_proj(x_t).reshape(n, h, 1, hd)
        if append:
            k_cache[:, :, pos] = self.k_proj(x_t).reshape(n, h, hd).to(k_cache.dtype)
            v_cache[:, :, pos] = self.v_proj(x_t).reshape(n, h, hd).to(v_cache.dtype)
            keys, values = k_cache[:, :, :pos + 1], v_cache[:, :, :pos + 1]
            if pad_mask is not None:
                pad_mask = pad_mask[:, :pos + 1]
        else:
            keys, values = k_cache, v_cache
        ctx = _attend(q, keys, values, None if pad_mask is None else pad_mask[:, None, None, :],
                      hd)
        out = self.out_proj(ctx.to(x_t.dtype).reshape(n, self.d_model))
        return out, k_cache, v_cache

    def _step_grouped(self, x_t: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      pad_mask: Optional[torch.Tensor] = None):
        """Cross-attention with beam-shared memory: x_t `[N, D]` (N = B·g),
        caches `[B, H, S, hd]`; the g query rows of utterance b ride as g
        query positions against its cache row (queries are independent in
        cross-attention, so this is per-row attention)."""
        h, hd = self.nhead, self.d_model // self.nhead
        n = x_t.shape[0]
        b = k_cache.shape[0]
        g = n // b
        q = self.q_proj(x_t).reshape(b, g, h, hd).transpose(1, 2)      # [B, H, g, hd]
        if pad_mask is not None and pad_mask.shape[0] == n:   # beam-tiled mask: rows repeat
            pad_mask = pad_mask[::g]
        mask = None if pad_mask is None else pad_mask[:, None, None, :]
        ctx = _attend(q, k_cache, v_cache, mask, hd)                       # [B, H, g, hd]
        out = self.out_proj(ctx.to(x_t.dtype).transpose(1, 2).reshape(n, self.d_model))
        return out, k_cache, v_cache


def _attend(q: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
            pad_mask: Optional[torch.Tensor], head_dim: int) -> torch.Tensor:
    """softmax(q·kᵀ / sqrt(hd)) · v over head-major `[.., S, hd]` operands,
    scores and accumulation in float32, the probabilities cast to the
    values' dtype first (the JAX step's `preferred_element_type`); masked
    positions (`pad_mask` 0) get float32's most negative value."""
    f32 = torch.float32
    scores = torch.matmul(q.to(f32), keys.to(f32).transpose(-1, -2)) / math.sqrt(head_dim)
    if pad_mask is not None:
        scores = torch.where(pad_mask > 0, scores, torch.finfo(f32).min)
    probs = torch.softmax(scores, dim=-1).to(values.dtype)
    return torch.matmul(probs.to(f32), values.to(f32))


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift: x `[B, H, T, 2T-1]` (keys from the
    most-past to the most-future) -> `[B, H, T, T]`, out[..., t, s] =
    x[..., t, (T-1) - t + s], by a pad, reshapes and slices (no gather).
    Square attention only: T queries over T keys."""
    b, h, t, w = x.shape
    if w != 2 * t - 1:
        raise ValueError(
            f"rel_shift requires square attention (got {t} queries, pos width {w} != 2*{t}-1); "
            "RelPosMHAXL cross-attention with mismatched query/key lengths is unsupported — "
            "use regularMHA")
    x = F.pad(x, (1, 0)).reshape(b, h, 2 * t, t)[:, :, 1:]
    return x.reshape(b, h, t, 2 * t - 1)[..., :t]


def _xavier_uniform_(t: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `xavier_uniform` on a 2-D leaf: U(±sqrt(6 / (fan_in + fan_out)))."""
    bound = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class RelPosMHAXL(nn.Module):
    """Multi-head attention over relative positions (Transformer-XL), with
    the content and position biases `pos_bias_u`, `pos_bias_v` `[H, hd]`
    and a bias-free `pos_proj` of the `[1, 2S-1, D]` position table."""

    def __init__(self, d_model: int, nhead: int, dropout_rate: float = 0.0,
                 mask_pos_future: bool = False):
        super().__init__()
        self.d_model, self.nhead = d_model, nhead
        self.mask_pos_future = mask_pos_future
        hd = d_model // nhead
        self.q_proj = Dense(d_model, d_model)
        self.k_proj = Dense(d_model, d_model)
        self.v_proj = Dense(d_model, d_model)
        self.pos_proj = Dense(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(nhead, hd))
        self.pos_bias_v = nn.Parameter(torch.empty(nhead, hd))
        self.out_proj = Dense(d_model, d_model)
        self.attn_dropout = Dropout(dropout_rate)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _xavier_uniform_(self.pos_bias_u, generator)
        _xavier_uniform_(self.pos_bias_v, generator)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                pos_embs: Optional[torch.Tensor] = None) -> torch.Tensor:
        if pos_embs is None:
            raise ValueError("RelPosMHAXL requires pos_embs [1, 2S-1, D]")
        h, hd = self.nhead, self.d_model // self.nhead
        b, t, _ = query.shape
        s = key.shape[1]
        q = self.q_proj(query).reshape(b, t, h, hd)
        k = self.k_proj(key).reshape(b, s, h, hd)
        v = self.v_proj(value).reshape(b, s, h, hd)
        p = self.pos_proj(pos_embs).reshape(1, -1, h, hd)
        content = _mm32("bthd,bshd->bhts", q + self.pos_bias_u.to(q.dtype), k)
        pos = rel_shift(_mm32("bthd,xphd->bhtp", q + self.pos_bias_v.to(q.dtype), p))
        scores = (content + pos) / math.sqrt(hd)
        allowed = attn_mask
        if self.mask_pos_future:
            causal = torch.tril(torch.ones(t, s, dtype=scores.dtype, device=scores.device))
            allowed = causal if allowed is None else allowed * causal
        bias = merge_masks(allowed, pad_mask, b, t, s)
        if bias is not None:
            scores = scores + bias
        probs = self.attn_dropout(torch.softmax(scores, dim=-1))
        ctx = _mm32("bhts,bshd->bthd", probs.to(v.dtype), v).to(v.dtype)
        return self.out_proj(ctx.reshape(b, t, self.d_model))


class HyperMixing(nn.Module):
    """HyperMixer token mixing: per head, out = W2 · GELU(W1ᵀ · v), the
    token-mixing weights W1 = `hyper_in`(x), W2 = `hyper_out`(x) (`[B, T,
    hypernet_size]` each, two separate networks), then `out_proj`.
    Padded frames of x and the values are zeroed first; `attn_mask` is
    taken and not used, as by the JAX module: the mix runs over every
    valid frame."""

    def __init__(self, d_model: int, hypernet_size: int, nhead: int = 1):
        super().__init__()
        self.d_model, self.nhead, self.hypernet_size = d_model, nhead, hypernet_size
        self.hyper_in = Dense(d_model, hypernet_size * nhead)
        self.hyper_out = Dense(d_model, hypernet_size * nhead)
        self.out_proj = Dense(d_model, d_model)

    def forward(self, query: torch.Tensor, key: Optional[torch.Tensor] = None,
                value: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = query
        value = x if value is None else value
        b, t, d = x.shape
        h, hyp = self.nhead, self.hypernet_size
        if pad_mask is not None:
            keep = pad_mask[..., None].to(x.dtype)
            x, value = x * keep, value * keep
        w1 = self.hyper_in(x).reshape(b, t, h, hyp)
        w2 = self.hyper_out(x).reshape(b, t, h, hyp)
        v = value.reshape(b, t, h, d // h)
        hidden = F.gelu(_mm32("bthp,bthd->bhpd", w1, v).to(v.dtype))
        mixed = _mm32("bthp,bhpd->bthd", w2, hidden).to(v.dtype)
        return self.out_proj(mixed.reshape(b, t, d))


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
