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

On the card, RelPosMHAXL's attention (after the projections) runs the
CUDA kernel `csrc/relpos_attention.cu` for a call it takes (`relpos_refusal`:
bf16, head size 64, square self-attention, no attn_mask, no active dropout;
any key padding mask and `mask_pos_future` it takes), through
`fused_relpos_attention` and the registered op
`summarymixing_torch::relpos_attention`; any other call on the card runs
the plain version `relpos_attention_reference`, counted in
`fused_relpos_attention.plain_calls`; on the CPU the plain version runs.
Source note: the kernel replaces no TPU kernel (the JAX package leaves this
attention to XLA); it was added because the plain version writes float32
`[B, H, T, T]` and `[B, H, T, 2T-1]` tensors to device memory about fifteen
times a call. Its bound is operations: the function needs three T x T x hd
products per utterance and head (content, the rel_shift band of the
position scores, value), at B=4, H=8, hd=64, T=3,000 1.11e11 operations,
0.112 ms at 989 TFLOP/s. Design: a block per (128 queries, head,
utterance) loops over 64-key tiles fed by TMA, runs the products on
`wgmma` (the position product over the 2T-1 columns of its window), stages
each warp's position scores in shared memory to read the rel_shift band,
and keeps an online softmax in registers, so no score or probability
reaches device memory. The pad mask reaches it as it is, `[B, S]` float32
in any pattern (a streaming Conformer's left buffer that is not full yet
leaves the valid keys at the end, not at the start): each block turns its
row into one bit a key in shared memory, loads only the key tiles between
the first and the last allowed key, and masks only in a tile with a key
not allowed or on the causal diagonal; a row with none attends uniformly
over all keys, as the plain version's all-masked softmax does. Its
backward is the plain version's VJP.

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

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from summarymixing_tpu_torch.ops import _build
from summarymixing_tpu_torch.ops.layers import Dense, Dropout, cast_params
from summarymixing_tpu_torch.ops.linear import get_activation
from summarymixing_tpu_torch.ops.masks import mask_to_additive
from summarymixing_tpu_torch.ops.summary_mixing import uses_kernel


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


# -- RelPosMHAXL's attention: plain version and the CUDA kernel's wrapper ----------------

RELPOS_HEAD_DIM = 64   # the head size csrc/relpos_attention.cu is built for


def relpos_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               p: torch.Tensor, pos_bias_u: torch.Tensor,
                               pos_bias_v: torch.Tensor,
                               attn_mask: Optional[torch.Tensor] = None,
                               pad_mask: Optional[torch.Tensor] = None,
                               causal: bool = False,
                               dropout: Optional[nn.Module] = None) -> torch.Tensor:
    """Plain version of RelPosMHAXL's attention: q `[B, T, H, hd]`, k and v
    `[B, S, H, hd]`, p the projected table `[1, 2S-1, H, hd]`, the biases
    `[H, hd]`; `attn_mask` `[T, S]` or `[B, T, S]` and `pad_mask` `[B, S]`
    (1 = allowed); `causal` joins the lower-triangular mask; `dropout` acts
    on the probabilities. Returns the context `[B, T, H, hd]` in v's dtype."""
    b, t, _, hd = q.shape
    s = k.shape[1]
    content = _mm32("bthd,bshd->bhts", q + pos_bias_u.to(q.dtype), k)
    pos = rel_shift(_mm32("bthd,xphd->bhtp", q + pos_bias_v.to(q.dtype), p))
    scores = (content + pos) / math.sqrt(hd)
    allowed = attn_mask
    if causal:
        tril = torch.tril(torch.ones(t, s, dtype=scores.dtype, device=scores.device))
        allowed = tril if allowed is None else allowed * tril
    bias = merge_masks(allowed, pad_mask, b, t, s)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    if dropout is not None:
        probs = dropout(probs)
    return _mm32("bhts,bshd->bthd", probs.to(v.dtype), v).to(v.dtype)


def relpos_refusal(*, dtypes, head_dim: int, tgt_len: int, src_len: int, pos_len: int,
                   attn_mask: bool, dropout: bool) -> Optional[str]:
    """Why the kernel does not take a RelPosMHAXL call, or None when it
    takes it: the dtypes of q, k, v and p, the head size, the query, key
    and position lengths, whether an attention mask is given and whether
    dropout on the probabilities is active. The one statement of the
    kernel's limits: the module's route and the launch's check both read
    it; on the card a call it refuses runs the plain version, counted in
    `fused_relpos_attention.plain_calls`."""
    if any(dt != torch.bfloat16 for dt in dtypes):
        return f"the kernel computes in bf16, not {sorted({str(dt) for dt in dtypes})}"
    if head_dim != RELPOS_HEAD_DIM:
        return f"the kernel is built for a head size of {RELPOS_HEAD_DIM}, not {head_dim}"
    if tgt_len != src_len or pos_len != 2 * src_len - 1:
        return (f"the kernel takes square self-attention (T queries, T keys, 2T-1 positions), "
                f"not {tgt_len} queries, {src_len} keys and {pos_len} positions")
    if attn_mask:
        return "the kernel takes a key padding mask and the causal mask, not an attn_mask"
    if dropout:
        return "the kernel has no dropout on the probabilities"
    return None


def _relpos_check(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask):
    b, t, h, hd = q.shape
    refused = relpos_refusal(dtypes=(q.dtype, k.dtype, v.dtype, p.dtype), head_dim=hd,
                             tgt_len=t, src_len=k.shape[1], pos_len=p.shape[1],
                             attn_mask=False, dropout=False)
    if refused is not None:
        raise ValueError(refused)
    for name, x, shape in (("q", q, (b, t, h, hd)), ("k", k, (b, t, h, hd)),
                           ("v", v, (b, t, h, hd)), ("p", p, (1, 2 * t - 1, h, hd)),
                           ("pos_bias_u", pos_bias_u, (h, hd)),
                           ("pos_bias_v", pos_bias_v, (h, hd))):
        if (x.dtype != q.dtype or tuple(x.shape) != shape or not x.is_contiguous()
                or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {q.dtype} {shape} "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
    if pad_mask is not None and (pad_mask.dtype != torch.float32
                                 or tuple(pad_mask.shape) != (b, t)
                                 or not pad_mask.is_contiguous()):
        raise ValueError(f"pad_mask must be a contiguous float32 [{b}, {t}] tensor, got "
                         f"{pad_mask.dtype} {tuple(pad_mask.shape)}")
    others = (k, v, p, pos_bias_u, pos_bias_v) + (() if pad_mask is None else (pad_mask,))
    if any(x.device != q.device for x in others):
        raise ValueError("every input must be on q's device")
    return b, t, h


@functools.cache
def _relpos_kernel():
    """The C entry point of csrc/relpos_attention.cu, built and declared on first use."""
    ptr, i = ctypes.c_void_p, ctypes.c_int
    fn = _build.load_library("relpos_attention").relpos_attention_forward
    # q, k, v, p, pos_bias_u, pos_bias_v, pad mask (or null), B, T, H, causal, scale,
    # out, stream
    fn.argtypes = [ptr] * 7 + [i] * 4 + [ctypes.c_float, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def _relpos_launch(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask, causal):
    """One launch of the kernel on the biases in q's dtype (the kernel adds
    them to q and rounds to bf16, as the plain version's bf16 add does)."""
    pos_bias_u, pos_bias_v = pos_bias_u.to(q.dtype), pos_bias_v.to(q.dtype)
    b, t, h = _relpos_check(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask)
    out = torch.empty_like(q)
    fn = _relpos_kernel()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), pos_bias_u.data_ptr(),
                 pos_bias_v.data_ptr(), None if pad_mask is None else pad_mask.data_ptr(),
                 b, t, h, int(causal),
                 1.0 / math.sqrt(RELPOS_HEAD_DIM), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"RelPosMHAXL kernel launch failed with CUDA error {err}")
    _relpos_counts.launches += 1
    return out


@torch.library.custom_op(f"{_build.OP_NAMESPACE}::relpos_attention", mutates_args=(),
                         device_types="cpu")
def relpos_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
                        pos_bias_u: torch.Tensor, pos_bias_v: torch.Tensor,
                        pad_mask: Optional[torch.Tensor], causal: bool) -> torch.Tensor:
    """The kernel as a registered op, `summarymixing_torch::relpos_attention`:
    every launch goes through it, so `torch.export` records it in a graph.
    `pad_mask` is `[B, S]` float32 (1 = allowed) or None. On the card one
    launch; on the CPU the plain version, for `torch.library.opcheck`."""
    return relpos_attention_reference(q, k, v, p, pos_bias_u, pos_bias_v, None, pad_mask,
                                      causal).contiguous()


@relpos_attention_op.register_kernel("cuda")
def _relpos_attention_cuda(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask, causal):
    return _relpos_launch(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask, causal)


@relpos_attention_op.register_fake
def _relpos_attention_fake(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask, causal):
    # shape and dtype only: the context has q's shape in v's dtype
    return q.new_empty(q.shape, dtype=v.dtype)


class FusedRelPosAttention(torch.autograd.Function):
    """Forward: one kernel launch. Backward: the VJP of the plain version,
    recomputed from the saved q, k, v, p, biases and pad mask."""

    @staticmethod
    def forward(ctx, q, k, v, p, pos_bias_u, pos_bias_v, pad_mask, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask)
        return relpos_attention_op(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask, causal)

    @staticmethod
    def backward(ctx, grad_out):
        *inputs, pad_mask = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        _relpos_counts.backwards += 1
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need) for x, need in zip(inputs, needs)]
            out = relpos_attention_reference(*leaves, None, pad_mask, ctx.causal)
            grads = iter(torch.autograd.grad(out, [x for x in leaves if x.requires_grad],
                                             grad_out))
        return (*(next(grads) if need else None for need in needs), None, None)


def fused_relpos_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
                           pos_bias_u: torch.Tensor, pos_bias_v: torch.Tensor,
                           pad_mask: Optional[torch.Tensor] = None,
                           causal: bool = False) -> torch.Tensor:
    """RelPosMHAXL's attention with no attn_mask and no dropout (the
    arguments of `relpos_attention_reference`). On a CPU tensor this is the
    plain version; on a CUDA tensor it launches the kernel or raises. When
    autograd records, the backward is the plain version's VJP.
    `fused_relpos_attention.launches` counts kernel launches, `.backwards`
    the backward passes through them and `.plain_calls` the RelPosMHAXL
    calls on the card that the kernel does not take (`relpos_refusal`)."""
    if q.device.type == "cpu":
        return relpos_attention_reference(q, k, v, p, pos_bias_u, pos_bias_v, None, pad_mask,
                                          causal)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    if pad_mask is not None:   # the kernel reads a float32 mask; the port's are float32
        pad_mask = pad_mask.to(torch.float32).contiguous()
    args = (q, k, v, p, pos_bias_u, pos_bias_v)
    if torch.is_grad_enabled() and any(x.requires_grad for x in args):
        return FusedRelPosAttention.apply(*args, pad_mask, causal)
    return relpos_attention_op(*args, pad_mask, causal)


fused_relpos_attention.launches = 0
fused_relpos_attention.backwards = 0
fused_relpos_attention.plain_calls = 0
# the counters stay on the wrapper when a caller swaps the module attribute
_relpos_counts = fused_relpos_attention


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
        if uses_kernel(q):
            drop = self.attn_dropout
            if relpos_refusal(dtypes=(q.dtype, k.dtype, v.dtype, p.dtype), head_dim=hd,
                              tgt_len=t, src_len=s, pos_len=p.shape[1],
                              attn_mask=attn_mask is not None,
                              dropout=drop.training and drop.rate > 0) is None:
                # the biases in q's dtype, cast once while no gradient is recorded
                u, vb = cast_params(self, q.dtype, ("pos_bias_u", "pos_bias_v"))
                ctx = fused_relpos_attention(q, k, v, p, u, vb, pad_mask, self.mask_pos_future)
                return self.out_proj(ctx.reshape(b, t, self.d_model))
            _relpos_counts.plain_calls += 1
        ctx = relpos_attention_reference(q, k, v, p, self.pos_bias_u, self.pos_bias_v, attn_mask,
                                         pad_mask, self.mask_pos_future, self.attn_dropout)
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
