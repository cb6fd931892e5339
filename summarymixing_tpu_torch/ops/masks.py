"""Mask builders — the port of `summarymixing_tpu/ops/masks.py`.

One convention everywhere: multiplicative float masks, 1 = valid, 0 = masked.
"""

from __future__ import annotations

from typing import Optional

import torch


def length_to_mask(lengths: torch.Tensor, max_len: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`[B]` lengths -> `[B, T]` float mask, 1 for t < length."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def rel_length_to_mask(rel_lens: torch.Tensor, max_len: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Relative lengths in [0, 1] -> `[B, T]` mask, abs = round(rel * T).

    The product is rounded in float32, as the JAX package does: a float64
    product can round to the other side of .5 and move a length by one."""
    rel = rel_lens.to(torch.float32)
    abs_len = torch.round(rel * torch.tensor(max_len, dtype=torch.float32,
                                             device=rel.device)).to(torch.int32)
    return length_to_mask(abs_len, max_len, dtype)


def chunked_context_mask(size: int, chunk_size: int, left_context_chunks: Optional[int] = None,
                         dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Dynamic Chunk Training mask `[T, T]`, 1 = allowed: frame t sees the
    frames s < (t//chunk + 1)·chunk (up to the end of its own chunk) and,
    with a limited left context, s >= (t//chunk - left_context_chunks)·chunk."""
    t_idx = torch.arange(size, device=device)
    chunk_of = t_idx // chunk_size
    allowed = t_idx[None, :] < ((chunk_of + 1) * chunk_size)[:, None]
    if left_context_chunks is not None:
        lower = (chunk_of - left_context_chunks) * chunk_size
        allowed = allowed & (t_idx[None, :] >= lower[:, None])
    return allowed.to(dtype)


def combine_padding(sum_mask: Optional[torch.Tensor],
                    pad_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Embed a `[B, T]` padding mask into a `[T, T]` (or `[B, T, T]`) summary
    mask, zeroing padded columns. Returns `[B, T, T]` when both are given."""
    if sum_mask is None or pad_mask is None:
        return sum_mask
    if sum_mask.dim() == 3:
        return sum_mask * pad_mask[:, None, :]
    return sum_mask[None, :, :] * pad_mask[:, None, :]


def key_padding_mask_from_tokens(tokens: torch.Tensor, pad_idx: int = 0,
                                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`[B, U]` int tokens -> `[B, U]` float mask, 1 where token != pad_idx."""
    return (tokens != pad_idx).to(dtype)


def lookahead_mask(size: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """`[T, T]` float mask, 1 where a target may attend (s <= t)."""
    return torch.tril(torch.ones(size, size, dtype=dtype, device=device))


def mask_to_additive(mask: Optional[torch.Tensor],
                     dtype: torch.dtype = torch.float32) -> Optional[torch.Tensor]:
    """1 = allowed mask -> additive bias: 0 where allowed, the dtype's most
    negative finite value where masked."""
    if mask is None:
        return None
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    neg = torch.full((), torch.finfo(dtype).min, dtype=dtype, device=mask.device)
    return torch.where(mask > 0, zero, neg)
