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


def combine_padding(sum_mask: Optional[torch.Tensor],
                    pad_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Embed a `[B, T]` padding mask into a `[T, T]` (or `[B, T, T]`) summary
    mask, zeroing padded columns. Returns `[B, T, T]` when both are given."""
    if sum_mask is None or pad_mask is None:
        return sum_mask
    if sum_mask.dim() == 3:
        return sum_mask * pad_mask[:, None, :]
    return sum_mask[None, :, :] * pad_mask[:, None, :]
