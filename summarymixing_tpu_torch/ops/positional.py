"""Absolute sinusoidal positional encoding — the port of the `sinusoid_table`
and `positional_encoding` functions of `summarymixing_tpu/ops/positional.py`,
and `positional_row`, the table's row at one position (the JAX package
slices that row out of a `max_length` table in its cached decode steps).
"""

from __future__ import annotations

import math

import torch


def sinusoid_table(length: int, dim: int, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """`[length, dim]`: PE(pos, 2i) = sin(pos / 10000^(2i/d)), PE(pos, 2i+1) = cos."""
    return _sinusoids(torch.arange(length, dtype=torch.float32, device=device)[:, None], dim,
                      dtype)


def positional_row(pos: int, dim: int, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """`[dim]`: row `pos` of `sinusoid_table`, the same arithmetic."""
    return _sinusoids(torch.full((1, 1), float(pos), dtype=torch.float32, device=device), dim,
                      dtype)[0]


def _sinusoids(pos: torch.Tensor, dim: int, dtype: torch.dtype) -> torch.Tensor:
    if dim % 2:
        raise ValueError(f"sinusoidal encoding needs even dim, got {dim}")
    device, length = pos.device, pos.shape[0]
    inv_freq = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                         * -(math.log(10000.0) / dim))
    angles = pos * inv_freq[None, :]
    pe = torch.zeros(length, dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe.to(dtype)


def positional_encoding(length: int, dim: int, dtype: torch.dtype = torch.float32,
                        device=None) -> torch.Tensor:
    """`[1, length, dim]` table to add to the inputs."""
    return sinusoid_table(length, dim, dtype, device)[None]
