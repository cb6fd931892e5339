"""Sinusoidal positional encodings — the port of `sinusoid_table`,
`positional_encoding` and `relpos_xl_table` from
`summarymixing_tpu/ops/positional.py`, with `positional_row`, the table's
rows at given positions (the JAX package gathers those rows from a
`max_length` table in its cached decode steps and its streaming encoder).
Every table is computed in float32 (sin in the even columns, cos in the
odd), then cast.
"""

from __future__ import annotations

import math

import torch


def sinusoid_table(length: int, dim: int, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """`[length, dim]`: PE(pos, 2i) = sin(pos / 10000^(2i/d)), PE(pos, 2i+1) = cos."""
    return _sinusoids(torch.arange(length, dtype=torch.float32, device=device)[:, None], dim,
                      dtype)


def positional_row(pos, dim: int, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """`[*shape(pos), dim]`: the rows of `sinusoid_table` at the integer
    position(s) `pos` (an int or a tensor), the same arithmetic."""
    pos = torch.as_tensor(pos, device=device)
    rows = _sinusoids(pos.reshape(-1, 1).to(torch.float32), dim, dtype)
    return rows.reshape(*pos.shape, dim)


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


def relpos_xl_table(length: int, dim: int, dtype: torch.dtype = torch.float32,
                    device=None) -> torch.Tensor:
    """`[1, 2·length - 1, dim]`: the encodings of the relative positions
    length-1, ..., 1, 0, -1, ..., -(length-1) (query index minus key
    index), from the most-past key to the most-future, as `RelPosMHAXL`'s
    rel-shift reads them."""
    pos = torch.arange(length - 1, -length, -1, dtype=torch.float32, device=device)
    return _sinusoids(pos[:, None], dim, dtype)[None]
