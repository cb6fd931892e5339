"""Absolute sinusoidal positional encoding — the port of the `sinusoid_table`
and `positional_encoding` functions of `summarymixing_tpu/ops/positional.py`.
"""

from __future__ import annotations

import math

import torch


def sinusoid_table(length: int, dim: int, dtype: torch.dtype = torch.float32,
                   device=None) -> torch.Tensor:
    """`[length, dim]`: PE(pos, 2i) = sin(pos / 10000^(2i/d)), PE(pos, 2i+1) = cos."""
    if dim % 2:
        raise ValueError(f"sinusoidal encoding needs even dim, got {dim}")
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
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
