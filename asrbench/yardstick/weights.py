"""Weights and frozen normalisation statistics made from the seed on the
device: one normal draw for every parameter at once, scaled per leaf.

- every parameter of 2 or more dimensions (matrices, convolution and LSTM
  kernels), whatever its name: std 1/sqrt(fan in), the product of all its
  dimensions after the first (`[out, in, ...]`);
- named exceptions: the token embedding, std 1/sqrt(d), so that
  sqrt(d)-scaled rows are unit; the cgMLP's depthwise kernel `[K, C]`, fan in
  K; RelPosMHAXL's relative-position biases `pos_bias_u`, `pos_bias_v`
  `[H, d/H]`, 0.05·N, as a bias;
- LayerNorm scales (1-D `.weight`): 1 + 0.1·N; the cgMLP gate's conv bias:
  1 + 0.1·N;
- every other bias: 0.05·N.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def _scale_shift(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if name.endswith("emb.weight"):
        return 1.0 / math.sqrt(shape[1]), 0.0
    if name.endswith("csgu.conv_kernel"):
        return 1.0 / math.sqrt(shape[0]), 0.0
    if name.endswith("csgu.conv_bias"):
        return 0.1, 1.0
    if name.endswith(("pos_bias_u", "pos_bias_v")):
        return 0.05, 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(int(np.prod(shape[1:]))), 0.0
    if name.endswith(".weight"):
        return 0.1, 1.0
    return 0.05, 0.0


def make_weights(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    sizes = [int(np.prod(s)) for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.tensor([_scale_shift(n, s)[0] for n, s in shapes], device=device)
    shift = torch.tensor([_scale_shift(n, s)[1] for n, s in shapes], device=device)
    counts = torch.tensor(sizes, device=device)
    flat = torch.addcmul(torch.repeat_interleave(shift, counts), flat,
                         torch.repeat_interleave(scale, counts))
    out, off = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def make_norm_stats(n_mels: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """Frozen statistics of a trained recognizer's input normalisation:
    means about 30 dB apart by band, spreads about 10 dB."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(2, n_mels, generator=gen, device=device)
    count = torch.tensor(1.0e7, device=device)
    std = 8.0 + 4.0 * u[1]
    return {"count": count, "mean": 20.0 + 30.0 * u[0], "m2": std * std * (count - 1.0)}
