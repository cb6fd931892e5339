"""Split ("parallel") linear layers and the trailing-activation MLP used by
the SummaryMixing cell — the port of `summarymixing_tpu/ops/linear.py`.

- `ParallelLinear`: `n_split` independent maps over `n_split` slices of the
  feature axis. Parameters keep the flax names and layouts: `kernel`
  `[n_split, in/n_split, out/n_split]`, `bias` `[n_split, out/n_split]`.
- `SummaryNet`: an MLP whose activation follows EVERY layer, the last one
  included. With `n_split > 1` the head axis stays unflattened until the
  last layer. With `n_split == 1` the layers are `Dense` layers
  (`ops/layers.py`, a `torch.nn.Linear`) named `layer_{i}`, like the flax
  `Dense` layers they mirror.

Activations are named as in the recipes (`config/loader.py` of the JAX
package): "gelu" is the tanh approximation, "gelu_exact" the erf form,
"swish" SiLU (the Conformer's default). The recipes use the first two;
the other activations of the JAX loader are not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from summarymixing_tpu_torch.ops.layers import Dense


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"gelu": gelu_tanh, "gelu_exact": gelu_exact, "swish": F.silu}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; one of {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def uniform_fan_in_(t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]):
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


class FanInDense(Dense):
    """A `Dense` drawn as torch's `Linear` is: weight uniform(±1/sqrt(fan_in)),
    bias zero. The flax `SummaryNet` draws its plain layers so
    (`uniform_fan_in_init`, zero bias); other `Dense` layers draw
    `lecun_normal` (`utils.init.init_parameters`)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        uniform_fan_in_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class ParallelLinear(nn.Module):
    """Input `[B, T, F]` is viewed as `[B, T, n_split, F/n_split]` (a 4-D
    input reuses its head axis); head h is mapped by `kernel[h]`. With a
    `compute_dtype` it rounds as flax does (`ops/layers.py`)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, in_features: int, features: int, n_split: int = 1,
                 combine_out_dims: bool = True):
        super().__init__()
        if in_features % n_split or features % n_split:
            raise ValueError(
                f"in {in_features} / out {features} not divisible by n_split {n_split}")
        self.features = features
        self.n_split = n_split
        self.combine_out_dims = combine_out_dims
        split_in, split_out = in_features // n_split, features // n_split
        self.kernel = nn.Parameter(torch.empty(n_split, split_in, split_out))
        self.bias = nn.Parameter(torch.empty(n_split, split_out))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _, split_in, split_out = self.kernel.shape
        uniform_fan_in_(self.kernel, split_in * split_out, generator)
        uniform_fan_in_(self.bias, split_out, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            b, t, f = x.shape
            x = x.reshape(b, t, self.n_split, f // self.n_split)
        elif x.dim() != 4:
            raise ValueError(f"expected 3-D or 4-D input, got {x.dim()}-D")
        if x.shape[2] != self.n_split:
            raise ValueError(f"head axis {x.shape[2]} does not match n_split {self.n_split}")
        kernel, bias = self.kernel, self.bias
        if self.compute_dtype is not None:
            x, kernel, bias = (v.to(self.compute_dtype) for v in (x, kernel, bias))
        y = torch.einsum("btmf,mfh->btmh", x, kernel) + bias
        if self.combine_out_dims:
            y = y.reshape(y.shape[0], y.shape[1], self.features)
        return y


class SummaryNet(nn.Module):
    """MLP of (Parallel)Linear layers, each followed by the activation."""

    def __init__(self, in_features: int, features: Sequence[int], n_split: int = 1,
                 activation: str = "gelu_exact"):
        super().__init__()
        self.features = tuple(features)
        self.n_split = n_split
        self.activation = activation
        self._act = get_activation(activation)
        fan_in = in_features
        for i, feats in enumerate(self.features):
            if n_split > 1:
                layer = ParallelLinear(fan_in, feats, n_split,
                                       combine_out_dims=(i == len(self.features) - 1))
            else:
                layer = FanInDense(fan_in, feats)
            self.add_module(f"layer_{i}", layer)
            fan_in = feats

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(len(self.features))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers():
            x = self._act(layer(x))
        return x
