"""Seeded random initialisation of a port model, and the xavier-normal
overwrite the JAX trainer applies before training from scratch.

Each leaf is drawn from the distribution its flax counterpart draws from:
`nn.Dense` and `nn.Conv` kernels from `lecun_normal` (a normal of
variance 1/fan_in truncated at two standard deviations, rescaled to keep
that variance) with zero biases; `nn.Embed` from a normal of std
1/sqrt(features); LayerNorms at (1, 0). The SummaryMixing MLPs' plain
layers (`ops.linear.FanInDense`), `ParallelLinear`, the LSTM cells and
the convolution modules draw through their own `reset_parameters`."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from summarymixing_tpu_torch.ops.linear import FanInDense

# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# `variance_scaling(..., "truncated_normal")` divides by it
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's `lecun_normal` in place: normal(0, sqrt(1/fan_in) / 0.8796)
    truncated at two of its standard deviations, so the variance is
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from `generator`: Linear and Conv weights
    `lecun_normal_` (fan-in: the weight's size over its output axis) with
    zero biases, LayerNorms at (1, 0), embeddings normal with std
    1/sqrt(width), and `FanInDense` and the port's own modules through
    their `reset_parameters(generator)`."""
    for mod in model.modules():
        if isinstance(mod, FanInDense):
            mod.reset_parameters(generator)
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            lecun_normal_(mod.weight, mod.weight[0].numel(), generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.Embedding):
            with torch.no_grad():
                mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5, generator=generator)
        elif hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return model


def xavier_std(param: torch.Tensor) -> float:
    """std of `torch.nn.init.xavier_normal_` for `param`:
    sqrt(2 / (fan_in + fan_out)) with torch's fans (size(1)·rf and
    size(0)·rf, rf the product of the trailing sizes). The port keeps the
    flax tree's layouts except for transposed Linear weights, where the
    fans swap and the std does not change, so this is the std the JAX
    package's `utils/init.py::_torch_xavier_std` gives the same leaf."""
    fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(param)
    return math.sqrt(2.0 / (fan_in + fan_out))


def xavier_normal_overwrite(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every parameter of `module` with more than one dimension
    from normal(0, `xavier_std`), in the order of `named_parameters`; the
    rest keep their values. The JAX trainer does this to the `asr`
    subtree after `init` (the reference TransformerASR's `_init_params`)."""
    with torch.no_grad():
        for _, p in module.named_parameters():
            if p.dim() > 1:
                p.normal_(0.0, xavier_std(p), generator=generator)
    return module
