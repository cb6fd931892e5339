"""Seeded random initialisation of a port model."""

from __future__ import annotations

import torch
from torch import nn

from summarymixing_tpu_torch.ops.linear import uniform_fan_in_


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from `generator`: Linear and Conv2d weights
    uniform(±1/sqrt(fan_in)) with zero biases, LayerNorms at (1, 0), and
    the port's own modules through their `reset_parameters(generator)`."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            uniform_fan_in_(mod.weight, mod.weight[0].numel(), generator)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return model
