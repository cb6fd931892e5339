"""Layers with flax's `dtype`/`param_dtype` semantics, and dropout drawn
from an explicit generator.

The JAX package keeps its parameters in float32 and computes in the
module's `dtype` (bfloat16 for `precision: bf16`). These subclasses of the
torch layers do the same: their parameters stay float32, and when
`compute_dtype` is set they cast at use, rounding where flax rounds:

- `Dense`: input, weight and bias cast; the product is rounded to the
  compute dtype, then the bias is added in it (flax `Dense`);
- `LayerNorm`: statistics and normalisation in float32 with float32 scale
  and bias, one rounding of the output (flax `LayerNorm`);
- `Conv1d`, `Conv2d`: input and kernel cast, the bias added after the
  convolution.

`set_compute_dtype(model, dtype)` sets it on every such layer. With no
compute dtype they are the plain torch layers. Without autograd (decoding)
the cast weights are cached per parameter version, so a weight is cast
once and not on every call.

`Dropout` draws its keep-mask from the generator `set_dropout_generator`
gave it (the trainer owns it), as flax's `Dropout` draws from the
`dropout` rng: keep with probability 1 - rate, kept values divided by
1 - rate in the input's dtype. `model.train()` and `model.eval()` switch
it on and off, as flax's `deterministic` does.

`remat_call(layer, *args)` runs a layer under `torch.utils.checkpoint`
(the JAX encoders' `nn.remat`): its activations are recomputed in the
backward pass. `checkpoint` restores only torch's global RNG for the
recompute, not the trainer's generator, so `remat_call` rewinds the
generators of the layer's `Dropout`s to their state at the forward for
the recompute, and puts them back after it: the recompute draws the
forward's keep-masks, and the draws after it are those without remat.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from summarymixing_tpu_torch.ops import _build


def cast_params(module: nn.Module, dtype: torch.dtype, names: Sequence[str]) -> tuple:
    """The named parameters of `module` cast to `dtype`: through autograd
    when it records, else cached until a parameter changes."""
    params = [getattr(module, n) for n in names]
    if torch.is_grad_enabled() and any(p is not None and p.requires_grad for p in params):
        return tuple(None if p is None else p.to(dtype) for p in params)
    return _build.cached_weights(module, lambda m: tuple(
        None if p is None else p.detach().to(dtype) for p in params))


class Dense(nn.Linear):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return F.linear(x, self.weight, self.bias)
        w, b = cast_params(self, cd, ("weight", "bias"))
        y = torch.matmul(x.to(cd), w.t())
        return y if b is None else y + b


class LayerNorm(nn.LayerNorm):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        return F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(cd)


class Conv1d(nn.Conv1d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        w, b = cast_params(self, cd, ("weight", "bias"))
        y = F.conv1d(x.to(cd), w, None, self.stride, self.padding)
        return y + b[:, None]


class Conv2d(nn.Conv2d):
    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd is None:
            return super().forward(x)
        w, b = cast_params(self, cd, ("weight", "bias"))
        y = F.conv2d(x.to(cd), w, None, self.stride, self.padding)
        return y + b[:, None, None]


def set_compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Set the compute dtype of every layer of `model` that has one."""
    for mod in model.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = dtype
    return model


class Dropout(nn.Module):
    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def keep_mask(self, shape, device) -> Optional[torch.Tensor]:
        """A bool keep-mask of `shape` (True = keep) in training with a
        positive rate, else None."""
        if not self.training or self.rate == 0.0:
            return None
        return torch.rand(shape, generator=self.generator, device=device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        keep = self.keep_mask(x.shape, x.device)
        return x if keep is None else apply_keep(x, keep, 1.0 - self.rate)


def apply_keep(x: torch.Tensor, keep: torch.Tensor, keep_prob: float) -> torch.Tensor:
    """Inverted dropout with a given keep-mask: x / keep_prob where kept, 0
    elsewhere, in x's dtype (flax's `select(keep, x / keep_prob, 0)`)."""
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def remat_call(layer: nn.Module, *args):
    """`layer(*args)`, its activations recomputed in the backward pass when
    autograd records it; the recompute draws the forward's dropout masks."""
    if not torch.is_grad_enabled():
        return layer(*args)
    gens = list({id(m.generator): m.generator for m in layer.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    at_forward = [g.get_state() for g in gens]
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return layer(*a)
        after = [g.get_state() for g in gens]
        for g, st in zip(gens, at_forward):
            g.set_state(st)
        try:
            return layer(*a)
        finally:
            for g, st in zip(gens, after):
                g.set_state(st)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    """Make every `Dropout` of `model` draw from `generator`."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator
    return model
