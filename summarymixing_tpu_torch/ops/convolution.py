"""Convolution blocks — the port of `depthwise_conv1d`,
`ConvolutionalSpatialGatingUnit`, `ConvolutionBranch` and
`ConvolutionFrontEnd` from `summarymixing_tpu/ops/convolution.py`.

`ConvolutionBranch` runs the plain path on the CPU and the fused cgMLP
kernel (`ops/fused_csgu.py`) on a CUDA tensor; on the card it takes the
recipe configuration (tanh-GELU, identity gate, no linear after the conv)
and raises `NotImplementedError` for any other. The CSGU's dropout runs
inside the kernel there, from a keep-mask the branch draws.
`ConvolutionModule` and its Dynamic Chunk Convolution are still to port
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from summarymixing_tpu_torch.ops import _build, fused_csgu
from summarymixing_tpu_torch.ops.layers import Conv2d, Dense, Dropout, LayerNorm
from summarymixing_tpu_torch.ops.linear import get_activation
from summarymixing_tpu_torch.ops.summary_mixing import uses_kernel

_TODO = "see ROADMAP.md, 'Modules still to port'"


def depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x `[B, T, C]`, kernel `[K, C]` -> `[B, T, C]`, SAME zero padding
    ((K-1)//2 frames before, the rest after); tap 0 reads frame t - (K-1)//2."""
    k, c = kernel.shape
    left = (k - 1) // 2
    xt = F.pad(x.transpose(1, 2), (left, k - 1 - left))
    out = F.conv1d(xt, kernel.t()[:, None, :].to(x.dtype), None, groups=c).transpose(1, 2)
    return out if bias is None else out + bias.to(x.dtype)


class ConvolutionalSpatialGatingUnit(nn.Module):
    """Split channels in half; the gate half goes LayerNorm -> pad mask ->
    depthwise conv (-> optional linear) -> gate activation; the output is
    the residual half times the gate, then dropout."""

    def __init__(self, input_size: int, kernel_size: int = 31,
                 use_linear_after_conv: bool = False, gate_activation: Optional[str] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        half = input_size // 2
        self.gate_activation = gate_activation
        self.use_linear_after_conv = use_linear_after_conv
        self.norm = LayerNorm(half, eps=1e-5)
        self.conv_kernel = nn.Parameter(torch.empty(kernel_size, half))
        self.conv_bias = nn.Parameter(torch.empty(half))
        if use_linear_after_conv:
            self.linear_after_conv = Dense(half, half)
        self.dropout = Dropout(dropout_rate)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.conv_kernel.normal_(0.0, 1e-3, generator=generator)
            self.conv_bias.fill_(1.0)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_res, x_gate = x.chunk(2, dim=-1)
        x_gate = self.norm(x_gate)
        if pad_mask is not None:
            x_gate = x_gate * pad_mask[..., None].to(x_gate.dtype)
        x_gate = depthwise_conv1d(x_gate, self.conv_kernel, self.conv_bias)
        if self.use_linear_after_conv:
            x_gate = self.linear_after_conv(x_gate)
        if self.gate_activation is not None:
            x_gate = get_activation(self.gate_activation)(x_gate)
        return self.dropout(x_res * x_gate)


class ConvolutionBranch(nn.Module):
    """Branchformer cgMLP branch: Linear(d -> units) -> activation -> CSGU ->
    Linear(units/2 -> d)."""

    def __init__(self, input_size: int, linear_units: int = 3072, kernel_size: int = 31,
                 activation: str = "gelu_exact", gate_activation: Optional[str] = None,
                 use_linear_after_conv: bool = False, dropout_rate: float = 0.0):
        super().__init__()
        self.activation = activation
        self.pre_channel_proj = Dense(input_size, linear_units)
        self.csgu = ConvolutionalSpatialGatingUnit(
            linear_units, kernel_size, use_linear_after_conv, gate_activation, dropout_rate)
        self.post_channel_proj = Dense(linear_units // 2, input_size)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if uses_kernel(x):
            if (self.activation != "gelu" or self.csgu.gate_activation is not None
                    or self.csgu.use_linear_after_conv):
                raise NotImplementedError(
                    "on CUDA only the fused cgMLP branch is ported: tanh-GELU, identity "
                    f"gate, no linear after the conv; {_TODO}")
            if pad_mask is not None:
                pad_mask = pad_mask.to(torch.float32).contiguous()
            b, t, _ = x.shape
            drop = self.csgu.dropout
            keep = drop.keep_mask((b, t, self.csgu.conv_bias.shape[0]), x.device)
            launch = _build.cached_weights(self, lambda m: tuple(
                w.detach() for w in fused_csgu.kernel_weights(fused_csgu.branch_weights(m))))
            return fused_csgu.fused_convolution_branch(
                x.contiguous(), pad_mask, fused_csgu.branch_weights(self), self.csgu.norm.eps,
                keep, 1.0 - drop.rate, launch_weights=launch)
        x = get_activation(self.activation)(self.pre_channel_proj(x))
        x = self.csgu(x, pad_mask=pad_mask)
        return self.post_channel_proj(x)


class ConvolutionFrontEnd(nn.Module):
    """2-D convolutional subsampling over `[B, T, F]` features: blocks of
    (Conv2d stride s×s, symmetric k//2 padding -> LayerNorm over channels ->
    leaky-ReLU 0.01 -> dropout), then (freq, channel) flattened in NHWC
    order to `[B, T', F'·C]`."""

    def __init__(self, out_channels: Sequence[int] = (64, 32),
                 kernel_sizes: Sequence[int] = (3, 3), strides: Sequence[int] = (2, 2),
                 dropout_rate: float = 0.0):
        super().__init__()
        self.strides = tuple(strides)
        in_ch = 1
        for i, (ch, k, s) in enumerate(zip(out_channels, kernel_sizes, strides)):
            self.add_module(f"conv_{i}", Conv2d(in_ch, ch, k, stride=s, padding=k // 2))
            self.add_module(f"norm_{i}", LayerNorm(ch, eps=1e-5))
            in_ch = ch
        self.num_blocks = len(self.strides)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.conv_0.compute_dtype or self.conv_0.weight.dtype)[:, None]  # [B, 1, T, F]
        for i in range(self.num_blocks):
            x = getattr(self, f"conv_{i}")(x)
            x = getattr(self, f"norm_{i}")(x.permute(0, 2, 3, 1))  # NHWC
            x = self.dropout(F.leaky_relu(x, 0.01))
            if i + 1 < self.num_blocks:
                x = x.permute(0, 3, 1, 2)
        b, t, f, c = x.shape
        return x.reshape(b, t, f * c)

    @staticmethod
    def subsampled_length(lengths: torch.Tensor, strides: Sequence[int] = (2, 2)) -> torch.Tensor:
        """Output lengths of the padded stride-s convs: ceil(len / s) each."""
        out = lengths
        for s in strides:
            out = -(-out // s)
        return out
