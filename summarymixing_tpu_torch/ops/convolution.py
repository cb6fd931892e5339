"""Convolution blocks — the port of `depthwise_conv1d`,
`ConvolutionalSpatialGatingUnit`, `ConvolutionBranch`, `_dcconv_depthwise`,
`ConvolutionModule` and `ConvolutionFrontEnd` from
`summarymixing_tpu/ops/convolution.py`.

`ConvolutionBranch` runs the plain path on the CPU. On a CUDA tensor it
runs the fused cgMLP kernel (`ops/fused_csgu.py`) when `fused_csgu.takes`
the configuration (tanh-GELU, identity gate, no linear after the conv,
conv width 15 or 31, bf16, widths the kernel tiles), and otherwise the
same plain path as the CPU, counted in
`fused_convolution_branch.plain_calls`. The CSGU's dropout runs inside the
kernel, from a keep-mask the branch draws.

`ConvolutionModule` (the Conformer's) is plain PyTorch on every device, as
the JAX module is plain `jnp`: its depthwise conv is SAME, causal, or the
Dynamic Chunk Convolution, whose future taps are gated by `t % chunk`. Its
kernel is kept as `[C, 1, K]`, the layout of `torch.nn.functional.conv1d`
with C groups (the flax `[K, C]` is transposed by `utils.convert`).
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


def depthwise_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x `[B, T, C]`, kernel `[K, C]` -> `[B, T, C]`, SAME zero padding
    ((K-1)//2 frames before, the rest after); tap 0 reads frame t - (K-1)//2."""
    k = kernel.shape[0]
    left = (k - 1) // 2
    out = _depthwise(x, kernel.t()[:, None, :].to(x.dtype), left, k - 1 - left)
    return out if bias is None else out + bias.to(x.dtype)


def _depthwise(x: torch.Tensor, weight: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """x `[B, T, C]`, weight `[C, 1, K]` -> `[B, T + left + right - K + 1, C]`,
    zero padding of `left` frames before and `right` after."""
    xt = F.pad(x.transpose(1, 2), (left, right))
    return F.conv1d(xt, weight, None, groups=x.shape[-1]).transpose(1, 2)


def _dcconv_depthwise(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      chunk_size) -> torch.Tensor:
    """Dynamic Chunk Convolution: a depthwise conv (weight `[C, 1, K]`, K =
    2·pad + 1) whose taps past the end of each output frame's chunk are
    zero. The past and centre taps run as one left-padded conv; future tap o
    reads frame t + o where t % chunk < chunk - o."""
    pad = (weight.shape[-1] - 1) // 2
    t_len = x.shape[1]
    out = _depthwise(x, weight[:, :, :pad + 1], pad, 0) + bias
    pos_in_chunk = torch.arange(t_len, device=x.device) % chunk_size
    for o in range(1, pad + 1):
        shifted = F.pad(x, (0, 0, 0, o))[:, o:o + t_len]
        gate = (pos_in_chunk < chunk_size - o).to(x.dtype)[None, :, None]
        out = out + weight[:, 0, pad + o] * shifted * gate
    return out


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
            if fused_csgu.takes(d=x.shape[-1], units=self.pre_channel_proj.out_features,
                                kernel_size=self.csgu.conv_kernel.shape[0],
                                activation=self.activation, dtype=x.dtype,
                                gate_activation=self.csgu.gate_activation,
                                use_linear_after_conv=self.csgu.use_linear_after_conv):
                return self._fused(x, pad_mask)
            fused_csgu.count_plain_call()
        x = get_activation(self.activation)(self.pre_channel_proj(x))
        x = self.csgu(x, pad_mask=pad_mask)
        return self.post_channel_proj(x)

    def _fused(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor]) -> torch.Tensor:
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


class ConvolutionModule(nn.Module):
    """Conformer convolution module: LayerNorm (eps 1e-5) -> `bottleneck` to
    2C -> GLU -> zero the padded frames -> depthwise conv (SAME, causal, or
    DCConv given `chunk_size`) -> `after_norm` -> activation ->
    `pointwise_out` -> dropout -> times the pad mask."""

    def __init__(self, input_size: int, kernel_size: int = 31, activation: str = "swish",
                 dropout_rate: float = 0.0, causal: bool = False):
        super().__init__()
        c = input_size
        self.causal = causal
        self._act = get_activation(activation)
        self.layer_norm = LayerNorm(c, eps=1e-5)
        self.bottleneck = Dense(c, 2 * c)
        self.conv_kernel = nn.Parameter(torch.empty(c, 1, kernel_size))
        self.conv_bias = nn.Parameter(torch.empty(c))
        self.after_norm = LayerNorm(c, eps=1e-5)
        self.pointwise_out = Dense(c, c)
        self.dropout = Dropout(dropout_rate)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """He-normal taps (fan-in K, as flax's `he_normal` on `[K, C]`), zero bias."""
        with torch.no_grad():
            k = self.conv_kernel.shape[-1]
            self.conv_kernel.normal_(0.0, (2.0 / k) ** 0.5, generator=generator)
            self.conv_bias.zero_()

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                chunk_size=None) -> torch.Tensor:
        """x `[B, T, C]`; pad_mask `[B, T]` float, 1 = valid; `chunk_size`
        (frames) turns on the Dynamic Chunk Convolution."""
        a, b = self.bottleneck(self.layer_norm(x)).chunk(2, dim=-1)
        out = a * torch.sigmoid(b)
        if pad_mask is not None:
            out = out * pad_mask[..., None].to(out.dtype)
        weight, bias = self.conv_kernel.to(out.dtype), self.conv_bias.to(out.dtype)
        k = weight.shape[-1]
        if chunk_size is not None:
            if self.causal:
                raise ValueError("DCConv is incompatible with causal convolution")
            out = _dcconv_depthwise(out, weight, bias, chunk_size)
        elif self.causal:
            out = _depthwise(out, weight, k - 1, 0) + bias
        else:
            out = _depthwise(out, weight, (k - 1) // 2, k - 1 - (k - 1) // 2) + bias
        out = self.dropout(self.pointwise_out(self._act(self.after_norm(out))))
        if pad_mask is not None:
            out = out * pad_mask[..., None].to(out.dtype)
        return out


def _mask_start(x: torch.Tensor, offset, time_dim: int) -> torch.Tensor:
    """Zero the frames of `x` before global frame 0, frame 0 of `x` being
    global frame `offset` (an int or a `[B]` tensor, per row, may be
    negative); `time_dim` is 1 (NHWC) or 2 (NCHW)."""
    off = torch.as_tensor(offset, device=x.device).reshape(-1, 1)
    keep = (off + torch.arange(x.shape[time_dim], device=x.device)[None, :]) >= 0
    shape = [keep.shape[0], 1, 1, 1]
    shape[time_dim] = x.shape[time_dim]
    return x * keep.reshape(shape).to(x.dtype)


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

    def forward(self, x: torch.Tensor, input_frame_offset=None) -> torch.Tensor:
        """`input_frame_offset` (int or `[B]`, may be negative) marks x's
        frame 0 as global frame `input_frame_offset` of a longer stream:
        frames before global frame 0 are zeroed at the input and after
        every block, which reproduces the offline stack's zero padding at
        the stream start (the chunked streaming frontend, `streaming.py`).
        It must be divisible by the product of the strides."""
        x = x.to(self.conv_0.compute_dtype or self.conv_0.weight.dtype)[:, None]  # [B, 1, T, F]
        offset = input_frame_offset
        if offset is not None:
            x = _mask_start(x, offset, time_dim=2)
        for i in range(self.num_blocks):
            x = getattr(self, f"conv_{i}")(x)
            x = getattr(self, f"norm_{i}")(x.permute(0, 2, 3, 1))  # NHWC
            x = self.dropout(F.leaky_relu(x, 0.01))
            if offset is not None:
                offset = offset // self.strides[i]
                x = _mask_start(x, offset, time_dim=1)
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
