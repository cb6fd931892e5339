"""The SummaryMixing cell — the port of `summarymixing_tpu/ops/summary_mixing.py`,
full and fast modes.

Full mode: on the CPU the cell runs the plain PyTorch path that mirrors
the flax module. On a CUDA tensor it runs the fused kernel
(`ops/fused_summary.py`) when the configuration is the one the kernel
takes — no `sum_mask`, nhead 1, one hidden layer per branch, erf or tanh
GELU — and raises `NotImplementedError` otherwise: it never runs the plain
path on the card. The dropout on the concatenated `[local, pooled]`
features runs inside the kernel there, from a keep-mask the cell draws.

Fast mode (the streaming Conformer transducer's): one `global_proj`
`SummaryNet((2·local_proj_out_dim,))` with no head split, pad-masked and
split into local and summary halves; the summary half pooled by the masked
time mean, or by `summary_matmul` given a `sum_mask`; then the merge. The
JAX package has no TPU kernel for it, so it runs this PyTorch code on the
card too.

The lite and expdecay modes and `decode_step` are still to port
(ROADMAP.md, "Modules still to port").
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from summarymixing_tpu_torch.ops import _build, fused_summary
from summarymixing_tpu_torch.ops.layers import Dropout
from summarymixing_tpu_torch.ops.linear import SummaryNet

_TODO = "see ROADMAP.md, 'Modules still to port'"


def uses_kernel(x: torch.Tensor) -> bool:
    """Whether a module runs its fused kernel for `x`: on the card."""
    return x.device.type == "cuda"


def masked_time_mean(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """Mean over time counting only valid steps, accumulated in float32.
    x `[B, T, F]`; pad_mask `[B, T, 1]`. Returns `[B, 1, F]`. Like the JAX
    module, the divisor is not clamped: an all-padding row gives NaN."""
    num = (x * pad_mask).to(torch.float32).sum(dim=1, keepdim=True)
    den = pad_mask.to(torch.float32).sum(dim=1, keepdim=True)
    return (num / den).to(x.dtype)


def summary_matmul(sum_mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out[b, t] = Σ_s mask[t, s] x[b, s] / max(rowsum, 1). sum_mask `[T, T]`
    or `[B, T, T]` float (1 = include); x `[B, T, F]`."""
    f32 = torch.float32
    m = sum_mask.to(f32)
    if m.dim() == 2:
        weighted = torch.einsum("ts,bsf->btf", m, x.to(f32))
        rowsum = m.sum(dim=1)[None, :, None]
    else:
        weighted = torch.einsum("bts,bsf->btf", m, x.to(f32))
        rowsum = m.sum(dim=2)[:, :, None]
    return (weighted / rowsum.clamp_min(1.0)).to(x.dtype)


class SummaryMixing(nn.Module):
    """Full- or fast-mode SummaryMixing: ``cell(x, sum_mask=None,
    pad_mask=None)`` with x `[B, T, enc_dim]`; returns `[B, T,
    summary_out_dim]`."""

    def __init__(self, enc_dim: int, nhead: int = 1,
                 local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
                 summary_hid_dim: Sequence[int] = (512,), summary_out_dim: int = 512,
                 activation: str = "gelu_exact", mode: str = "SummaryMixing",
                 dropout_rate: float = 0.0):
        super().__init__()
        if mode not in ("SummaryMixing", "SummaryMixing-fast"):
            raise NotImplementedError(f"SummaryMixing mode {mode!r} is not ported; {_TODO}")
        self.mode = mode
        self.nhead = nhead
        self.activation = activation
        if mode == "SummaryMixing-fast":
            # one projection to [local | summary], no head split (the JAX
            # module's global_proj, whatever nhead says)
            self.global_proj = SummaryNet(enc_dim, (2 * local_proj_out_dim,), 1, activation)
            merged = 2 * local_proj_out_dim
        else:
            self.local_proj = SummaryNet(
                enc_dim, tuple(local_proj_hid_dim) + (local_proj_out_dim,), nhead, activation)
            self.summary_proj = SummaryNet(
                enc_dim, tuple(summary_hid_dim) + (summary_out_dim,), nhead, activation)
            merged = local_proj_out_dim + summary_out_dim
        self.summary_local_merging = SummaryNet(merged, (summary_out_dim,), 1, activation)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, sum_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sum_mask `[T, T]` or `[B, T, T]`, 1 = include; pad_mask `[B, T]` or
        `[B, T, 1]` float, 1 = valid."""
        if pad_mask is None:
            pad_mask = torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
        elif pad_mask.dim() == 2:
            pad_mask = pad_mask[..., None]
        if self.mode == "SummaryMixing" and uses_kernel(x):
            return self._fused(x, sum_mask, pad_mask)
        pad_mask = pad_mask.to(x.dtype)
        if self.mode == "SummaryMixing-fast":
            local, summary = (self.global_proj(x) * pad_mask).chunk(2, dim=-1)
        else:
            local = self.local_proj(x) * pad_mask
            summary = self.summary_proj(x) * pad_mask
        if sum_mask is None:
            pooled = masked_time_mean(summary, pad_mask).expand_as(summary)
        else:
            pooled = summary_matmul(sum_mask, summary)
        return self.summary_local_merging(self.dropout(torch.cat([local, pooled], dim=-1)))

    def _fused(self, x, sum_mask, pad_mask):
        if (sum_mask is not None or self.nhead != 1
                or len(self.local_proj.features) != 2 or len(self.summary_proj.features) != 2
                or self.activation not in fused_summary.KERNEL_ACTIVATIONS):
            raise NotImplementedError(
                "on CUDA only the fused cell is ported: full mode, no sum_mask, nhead 1, "
                f"one hidden layer per branch, GELU activation; {_TODO}")
        pad = pad_mask.to(torch.float32).contiguous()
        b, t, _ = x.shape
        keep = self.dropout.keep_mask(
            (b, t, self.local_proj.features[-1] + self.summary_proj.features[-1]), x.device)
        launch = _build.cached_weights(self, lambda m: tuple(
            w.detach() for w in fused_summary.kernel_weights(fused_summary.params_to_weights(m))))
        return fused_summary.fused_summary_mixing(
            x.contiguous(), pad, fused_summary.params_to_weights(self), self.activation,
            keep, 1.0 - self.dropout.rate, launch_weights=launch)
