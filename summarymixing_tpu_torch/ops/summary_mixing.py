"""The SummaryMixing cell — the port of `summarymixing_tpu/ops/summary_mixing.py`
in its four modes (`MODES`).

Full mode: on the CPU the cell runs the plain PyTorch path that mirrors
the flax module. On a CUDA tensor it runs the fused kernel
(`ops/fused_summary.py`) when `fused_summary.takes` the configuration (no
`sum_mask`, nhead 1, one hidden layer per branch, erf or tanh GELU, bf16,
widths the kernel tiles), and otherwise the same plain path as the CPU,
as the flax module computes every configuration; such a call is counted
in `fused_summary_mixing.plain_calls`. The decision is made from the
configuration before any launch, the same in training and evaluation: a
configuration the kernel takes runs the kernel or raises. The dropout on
the concatenated `[local, pooled]` features runs inside the kernel there,
from a keep-mask the cell draws.

Fast mode (the streaming Conformer transducer's): one `global_proj`
`SummaryNet((2·local_proj_out_dim,))` with no head split, pad-masked and
split into local and summary halves; the summary half pooled by the masked
time mean, or by `summary_matmul` given a `sum_mask`; then the merge.

Lite mode: only `summary_proj`; the cell's output is the pad-masked time
mean of s(x) broadcast over T, with no local branch, no merge and no
dropout. It has no per-step weighting, so it refuses a `sum_mask`
(`ValueError`, as the flax module does) rather than train non-causally.

Exp-decay mode: the full mode's modules, with the summary pooled by
`summary_matmul` under the Laplacian weights `laplace_weights(T,
decay_constant)` (0.995, not trained). Without a `sum_mask` the weights'
padded columns are zeroed, `[B, T, T]`, so each row is normalised by its
valid decay mass (the JAX module's deliberate fix of the reference's
padding bias); with one, the weights are multiplied by it.

The kernel computes full mode only, as the Pallas kernel does, so on the
card fast, lite and expdecay cells run this PyTorch code, each call
counted as a plain call.

In a time-sharded encode (`parallel/sequence.py`) the masked time mean
sums its numerator and count over the shards, and a full-mode cell the
kernel takes runs the kernel's split route (`sm_partial`, the all-reduce
of the `[B, OS]` sums and `[B]` counts, `sm_finish`); inference only. A
`sum_mask` and expdecay's `[T, T]` weights couple every pair of frames
and are refused there.

Incremental causal decoding (the Summary Decoder's self-attention):
`decode_init` and `decode_step` carry the running `(sum, denom)` pair of
the causal summary in float32, decayed by `decay_constant` per step in
expdecay mode, so one decoding position costs O(1) where the
whole-prefix forward with a lookahead `sum_mask` costs O(t); the step
equals that forward at its newest position (lite: the running mean, with
no merge).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from summarymixing_tpu_torch.ops import _build, fused_summary, time_shard
from summarymixing_tpu_torch.ops.layers import Dropout
from summarymixing_tpu_torch.ops.linear import SummaryNet

MODES = (
    "SummaryMixing",
    "SummaryMixing-lite",
    "SummaryMixing-expdecay",
    "SummaryMixing-fast",
)
_FULL = ("SummaryMixing", "SummaryMixing-expdecay")


def uses_kernel(x: torch.Tensor) -> bool:
    """Whether a module takes its kernel route for `x`: on the card. The
    route then launches the kernel for a configuration it takes and runs
    the plain path, counted, for any other."""
    return x.device.type == "cuda"


def laplace_weights(size: int, decay_constant: float, device=None) -> torch.Tensor:
    """`[size, size]` float32, w[i, j] = decay_constant ** |i - j|, as
    exp(|i - j| · log(decay_constant)) in float32 (the logarithm taken in
    float32 on the host, so no scalar is copied to the card): not
    normalised (the masked product normalises its rows)."""
    idx = torch.arange(size, device=device)
    dist = (idx[None, :] - idx[:, None]).abs().to(torch.float32)
    return torch.exp(dist * float(np.log(np.float32(decay_constant))))


def masked_time_mean(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """Mean over time counting only valid steps, accumulated in float32.
    x `[B, T, F]`; pad_mask `[B, T, 1]`. Returns `[B, 1, F]`. Like the JAX
    module, the divisor is not clamped: an all-padding row gives NaN. In a
    time-sharded encode both sums run over every shard."""
    num = (x * pad_mask).to(torch.float32).sum(dim=1, keepdim=True)
    den = pad_mask.to(torch.float32).sum(dim=1, keepdim=True)
    shard = time_shard.current()
    if shard is not None:
        num, den = shard.sum_(num, den)
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
    """SummaryMixing in one of `MODES`: ``cell(x, sum_mask=None,
    pad_mask=None)`` with x `[B, T, enc_dim]`; returns `[B, T,
    summary_out_dim]`. `decay_constant` is expdecay's, an attribute and
    not a parameter."""

    def __init__(self, enc_dim: int, nhead: int = 1,
                 local_proj_hid_dim: Sequence[int] = (512,), local_proj_out_dim: int = 512,
                 summary_hid_dim: Sequence[int] = (512,), summary_out_dim: int = 512,
                 activation: str = "gelu_exact", mode: str = "SummaryMixing",
                 dropout_rate: float = 0.0, decay_constant: float = 0.995):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.nhead = nhead
        self.activation = activation
        self.decay_constant = decay_constant
        summary_dims = tuple(summary_hid_dim) + (summary_out_dim,)
        if mode == "SummaryMixing-fast":
            # one projection to [local | summary], no head split (the JAX
            # module's global_proj, whatever nhead says)
            self.global_proj = SummaryNet(enc_dim, (2 * local_proj_out_dim,), 1, activation)
            merged = 2 * local_proj_out_dim
        elif mode in _FULL:
            self.local_proj = SummaryNet(
                enc_dim, tuple(local_proj_hid_dim) + (local_proj_out_dim,), nhead, activation)
            self.summary_proj = SummaryNet(enc_dim, summary_dims, nhead, activation)
            merged = local_proj_out_dim + summary_out_dim
        else:   # lite: the summary branch alone
            self.summary_proj = SummaryNet(enc_dim, summary_dims, nhead, activation)
        if mode != "SummaryMixing-lite":
            self.summary_local_merging = SummaryNet(merged, (summary_out_dim,), 1, activation)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, sum_mask: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sum_mask `[T, T]` or `[B, T, T]`, 1 = include; pad_mask `[B, T]` or
        `[B, T, 1]` float, 1 = valid."""
        lite = self.mode == "SummaryMixing-lite"
        if lite and sum_mask is not None:
            # the lite summary is one global masked mean: there is no
            # per-step weighting to restrict, so accepting a causal or
            # chunked mask would train non-causally
            raise ValueError("SummaryMixing-lite has no sum_mask path; use the full or fast "
                             "mode for causal / limited-context mixing")
        shard = time_shard.current()
        if shard is not None and (sum_mask is not None or self.mode == "SummaryMixing-expdecay"):
            raise NotImplementedError("a time-sharded cell pools by the masked mean: no "
                                      "sum_mask, not expdecay")
        if pad_mask is None:
            pad_mask = torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
        elif pad_mask.dim() == 2:
            pad_mask = pad_mask[..., None]
        if uses_kernel(x):
            if fused_summary.takes(**self._kernel_config(x, sum_mask)):
                if shard is not None:
                    return self._fused_split(x, pad_mask, shard)
                return self._fused(x, pad_mask)
            fused_summary.count_plain_call()
        pad_mask = pad_mask.to(x.dtype)
        if lite:
            summary = self.summary_proj(x) * pad_mask
            return masked_time_mean(summary, pad_mask).expand_as(summary)
        if self.mode == "SummaryMixing-fast":
            local, summary = (self.global_proj(x) * pad_mask).chunk(2, dim=-1)
        else:
            local = self.local_proj(x) * pad_mask
            summary = self.summary_proj(x) * pad_mask
        if self.mode == "SummaryMixing-expdecay":
            decay = laplace_weights(x.shape[1], self.decay_constant, x.device)
            # without a sum_mask, the padded columns are zeroed so that each
            # row is normalised by its valid decay mass
            sum_mask = (decay[None] * pad_mask[:, :, 0][:, None, :] if sum_mask is None
                        else decay * sum_mask.to(torch.float32))
        if sum_mask is None:
            pooled = masked_time_mean(summary, pad_mask).expand_as(summary)
        else:
            pooled = summary_matmul(sum_mask, summary)
        return self.summary_local_merging(self.dropout(torch.cat([local, pooled], dim=-1)))

    # -- incremental causal decoding ----------------------------------------
    def decode_init(self, batch: int, device=None) -> dict:
        """The carry of `decode_step`: `sum` `[batch, width]` and `denom`
        `[batch, 1]`, float32 zeros; the width is the summary half's
        (`local_proj_out_dim` in the fast mode, `summary_out_dim` in the
        others)."""
        width = (self.global_proj.features[-1] // 2 if self.mode == "SummaryMixing-fast"
                 else self.summary_proj.features[-1])
        return {"sum": torch.zeros(batch, width, dtype=torch.float32, device=device),
                "denom": torch.zeros(batch, 1, dtype=torch.float32, device=device)}

    def decode_step(self, x_t: torch.Tensor, cache: dict):
        """One causal position: x_t `[B, F]` -> (`[B, summary_out_dim]`, carry).
        Decays the carry by w (`decay_constant` in expdecay mode, else 1),
        adds s(x_t) and 1, and merges f(x_t) with sum / denom: the
        lookahead-`sum_mask` forward evaluated at its newest position. Lite
        returns sum / denom, the running mean, with no merge. No dropout
        (decoding)."""
        x = x_t[:, None, :]
        local = None
        if self.mode == "SummaryMixing-fast":
            local, s = self.global_proj(x)[:, 0].chunk(2, dim=-1)
        elif self.mode in _FULL:
            local, s = self.local_proj(x)[:, 0], self.summary_proj(x)[:, 0]
        else:
            s = self.summary_proj(x)[:, 0]
        w = self.decay_constant if self.mode == "SummaryMixing-expdecay" else 1.0
        new_sum = cache["sum"] * w + s.to(cache["sum"].dtype)
        new_denom = cache["denom"] * w + 1.0
        pooled = (new_sum / new_denom).to(s.dtype)
        if local is None:
            return pooled, {"sum": new_sum, "denom": new_denom}
        out = self.summary_local_merging(torch.cat([local, pooled], dim=-1)[:, None])[:, 0]
        return out, {"sum": new_sum, "denom": new_denom}

    def _kernel_config(self, x: torch.Tensor, sum_mask) -> dict:
        """This call's configuration in `fused_summary.refusal`'s keywords
        (the fast and lite modes have no branches of the full mode's: the
        mode refuses them before the widths are read). The
        dropout keep-mask is not part of it: whether training or not, a
        configuration the kernel takes launches it, and the launch raises
        for a keep-mask wider than the kernel holds."""
        full = self.mode == "SummaryMixing"
        return dict(mode=self.mode, sum_mask=sum_mask is not None, nhead=self.nhead,
                    d=x.shape[-1], local_dims=self.local_proj.features if full else (),
                    summary_dims=self.summary_proj.features if full else (),
                    n=self.summary_local_merging.features[-1] if full else 0,
                    activation=self.activation,
                    dtype=x.dtype)

    def _launch_weights(self):
        return _build.cached_weights(self, lambda m: tuple(
            w.detach() for w in fused_summary.kernel_weights(fused_summary.params_to_weights(m))))

    def _fused_split(self, x, pad_mask, shard):
        """The kernel's split route on this shard's frames: partial sums and
        counts, their sum over the shards, then the finish."""
        if self.dropout.training and self.dropout.rate > 0.0:
            raise ValueError("the split route serves inference: no dropout keep-mask")
        pad = pad_mask.to(torch.float32).contiguous()
        weights, launch = fused_summary.params_to_weights(self), self._launch_weights()
        total, count, pre = fused_summary.fused_summary_partial(
            x.contiguous(), pad, weights, self.activation, launch_weights=launch)
        total, count = shard.sum_(total, count)
        return fused_summary.fused_summary_finish(pre, pad, total, count, weights,
                                                  self.activation, x.dtype,
                                                  launch_weights=launch)

    def _fused(self, x, pad_mask):
        pad = pad_mask.to(torch.float32).contiguous()
        b, t, _ = x.shape
        keep = self.dropout.keep_mask(
            (b, t, self.local_proj.features[-1] + self.summary_proj.features[-1]), x.device)
        launch = self._launch_weights()
        return fused_summary.fused_summary_mixing(
            x.contiguous(), pad, fused_summary.params_to_weights(self), self.activation,
            keep, 1.0 - self.dropout.rate, launch_weights=launch)
