"""Sequence KL-divergence with label smoothing and the masked NLL — the port
of `summarymixing_tpu/losses/kldiv.py::kldiv_loss` and `nll_loss`."""

from __future__ import annotations

from typing import Optional

import torch

from summarymixing_tpu_torch.ops.masks import length_to_mask


def kldiv_loss(log_probs: torch.Tensor, targets: torch.Tensor,
               target_lengths: Optional[torch.Tensor] = None, label_smoothing: float = 0.0,
               pad_idx: Optional[int] = None, reduction: str = "batchmean") -> torch.Tensor:
    """KL(label-smoothed one-hot || model). log_probs `[B, U, V]`, targets
    `[B, U]` int. With smoothing eps the true class gets 1 - eps and the
    rest share eps uniformly (excluding pad_idx if given)."""
    b, u, v = log_probs.shape
    if target_lengths is None:
        mask = torch.ones(b, u, dtype=log_probs.dtype, device=log_probs.device)
    else:
        mask = length_to_mask(target_lengths, u, log_probs.dtype)
    if pad_idx is not None:
        mask = mask * (targets != pad_idx).to(log_probs.dtype)
    tgt_lp = torch.gather(log_probs, -1, targets[..., None].to(torch.long))[..., 0]
    if label_smoothing > 0.0:
        smooth_mass = label_smoothing / (v - (2 if pad_idx is not None else 1))
        sum_lp = log_probs.sum(dim=-1)
        if pad_idx is not None:
            sum_lp = sum_lp - log_probs[..., pad_idx]
        nll = -((1.0 - label_smoothing) * tgt_lp + smooth_mass * (sum_lp - tgt_lp))
    else:
        nll = -tgt_lp
    nll = nll * mask
    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        return nll.sum() / mask.sum().clamp_min(1.0)
    if reduction == "batchmean":
        return (nll.sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             target_lengths: Optional[torch.Tensor] = None, pad_idx: Optional[int] = None,
             reduction: str = "batchmean") -> torch.Tensor:
    """Masked negative log-likelihood: `kldiv_loss` without smoothing."""
    return kldiv_loss(log_probs, targets, target_lengths, label_smoothing=0.0, pad_idx=pad_idx,
                      reduction=reduction)
