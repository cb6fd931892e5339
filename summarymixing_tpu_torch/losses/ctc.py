"""CTC loss — the port of `summarymixing_tpu/losses/ctc.py::ctc_loss`.

`torch.nn.functional.ctc_loss` computes the per-utterance negative log
likelihood (no Pallas kernel computes it in the JAX package, whose alpha
recursion is a `lax.scan`). Two points are made to match the JAX value:

- an impossible alignment (fewer frames than labels plus repeats): the
  JAX recursion clamps log P at -1e30 and so gives a finite loss of 1e30,
  where torch gives inf. Here such a row is set to 1e30 and gets no
  gradient (torch's `zero_infinity`); the JAX gradient through the clamped
  recursion is some bounded value of no meaning;
- the reductions, `batchmean` dividing each utterance by its label length
  (at least 1) before the batch mean, as torch's `mean` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMPOSSIBLE = 1e30   # -log P of an impossible alignment in the JAX package


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor, blank_id: int = 0,
             reduction: str = "batchmean") -> torch.Tensor:
    """log_probs `[B, T, V]` (log-softmax over V); targets `[B, U]` int
    labels padded with anything; lengths absolute."""
    b, u = targets.shape
    input_lengths = input_lengths.to(torch.long)
    target_lengths = target_lengths.to(torch.long)
    per_seq = F.ctc_loss(log_probs.to(torch.float32).transpose(0, 1), targets.to(torch.long),
                         input_lengths, target_lengths, blank=blank_id, reduction="none",
                         zero_infinity=True)
    # a path needs one frame per label plus one blank between repeated labels
    valid = torch.arange(u, device=targets.device)[None, :] < target_lengths[:, None]
    repeats = ((targets[:, 1:] == targets[:, :-1]) & valid[:, 1:]).sum(dim=1)
    impossible = input_lengths < target_lengths + repeats
    per_seq = torch.where(impossible, torch.full_like(per_seq, IMPOSSIBLE), per_seq)
    if reduction == "none":
        return per_seq
    if reduction == "sum":
        return per_seq.sum()
    if reduction == "mean":
        return per_seq.mean()
    if reduction == "batchmean":
        return (per_seq / target_lengths.clamp_min(1).to(per_seq.dtype)).mean()
    raise ValueError(f"unknown reduction {reduction!r}")
