"""CTC loss — the port of `summarymixing_tpu/losses/ctc.py::ctc_loss` and
`ctc_forward_logprob`.

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

`ctc_forward_logprob` is the JAX recursion itself in plain PyTorch: log
P(targets | log_probs) per utterance by the alpha recursion over the
S = 2U + 1 states of the blank-extended labels, in log space, with the
JAX floor of -1e30 (an impossible alignment gives -1e30, not -inf).
`ctc_loss` keeps `F.ctc_loss`; the two agree (by test).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMPOSSIBLE = 1e30   # -log P of an impossible alignment in the JAX package
_NEG = -1e30


def ctc_forward_logprob(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                        targets: torch.Tensor, target_lengths: torch.Tensor,
                        blank_id: int = 0) -> torch.Tensor:
    """log P(targets | log_probs) `[B]`, float32. log_probs `[B, T, V]`
    already log-softmaxed; targets `[B, U]` (values past target_lengths
    are ignored); lengths absolute."""
    log_probs = log_probs.to(torch.float32)
    b, t, _ = log_probs.shape
    u = targets.shape[1]
    s = 2 * u + 1
    dev = log_probs.device
    input_lengths = input_lengths.to(torch.long)
    target_lengths = target_lengths.to(torch.long)
    ext = torch.full((b, s), blank_id, dtype=torch.long, device=dev)
    ext[:, 1::2] = targets.to(torch.long)
    lp_ext = torch.gather(log_probs, 2, ext[:, None, :].expand(b, t, s))   # [B, T, S]
    # a label state may also be entered from s-2 when it differs from the
    # label two states back
    same = torch.cat([torch.ones(b, 2, dtype=torch.bool, device=dev), ext[:, 2:] == ext[:, :-2]],
                     dim=1)
    states = torch.arange(s, device=dev)[None, :]
    can_skip = (states % 2 == 1) & ~same
    valid_s = states < (2 * target_lengths[:, None] + 1)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)

    alpha = torch.full((b, s), _NEG, dtype=torch.float32, device=dev)
    alpha[:, 0] = 0.0
    alpha[:, 1] = torch.where(target_lengths > 0, 0.0, _NEG)
    alpha = torch.where(valid_s, alpha + lp_ext[:, 0], neg)
    alphas = [alpha]
    for i in range(1, t):
        prev = torch.cat([torch.full((b, 1), _NEG, device=dev), alpha[:, :-1]], dim=1)
        skip = torch.cat([torch.full((b, 2), _NEG, device=dev), alpha[:, :-2]], dim=1)
        skip = torch.where(can_skip, skip, neg)
        m = torch.maximum(torch.maximum(alpha, prev), skip)
        a = m + torch.log(torch.exp(alpha - m) + torch.exp(prev - m) + torch.exp(skip - m))
        alpha = torch.where(valid_s, a + lp_ext[:, i], neg)
        alphas.append(alpha)
    at_end = torch.stack(alphas)[torch.clamp(input_lengths - 1, min=0),
                                 torch.arange(b, device=dev)]                  # [B, S]
    a_label = torch.gather(at_end, 1, torch.clamp(2 * target_lengths - 1, min=0)[:, None])[:, 0]
    a_label = torch.where(target_lengths > 0, a_label, neg)
    a_blank = torch.gather(at_end, 1, (2 * target_lengths)[:, None])[:, 0]
    return torch.clamp(torch.logaddexp(a_label, a_blank), min=_NEG)


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
