"""RNN-Transducer loss — the port of `summarymixing_tpu/losses/transducer.py`,
in plain PyTorch (float32) and differentiated by autograd.

The alpha recursion over the `[T, U+1]` lattice,

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + label[t, u-1]),

runs as a loop over t; each row is closed-form, one `torch.logcumsumexp`
over u:

    alpha[t, u] = L[t, u] + logcumsumexp_u(A[t, u] - L[t, u]),
    A[t, u] = alpha[t-1, u] + blank[t-1, u],  L[t, u] = sum_{w<u} label[t, w].

"Log zero" is -1e5, not -inf, and every row is clamped at it where the JAX
loss clamps: exp(-1e5) is 0 in float32, and the backward never meets an
infinite partial (no NaN). Each utterance's answer alpha[T_b-1, U_b] +
blank[T_b-1, U_b] is latched inside the loop at t == T_b - 1.

    >>> import torch
    >>> from summarymixing_tpu_torch.losses.transducer import transducer_loss
    >>> logits = torch.zeros(1, 6, 4, 5)   # [B, T, U+1, V], uniform joint
    >>> l = transducer_loss(logits, torch.tensor([[1, 2, 3]]), torch.tensor([6]),
    ...                     torch.tensor([3]))
    >>> round(float(l), 2)
    10.46
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_NEG = -1e5


def transducer_lattice_logprob(blank_lp: torch.Tensor, label_lp: torch.Tensor,
                               input_lengths: torch.Tensor,
                               target_lengths: torch.Tensor) -> torch.Tensor:
    """blank_lp `[B, T, U+1]`: log P(blank | t, u); label_lp `[B, T, U+1]`:
    log P(y_{u+1} | t, u) (entries at u >= U_b are ignored). Returns
    log P(y | x) `[B]`."""
    b, t, u1 = blank_lp.shape
    device = blank_lp.device
    target_lengths = target_lengths.long().to(device)
    input_lengths = input_lengths.long().to(device)
    label_valid = torch.arange(u1, device=device)[None, None, :] < target_lengths[:, None, None]
    label_lp = torch.where(label_valid, label_lp, torch.full_like(label_lp, _NEG))

    def excl_cumsum_row(label_t: torch.Tensor) -> torch.Tensor:
        cs = torch.cat([torch.zeros_like(label_t[:, :1]),
                        torch.cumsum(label_t[:, :-1], dim=1)], dim=1)
        return torch.clamp_min(cs, _NEG)

    t_last = torch.clamp_min(input_lengths - 1, 0)
    # blank log-prob at (t, U_b) for every t: [B, T]
    final_blank = torch.gather(blank_lp, 2, target_lengths[:, None, None].expand(b, t, 1))[..., 0]

    def final_at(alpha_t: torch.Tensor, ti: int) -> torch.Tensor:
        return torch.gather(alpha_t, 1, target_lengths[:, None])[:, 0] + final_blank[:, ti]

    alpha = excl_cumsum_row(label_lp[:, 0])
    latched = torch.where(t_last == 0, final_at(alpha, 0),
                          torch.full((b,), _NEG, dtype=blank_lp.dtype, device=device))
    for ti in range(1, t):
        a_entry = alpha + blank_lp[:, ti - 1]
        l_cum = excl_cumsum_row(label_lp[:, ti])
        alpha = torch.clamp_min(l_cum + torch.logcumsumexp(a_entry - l_cum, dim=1), _NEG)
        latched = torch.where(t_last == ti, final_at(alpha, ti), latched)
    return latched


def _reduce(loss: torch.Tensor, target_lengths: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    if reduction == "batchmean":
        return (loss / torch.clamp_min(target_lengths.to(loss.device), 1)).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def gather_lattice_logprobs(logits: torch.Tensor, targets: torch.Tensor,
                            blank_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`[B, T', U+1, V]` joint logits -> the two normalised V-slices the
    lattice reads: (blank_lp, label_lp), each `[B, T', U+1]`."""
    b, t, u1, _ = logits.shape
    lsd = torch.logsumexp(logits, dim=-1)
    blank_lp = logits[..., blank_id] - lsd
    tgt = torch.cat([targets.long(), torch.zeros_like(targets[:, :1]).long()], dim=1)
    tgt = tgt.to(logits.device)[:, None, :, None].expand(b, t, u1, 1)
    label_lp = torch.gather(logits, -1, tgt)[..., 0] - lsd
    return blank_lp, label_lp


def transducer_loss_chunked(enc_proj: torch.Tensor, dec_proj: torch.Tensor,
                            joint_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                            targets: torch.Tensor, input_lengths: torch.Tensor,
                            target_lengths: torch.Tensor, blank_id: int = 0,
                            reduction: str = "mean", chunk_size: int = 64) -> torch.Tensor:
    """The RNN-T loss without the whole `[B, T, U+1, V]` joint tensor: the
    joint runs over T in chunks of `chunk_size` encoder frames, each under
    `torch.utils.checkpoint` (its logits are made again in the backward), so
    only the two `[B, c, U+1]` slices per chunk are kept.
    `joint_fn(enc_chunk [B, c, J], dec_proj [B, U+1, J])` gives the chunk's
    logits `[B, c, U+1, V]`; it draws nothing at random. T is zero-padded to
    a whole number of chunks; the padded frames lie past every length."""
    b, t, _ = enc_proj.shape
    n_chunks = -(-t // chunk_size)
    enc_proj = F.pad(enc_proj, (0, 0, 0, n_chunks * chunk_size - t))

    def chunk_slices(enc_chunk, dec):
        return gather_lattice_logprobs(joint_fn(enc_chunk, dec), targets, blank_id)

    blanks, labels = [], []
    for c in range(n_chunks):
        bl, la = checkpoint(chunk_slices, enc_proj[:, c * chunk_size:(c + 1) * chunk_size],
                            dec_proj, use_reentrant=False, preserve_rng_state=False)
        blanks.append(bl)
        labels.append(la)
    ll = transducer_lattice_logprob(torch.cat(blanks, dim=1)[:, :t],
                                    torch.cat(labels, dim=1)[:, :t], input_lengths,
                                    target_lengths)
    return _reduce(-ll, target_lengths, reduction)


def transducer_loss(logits: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
                    target_lengths: torch.Tensor, blank_id: int = 0,
                    reduction: str = "mean") -> torch.Tensor:
    """logits `[B, T, U+1, V]` (pre-softmax joint outputs), targets `[B, U]`,
    absolute lengths: -log P(y | x) reduced over the batch (`none`, `sum`,
    `mean`, or `batchmean`: each divided by its target length first)."""
    blank_lp, label_lp = gather_lattice_logprobs(logits, targets, blank_id)
    ll = transducer_lattice_logprob(blank_lp, label_lp, input_lengths, target_lengths)
    return _reduce(-ll, target_lengths, reduction)
