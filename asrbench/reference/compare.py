"""The numbers that decide `correct`, each against its limit.

Decode (greedy CTC): for a sample of the window's batches the reference's
log-probabilities are computed from the same waveforms and weights; the
system's answer is judged by

- `hyp_rows_wrong`: rows whose served token list is not the collapse of the
  system's own per-frame best tokens (an altered or dropped answer);
- `kl_mean`: the mean over the valid frames of the sampled rows of the
  Kullback-Leibler divergence of the system's per-frame distribution from
  the reference's, sum_v p_ref (log p_ref - log p_sys);
- `kl_row_max`: the largest, over the sampled rows, of one row's mean of
  that divergence over its own valid frames (a fault confined to one row).

Training: the reference follows the system's first three steps from the
same weights, batches and draws, and

- `loss_gap`: the largest relative gap between the two losses of a step;
- `grad_gap`: over the leaves, the gap between the norms of the first
  gradient as the optimizer took it (the system's from its first moment
  after one step, mu / (1 - beta1)), over the larger of the reference leaf's
  norm and the median leaf's;
- `update_gap`: the same for the change of the parameters over three steps;
- `loss_gap_1`: the first step's loss gap, steadier from seed to seed.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's move by round-off alone and are left out of both leaf numbers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


def decode_numbers(rows: Sequence[Dict]) -> Dict[str, float]:
    """`rows`: per sampled batch `hyps`, `lp` (system `[B, T', V]`), `lens`
    (system `[B]`), `ref_lp`, `ref_lens`."""
    from asrbench.reference import asr

    wrong, kl, frames, row_max = 0, 0.0, 0, 0.0
    for r in rows:
        if not torch.equal(r["lens"].cpu().long(), r["ref_lens"].cpu().long()):
            raise AssertionError("encoder lengths differ from the reference's")
        lp, ref = r["lp"].float(), r["ref_lp"].float()
        lens = r["lens"].to(lp.device)
        wrong += sum(a != b for a, b in zip(asr.collapse(lp.argmax(dim=-1), lens), r["hyps"]))
        valid = torch.arange(lp.shape[1], device=lp.device)[None] < lens[:, None]
        per_frame = (torch.exp(ref) * (ref - lp)).sum(dim=-1)
        per_row = torch.where(valid, per_frame, 0.0).double().sum(dim=1)
        kl += float(per_row.sum())
        frames += int(valid.sum())
        row_max = max(row_max, float((per_row / lens.clamp_min(1)).max()))
    return {"hyp_rows_wrong": float(wrong), "kl_mean": kl / max(frames, 1),
            "kl_row_max": row_max}


def _leaf_gaps(prog: Sequence[float], ref: Sequence[float], keep: Sequence[bool]) -> List[float]:
    kept = [r for r, k in zip(ref, keep) if k]
    med = sorted(kept)[len(kept) // 2]
    return sorted(abs(p - r) / max(r, med) for p, r, k in zip(prog, ref, keep) if k)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """`prog` and `ref`: `losses` (3 floats), `grad_norms` and `update_norms`
    (per leaf, in one order)."""
    g = ref["grad_norms"]
    med = sorted(g)[len(g) // 2]
    keep = [x >= 1e-3 * med for x in g]
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    grad = _leaf_gaps(prog["grad_norms"], g, keep)
    upd = _leaf_gaps(prog["update_norms"], ref["update_norms"], keep)
    return {"loss_gap": max(losses), "grad_gap": grad[-1], "update_gap": upd[-1],
            "loss_gap_1": losses[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> List[Dict]:
    """One entry per limited number: name, value, limit, ok (value <= limit)."""
    return [{"name": k, "value": numbers[k], "limit": lim, "ok": numbers[k] <= lim}
            for k, lim in limits.items()]


def leaf_norms(tensors: Sequence[torch.Tensor]) -> List[float]:
    return [float(t.detach().float().norm()) for t in tensors]
