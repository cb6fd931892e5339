"""Collectives on tensors for the data- and sequence-parallel paths: every
collective the port runs on a tensor goes through this module.

Two processes cannot share one card under NCCL, so the card machine's
multi-process checks run gloo on CUDA tensors (`chip_smoke.py` phase 25).
The card's PyTorch (2.11) runs every collective used here (all-reduce,
all-gather, broadcast) on CUDA tensors under gloo as well, so nothing is
copied through host memory by hand: the tensors go to the backend as
they are, under NCCL and gloo alike.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# the collectives `all_reduce_` has run in this process (a group of more
# than one process): `calls`, and `bytes` (elements times element size),
# counted on the host
COLLECTIVES = {"calls": 0, "bytes": 0}


def group_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """Reduce `t` in place over the group's processes, counted in
    `COLLECTIVES`; returns it."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += t.numel() * t.element_size()
    return t


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's `t` (one shape on all), concatenated along the
    leading axis in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """`t` from global rank `src` to every process of the group, in place."""
    if group_size(group) > 1:
        dist.broadcast(t, src, group=group)
    return t


def flat(tensors: Sequence[torch.Tensor], extra: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """One float32 vector of `tensors` then `extra` (scalars), for a single
    collective."""
    return torch.cat([t.reshape(-1).to(torch.float32) for t in list(tensors) + list(extra)])


def unflat(vec: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors of `flat(like)`'s layout back from `vec`, in `like`'s
    shapes and dtypes; what is left over follows as one more entry."""
    out, i = [], 0
    for t in like:
        n = t.numel()
        out.append(vec[i:i + n].view(t.shape).to(t.dtype))
        i += n
    out.append(vec[i:])
    return out


def sum_tensors(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The tensors summed over the group's processes, in one float32
    collective (their own dtypes back)."""
    return unflat(all_reduce_(flat(tensors), group=group), tensors)[:-1]


def broadcast_parameters(params: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Every process of `group` takes global rank `src`'s values of
    `params` (one collective over their flat copy)."""
    if group_size(group) == 1:
        return
    with torch.no_grad():
        vec = broadcast_(flat(params), src, group)
        for p, v in zip(params, unflat(vec, params)):
            p.copy_(v)


class GradientSync:
    """The data-parallel reduction of the trainers: the loss and the
    gradient are the mean over every process's rows (the processes hold
    equal row counts, and every loss is a mean over rows), so each
    process steps the same optimizer on the same values and keeps the
    same parameters.

    `mean_(grads, loss)` averages the gradients and the loss in one
    collective; `loss_and_flag(loss, local_ok)` averages the loss and
    ORs a local non-finite flag (gradient accumulation reduces the
    gradients once per optimizer step, the accumulator, and decides each
    micro step's skip from these two); `sum_` sums statistics in place."""

    def __init__(self, group=None):
        self.group = group
        self.size = group_size(group)

    def mean_(self, grads: List[torch.Tensor], loss: torch.Tensor):
        """(mean gradients, mean loss)."""
        vec = all_reduce_(flat(grads, [loss.detach()]), group=self.group).div_(self.size)
        *out, rest = unflat(vec, grads)
        return out, rest[0]

    def mean_list_(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        vec = all_reduce_(flat(tensors), group=self.group).div_(self.size)
        return unflat(vec, tensors)[:-1]

    def loss_and_flag(self, loss: torch.Tensor, local_ok: torch.Tensor):
        """(mean loss, whether every process's flag is true)."""
        vec = torch.stack([loss.detach().to(torch.float32),
                           (~local_ok).to(torch.float32)])
        vec = all_reduce_(vec, group=self.group)
        return vec[0] / self.size, vec[1] == 0

    def sum_(self, *tensors: torch.Tensor):
        """The tensors summed over the processes (float32, one collective)."""
        return tuple(sum_tensors(tensors, self.group))


def gradient_sync(group=None) -> Optional[GradientSync]:
    """A `GradientSync` over `group` when more than one process takes part, else None."""
    return GradientSync(group) if group_size(group) > 1 else None
