"""Parameters stored sharded and gathered whole for use — the runtime of
the sharding rules of `parallel/mesh.py` (what GSPMD does for them in the
JAX trainer, `summarymixing_tpu/training/trainer.py:116-125`).

`ShardedParameters(named_params, mesh, placements)` keeps, for every
parameter that a rule shards (`Shard(axis)` on one mesh dimension), this
process's slice along that axis; replicated parameters are kept whole.
`dtensors()` views the kept tensors as `DTensor`s with the rule's
placements. A step then runs:

- `gather()`: one all-gather per mesh axis (the flattened slices of every
  parameter sharded over it) refills each module parameter with the whole
  tensor, written in place with `copy_` so that its version rises: the
  kernels' weight caches (`ops/_build.py::cached_weights`, keyed on
  `(data_ptr, _version)`) cannot mistake a refilled parameter for last
  step's even when its storage lands at the same address;
- the forward and backward on whole parameters, so the hand-written
  kernels get whole, contiguous weights as everywhere else; each process
  has the whole gradient of its own rows;
- the trainer's data-axis mean of the whole gradients (`GradientSync`,
  unchanged: no gradient is reduce-scattered before it), the global norm
  on the whole mean gradient, then `slices(grads)`: this process's slice
  of each sharded gradient. The model axis adds nothing up: its
  processes hold the same rows and so the same gradient, and each takes
  its own slice;
- the optimizer on the kept slices and their moments (with `MultiSteps`,
  the accumulator is kept as slices too, and its inner step clips by the
  norm of the whole accumulator, `whole_tensors`);
- `release()`: the sharded parameters' module storage is freed
  (`untyped_storage().resize_(0)`), so between steps a process holds its
  slices, their moments and the replicated parameters.

Collectives run on the mesh's process groups as they are: the card's
PyTorch takes all-gather on CUDA tensors under gloo as under NCCL
(`parallel/comm.py`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch

from summarymixing_tpu_torch.parallel import comm


class ShardedParameters:
    def __init__(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]], mesh,
                 placements: Dict[str, list]):
        from torch.distributed.tensor import Shard

        self.mesh = mesh
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.placements = [placements[n] for n in self.names]
        # per parameter: (mesh axis name, tensor axis) or None when replicated
        self.split: List = []
        for name, place in zip(self.names, self.placements):
            shards = [(i, p.dim) for i, p in enumerate(place) if isinstance(p, Shard)]
            if len(shards) > 1:
                raise ValueError(f"{name}: sharded on more than one mesh axis")
            self.split.append((mesh.mesh_dim_names[shards[0][0]], shards[0][1])
                              if shards else None)
        # in mesh order on every process: each axis's all-gather is a
        # collective, and the processes must issue them in one order
        self.groups: Dict[str, Tuple] = {}
        used = {s[0] for s in self.split if s is not None}
        for axis in (a for a in mesh.mesh_dim_names if a in used):
            dim = mesh.mesh_dim_names.index(axis)
            self.groups[axis] = (mesh.get_group(axis), mesh.get_local_rank(axis),
                                 mesh.size(dim))
        with torch.no_grad():
            self.local = [p if s is None else self._slice(p.detach(), s).clone()
                          for p, s in zip(self.params, self.split)]
        self._whole = True

    def _slice(self, t: torch.Tensor, split) -> torch.Tensor:
        axis, dim = split
        _, index, size = self.groups[axis]
        return t.chunk(size, dim=dim)[index]

    # -- what a process holds -------------------------------------------------
    def dtensors(self) -> Dict[str, torch.Tensor]:
        """name -> the kept tensor as a `DTensor` with the rule's placements."""
        return {n: self.as_dtensor(t, i) for i, (n, t) in enumerate(zip(self.names, self.local))}

    def as_dtensor(self, t: torch.Tensor, i: int):
        """`t`, a tensor shaped as parameter `i`'s kept slice, as a DTensor."""
        from torch.distributed.tensor import DTensor

        p = self.params[i]
        return DTensor.from_local(t.detach(), self.mesh, self.placements[i], run_check=False,
                                  shape=p.shape, stride=_contiguous_stride(p.shape))

    def held_share(self) -> float:
        """The share of the parameters' elements this process keeps."""
        kept = sum(t.numel() for t in self.local)
        return kept / sum(p.numel() for p in self.params)

    # -- one step ---------------------------------------------------------------
    def _gathered(self, kept: Sequence[torch.Tensor]):
        """(index, whole tensor) of every sharded parameter from `kept`,
        tensors shaped as the kept slices: one all-gather per mesh axis, in
        mesh order."""
        for axis, (group, _, size) in self.groups.items():
            members = [i for i, s in enumerate(self.split) if s is not None and s[0] == axis]
            flat = torch.cat([kept[i].reshape(-1) for i in members])
            parts = comm.all_gather_rows(flat[None], group)
            offset = 0
            for i in members:
                t = kept[i]
                n = t.numel()
                yield i, torch.cat([parts[r, offset:offset + n].view(t.shape)
                                    for r in range(size)], dim=self.split[i][1])
                offset += n

    @torch.no_grad()
    def gather(self) -> None:
        """Refill every sharded module parameter with the whole tensor."""
        if self._whole:
            return
        for i, whole in self._gathered(self.local):
            p = self.params[i]
            p.untyped_storage().resize_(p.numel() * p.element_size())
            p.copy_(whole)
        self._whole = True

    @torch.no_grad()
    def whole_tensors(self, kept: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The whole tensors of `kept` (one per parameter, shaped as its
        kept slice, such as an optimizer's accumulator), gathered as the
        parameters are (a collective on every process)."""
        out = list(kept)
        for i, whole in self._gathered(kept):
            out[i] = whole
        return out

    def release(self) -> None:
        """Free the sharded parameters' whole storage (their gradients first)."""
        if not self._whole:
            return
        for p, s in zip(self.params, self.split):
            if s is not None:
                p.grad = None
                p.untyped_storage().resize_(0)
        self._whole = False

    @contextlib.contextmanager
    def whole(self):
        """The module's parameters whole inside the block, released after."""
        self.gather()
        try:
            yield
        finally:
            self.release()

    def slices(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This process's slice of each whole tensor (one per parameter)."""
        return [t if s is None else self._slice(t, s).contiguous()
                for t, s in zip(tensors, self.split)]


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
