"""Device mesh, data-parallel placement and the parameter-sharding rules —
the port of `summarymixing_tpu/parallel/mesh.py` on
`torch.distributed.device_mesh` and `torch.distributed.tensor`.

The JAX module builds a `("data", "model")` mesh over every device and
lets GSPMD shard the batch, all-reduce the gradient and place parameters
by a rule. Here one process drives one device, a mesh is a `DeviceMesh`
over the process group's ranks, and the collectives are explicit
(`parallel/comm.py`, `parallel/sharded.py`, called by the trainers).

The three rules (`tensor_parallel_param_sharding`,
`fsdp_param_sharding`, `composite_param_sharding`) return, for a port
module, the `DTensor` placements of every parameter (one `Shard(axis)` or
`Replicate()` per mesh dimension). They decide on the flax leaf each
parameter was read from (`utils.convert.leaf_layouts`): its shape in the
flax tree, and the port axis each flax axis maps to. So the placement is
the JAX rule's, mapped through the weight bridge: the column shard
`P(None, "model")` of a Dense kernel `[in, out]` is `Shard(0)` of the
Linear's `[out, in]`, and FSDP's "largest divisible dimension" breaks
ties in the flax order, as the JAX rule's stable sort does. A parameter
that packs several flax leaves (the LSTM's four gates along its axis 0)
is sharded when every leaf is, on the matching axis.

A rule takes a `DeviceMesh`, or a mapping of axis names to sizes in mesh
order (`{"data": 2, "model": 2}`), which is all it reads.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _ensure_group() -> None:
    """A one-process run has no process group; a mesh needs one, so it
    gets a one-rank gloo group over an in-memory store."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)


def mesh_device_type(device=None) -> str:
    """The mesh's device type: "cuda" when this process runs on the card."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() and torch.cuda.is_initialized() else "cpu"


def build_mesh(shape: Sequence[int], names: Sequence[str], device=None):
    """A `DeviceMesh` of `shape` over ranks 0..prod(shape)-1 in order."""
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_group()
    ranks = torch.arange(int(np.prod(shape))).reshape(tuple(shape))
    return DeviceMesh(mesh_device_type(device), ranks, mesh_dim_names=tuple(names))


def check_mesh(sizes: Sequence[int], n_devices: int, label: str) -> None:
    if int(np.prod(sizes)) != n_devices:
        raise ValueError(
            f"mesh {label} does not use all {n_devices} devices — choose axis sizes whose "
            "product is the device count (silently idling chips costs throughput)")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None, device=None):
    """A `("data", "model")` `DeviceMesh` over every process (one device
    each; `devices`, when given, only counts them). Defaults to all
    processes on the data axis. A mesh that leaves a device out raises
    `ValueError`."""
    n_dev = len(devices) if devices is not None else _world()
    if n_data is None:
        n_data = n_dev // n_model
    check_mesh((n_data, n_model), n_dev, f"{n_data}x{n_model}")
    return build_mesh((n_data, n_model), ("data", "model"), device)


def axis_sizes(mesh) -> "OrderedDict[str, int]":
    """The mesh's axis names and sizes, in mesh order."""
    if isinstance(mesh, Mapping):
        return OrderedDict(mesh)
    return OrderedDict((name, mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names))


def axis_group(mesh, name: str):
    """(process group, this process's index, size) of `mesh`'s axis `name`;
    the group is None when the axis has one process."""
    dim = mesh.mesh_dim_names.index(name)
    size = mesh.size(dim)
    if size == 1:
        return None, 0, 1
    return mesh.get_group(name), mesh.get_local_rank(name), size


def data_parallel_sharding(mesh):
    """The placement of batch-leading tensors: split over the data axis,
    `[Shard(0)]` on the mesh's data dimension (the counterpart of
    `NamedSharding(mesh, P("data"))`)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == "data" else Replicate() for name in axis_sizes(mesh)]


def replicate(mesh):
    """Fully replicated placements (parameters, scalars)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in axis_sizes(mesh)]


def shard_batch(batch, mesh):
    """Each process's rows of a host batch (dict of arrays or tensors with
    the global batch leading): the slice `launch.local_rows` gives this
    process's data coordinate. The JAX function places the global batch
    on every device; here each process keeps only its own rows, which is
    what `DTensor.from_local` would wrap. Processes that differ only on
    the model axis get the same rows."""
    from summarymixing_tpu_torch.parallel import launch

    _, index, n_data = axis_group(mesh, "data")
    return {k: v[launch.local_rows(len(v), n_data, index)] for k, v in batch.items()}


# -- parameter-sharding rules -------------------------------------------------

def _tp_axis(shape, n_model: int, min_dim: int) -> Optional[int]:
    """The flax axis the JAX tensor-parallel rule shards, or None: a 2-D
    kernel whose output (last) axis is at least `min_dim` wide and
    divisible by the model axis."""
    if n_model > 1 and len(shape) == 2 and shape[-1] >= min_dim and shape[-1] % n_model == 0:
        return 1
    return None


def _fsdp_axis(shape, n_axis: int, min_size: int) -> Optional[int]:
    """The flax axis the JAX FSDP rule shards, or None: the largest axis
    divisible by the mesh axis, ties to the first (a stable sort by -size
    over the flax axes), for leaves of at least `min_size` elements."""
    if n_axis > 1 and len(shape) >= 1 and int(np.prod(shape)) >= min_size:
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if shape[d] % n_axis == 0:
                return d
    return None


def _placements(module, mesh, choose) -> Dict[str, List]:
    """`choose(flax leaf shape) -> (mesh axis, flax axis) or None`, applied
    to every parameter of `module` and mapped to placements."""
    from torch.distributed.tensor import Replicate, Shard

    from summarymixing_tpu_torch.utils.convert import leaf_layouts

    names = list(axis_sizes(mesh))
    out = {}
    for pname, layout in leaf_layouts(module).items():
        placements = [Replicate() for _ in names]
        picked = choose(layout.shape)
        if picked is not None:
            mesh_axis, flax_axis = picked
            placements[names.index(mesh_axis)] = Shard(layout.axes[flax_axis])
        out[pname] = placements
    return out


def tensor_parallel_param_sharding(mesh, min_dim: int = 1024):
    """The rule for the mesh's "model" axis: every 2-D kernel whose output
    width is at least `min_dim` and divisible by the axis is split along
    its output columns (a Linear's `Shard(0)`); everything else is
    replicated. Returns `fn(module) -> {parameter name: placements}`."""
    n_model = axis_sizes(mesh).get("model", 1)

    def choose(shape):
        axis = _tp_axis(shape, n_model, min_dim)
        return None if axis is None else ("model", axis)

    return lambda module: _placements(module, mesh, choose)


def fsdp_param_sharding(mesh, axis: str = "data", min_size: int = 2 ** 16):
    """Fully sharded data parallelism (ZeRO-3): each parameter of at least
    `min_size` elements is split over `axis` along its largest divisible
    dimension; smaller ones (norms, biases) are replicated. Returns
    `fn(module) -> {parameter name: placements}`."""
    n_axis = axis_sizes(mesh)[axis]

    def choose(shape):
        d = _fsdp_axis(shape, n_axis, min_size)
        return None if d is None else (axis, d)

    return lambda module: _placements(module, mesh, choose)


def composite_param_sharding(mesh, tp_min_dim: int = 1024, fsdp_min_size: int = 2 ** 16,
                             fsdp_axis: str = "data"):
    """Tensor parallelism for the wide 2-D kernels (over "model") and FSDP
    for every other large parameter (over `fsdp_axis`). Returns
    `fn(module) -> {parameter name: placements}`."""
    sizes = axis_sizes(mesh)
    n_model, n_fsdp = sizes.get("model", 1), sizes[fsdp_axis]

    def choose(shape):
        t = _tp_axis(shape, n_model, tp_min_dim)
        if t is not None:
            return "model", t
        d = _fsdp_axis(shape, n_fsdp, fsdp_min_size)
        return None if d is None else (fsdp_axis, d)

    return lambda module: _placements(module, mesh, choose)
