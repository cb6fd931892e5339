"""Device mesh and data-parallel placement — the port of the data axis of
`summarymixing_tpu/parallel/mesh.py` on `torch.distributed.device_mesh`.

The JAX module builds a `("data", "model")` mesh over every device and
lets GSPMD shard the batch and all-reduce the gradient. Here one process
drives one device, a mesh is a `DeviceMesh` over the process group's
ranks, and the gradient all-reduce is explicit (`parallel/comm.py`,
called by the trainers). Only `n_model == 1` is taken: the FSDP and
tensor-parallel rules of the JAX module (`tensor_parallel_param_sharding`,
`fsdp_param_sharding`, `composite_param_sharding`) are still to port
(ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

from typing import Optional, Sequence

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
    `ValueError`; `n_model` > 1 raises `NotImplementedError`."""
    n_dev = len(devices) if devices is not None else _world()
    if n_data is None:
        n_data = n_dev // n_model
    check_mesh((n_data, n_model), n_dev, f"{n_data}x{n_model}")
    if n_model != 1:
        raise NotImplementedError(
            "a model axis (tensor parallelism, FSDP) is not ported; see ROADMAP.md queue 1 "
            "item 10")
    return build_mesh((n_data, n_model), ("data", "model"), device)


def data_parallel_sharding(mesh):
    """The placement of batch-leading tensors: split over the data axis,
    `[Shard(0)]` on the mesh's data dimension (the counterpart of
    `NamedSharding(mesh, P("data"))`)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == "data" else Replicate() for name in mesh.mesh_dim_names]


def replicate(mesh):
    """Fully replicated placements (parameters, scalars)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def shard_batch(batch, mesh):
    """Each process's rows of a host batch (dict of arrays or tensors with
    the global batch leading): the slice `launch.local_rows` gives this
    process's data coordinate. The JAX function places the global batch
    on every device; here each process keeps only its own rows, which is
    what `DTensor.from_local` would wrap."""
    from summarymixing_tpu_torch.parallel import launch

    n_data = mesh.size(mesh.mesh_dim_names.index("data"))
    index = mesh.get_coordinate()[mesh.mesh_dim_names.index("data")] if n_data > 1 else 0
    return {k: v[launch.local_rows(len(v), n_data, index)] for k, v in batch.items()}
