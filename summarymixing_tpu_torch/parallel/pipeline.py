"""Pipeline parallelism: an encoder's layer stack split into stages over a
"pipe" mesh axis, microbatches streamed through them GPipe-style — the
port of `summarymixing_tpu/parallel/pipeline.py` on `torch.distributed`.

The stack's parameters are stacked `{name: [L, ...]}` (the layout of the
JAX encoders' `scan_layers=True`, here built by `stacked_params` from an
encoder's `layer_{i}` or read from a flax tree by `load_jax_params`). With
S stages, process s of the pipe axis runs layers [s·L/S, (s+1)·L/S) on
each of M microbatches, over M + S - 1 steps: at step t stage s takes
microbatch t - s (the pad mask of THAT microbatch: indexing it by the
ingest step applied microbatch t's valid-frame counts to every stage,
the bug the JAX module guards against), and stage s + 1 receives its
output for step t + 1. The last stage's outputs are broadcast over the
pipe axis (the JAX `psum` over "pipe"), so every process gets the whole
`[B, T, D]`; with a data axis each microbatch's rows are split over it
and gathered back. Steps on which a stage holds no microbatch run
nothing (the JAX schedule computes and discards them). Utilisation is the
GPipe bubble's M / (M + S - 1).

Activations travel by point-to-point `send`/`recv` between neighbouring
stages. Gloo's point-to-point does not take CUDA tensors, so under gloo
(two processes sharing one card) they are staged through host memory:
copied to the CPU, sent, received and copied back. Under NCCL (a card
per process) they go as they are. The broadcast and the data-axis
all-gather take CUDA tensors under both backends.

The pipelined stack is differentiable: one autograd Function whose
forward keeps each stage's graph per microbatch, and whose backward runs
the schedule in reverse (stage s receives the gradient of its output
from s + 1, sends the gradient of its input to s - 1). The last stage
takes the output's gradient as its own: every process must compute the
same loss from the replicated output, as a loss of a replicated JAX value
is one loss. Each process's gradient is that of its stage's layers,
summed over the data axis, so it is the gradient of the whole batch; the input's gradient is gathered to every
process.

Dropout (`seed` given; the layer modules in training mode): each layer
call draws from its own `torch.Generator`, seeded from (seed, data index,
microbatch, absolute layer), so every in-flight microbatch draws an
independent mask on every layer. These are not the JAX bits (fault 6):
parity with JAX holds at dropout 0.

    mesh = make_pipeline_mesh(n_data=1, n_pipe=2)
    encode = pipeline_branchformer_encode(encoder, mesh, n_micro=4)
    y = encode(stacked_params(encoder, stage_of=mesh), x, None, pad_mask)  # [B, T, D] everywhere
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from summarymixing_tpu_torch.ops import _build
from summarymixing_tpu_torch.ops.layers import set_dropout_generator
from summarymixing_tpu_torch.parallel.mesh import build_mesh, check_mesh


def make_pipeline_mesh(n_data: Optional[int] = None, n_pipe: int = 1,
                       devices: Optional[Sequence] = None, device=None):
    """A `("data", "pipe")` `DeviceMesh` over every process (one device
    each; `devices`, when given, only counts them). A mesh that leaves a
    device out raises `ValueError`."""
    n_dev = len(devices) if devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if n_data is None:
        n_data = n_dev // n_pipe
    check_mesh((n_data, n_pipe), n_dev, f"{n_data}x{n_pipe}")
    return build_mesh((n_data, n_pipe), ("data", "pipe"), device)


def _microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def dropout_seed(seed: int, data_index: int, micro: int, layer: int) -> int:
    """The seed of one layer call's dropout stream."""
    return int(np.random.SeedSequence([seed, data_index, micro, layer]).generate_state(
        1, np.uint64)[0] >> 1)


class _Topology:
    """This process's place on the mesh and its neighbours' global ranks."""

    def __init__(self, mesh):
        self.mesh = mesh
        names = mesh.mesh_dim_names
        self.n_data = mesh.size(names.index("data"))
        self.n_stages = mesh.size(names.index("pipe"))
        coord = mesh.get_coordinate()
        self.data_index = coord[names.index("data")]
        self.stage = coord[names.index("pipe")]
        ranks = mesh.mesh
        if names.index("pipe") == 0:
            ranks = ranks.t()
        self.pipe_ranks = [int(r) for r in ranks[self.data_index]]
        self.pipe_group = mesh.get_group("pipe") if self.n_stages > 1 else None
        self.data_group = mesh.get_group("data") if self.n_data > 1 else None

    def _host_staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend() == "gloo"

    def send(self, t: torch.Tensor, stage: int) -> None:
        dst = self.pipe_ranks[stage]
        dist.send(t.cpu() if self._host_staged(t) else t.contiguous(), dst)

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        src = self.pipe_ranks[stage]
        if self._host_staged(like):
            buf = torch.empty(like.shape, dtype=like.dtype)
            dist.recv(buf, src)
            return buf.to(like.device)
        buf = torch.empty_like(like)
        dist.recv(buf, src)
        return buf

    def replicate_last(self, t: torch.Tensor) -> torch.Tensor:
        """The last stage's `t` on every process of the pipe axis."""
        if self.pipe_group is not None:
            dist.broadcast(t, self.pipe_ranks[-1], group=self.pipe_group)
        return t

    def replicate_first(self, t: torch.Tensor) -> torch.Tensor:
        if self.pipe_group is not None:
            dist.broadcast(t, self.pipe_ranks[0], group=self.pipe_group)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """`[M, b/n_data, ...]` of every data index -> `[M, b, ...]`."""
        if self.data_group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.n_data)]
        dist.all_gather(parts, t.contiguous(), group=self.data_group)
        return torch.cat(parts, dim=1)

    def sum_data(self, tensors: List[torch.Tensor]) -> None:
        if self.data_group is None or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.data_group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()


class _GPipe(torch.autograd.Function):
    """`xs` `[M, b, T, D]` (every data index's rows) through the stages;
    `stage_params` this process's stage parameters."""

    @staticmethod
    def forward(ctx, run, xs, *stage_params):
        top = run.top
        s, n_st, m = top.stage, top.n_stages, xs.shape[0]
        rows = xs.shape[1] // top.n_data
        lo = top.data_index * rows
        local = xs[:, lo:lo + rows]
        keep = run.keep_graph
        leaves = [p.detach().requires_grad_(keep and p.requires_grad) for p in stage_params]
        saved: Dict[int, tuple] = {}
        outs: List[Optional[torch.Tensor]] = [None] * m
        with torch.enable_grad() if keep else torch.no_grad():
            for t in range(m + n_st - 1):
                mb = t - s   # stage s holds microbatch t - s at step t
                if not 0 <= mb < m:
                    continue
                x_in = local[mb] if s == 0 else top.recv(local[mb], s - 1)
                x_leaf = x_in.detach().requires_grad_(keep and (s > 0 or xs.requires_grad))
                y = run.stage(leaves, x_leaf, mb)
                if y.shape != x_in.shape or y.dtype != x_in.dtype:
                    raise ValueError(f"a pipeline stage maps {tuple(x_in.shape)} {x_in.dtype} "
                                     f"to {tuple(y.shape)} {y.dtype}: stages pass their "
                                     "input's shape and dtype on")
                saved[mb] = (x_leaf, y)
                if s < n_st - 1:
                    top.send(y.detach(), s + 1)
                else:
                    outs[mb] = y.detach()
        out = torch.stack(outs) if s == n_st - 1 else torch.empty_like(local)
        out = top.gather_rows(top.replicate_last(out))
        ctx.run, ctx.saved, ctx.leaves, ctx.m = run, saved, leaves, m
        ctx.xs_meta = (xs.shape, xs.dtype, xs.device, xs.requires_grad)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        run, top, saved, leaves = ctx.run, ctx.run.top, ctx.saved, ctx.leaves
        s, n_st, m = top.stage, top.n_stages, ctx.m
        shape, dtype, device, x_grad = ctx.xs_meta
        rows = shape[1] // top.n_data
        lo = top.data_index * rows
        grad_local = grad_out[:, lo:lo + rows]
        trained = [i for i, p in enumerate(leaves) if p.requires_grad]
        param_grads = [torch.zeros_like(leaves[i]) for i in trained]
        grad_x = torch.zeros((m, rows) + tuple(shape[2:]), dtype=dtype, device=device)
        for t in reversed(range(m + n_st - 1)):
            mb = t - s
            if not 0 <= mb < m:
                continue
            x_leaf, y = saved.pop(mb)
            g = grad_local[mb] if s == n_st - 1 else top.recv(y, s + 1)
            inputs = ([x_leaf] if x_leaf.requires_grad else []) + [leaves[i] for i in trained]
            grads = torch.autograd.grad(y, inputs, g.to(y.dtype), allow_unused=True)
            if x_leaf.requires_grad:
                gx, grads = grads[0], grads[1:]
                if s > 0:
                    top.send(gx.detach(), s - 1)
                else:
                    grad_x[mb] = gx
            for acc, gp in zip(param_grads, grads):
                if gp is not None:
                    acc.add_(gp)
        top.sum_data(param_grads)
        out_grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
        for i, gp in zip(trained, param_grads):
            out_grads[i] = gp
        grad_xs = None
        if x_grad:
            grad_xs = top.gather_rows(top.replicate_first(grad_x))
        return (None, grad_xs, *out_grads)


class _Run:
    """One call's stage: this process's layers over one microbatch."""

    def __init__(self, top: _Topology, layer_module, names: List[str], first_layer: int,
                 src_mask, pads, seed):
        self.top, self.layer_module, self.names = top, layer_module, names
        self.first_layer, self.src_mask, self.pads, self.seed = first_layer, src_mask, pads, seed

    def stage(self, leaves: List[torch.Tensor], x: torch.Tensor, mb: int) -> torch.Tensor:
        rows = self.pads.shape[1] // self.top.n_data
        lo = self.top.data_index * rows
        pad = self.pads[mb, lo:lo + rows]
        for j in range(leaves[0].shape[0]):
            layer = self.first_layer + j
            if self.seed is not None:
                gen = torch.Generator(device=x.device)
                gen.manual_seed(dropout_seed(self.seed, self.top.data_index, mb, layer))
                set_dropout_generator(self.layer_module, gen)
            x = functional_call(self.layer_module, {n: p[j] for n, p in zip(self.names, leaves)},
                                (x, self.src_mask, pad, None))
            # the template's weight caches are keyed by these slices' addresses
            _build.drop_cached_weights(self.layer_module)
        return x


def pipeline_layer_stack(layer_module, mesh, n_micro: int) -> Callable:
    """GPipe over a stack of structurally identical layers.

    `layer_module`: one layer whose forward is `(x, src_mask, pad_mask,
    pos_embs)` (a `BranchformerEncoderLayer`); its own parameter values
    are not used. Returns `fn(stacked_params, x [B, T, D], src_mask=None,
    pad_mask=None [B, T], seed=None) -> [B, T, D]`, where `stacked_params`
    maps each of the layer's parameter names to this stage's L/S layers
    stacked on a leading axis (`stacked_params(encoder, stage_of=mesh)`),
    so stage s holds layers [s·L/S, (s+1)·L/S). B must divide by
    `n_micro`, and each microbatch by the data axis. `seed` turns on
    training-mode dropout (`dropout_seed`); without it the layer runs in
    eval mode."""
    top = _Topology(mesh)

    def call(stacked_params: Dict[str, torch.Tensor], x: torch.Tensor,
             src_mask: Optional[torch.Tensor] = None, pad_mask: Optional[torch.Tensor] = None,
             seed: Optional[int] = None) -> torch.Tensor:
        names = list(stacked_params)
        stage = [stacked_params[n] for n in names]
        first = top.stage * stage[0].shape[0]
        micro_b = x.shape[0] // n_micro
        if x.shape[0] % n_micro == 0 and micro_b % top.n_data:
            raise ValueError(
                f"microbatch size {micro_b} not divisible by the data axis ({top.n_data}) — "
                f"choose n_micro so that batch/(n_micro*n_data) is integral")
        if pad_mask is None:
            pad_mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
        xs = _microbatch(x, n_micro)
        pads = _microbatch(pad_mask, n_micro)
        mode = layer_module.training
        layer_module.train(seed is not None)
        try:
            run = _Run(top, layer_module, names, first, src_mask, pads, seed)
            # a graph per microbatch only when a gradient is wanted
            run.keep_graph = torch.is_grad_enabled() and (
                xs.requires_grad or any(p.requires_grad for p in stage))
            out = _GPipe.apply(run, xs, *stage)
        finally:
            layer_module.train(mode)
        return out.reshape(x.shape)

    return call


def check_layers(n_layers: int, mesh) -> int:
    """The layers per stage of an `n_layers` stack on `mesh`'s pipe axis;
    `ValueError` unless the axis divides them."""
    n_stages = _Topology(mesh).n_stages
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by pipe axis {n_stages}")
    return n_layers // n_stages


def stacked_params(encoder, stage_of=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """`{"layers": {name: [L, ...]}, "norm": {...}}` from an encoder's
    `layer_{i}` and `norm` (the JAX `scan_layers=True` layout, in the
    port's names), stacked with autograd, so a gradient reaches each
    layer's parameters. With `stage_of` (a pipeline mesh) only this
    process's stage's layers are stacked, the form the pipeline takes;
    without it every layer (a one-stage pipeline's)."""
    n = encoder.num_layers
    layers = range(n)
    if stage_of is not None:
        per = check_layers(n, stage_of)
        first = _Topology(stage_of).stage * per
        layers = range(first, first + per)
    mods = [getattr(encoder, f"layer_{i}") for i in layers]
    names = [name for name, _ in mods[0].named_parameters()]
    per_layer = [dict(m.named_parameters()) for m in mods]
    return {"layers": {name: torch.stack([p[name] for p in per_layer]) for name in names},
            "norm": dict(encoder.norm.named_parameters())}


def pipeline_branchformer_encode(encoder, mesh, n_micro: int) -> Callable:
    """Pipeline the layer stack of a `BranchformerEncoder`; its final
    LayerNorm (eps 1e-6) runs replicated after the stack. Returns
    `fn(encoder_params, x [B, T, D], src_mask=None, pad_mask=None,
    seed=None) -> [B, T, D]` with `encoder_params` as
    `stacked_params(encoder, stage_of=mesh)` gives it. `ValueError` when
    the pipe axis does not divide the encoder's layers."""
    per = check_layers(encoder.num_layers, mesh)
    stack = pipeline_layer_stack(encoder.layer_0, mesh, n_micro)

    def call(encoder_params, x: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
             pad_mask: Optional[torch.Tensor] = None, seed: Optional[int] = None):
        held = next(iter(encoder_params["layers"].values())).shape[0]
        if held != per:
            raise ValueError(f"stacked parameters hold {held} layers, not this stage's {per}")
        y = stack(encoder_params["layers"], x, src_mask, pad_mask, seed=seed)
        return functional_call(encoder.norm, encoder_params["norm"], (y,))

    return call
