"""The fused SummaryMixing cell (full mode, nhead 1, one hidden layer per
branch): plain PyTorch version, weight flattener and the CUDA kernel's
wrapper, an autograd Function.

    local  = act(act(x·W1 + b1)·W2 + b2) · pad
    summ   = act(act(x·S1 + c1)·S2 + c2) · pad
    pooled = Σ_t summ / max(Σ_t pad, 1)                (fp32)
    cat    = dropout([local, pooled])                  (optional keep-mask)
    out    = act(cat·[M1; M2] + mb)                    (concat-free merge)

Source note (csrc/summary_mixing.cu):

- Replaces the TPU kernel `summarymixing_tpu/ops/pallas_summary.py`,
  `_kernel` through `_pallas_forward` / `fused_summary_mixing`. The plain
  version here is the counterpart of its `_jnp_reference`, with the flax
  cell's dropout on the concatenated features (`summary_mixing.py:306-307`)
  added.
- Bound on the H100: operations. At the flagship shapes (B=8, T=751,
  all widths 512) the five products over the 4129 valid frames are
  ≈ 10.8 GFLOP against ≈ 15 MB of device traffic, far above the card's
  295 FLOP/byte ridge.
- Design: on the TPU one grid step held a whole utterance in VMEM; on
  Hopper blocks run in parallel and cannot carry the time sum, so the
  kernel runs in three launches. (a) one launch over (64-frame tile,
  utterance, branch), 192 blocks at the flagship shape: each block
  chains its products on the `wgmma` + TMA core of csrc/gemm_sm90.cuh,
  keeping the activation tile in one swizzled shared-memory buffer that
  each epilogue rewrites. Summary blocks write fp32 column sums per tile,
  with no atomics, so runs repeat bit for bit; local blocks write the
  fp32 pre-activation `local·M1`. A tile with no valid frame computes
  no product. (b) a block per (utterance, 32 columns) reduces the
  partials in tile order, divides by max(Σ pad, 1) and folds
  pooled·M2 + mb into an fp32 row bias; (c) an elementwise pass applies
  `act(local·M1 + bias)`. Intermediates are rounded to bf16 where the
  TPU kernel rounds them. The ragged T edge is masked in the kernel. The
  activation (erf or tanh GELU) is a template parameter.
- Dropout: with a keep-mask over the concatenated `[B, T, OL + OS]`
  features the local half is masked in (a)'s epilogue before the M1
  product. The pooled half differs per frame, so the fold of (b) no
  longer holds: (b) keeps `pooled / keep_prob` and the bias `mb`, and one
  more launch on the same product core, (d) `pooled_pass`, builds each
  tile's masked pooled rows in shared memory and adds their product with
  M2 to the pre-activation of every frame before (c).
- Gradient: the autograd Function's backward is the vector-Jacobian
  product of the plain version, recomputed from the saved inputs, the
  float32 parameters and the keep-mask, as the JAX package defines the
  Pallas kernel's (`pallas_summary.py:153-156`).

Weights use `torch.nn.Linear`'s layout, `[out, in]`; M1 and M2 are the
column blocks of the merge layer's weight and may be strided views of it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from summarymixing_tpu_torch.ops import _build
from summarymixing_tpu_torch.ops.linear import get_activation

# activation name -> template id in csrc/summary_mixing.cu
KERNEL_ACTIVATIONS = {"gelu_exact": 1, "gelu": 2}
TILE = 64             # frames per block (kTile in the source)
WIDTH_MULTIPLE = 256  # products are walked in 256-column chunks (kChunk)
MAX_WIDTH = 512       # D and each branch's widths: a resident operand is [64, 512] bf16


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a · wᵀ with fp32 accumulation and an fp32 result (w is `[out, in]`)."""
    return torch.matmul(a.to(torch.float32), w.to(torch.float32).t())


def summary_mixing_reference(x: torch.Tensor, pad: torch.Tensor, weights: Tuple,
                             activation: str = "gelu_exact",
                             keep: Optional[torch.Tensor] = None,
                             keep_prob: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x `[B, T, D]`; pad `[B, T, 1]`
    float, 1 = valid; weights `(W1, b1, W2, b2, S1, c1, S2, c2, M1, M2, mb)`;
    keep, optional, a bool `[B, T, OL + OS]` dropout keep-mask over
    `[local, pooled]`, kept values divided by `keep_prob` in x's dtype."""
    w1, b1, w2, b2, s1, c1, s2, c2, m1, m2, mb = weights
    act = get_activation(activation)
    f32 = torch.float32
    padf = pad.to(f32)
    h = act(_mm(x, s1) + c1.to(f32))
    summ = act(_mm(h.to(x.dtype), s2) + c2.to(f32)) * padf
    count = padf.sum(dim=1, keepdim=True).clamp_min(1.0)
    pooled = (summ.sum(dim=1, keepdim=True) / count).to(x.dtype)
    h = act(_mm(x, w1) + b1.to(f32))
    local = (act(_mm(h.to(x.dtype), w2) + b2.to(f32)) * padf).to(x.dtype)
    if keep is None:
        merged = _mm(local, m1) + _mm(pooled, m2) + mb.to(f32)
    else:
        ol = local.shape[-1]
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        local = torch.where(keep[..., :ol], local / keep_prob, zero)
        pooled = torch.where(keep[..., ol:], pooled / keep_prob, zero)
        merged = _mm(local, m1) + _mm(pooled, m2) + mb.to(f32)
    return act(merged).to(x.dtype)


def params_to_weights(cell) -> Tuple:
    """Flatten a port `SummaryMixing` cell (full mode, nhead 1, one hidden
    layer per branch) into the kernel's weight tuple: the cell's own
    parameters, M1 and M2 as views of the merge weight."""
    lp0, lp1 = cell.local_proj.layers()
    sp0, sp1 = cell.summary_proj.layers()
    (mg,) = cell.summary_local_merging.layers()
    local_out = lp1.weight.shape[0]
    return (lp0.weight, lp0.bias, lp1.weight, lp1.bias,
            sp0.weight, sp0.bias, sp1.weight, sp1.bias,
            mg.weight[:, :local_out], mg.weight[:, local_out:], mg.bias)


def kernel_weights(weights: Tuple) -> Tuple:
    """The weight tuple as the kernel takes it: every tensor in bf16 (M1
    and M2 each a contiguous cast). Differentiable."""
    return tuple(w.to(torch.bfloat16) for w in weights)


def refusal(*, d: int, local_dims: Sequence[int], summary_dims: Sequence[int], n: int,
            activation: str, dtype: torch.dtype, mode: str = "SummaryMixing",
            sum_mask: bool = False, nhead: int = 1,
            keep: bool = False) -> Optional[Tuple[type, str]]:
    """Why the kernel does not take a cell of this configuration, as
    `(exception type, message)`, or None when it takes it. `local_dims` and
    `summary_dims` are each branch's widths, hidden layers then output; `n`
    the merge's output width; `keep` whether a dropout keep-mask comes with
    the launch (the cell decides its route without it, so a configuration
    taken in evaluation is taken in training, where `_check` raises for a
    keep-mask wider than the kernel holds). The one statement of the
    kernel's limits: `takes` and the launch's `_check` both read it."""
    if mode != "SummaryMixing" or sum_mask or nhead != 1:
        return NotImplementedError, (
            f"the SummaryMixing kernel computes full mode with no sum_mask at nhead 1, not "
            f"mode {mode!r}, sum_mask {sum_mask}, nhead {nhead}")
    if len(local_dims) != 2 or len(summary_dims) != 2:
        return NotImplementedError, (
            "the SummaryMixing kernel has one hidden layer per branch, not "
            f"{len(local_dims) - 1} and {len(summary_dims) - 1}")
    if activation not in KERNEL_ACTIVATIONS:
        return NotImplementedError, (
            f"the SummaryMixing kernel has activations {sorted(KERNEL_ACTIVATIONS)}, "
            f"not {activation!r}")
    if dtype != torch.bfloat16:
        return ValueError, f"the SummaryMixing kernel computes in bf16, not {dtype}"
    (hl, ol), (hs, os_) = local_dims, summary_dims
    for name, width in (("D", d), ("local hidden", hl), ("local out", ol),
                        ("summary hidden", hs), ("summary out", os_), ("out", n)):
        if width % WIDTH_MULTIPLE:
            return ValueError, f"{name} width {width} is not a multiple of {WIDTH_MULTIPLE}"
    for name, width in (("D", d), ("local hidden", hl), ("local out", ol),
                        ("summary hidden", hs)):
        if width > MAX_WIDTH:
            return ValueError, (f"{name} width {width} is wider than the {MAX_WIDTH} columns "
                                "a block keeps in shared memory")
    if keep and os_ > MAX_WIDTH:
        return ValueError, (f"with a keep-mask the summary out width {os_} must be at most "
                            f"{MAX_WIDTH}: the masked pooled rows stay in shared memory")
    return None


def takes(**config) -> bool:
    """Whether the kernel takes a cell of this configuration (`refusal`'s
    keywords). On the card a configuration it does not take runs the plain
    PyTorch path, counted by `count_plain_call`."""
    return refusal(**config) is None


def count_plain_call() -> None:
    """Count one call on a CUDA tensor that ran the plain path because the
    kernel does not take its configuration: `fused_summary_mixing.plain_calls`."""
    _counts.plain_calls += 1


def _check(x, pad, weights, activation, keep=None):
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x must be a contiguous, 16-byte aligned bf16 [B, T, D] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, t, d = x.shape
    if (pad.dtype != torch.float32 or tuple(pad.shape) != (b, t, 1)
            or not pad.is_contiguous() or pad.device != x.device):
        raise ValueError(f"pad must be a contiguous float32 [B, T, 1] tensor on x's device, "
                         f"got {pad.dtype} {tuple(pad.shape)} on {pad.device}")
    w1, b1, w2, b2, s1, c1, s2, c2, m1, m2, mb = weights
    hl, ol, hs, os_, n = w1.shape[0], w2.shape[0], s1.shape[0], s2.shape[0], m1.shape[0]
    refused = refusal(d=d, local_dims=(hl, ol), summary_dims=(hs, os_), n=n,
                      activation=activation, dtype=x.dtype, keep=keep is not None)
    if refused is not None:
        raise refused[0](refused[1])
    want = {"W1": (w1, (hl, d)), "W2": (w2, (ol, hl)), "S1": (s1, (hs, d)),
            "S2": (s2, (os_, hs)), "M1": (m1, (n, ol)), "M2": (m2, (n, os_))}
    for name, (w, shape) in want.items():
        if (w.dtype != torch.bfloat16 or tuple(w.shape) != shape or w.stride(1) != 1
                or w.stride(0) % 8 or w.data_ptr() % 16 or w.device != x.device):
            # TMA reads each matrix by tensor map: 16-byte aligned base and row stride
            raise ValueError(f"{name} must be bf16 {shape} with unit column stride, a row "
                             f"stride that is a multiple of 8 and 16-byte alignment; got "
                             f"{w.dtype} {tuple(w.shape)} strides {w.stride()}")
    for name, v, size in (("b1", b1, hl), ("b2", b2, ol), ("c1", c1, hs),
                          ("c2", c2, os_), ("mb", mb, n)):
        if (v.dtype != torch.bfloat16 or tuple(v.shape) != (size,)
                or not v.is_contiguous() or v.device != x.device):
            raise ValueError(f"{name} must be a contiguous bf16 [{size}] vector")
    if keep is not None and (keep.dtype != torch.bool or tuple(keep.shape) != (b, t, ol + os_)
                             or not keep.is_contiguous() or keep.device != x.device):
        raise ValueError(f"keep must be a contiguous bool [B, T, {ol + os_}] tensor on x's "
                         f"device, got {keep.dtype} {tuple(keep.shape)}")
    return b, t, d, hl, ol, hs, os_, n


@functools.cache
def _kernel():
    """The C entry point of csrc/summary_mixing.cu, built and declared on first use."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.load_library("summary_mixing").sm_forward
    # x, pad, B, T, D, HL, OL, HS, OS, N, W1 b1 W2 b2 S1 c1 S2 c2 M1 M2,
    # ldM1, mb, ldM2, keep, 1 / keep_prob, partial, bias, pooled, pre, out, activation, stream
    fn.argtypes = [p, p] + [i] * 8 + [p] * 10 + [i, p, i, p, f] + [p] * 5 + [i, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, pad, weights, activation, keep, keep_prob):
    """One launch of the kernel on bf16 `weights` (the layout `_check` takes)."""
    b, t, d, hl, ol, hs, os_, n = _check(x, pad, weights, activation, keep)
    w1, b1, w2, b2, s1, c1, s2, c2, m1, m2, mb = weights
    n_tiles = -(-t // TILE)
    partial = torch.empty(b, n_tiles, os_, dtype=torch.float32, device=x.device)
    bias = torch.empty(b, n, dtype=torch.float32, device=x.device)
    pooled = torch.empty(b, os_, dtype=x.dtype, device=x.device)
    pre = torch.empty(b, t, n, dtype=torch.float32, device=x.device)
    out = torch.empty(b, t, n, dtype=x.dtype, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), pad.data_ptr(), b, t, d, hl, ol, hs, os_, n,
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 s1.data_ptr(), c1.data_ptr(), s2.data_ptr(), c2.data_ptr(),
                 m1.data_ptr(), m2.data_ptr(), m1.stride(0), mb.data_ptr(), m2.stride(0),
                 None if keep is None else keep.data_ptr(), 1.0 / keep_prob,
                 partial.data_ptr(), bias.data_ptr(), pooled.data_ptr(), pre.data_ptr(),
                 out.data_ptr(), KERNEL_ACTIVATIONS[activation],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"SummaryMixing kernel launch failed with CUDA error {err}")
    _counts.launches += 1
    return out


class FusedSummaryMixing(torch.autograd.Function):
    """Forward: one kernel launch. Backward: the VJP of the plain version,
    recomputed from the saved x, pad, keep-mask and `weights` (the
    parameters as the caller holds them, float32 in training), whose
    gradients come back in their own dtype."""

    @staticmethod
    def forward(ctx, x, pad, keep, activation, keep_prob, launch_weights, *weights):
        if launch_weights is None:
            launch_weights = kernel_weights(weights)
        ctx.activation, ctx.keep_prob = activation, keep_prob
        ctx.save_for_backward(x, pad, keep, *weights)
        return _launch(x, pad, launch_weights, activation, keep, keep_prob)

    @staticmethod
    def backward(ctx, grad_out):
        x, pad, keep, *weights = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[6:]
        _counts.backwards += 1
        with torch.enable_grad():
            xd = x.detach().requires_grad_(need_x)
            wd = [w.detach().requires_grad_(need) for w, need in zip(weights, need_w)]
            out = summary_mixing_reference(xd, pad, kernel_weights(wd), ctx.activation,
                                           keep, ctx.keep_prob)
            inputs = [v for v in [xd] + wd if v.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, grad_out))
        gx = next(grads) if need_x else None
        return (gx, None, None, None, None, None,
                *(next(grads) if need else None for need in need_w))


def kernel_call(x, pad, weights, activation, keep, keep_prob, launch_weights=None):
    """The CUDA side of `fused_summary_mixing`: the autograd Function when autograd
    records through `x` or a weight, else one bare launch."""
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights)):
        return FusedSummaryMixing.apply(x, pad, keep, activation, keep_prob, launch_weights,
                                        *weights)
    if launch_weights is None:
        launch_weights = kernel_weights(weights)
    return _launch(x, pad, launch_weights, activation, keep, keep_prob)


def fused_summary_mixing(x: torch.Tensor, pad: torch.Tensor, weights: Tuple,
                         activation: str = "gelu_exact", keep: Optional[torch.Tensor] = None,
                         keep_prob: float = 1.0,
                         launch_weights: Optional[Tuple] = None) -> torch.Tensor:
    """The fused cell. On a CPU tensor this is the plain version; on a CUDA
    tensor it launches the kernel (bf16 `x`, fp32 `pad`, optional bool
    keep-mask) or raises. `weights` may be in any float dtype: the launch
    takes their bf16 casts, or `launch_weights` when the caller has them
    cached; when autograd records, the backward is the plain version's
    VJP and returns gradients for `x` and `weights`.
    `fused_summary_mixing.launches` counts kernel launches,
    `fused_summary_mixing.backwards` the backward passes through them and
    `fused_summary_mixing.plain_calls` the cells on the card whose
    configuration the kernel does not take (`takes`)."""
    if x.device.type == "cpu":
        return summary_mixing_reference(x, pad, weights, activation, keep, keep_prob)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return kernel_call(x, pad, weights, activation, keep, keep_prob, launch_weights)


fused_summary_mixing.launches = 0
fused_summary_mixing.backwards = 0
fused_summary_mixing.plain_calls = 0
# the counters stay on the wrapper when a caller swaps the module attribute
_counts = fused_summary_mixing
