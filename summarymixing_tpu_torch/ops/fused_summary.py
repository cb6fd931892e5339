"""The fused SummaryMixing cell (full mode, nhead 1, one hidden layer per
branch): plain PyTorch version, weight flattener and the CUDA kernel's
wrapper.

    local  = act(act(x·W1 + b1)·W2 + b2) · pad
    summ   = act(act(x·S1 + c1)·S2 + c2) · pad
    pooled = Σ_t summ / max(Σ_t pad, 1)                (fp32)
    out    = act(local·M1 + pooled·M2 + mb)            (concat-free merge)

Source note (csrc/summary_mixing.cu):

- Replaces the TPU kernel `summarymixing_tpu/ops/pallas_summary.py`,
  `_kernel` through `_pallas_forward` / `fused_summary_mixing`. The plain
  version here is the counterpart of its `_jnp_reference`.
- Bound on the H100: operations. At the flagship shapes (B=8, T=751,
  all widths 512) the five products are 5·2·6008·512² ≈ 15.7 GFLOP against
  ≈ 15 MB of device traffic, far above the card's 295 FLOP/byte ridge.
- Design: on the TPU one grid step held a whole utterance in VMEM; on
  Hopper blocks run in parallel and cannot carry the time sum, so the
  kernel runs in three launches. (a) a block per (utterance, 64-frame
  tile) computes the summary branch with the hidden layer kept in shared
  memory and writes fp32 column sums per tile, with no atomics, so runs
  repeat bit for bit; (b) a block per utterance reduces those partials,
  divides by max(Σ pad, 1) and folds pooled·M2 + mb into an fp32 row bias;
  (c) a block per tile computes the local branch and the merge on chip
  and writes only the output. Every product is a bf16 WMMA tile with fp32
  accumulation computed in the kernel's body; intermediates are rounded
  to bf16 where the TPU kernel rounds them. The ragged T edge is masked in
  the kernel. The activation (erf or tanh GELU) is a template parameter.

Weights use `torch.nn.Linear`'s layout, `[out, in]`; M1 and M2 are the
column blocks of the merge layer's weight and may be strided views of it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from summarymixing_tpu_torch.ops import _build
from summarymixing_tpu_torch.ops.linear import get_activation

# activation name -> template id in csrc/summary_mixing.cu
KERNEL_ACTIVATIONS = {"gelu_exact": 1, "gelu": 2}
TILE = 64            # frames per block (BM in the source)
WIDTH_MULTIPLE = 128  # every width is walked in 128-column chunks
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a · wᵀ with fp32 accumulation and an fp32 result (w is `[out, in]`)."""
    return torch.matmul(a.to(torch.float32), w.to(torch.float32).t())


def summary_mixing_reference(x: torch.Tensor, pad: torch.Tensor, weights: Tuple,
                             activation: str = "gelu_exact") -> torch.Tensor:
    """Plain PyTorch version of the kernel. x `[B, T, D]`; pad `[B, T, 1]`
    float, 1 = valid; weights `(W1, b1, W2, b2, S1, c1, S2, c2, M1, M2, mb)`."""
    w1, b1, w2, b2, s1, c1, s2, c2, m1, m2, mb = weights
    act = get_activation(activation)
    f32 = torch.float32
    padf = pad.to(f32)
    h = act(_mm(x, s1) + c1.to(f32))
    summ = act(_mm(h.to(x.dtype), s2) + c2.to(f32)) * padf
    count = padf.sum(dim=1, keepdim=True).clamp_min(1.0)
    pooled = summ.sum(dim=1, keepdim=True) / count
    h = act(_mm(x, w1) + b1.to(f32))
    local = act(_mm(h.to(x.dtype), w2) + b2.to(f32)) * padf
    merged = _mm(local.to(x.dtype), m1) + _mm(pooled.to(x.dtype), m2) + mb.to(f32)
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


def _smem_bytes(d: int, hid: int, out: int) -> int:
    # Xs [64][max(D, OL)+8] + Hs [64][H+8] bf16, W tile [128][40] bf16,
    # fp32 chunk [64][132], pad [64]
    return (TILE * (max(d, out) + 8) * 2 + TILE * (hid + 8) * 2
            + 128 * 40 * 2 + TILE * 132 * 4 + TILE * 4)


def _check(x, pad, weights, activation):
    if activation not in KERNEL_ACTIVATIONS:
        raise NotImplementedError(
            f"the SummaryMixing kernel has activations {sorted(KERNEL_ACTIVATIONS)}, "
            f"not {activation!r}")
    if (x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"x must be a contiguous, 16-byte aligned bf16 [B, T, D] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, t, d = x.shape
    if (pad.dtype != torch.float32 or tuple(pad.shape) != (b, t, 1)
            or not pad.is_contiguous() or pad.device != x.device):
        raise ValueError(f"pad must be a contiguous float32 [B, T, 1] tensor on x's device, "
                         f"got {pad.dtype} {tuple(pad.shape)} on {pad.device}")
    w1, b1, w2, b2, s1, c1, s2, c2, m1, m2, mb = weights
    hl, ol, hs, os_, n = w1.shape[0], w2.shape[0], s1.shape[0], s2.shape[0], m1.shape[0]
    want = {"W1": (w1, (hl, d)), "W2": (w2, (ol, hl)), "S1": (s1, (hs, d)),
            "S2": (s2, (os_, hs)), "M1": (m1, (n, ol)), "M2": (m2, (n, os_))}
    for name, (w, shape) in want.items():
        if (w.dtype != torch.bfloat16 or tuple(w.shape) != shape or w.stride(1) != 1
                or w.stride(0) % 8 or w.data_ptr() % 16 or w.device != x.device):
            raise ValueError(f"{name} must be bf16 {shape} with unit column stride, a row "
                             f"stride that is a multiple of 8 and 16-byte alignment; got "
                             f"{w.dtype} {tuple(w.shape)} strides {w.stride()}")
    for name, v, size in (("b1", b1, hl), ("b2", b2, ol), ("c1", c1, hs),
                          ("c2", c2, os_), ("mb", mb, n)):
        if (v.dtype != torch.bfloat16 or tuple(v.shape) != (size,)
                or not v.is_contiguous() or v.device != x.device):
            raise ValueError(f"{name} must be a contiguous bf16 [{size}] vector")
    for name, width in (("D", d), ("local hidden", hl), ("local out", ol),
                        ("summary hidden", hs), ("summary out", os_), ("out", n)):
        if width % WIDTH_MULTIPLE:
            raise ValueError(f"{name} width {width} is not a multiple of {WIDTH_MULTIPLE}")
    smem = max(_smem_bytes(d, hs, 0), _smem_bytes(d, hl, ol))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"widths need {smem} bytes of shared memory per block, "
                         f"more than {_SMEM_LIMIT}")
    return b, t, d, hl, ol, hs, os_, n


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.sm_forward
    # x, pad, B, T, D, HL, OL, HS, OS, N, W1 b1 W2 b2 S1 c1 S2 c2 M1 M2,
    # ldM1, mb, ldM2, partial, bias, out, activation, stream
    fn.argtypes = [p, p] + [i] * 8 + [p] * 10 + [i, p, i] + [p] * 3 + [i, p]
    fn.restype = ctypes.c_int
    return fn


def fused_summary_mixing(x: torch.Tensor, pad: torch.Tensor, weights: Tuple,
                         activation: str = "gelu_exact") -> torch.Tensor:
    """The fused cell. On a CPU tensor this is the plain version; on a CUDA
    tensor it launches the kernel (bf16 `x` and weights, fp32 `pad`) or
    raises. `fused_summary_mixing.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return summary_mixing_reference(x, pad, weights, activation)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    b, t, d, hl, ol, hs, os_, n = _check(x, pad, weights, activation)
    w1, b1, w2, b2, s1, c1, s2, c2, m1, m2, mb = weights
    n_tiles = -(-t // TILE)
    partial = torch.empty(b, n_tiles, os_, dtype=torch.float32, device=x.device)
    bias = torch.empty(b, n, dtype=torch.float32, device=x.device)
    out = torch.empty(b, t, n, dtype=x.dtype, device=x.device)
    fn = _declare(_build.load_library("summary_mixing"))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), pad.data_ptr(), b, t, d, hl, ol, hs, os_, n,
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 s1.data_ptr(), c1.data_ptr(), s2.data_ptr(), c2.data_ptr(),
                 m1.data_ptr(), m2.data_ptr(), m1.stride(0), mb.data_ptr(), m2.stride(0),
                 partial.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 KERNEL_ACTIVATIONS[activation], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"SummaryMixing kernel launch failed with CUDA error {err}")
    fused_summary_mixing.launches += 1
    return out


fused_summary_mixing.launches = 0
