"""The whole Branchformer cgMLP branch: plain PyTorch version, weight
flattener and the CUDA kernel's wrapper, an autograd Function.

    h         = gelu_tanh(x·W_pre + b_pre)                    (D -> 2C)
    res, gate = h[..., :C], h[..., C:]
    gate      = LayerNorm(gate) · mask                         (fp32 stats)
    gate      = depthwise_conv(gate, K taps, zero outside [0, T)) + conv_b
    g         = dropout(res · gate)                            (optional keep-mask)
    out       = g·W_post + b_post                              (C -> D)

Source note (csrc/csgu.cu, on the product core of csrc/gemm_sm90.cuh):

- Replaces the TPU kernel `summarymixing_tpu/ops/pallas_csgu.py`,
  `_kernel` through `fused_convolution_branch`.
- Bound on the H100: operations. At the flagship shapes (B=8, T=751,
  D=512, 2C=3072, K=31) the two products are ≈ 28.3 GFLOP and the conv
  taps ≈ 0.6 GFLOP, against ≈ 17 MB that a fused kernel must move. The
  gate pass between the products is bound by bytes (≈ 55 MB through the
  bf16 scratches).
- Design: the Pallas kernel keeps a `[tile + 30, 3072]` fp32 block in
  VMEM, about 1.1 MB for a 64-frame tile, far beyond the 227 KB of shared
  memory a Hopper block has. So the branch runs in four launches: (1)
  `x·W_preᵀ + b_pre` with tanh-GELU in its epilogue, to a bf16 `[B, T, 2C]`
  scratch, on `wgmma` fed by TMA through an mbarrier ring, a persistent
  block per SM whose two warpgroups take 128×128 tiles in turn so one's
  epilogue overlaps the other's products, and whose results leave by TMA
  store; (2) LayerNorm statistics of each gate row in fp32, once per row;
  (3) a block per (128-frame tile, 64-channel tile, utterance) stages the
  normalised gate window in shared memory, zeroing rows that are padding
  or outside `[0, T)` (so they reach the conv as zero, not as the
  LayerNorm bias), runs the K-tap depthwise conv with the taps in
  registers, adds the bias and multiplies by `res`, to a bf16 `[B, T, C]`
  scratch, every device access a 16-byte vector; (4) the same product
  kernel for `·W_postᵀ + b_post`. The bf16 scratches round where the TPU
  kernel keeps fp32.
- Dropout: the flax CSGU drops `res·gate` before `post_channel_proj`
  (`convolution.py:103-104`); with a bool keep-mask `[B, T, C]` the gate
  pass divides the kept products by `keep_prob` and zeroes the others.
- Gradient: the Pallas kernel is forward-only and JAX differentiates the
  flax module. The autograd Function's backward here is the VJP of the
  plain version, recomputed from the saved inputs, the float32
  parameters and the keep-mask.

Matrices use `torch.nn.Linear`'s layout, `[out, in]`; the conv weight is
`[K, C]` with tap 0 reading frame t - (K-1)/2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from summarymixing_tpu_torch.ops import _build
from summarymixing_tpu_torch.ops.linear import gelu_tanh

KERNEL_SIZES = (15, 31)   # conv widths instantiated in csrc/csgu.cu
WIDTH_MULTIPLE = 128      # product tiles are 128 columns wide, TMA boxes 64 deep


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a · wᵀ with fp32 accumulation and an fp32 result (w is `[out, in]`)."""
    return torch.matmul(a.to(torch.float32), w.to(torch.float32).t())


def convolution_branch_reference(x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                                 weights: Tuple, eps: float = 1e-5,
                                 keep: Optional[torch.Tensor] = None,
                                 keep_prob: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel. x `[B, T, D]`; pad_mask `[B, T]`
    float, 1 = valid, or None; weights `(W_pre, b_pre, ln_scale, ln_bias,
    conv_w, conv_b, W_post, b_post)`; keep, optional, a bool `[B, T, C]`
    dropout keep-mask on `res·gate`, kept values divided by `keep_prob`."""
    w_pre, b_pre, ln_w, ln_b, conv_w, conv_b, w_post, b_post = weights
    f32 = torch.float32
    h = gelu_tanh(_mm(x, w_pre) + b_pre.to(f32))
    c = h.shape[-1] // 2
    res, gate = h[..., :c], h[..., c:]
    gate = F.layer_norm(gate, (c,), ln_w.to(f32), ln_b.to(f32), eps)
    if pad_mask is not None:
        gate = gate * pad_mask[..., None].to(f32)
    k = conv_w.shape[0]
    left = (k - 1) // 2
    gate = F.pad(gate.transpose(1, 2), (left, k - 1 - left))
    gate = F.conv1d(gate, conv_w.to(f32).t()[:, None, :], conv_b.to(f32), groups=c)
    o = res * gate.transpose(1, 2)
    if keep is not None:
        o = torch.where(keep, o / keep_prob, torch.zeros((), dtype=f32, device=o.device))
    return (_mm(o.to(x.dtype), w_post) + b_post.to(f32)).to(x.dtype)


def branch_weights(branch) -> Tuple:
    """Flatten a port `ConvolutionBranch` into its parameter tuple in the
    kernel's order: `(W_pre, b_pre, ln_scale, ln_bias, conv_w, conv_b,
    W_post, b_post)`."""
    csgu = branch.csgu
    return (branch.pre_channel_proj.weight, branch.pre_channel_proj.bias,
            csgu.norm.weight, csgu.norm.bias, csgu.conv_kernel, csgu.conv_bias,
            branch.post_channel_proj.weight, branch.post_channel_proj.bias)


def kernel_weights(weights: Tuple) -> Tuple:
    """The parameter tuple as the kernel takes it: the two matrices in
    bf16, the vectors and the conv in fp32. Differentiable."""
    w_pre, b_pre, ln_w, ln_b, conv_w, conv_b, w_post, b_post = weights
    bf, f32 = torch.bfloat16, torch.float32
    return (w_pre.to(bf), b_pre.to(f32), ln_w.to(f32), ln_b.to(f32), conv_w.to(f32),
            conv_b.to(f32), w_post.to(bf), b_post.to(f32))


def refusal(*, d: int, units: int, kernel_size: int, activation: str, dtype: torch.dtype,
            gate_activation: Optional[str] = None,
            use_linear_after_conv: bool = False) -> Optional[Tuple[type, str]]:
    """Why the kernel does not take a cgMLP branch of this configuration,
    as `(exception type, message)`, or None when it takes it: `d` the model
    width, `units` the pre-projection's width (2C), `kernel_size` the conv
    width. The one statement of the kernel's limits: `takes` and the
    launch's `_check` both read it."""
    if activation != "gelu" or gate_activation is not None or use_linear_after_conv:
        return NotImplementedError, (
            "the cgMLP kernel computes tanh-GELU with an identity gate and no linear after "
            f"the conv, not activation {activation!r}, gate {gate_activation!r}, linear "
            f"after conv {use_linear_after_conv}")
    if kernel_size not in KERNEL_SIZES:
        return NotImplementedError, (f"the cgMLP kernel is built for conv widths "
                                     f"{KERNEL_SIZES}, not {kernel_size}")
    if dtype != torch.bfloat16:
        return ValueError, f"the cgMLP kernel computes in bf16, not {dtype}"
    for name, width in (("D", d), ("C", units // 2)):
        if width % WIDTH_MULTIPLE:
            return ValueError, f"{name} width {width} is not a multiple of {WIDTH_MULTIPLE}"
    return None


def takes(**config) -> bool:
    """Whether the kernel takes a cgMLP branch of this configuration
    (`refusal`'s keywords). On the card a configuration it does not take
    runs the plain PyTorch path, counted by `count_plain_call`."""
    return refusal(**config) is None


def count_plain_call() -> None:
    """Count one call on a CUDA tensor that ran the plain path because the
    kernel does not take its configuration:
    `fused_convolution_branch.plain_calls`."""
    _counts.plain_calls += 1


def _check(x, pad_mask, weights, keep=None):
    if x.dim() != 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x must be a contiguous, 16-byte aligned bf16 [B, T, D] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, t, d = x.shape
    w_pre, b_pre, ln_w, ln_b, conv_w, conv_b, w_post, b_post = weights
    c2 = w_pre.shape[0]
    c = c2 // 2
    k = conv_w.shape[0]
    refused = refusal(d=d, units=c2, kernel_size=k, activation="gelu", dtype=x.dtype)
    if refused is not None:
        raise refused[0](refused[1])
    for name, w, shape in (("W_pre", w_pre, (c2, d)), ("W_post", w_post, (d, c))):
        if (w.dtype != torch.bfloat16 or tuple(w.shape) != shape or not w.is_contiguous()
                or w.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned bf16 {shape} "
                             f"matrix, got {w.dtype} {tuple(w.shape)}")
    for name, v, shape in (("b_pre", b_pre, (c2,)), ("ln_scale", ln_w, (c,)),
                           ("ln_bias", ln_b, (c,)), ("conv_w", conv_w, (k, c)),
                           ("conv_b", conv_b, (c,)), ("b_post", b_post, (d,))):
        if v.dtype != torch.float32 or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor, got "
                             f"{v.dtype} {tuple(v.shape)}")
    if pad_mask is not None and (pad_mask.dtype != torch.float32
                                 or tuple(pad_mask.shape) != (b, t)
                                 or not pad_mask.is_contiguous()
                                 or pad_mask.device != x.device):
        raise ValueError(f"pad_mask must be a contiguous float32 [B, T] tensor on x's "
                         f"device, got {pad_mask.dtype} {tuple(pad_mask.shape)} on "
                         f"{pad_mask.device}")
    if keep is not None and (keep.dtype != torch.bool or tuple(keep.shape) != (b, t, c)
                             or not keep.is_contiguous() or keep.device != x.device):
        raise ValueError(f"keep must be a contiguous bool [B, T, {c}] tensor on x's device, "
                         f"got {keep.dtype} {tuple(keep.shape)}")
    if any(v.device != x.device for v in weights):
        raise ValueError("weights and x must be on one device")
    return b, t, d, c2, k


@functools.cache
def _kernel():
    """The C entry point of csrc/csgu.cu, built and declared on first use."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.load_library("csgu").csgu_forward
    # x, mask, B, T, D, 2C, K, W_pre, b_pre, ln_w, ln_b, eps, conv_w, conv_b,
    # W_post, b_post, keep, 1 / keep_prob, h scratch, LayerNorm stats scratch,
    # gate scratch, out, stream
    fn.argtypes = [p, p] + [i] * 5 + [p] * 4 + [f] + [p] * 5 + [f] + [p] * 5
    fn.restype = ctypes.c_int
    return fn


def _launch(x, pad_mask, weights, eps, keep, keep_prob):
    """One launch of the kernel on `weights` in the layout `_check` takes."""
    b, t, d, c2, k = _check(x, pad_mask, weights, keep)
    if pad_mask is None:
        pad_mask = torch.ones(b, t, dtype=torch.float32, device=x.device)
    w_pre, b_pre, ln_w, ln_b, conv_w, conv_b, w_post, b_post = weights
    h = torch.empty(b, t, c2, dtype=x.dtype, device=x.device)
    stats = torch.empty(b * t, 2, dtype=torch.float32, device=x.device)
    g = torch.empty(b, t, c2 // 2, dtype=x.dtype, device=x.device)
    out = torch.empty(b, t, d, dtype=x.dtype, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), pad_mask.data_ptr(), b, t, d, c2, k,
                 w_pre.data_ptr(), b_pre.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), eps,
                 conv_w.data_ptr(), conv_b.data_ptr(), w_post.data_ptr(), b_post.data_ptr(),
                 None if keep is None else keep.data_ptr(), 1.0 / keep_prob,
                 h.data_ptr(), stats.data_ptr(), g.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cgMLP kernel launch failed with CUDA error {err}")
    _counts.launches += 1
    return out


class FusedConvolutionBranch(torch.autograd.Function):
    """Forward: one kernel launch. Backward: the VJP of the plain version,
    recomputed from the saved x, pad mask, keep-mask and `weights` (the
    parameters as the caller holds them), whose gradients come back in
    their own dtype."""

    @staticmethod
    def forward(ctx, x, pad_mask, keep, eps, keep_prob, launch_weights, *weights):
        if launch_weights is None:
            launch_weights = kernel_weights(weights)
        ctx.eps, ctx.keep_prob = eps, keep_prob
        ctx.save_for_backward(x, pad_mask, keep, *weights)
        return _launch(x, pad_mask, launch_weights, eps, keep, keep_prob)

    @staticmethod
    def backward(ctx, grad_out):
        x, pad_mask, keep, *weights = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[6:]
        _counts.backwards += 1
        with torch.enable_grad():
            xd = x.detach().requires_grad_(need_x)
            wd = [w.detach().requires_grad_(need) for w, need in zip(weights, need_w)]
            out = convolution_branch_reference(xd, pad_mask, kernel_weights(wd), ctx.eps,
                                               keep, ctx.keep_prob)
            inputs = [v for v in [xd] + wd if v.requires_grad]
            grads = iter(torch.autograd.grad(out, inputs, grad_out))
        gx = next(grads) if need_x else None
        return (gx, None, None, None, None, None,
                *(next(grads) if need else None for need in need_w))


def kernel_call(x, pad_mask, weights, eps, keep, keep_prob, launch_weights=None):
    """The CUDA side of `fused_convolution_branch`: the autograd Function when autograd
    records through `x` or a weight, else one bare launch."""
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights)):
        return FusedConvolutionBranch.apply(x, pad_mask, keep, eps, keep_prob, launch_weights,
                                            *weights)
    if launch_weights is None:
        launch_weights = kernel_weights(weights)
    return _launch(x, pad_mask, launch_weights, eps, keep, keep_prob)


def fused_convolution_branch(x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                             weights: Tuple, eps: float = 1e-5,
                             keep: Optional[torch.Tensor] = None, keep_prob: float = 1.0,
                             launch_weights: Optional[Tuple] = None) -> torch.Tensor:
    """The fused cgMLP branch. On a CPU tensor this is the plain version; on
    a CUDA tensor it launches the kernel or raises. `weights` may be in any
    float dtype: the launch takes `kernel_weights(weights)`, or
    `launch_weights` when the caller has them cached; when autograd
    records, the backward is the plain version's VJP.
    `fused_convolution_branch.launches` counts kernel launches,
    `fused_convolution_branch.backwards` the backward passes through them
    and `fused_convolution_branch.plain_calls` the branches on the card
    whose configuration the kernel does not take (`takes`)."""
    if x.device.type == "cpu":
        return convolution_branch_reference(x, pad_mask, weights, eps, keep, keep_prob)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return kernel_call(x, pad_mask, weights, eps, keep, keep_prob, launch_weights)


fused_convolution_branch.launches = 0
fused_convolution_branch.backwards = 0
fused_convolution_branch.plain_calls = 0
# the counters stay on the wrapper when a caller swaps the module attribute
_counts = fused_convolution_branch
