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
  flax module in bf16. Here the backward is a kernel too (`csgu_backward`),
  which replaces the float32 recompute and autograd VJP of the plain
  version that the port ran before. A forward that autograd records runs
  the training op `summarymixing_torch::convolution_branch_train`, the same
  launch with its bf16 `h`, LayerNorm statistics and bf16 `g` kept (about
  125 MB a layer at 13,500 rows); the inference op and its launch are
  unchanged. Bound: the four products and the bf16 recompute of
  `x·W_preᵀ` (≈ 12.6 MFLOP a row, ≈ 171 GFLOP a layer at 13,600 rows)
  by operations, the gate pass's VJP between them by bytes. Design: every
  product on the `wgmma` core (TMA, mbarrier ring), the weight gradients
  reading their token-major operands MN-major (no transposed copy), cut
  over token ranges whose fp32 partial sums are added in order; the
  recompute's epilogue turns dh into dz = dh·gelu'(z) in place, so z is
  never stored; one gate pass per (frame tile, channel tile, utterance)
  recomputes the conv, runs its transposed conv and weight sums with the
  taps in registers and writes dh's res half and LayerNorm's fp32 dxhat,
  and a row pass finishes LayerNorm's backward, which needs sums over all
  C. Products take bf16 operands with fp32 accumulators; the one new
  rounding is dh and dz to bf16 before the products that read them; every
  reduction is fp32, in a fixed order, without atomics, so two runs give
  the same bits. Gradients come back in each parameter's own dtype; only
  those `ctx.needs_input_grad` asks for are computed. The backward takes
  what `refusal` lets the forward take (it checks through `_check`).
- Launch: through the registered op `summarymixing_torch::convolution_branch`
  (`convolution_branch_op`), whose CUDA implementation is the `ctypes`
  launch and whose fake implementation gives the output's shape, so a
  model on the card exports with `torch.export`.

Matrices use `torch.nn.Linear`'s layout, `[out, in]`; the conv weight is
`[K, C]` with tap 0 reading frame t - (K-1)/2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from summarymixing_tpu_torch.ops import _build, time_shard
from summarymixing_tpu_torch.ops.linear import gelu_tanh
from summarymixing_tpu_torch.training.profiling import span

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
    _, o = _reference_parts(x, pad_mask, weights, eps, keep, keep_prob)
    w_post, b_post = weights[6:]
    return (_mm(o.to(x.dtype), w_post) + b_post.to(torch.float32)).to(x.dtype)


def _reference_parts(x, pad_mask, weights, eps, keep, keep_prob):
    """The plain version's `h` `[B, T, 2C]` and gated product `[B, T, C]`, float32."""
    w_pre, b_pre, ln_w, ln_b, conv_w, conv_b = weights[:6]
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
    return h, o


def gelu_tanh_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz of `gelu_tanh`."""
    k, a = 0.7978845608028654, 0.044715
    t = torch.tanh(k * (z + a * z ** 3))
    return 0.5 * (1 + t) + 0.5 * z * (1 - t * t) * k * (1 + 3 * a * z * z)


def _shift(v: torch.Tensor, s: int) -> torch.Tensor:
    """`out[:, t] = v[:, t + s]`, 0 where t + s is outside [0, T)."""
    t = v.shape[1]
    out = torch.zeros_like(v)
    if abs(s) < t:
        out[:, max(0, -s):t - max(0, s)] = v[:, max(0, s):t - max(0, -s)]
    return out


def convolution_branch_backward_reference(grad_out: torch.Tensor, x: torch.Tensor,
                                          pad_mask: Optional[torch.Tensor], weights: Tuple,
                                          eps: float = 1e-5, keep: Optional[torch.Tensor] = None,
                                          keep_prob: float = 1.0,
                                          needs: Optional[Tuple[bool, ...]] = None) -> Tuple:
    """Plain PyTorch version of the kernel's backward: the gradients of x
    and of the eight weights (`convolution_branch_reference`'s arguments)
    given `grad_out`, float32 arithmetic with the kernel's rounding points,
    each a cast to x's dtype: `h` (the forward's scratch), g, dh (both
    halves) and dz = dh·gelu'(z), z recomputed. With float32 x they round
    nothing and this is the VJP of `convolution_branch_reference`. `needs`
    (9 bools, x then the weights) picks the gradients computed, None for
    the others; x's comes back in x's dtype, the weights' in float32."""
    needs = needs or (True,) * 9
    need_x, n_wpre, n_bpre, n_lnw, n_lnb, n_cw, n_cb, n_wpost, n_bpost = needs
    f32, rd = torch.float32, x.dtype
    w_pre, b_pre, ln_w, ln_b, conv_w, conv_b, w_post, b_post = (w.to(f32) for w in weights)
    xf = x.to(f32)
    z = xf @ w_pre.t() + b_pre
    h = gelu_tanh(z).to(rd).to(f32)
    c = h.shape[-1] // 2
    res, gt = h[..., :c], h[..., c:]
    mu = gt.mean(-1, keepdim=True)
    rstd = torch.rsqrt((gt - mu).pow(2).mean(-1, keepdim=True) + eps)
    xhat = (gt - mu) * rstd
    m = torch.ones_like(mu) if pad_mask is None else pad_mask[..., None].to(f32)
    nm = (xhat * ln_w + ln_b) * m
    k = conv_w.shape[0]
    left = (k - 1) // 2
    y = conv_b + sum(conv_w[i] * _shift(nm, i - left) for i in range(k))
    zero = torch.zeros((), dtype=f32, device=x.device)

    def drop(v):
        return v if keep is None else torch.where(keep, v / keep_prob, zero)
    def flat(v):
        return v.reshape(-1, v.shape[-1])
    go = grad_out.to(f32)
    dw_post = flat(go).t() @ flat(drop(res * y).to(rd).to(f32)) if n_wpost else None
    db_post = go.sum((0, 1)) if n_bpost else None
    grads = dict.fromkeys(("x", "w_pre", "b_pre", "ln_w", "ln_b", "conv_w", "conv_b"))
    if any(needs[:7]):
        do = drop(go @ w_post)
        dy = do * res
        grads["conv_b"] = dy.sum((0, 1)) if n_cb else None
        grads["conv_w"] = (torch.stack([(dy * _shift(nm, i - left)).sum((0, 1)) for i in range(k)])
                           if n_cw else None)
        dn = sum(conv_w[i] * _shift(dy, left - i) for i in range(k)) * m
        grads["ln_b"] = dn.sum((0, 1)) if n_lnb else None
        grads["ln_w"] = (dn * xhat).sum((0, 1)) if n_lnw else None
        dxh = dn * ln_w
        dgt = rstd * (dxh - dxh.mean(-1, keepdim=True)
                      - xhat * (dxh * xhat).mean(-1, keepdim=True))
        dh = torch.cat([do * y, dgt], -1).to(rd).to(f32)
        dz = (dh * gelu_tanh_grad(z)).to(rd).to(f32)
        grads["x"] = (dz @ w_pre).to(rd) if need_x else None
        grads["w_pre"] = flat(dz).t() @ flat(xf) if n_wpre else None
        grads["b_pre"] = dz.sum((0, 1)) if n_bpre else None
    return (*grads.values(), dw_post, db_post)


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
            gate_activation: Optional[str] = None, use_linear_after_conv: bool = False,
            act_int8: bool = False) -> Optional[Tuple[type, str]]:
    """Why the kernel does not take a cgMLP branch of this configuration,
    as `(exception type, message)`, or None when it takes it: `d` the model
    width, `units` the pre-projection's width (2C), `kernel_size` the conv
    width. The one statement of the kernel's limits: `takes` and the
    launch's `_check` both read it. `act_int8` (W8A8 projections) is
    refused: the kernel's products are bf16."""
    if act_int8:
        return NotImplementedError, ("the cgMLP kernel's products are bf16, not W8A8: an "
                                     "act_int8 branch runs its own route (ops/quant.py)")
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


def count_int8_call() -> None:
    """Count one cgMLP branch run on the W8A8 route (`act_int8`, on any
    device): `fused_convolution_branch.int8_calls`, neither a launch of
    the kernel nor a plain call."""
    _counts.int8_calls += 1


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


@functools.cache
def _backward_kernel():
    """The backward's C entry point of csrc/csgu.cu, built and declared on first use."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _build.load_library("csgu").csgu_backward
    # dOut, x, h, stats, g, mask, keep, 1 / keep_prob, B, T, D, 2C, K, W_pre,
    # b_pre, ln_w, ln_b, conv_w, conv_b, W_post, need, split_post, split_pre,
    # 7 scratches, 6 outputs, stream
    fn.argtypes = [p] * 7 + [f] + [i] * 5 + [p] * 7 + [i] * 3 + [p] * 14
    fn.restype = ctypes.c_int
    return fn


def _launch(x, pad_mask, weights, eps, keep, keep_prob, keep_scratch=False):
    """One launch of the kernel on `weights` in the layout `_check` takes:
    the output, or with `keep_scratch` also what the backward reads, the
    bf16 `h` `[B, T, 2C]`, the gate rows' LayerNorm statistics `[B·T, 2]`
    and the bf16 gated product `g` `[B, T, C]`."""
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
    if time_shard.current() is not None:
        # a time-sharded encode: the shard's frames and their halos
        _counts.halo_launches += 1
    return (out, h, stats, g) if keep_scratch else out


_WGRAD_ITEMS = 264   # a weight gradient's (tile, token range) items: two per SM of an H100


def _wgrad_splits(rows: int, cols: int, m: int) -> int:
    """Token ranges a `[rows, cols]` weight gradient over `m` tokens is cut
    into: enough 128 x 128 tiles for `_WGRAD_ITEMS`, at least 8 stages of 64
    tokens each. A function of the shapes alone, so the same inputs give
    the same sums."""
    tiles = (rows // 128) * (cols // 128)
    stages = -(-m // 64)
    return max(1, min(-(-_WGRAD_ITEMS // tiles), stages // 8))


def _launch_backward(grad_out, x, pad_mask, keep, keep_prob, weights, kept, needs):
    """The backward's launches on what the training launch kept (`h`,
    `stats`, `g`): the gradients of x and of each of `weights` (the launch
    layout, `_check`'s) whose `needs` entry is set, fp32 for the weights,
    None for the others."""
    b, t, d, c2, k = _check(x, pad_mask, weights, keep)
    c, m, dev = c2 // 2, b * t, x.device
    grad_out = grad_out.contiguous()
    if grad_out.dtype != x.dtype or tuple(grad_out.shape) != (b, t, d):
        raise ValueError(f"grad_out must be a {x.dtype} [B, T, D] tensor, got "
                         f"{grad_out.dtype} {tuple(grad_out.shape)}")
    if pad_mask is None:
        pad_mask = torch.ones(b, t, dtype=torch.float32, device=dev)
    h, stats, g = kept
    w_pre, b_pre, ln_w, ln_b, conv_w, conv_b, w_post, b_post = weights
    need_x, n_wpre, n_bpre, n_lnw, n_lnb, n_cw, n_cb, n_wpost, n_bpost = needs
    need = (need_x | n_wpre << 1 | n_bpre << 2 | (n_lnw or n_lnb or n_cw or n_cb) << 3
            | n_wpost << 4 | n_bpost << 5)
    split_post, split_pre = _wgrad_splits(d, c, m), _wgrad_splits(c2, d, m)
    f32 = torch.float32

    def empty(*shape, dtype=f32):
        return torch.empty(*shape, dtype=dtype, device=dev)
    upstream = need & 15
    dg = empty(m, c) if upstream else None
    dxhat = empty(m, c) if upstream else None
    dh = empty(m, c2, dtype=x.dtype) if upstream else None
    rowpart = empty(m, c // 64, 2) if upstream else None
    gparts = empty(b * -(-t // 128), k + 3, c) if upstream else None
    wparts = empty(max(split_post * d * c, split_pre * c2 * d)) if need & 18 else None
    cparts = empty(-(-m // 128), c2) if need & 36 else None
    dx = empty(b, t, d, dtype=x.dtype) if need_x else None
    dw_pre = empty(c2, d) if n_wpre else None
    db_pre = empty(c2) if n_bpre else None
    dgate = empty(k + 3, c) if need & 8 else None
    dw_post = empty(d, c) if n_wpost else None
    db_post = empty(d) if n_bpost else None

    def ptr(v):
        return None if v is None else v.data_ptr()
    with torch.cuda.device(dev):
        err = _backward_kernel()(
            grad_out.data_ptr(), x.data_ptr(), h.data_ptr(), stats.data_ptr(), g.data_ptr(),
            pad_mask.data_ptr(), ptr(keep), 1.0 / keep_prob, b, t, d, c2, k,
            w_pre.data_ptr(), b_pre.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
            conv_w.data_ptr(), conv_b.data_ptr(), w_post.data_ptr(), need, split_post, split_pre,
            *map(ptr, (dg, dxhat, dh, rowpart, gparts, wparts, cparts, dx, dw_pre, db_pre, dgate,
                       dw_post, db_post)),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cgMLP backward launch failed with CUDA error {err}")
    _counts.backward_launches += 1
    gate = (None,) * 4 if dgate is None else (dgate[k + 1], dgate[k + 2], dgate[:k], dgate[k])
    return (dx, dw_pre, db_pre, *(v if need_v else None for v, need_v in
                                  zip(gate, (n_lnw, n_lnb, n_cw, n_cb))), dw_post, db_post)


@torch.library.custom_op(f"{_build.OP_NAMESPACE}::convolution_branch", mutates_args=(),
                         device_types="cpu")
def convolution_branch_op(x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                          weights: List[torch.Tensor], eps: float, keep: Optional[torch.Tensor],
                          keep_prob: float) -> torch.Tensor:
    """The kernel as a registered op, `summarymixing_torch::convolution_branch`:
    every launch goes through it, so `torch.export` records it in a graph.
    On the card one launch on `weights` in the layout `_check` takes; on
    the CPU the plain version, for `torch.library.opcheck`."""
    return convolution_branch_reference(x, pad_mask, tuple(weights), eps, keep, keep_prob)


@convolution_branch_op.register_kernel("cuda")
def _convolution_branch_cuda(x, pad_mask, weights, eps, keep, keep_prob):
    return _launch(x, pad_mask, weights, eps, keep, keep_prob)


@convolution_branch_op.register_fake
def _convolution_branch_fake(x, pad_mask, weights, eps, keep, keep_prob):
    # shape and dtype only: no guard on B or T
    return torch.empty_like(x)


@torch.library.custom_op(f"{_build.OP_NAMESPACE}::convolution_branch_train", mutates_args=(),
                         device_types="cpu")
def convolution_branch_train_op(x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                                weights: List[torch.Tensor], eps: float,
                                keep: Optional[torch.Tensor], keep_prob: float
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`convolution_branch_op` for a forward that autograd records,
    `summarymixing_torch::convolution_branch_train`: the output and what
    the backward reads, the bf16 `h` `[B, T, 2C]`, the gate rows' LayerNorm
    (mean, rstd) `[B·T, 2]` and the bf16 `g` `[B, T, C]`. On the card the
    same one launch, its scratches kept; on the CPU the plain version's."""
    h, o = _reference_parts(x, pad_mask, weights, eps, keep, keep_prob)
    h = h.to(x.dtype)
    gate = h[..., h.shape[-1] // 2:].to(torch.float32)   # the kernel's statistics read bf16 h
    stats = torch.stack([gate.mean(-1), torch.rsqrt(gate.var(-1, unbiased=False) + eps)], -1)
    return (convolution_branch_reference(x, pad_mask, tuple(weights), eps, keep, keep_prob),
            h, stats.reshape(-1, 2), o.to(x.dtype))


@convolution_branch_train_op.register_kernel("cuda")
def _convolution_branch_train_cuda(x, pad_mask, weights, eps, keep, keep_prob):
    return _launch(x, pad_mask, weights, eps, keep, keep_prob, keep_scratch=True)


@convolution_branch_train_op.register_fake
def _convolution_branch_train_fake(x, pad_mask, weights, eps, keep, keep_prob):
    b, t, _ = x.shape
    c2 = weights[0].shape[0]
    return (torch.empty_like(x), x.new_empty(b, t, c2), x.new_empty(b * t, 2, dtype=torch.float32),
            x.new_empty(b, t, c2 // 2))


class FusedConvolutionBranch(torch.autograd.Function):
    """Forward: one kernel launch, which on the card keeps `h`, the
    LayerNorm statistics and `g` for the backward
    (`convolution_branch_train_op`). Backward: on the card the backward's
    launches (`_launch_backward`), on the CPU its plain version
    (`convolution_branch_backward_reference`), both on the launch weights,
    inside the span `train.cgmlp_backward`; each weight's gradient comes
    back in the dtype of the parameter the caller passed."""

    @staticmethod
    def forward(ctx, x, pad_mask, keep, eps, keep_prob, launch_weights, *weights):
        if launch_weights is None:
            launch_weights = kernel_weights(weights)
        ctx.eps, ctx.keep_prob = eps, keep_prob
        ctx.dtypes = [w.dtype for w in weights]
        kept = ()
        if x.device.type == "cuda":
            out, *kept = convolution_branch_train_op(x, pad_mask, list(launch_weights), eps, keep,
                                                     keep_prob)
        else:
            out = convolution_branch_op(x, pad_mask, list(launch_weights), eps, keep, keep_prob)
        ctx.save_for_backward(x, pad_mask, keep, *launch_weights, *kept)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, pad_mask, keep, *saved = ctx.saved_tensors
        weights, kept = tuple(saved[:8]), saved[8:]
        needs = (ctx.needs_input_grad[0], *ctx.needs_input_grad[6:])
        _counts.backwards += 1
        with span("train.cgmlp_backward"):
            if x.device.type == "cuda":
                grads = _launch_backward(grad_out, x, pad_mask, keep, ctx.keep_prob, weights,
                                         kept, needs)
            else:
                grads = convolution_branch_backward_reference(
                    grad_out, x, pad_mask, weights, ctx.eps, keep, ctx.keep_prob, needs)
        gx, *gw = grads
        return (gx, None, None, None, None, None,
                *(None if v is None else v.to(dt) for v, dt in zip(gw, ctx.dtypes)))


def kernel_call(x, pad_mask, weights, eps, keep, keep_prob, launch_weights=None):
    """The CUDA side of `fused_convolution_branch`: the autograd Function when autograd
    records through `x` or a weight, else one bare launch."""
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights)):
        return FusedConvolutionBranch.apply(x, pad_mask, keep, eps, keep_prob, launch_weights,
                                            *weights)
    if launch_weights is None:
        launch_weights = kernel_weights(weights)
    return convolution_branch_op(x, pad_mask, list(launch_weights), eps, keep, keep_prob)


def fused_convolution_branch(x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                             weights: Tuple, eps: float = 1e-5,
                             keep: Optional[torch.Tensor] = None, keep_prob: float = 1.0,
                             launch_weights: Optional[Tuple] = None) -> torch.Tensor:
    """The fused cgMLP branch. On a CPU tensor this is the plain version; on
    a CUDA tensor it launches the kernel or raises. `weights` may be in any
    float dtype: the launch takes `kernel_weights(weights)`, or
    `launch_weights` when the caller has them cached; when autograd
    records, the backward is the kernel's on the card and its plain
    version on the CPU. `fused_convolution_branch.launches` counts forward
    launches, `fused_convolution_branch.backwards` the backward passes
    through them, `fused_convolution_branch.backward_launches` those that
    ran the backward's launches, and `fused_convolution_branch.plain_calls`
    the branches on the card whose configuration the kernel does not take
    (`takes`);
    `fused_convolution_branch.halo_launches` counts the launches made
    inside a time-sharded encode (`ops/time_shard.py`), on a shard's
    frames and their halos, beside `launches`; `int8_calls` counts the
    branches run on the W8A8 route (`count_int8_call`), which launch
    nothing."""
    if x.device.type == "cpu":
        return convolution_branch_reference(x, pad_mask, weights, eps, keep, keep_prob)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return kernel_call(x, pad_mask, weights, eps, keep, keep_prob, launch_weights)


fused_convolution_branch.launches = 0
fused_convolution_branch.backwards = 0
fused_convolution_branch.backward_launches = 0
fused_convolution_branch.plain_calls = 0
fused_convolution_branch.halo_launches = 0
fused_convolution_branch.int8_calls = 0
# the counters stay on the wrapper when a caller swaps the module attribute
_counts = fused_convolution_branch
