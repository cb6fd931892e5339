"""W8A8 building blocks for inference — the port of
`summarymixing_tpu/ops/quant.py` (`quantize_act`, `quantize_weight`,
`int8_matmul`, and `Int8Linear` for its `Int8Dense`).

Scheme, as in the JAX module:

- weights: symmetric per-output-channel int8 with float32 scales,
  `scale = max(absmax, eps) / 127`, `q = clip(round(w / scale), -127, 127)`;
- activations: the same per row (last axis), computed at each call;
- the product in int8 x int8 -> int32, then `acc · s_a · s_w (+ bias)` in
  float32, cast to the output dtype.

Rounding is half-to-even on both sides (`torch.round`, `jnp.round`) and
the division is float32 on both, so the same inputs give the same `q`, the
same int32 accumulators and the same float32 result as the JAX package.

The int8 product: on the card `torch._int_mm` (int8 tensor cores). It
takes K and N that are multiples of 8 and more than 16 rows; fewer rows
are padded with zero rows, which changes no output row, and K or N off
the multiple of 8 raises `ValueError`. The flagship cgMLP's 512 -> 3072
and 1536 -> 512 products meet it. On the CPU the same call is exact in
int32 (float32 would not be: 127² · 3072 > 2²⁴). The JAX package computes
this product with XLA's `dot_general`, outside any Pallas kernel, so no
kernel of the port replaces it.

Matrices use `torch.nn.Linear`'s layout: `quantize_weight` takes `[O, C]`
and scales each of the O rows (the JAX function takes the flax `[C, O]`
kernel and scales each column: the same numbers).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from summarymixing_tpu_torch.ops import _build
from summarymixing_tpu_torch.ops.layers import Dense

INT_MM_MIN_ROWS = 17   # torch._int_mm on CUDA takes more than 16 rows
INT_MM_MULTIPLE = 8    # ... and K, N multiples of 8


def quantize_act(x: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row (last axis) int8: `x [..., C]` -> (q int8
    `[..., C]`, scale float32 `[..., 1]`), x ≈ q · scale."""
    x = x.to(torch.float32)
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), eps) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def quantize_weight(w: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a `[O, C]` weight: (q int8
    `[O, C]`, scale float32 `[O]`)."""
    w = w.to(torch.float32)
    scale = torch.clamp_min(w.abs().amax(dim=1), eps) / 127.0
    return torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8), scale


def check_card_shape(k: int, n: int) -> None:
    """Raise `ValueError` unless the card's int8 product takes K and N."""
    if k % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
        raise ValueError(f"the int8 product on the card (torch._int_mm) takes K and N that are "
                         f"multiples of {INT_MM_MULTIPLE}, not K={k}, N={n}")


def int8_accumulate(q_a: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """The int32 accumulators `q_a [..., C] · q_wᵀ` (`q_w [O, C]`), exact.
    The product takes `q_wᵀ` as a view, `[C, O]` column-major (the TN
    layout of cuBLASLt's int8 GEMM), so a cached `q_w` is never copied."""
    lead, k = q_a.shape[:-1], q_a.shape[-1]
    n = q_w.shape[0]
    a = q_a.reshape(-1, k)
    if a.is_cuda:
        check_card_shape(k, n)
        m = a.shape[0]
        if m < INT_MM_MIN_ROWS:
            a = torch.cat([a, a.new_zeros(INT_MM_MIN_ROWS - m, k)])
        acc = torch._int_mm(a.contiguous(), q_w.t())[:m]
    else:
        acc = torch._int_mm(a.contiguous(), q_w.t())
    return acc.reshape(*lead, n)


def int8_matmul(q_a: torch.Tensor, s_a: torch.Tensor, q_w: torch.Tensor, s_w: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """`(q_a · s_a) · (q_w · s_w)ᵀ + bias` with the contraction in int32 and
    the scales applied after it. q_a `[..., C]` int8, s_a `[..., 1]`, q_w
    `[O, C]` int8, s_w `[O]`; the result in `dtype`."""
    y = int8_accumulate(q_a, q_w).to(torch.float32) * s_a * s_w
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dtype)


class Int8Linear(Dense):
    """`Dense` computing W8A8 (the JAX `Int8Dense`): the same float32
    `weight [out, in]` and `bias`, so checkpoints and `load_jax_params`
    are unchanged. The weight is quantized once per parameter version;
    the output is in the compute dtype, or float32 without one (the JAX
    `ConvolutionBranch` gives `dtype or float32`). Inference only: the
    rounding has no gradient."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q_w, s_w = _build.cached_weights(self, lambda m: quantize_weight(m.weight.detach()))
        q_a, s_a = quantize_act(x)
        return int8_matmul(q_a, s_a, q_w, s_w, self.bias,
                           dtype=self.compute_dtype or torch.float32)


# the JAX module's name
Int8Dense = Int8Linear
