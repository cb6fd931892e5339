"""The port's two CUDA kernels against their plain PyTorch versions, on the
card. This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_card.py -m gpu --noconftest -q

(`--noconftest` because tests/conftest.py sets JAX up.) Without a card the
test skips; the CPU tests hold the plain versions against the JAX package.
"""

import pytest
import torch

from summarymixing_tpu_torch.ops import fused_csgu, fused_summary


def _max_rel_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float(((got - want).abs() / (1 + want.abs())).max())


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card():
    """Each kernel against its plain version, bf16, at a small ragged shape.
    Tolerance: max |kernel - plain| / (1 + |plain|) of 2^-5 (cell) and 2^-4
    (cgMLP), the bf16 rounding budget chip_smoke.py states."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests hold the plain versions instead")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    b, t, d, c2, k = 3, 150, 128, 512, 31

    def w(*shape, dtype=torch.bfloat16):
        return ((torch.rand(*shape, generator=g, device="cuda") * 2 - 1)
                * shape[-1] ** -0.5).to(dtype)

    x = torch.randn(b, t, d, generator=g, device="cuda").to(torch.bfloat16)
    mask = (torch.arange(t, device="cuda")[None, :]
            < torch.tensor([150, 97, 1], device="cuda")[:, None]).float()
    merge = w(d, 2 * d)
    cell = (w(d, d), w(d), w(d, d), w(d), w(d, d), w(d), w(d, d), w(d),
            merge[:, :d], merge[:, d:], w(d))
    for act in ("gelu", "gelu_exact"):
        n0 = fused_summary.fused_summary_mixing.launches
        got = fused_summary.fused_summary_mixing(x, mask[..., None].contiguous(), cell, act)
        want = fused_summary.summary_mixing_reference(x, mask[..., None], cell, act)
        assert fused_summary.fused_summary_mixing.launches == n0 + 1
        assert _max_rel_err(got, want) <= 2.0 ** -5
    f32 = torch.float32
    branch = (w(c2, d), w(c2, dtype=f32), 1 + w(c2 // 2, dtype=f32), w(c2 // 2, dtype=f32),
              w(k, c2 // 2, dtype=f32), 1 + w(c2 // 2, dtype=f32), w(d, c2 // 2),
              w(d, dtype=f32))
    n0 = fused_csgu.fused_convolution_branch.launches
    got = fused_csgu.fused_convolution_branch(x, mask, branch)
    want = fused_csgu.convolution_branch_reference(x, mask, branch)
    assert fused_csgu.fused_convolution_branch.launches == n0 + 1
    assert _max_rel_err(got, want) <= 2.0 ** -4
