"""The port's two CUDA kernels against their plain PyTorch versions, on the
card. This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_card.py -m gpu --noconftest -q

(`--noconftest` because tests/conftest.py sets JAX up.) Without a card the
tests skip; the CPU tests hold the plain versions against the JAX package.

Tolerance: max |kernel - plain| / (1 + |plain|) of 2^-5 (cell) and 2^-4
(cgMLP), the bf16 rounding budget chip_smoke.py states.
"""

import pytest
import torch

from summarymixing_tpu_torch.ops import fused_csgu, fused_summary

CELL_TOL, CSGU_TOL = 2.0 ** -5, 2.0 ** -4

# (T, valid lengths[, D, 2C]), at flagship widths (D 512, 2C 3072, K 31)
# unless the case names others:
# - ragged: T = 150 is a multiple of neither the cell's 64-frame tile nor
#   the gate pass's 128-frame tile; one row has a single valid frame;
# - halo: valid frames end 5 frames after T crosses a 128-frame gate tile
#   and 3 before it, inside the 15-frame conv halo;
# - empty tile: rows whose last tiles are all padding (200 valid of 333, so
#   tiles 4 and 5 of that row hold no valid frame), and a row with none.
CASES = {
    "ragged": (150, [150, 97, 1]),
    # narrower widths (D 256, 2C 512): four 64-channel gate tiles and a
    # 256-column cell product, half the flagship's
    "narrow": (150, [150, 97, 1], 256, 512),
    "halo": (261, [261, 133, 125]),
    "empty_tile": (333, [333, 200, 0]),
}


def _max_rel_err(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float(((got - want).abs() / (1 + want.abs())).max())


def _setup(t, lengths, d=512, c2=3072, k=31):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests hold the plain versions instead")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)

    def w(*shape, dtype=torch.bfloat16):
        return ((torch.rand(*shape, generator=g, device="cuda") * 2 - 1)
                * shape[-1] ** -0.5).to(dtype)

    x = torch.randn(len(lengths), t, d, generator=g, device="cuda").to(torch.bfloat16)
    mask = (torch.arange(t, device="cuda")[None, :]
            < torch.tensor(lengths, device="cuda")[:, None]).float()
    merge = w(d, 2 * d)
    cell = (w(d, d), w(d), w(d, d), w(d), w(d, d), w(d), w(d, d), w(d),
            merge[:, :d], merge[:, d:], w(d))
    f32 = torch.float32
    branch = (w(c2, d), w(c2, dtype=f32), 1 + w(c2 // 2, dtype=f32), w(c2 // 2, dtype=f32),
              w(k, c2 // 2, dtype=f32), 1 + w(c2 // 2, dtype=f32), w(d, c2 // 2),
              w(d, dtype=f32))
    return x, mask, cell, branch


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_match_plain_versions_on_card(case):
    """Each kernel against its plain version, bf16, at flagship widths. An
    all-padding row checks the pooled count's clamp at 1 against the plain
    version, which clamps too."""
    x, mask, cell, branch = _setup(*CASES[case])
    pad = mask[..., None].contiguous()
    for act in ("gelu", "gelu_exact"):
        n0 = fused_summary.fused_summary_mixing.launches
        got = fused_summary.fused_summary_mixing(x, pad, cell, act)
        want = fused_summary.summary_mixing_reference(x, pad, cell, act)
        assert fused_summary.fused_summary_mixing.launches == n0 + 1
        assert _max_rel_err(got, want) <= CELL_TOL
    n0 = fused_csgu.fused_convolution_branch.launches
    got = fused_csgu.fused_convolution_branch(x, mask, branch)
    want = fused_csgu.convolution_branch_reference(x, mask, branch)
    assert fused_csgu.fused_convolution_branch.launches == n0 + 1
    assert _max_rel_err(got, want) <= CSGU_TOL


@pytest.mark.gpu
def test_kernels_repeat_bit_for_bit_on_card():
    """No atomics: the same inputs give the same bits on a second call."""
    x, mask, cell, branch = _setup(*CASES["ragged"])
    pad = mask[..., None].contiguous()
    assert torch.equal(fused_summary.fused_summary_mixing(x, pad, cell, "gelu"),
                       fused_summary.fused_summary_mixing(x, pad, cell, "gelu"))
    assert torch.equal(fused_csgu.fused_convolution_branch(x, mask, branch),
                       fused_csgu.fused_convolution_branch(x, mask, branch))
