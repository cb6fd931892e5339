"""The port's two CUDA kernels against their plain PyTorch versions, on the
card. This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_card.py -m gpu --noconftest -q

(`--noconftest` because tests/conftest.py sets JAX up.) Without a card the
tests skip; the CPU tests hold the plain versions against the JAX package.

Tolerance: max |kernel - plain| / (1 + |plain|) of 2^-5 (cell) and 2^-4
(cgMLP), the bf16 rounding budget chip_smoke.py states, with or without a
dropout keep-mask. The autograd Functions' gradients must equal the plain
versions' autograd gradients bit for bit: their backward is that VJP.
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
    got, want = got.detach().float(), want.detach().float()
    assert torch.isfinite(got).all()
    return float(((got - want).abs() / (1 + want.abs())).max())


def _setup(t, lengths, d=512, c2=3072, k=31):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests hold the plain versions instead")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True   # the depthwise conv's backward
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


def _keep(lengths, t, width, rate=0.1, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(len(lengths), t, width, generator=g, device="cuda") < 1.0 - rate


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_kernels_match_plain_versions_on_card(case):
    """Both kernels with a dropout keep-mask (rate 0.1) against their plain
    versions with the same mask, over the ragged cases: the cell's local
    half in the branch pass and its pooled half in the pooled pass, the
    cgMLP's in the gate pass."""
    t, lengths = CASES[case][:2]
    x, mask, cell, branch = _setup(*CASES[case])
    pad = mask[..., None].contiguous()
    d, c = x.shape[2], branch[0].shape[0] // 2
    keep_cell, keep_branch = _keep(lengths, t, 2 * d), _keep(lengths, t, c, seed=2)
    for act in ("gelu", "gelu_exact"):
        n0 = fused_summary.fused_summary_mixing.launches
        got = fused_summary.fused_summary_mixing(x, pad, cell, act, keep_cell, 0.9)
        want = fused_summary.summary_mixing_reference(x, pad, cell, act, keep_cell, 0.9)
        assert fused_summary.fused_summary_mixing.launches == n0 + 1
        assert _max_rel_err(got, want) <= CELL_TOL
        # the mask matters: without it the output differs
        unmasked = fused_summary.summary_mixing_reference(x, pad, cell, act)
        assert _max_rel_err(got, unmasked) > CELL_TOL
    got = fused_csgu.fused_convolution_branch(x, mask, branch, keep=keep_branch, keep_prob=0.9)
    want = fused_csgu.convolution_branch_reference(x, mask, branch, keep=keep_branch,
                                                   keep_prob=0.9)
    assert _max_rel_err(got, want) <= CSGU_TOL


def _grads(fn, x, weights, g_out):
    x = x.detach().requires_grad_()
    weights = [w.detach().float().requires_grad_() for w in weights]
    out = fn(x, weights)
    grads = torch.autograd.grad(out, [x] + weights, g_out)
    return out, grads


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["cell", "csgu"])
def test_function_gradients_equal_plain_autograd_on_card(kernel):
    """Through the wrapper on float32 weights, at flagship widths over
    ragged lengths with a keep-mask: the gradients of x and of every weight
    equal, bit for bit, those of the plain version run under autograd on
    the same inputs, mask and bf16-cast weights."""
    t, lengths = CASES["ragged"]
    x, mask, cell, branch = _setup(t, lengths)
    pad = mask[..., None].contiguous()
    if kernel == "cell":
        keep = _keep(lengths, t, 2 * x.shape[2])
        weights = cell

        def kern(xx, ws):
            return fused_summary.fused_summary_mixing(xx, pad, tuple(ws), "gelu", keep, 0.9)

        def plain(xx, ws):
            return fused_summary.summary_mixing_reference(
                xx, pad, fused_summary.kernel_weights(ws), "gelu", keep, 0.9)
        counter = fused_summary.fused_summary_mixing
    else:
        keep = _keep(lengths, t, branch[0].shape[0] // 2)
        weights = branch

        def kern(xx, ws):
            return fused_csgu.fused_convolution_branch(xx, mask, tuple(ws), keep=keep,
                                                       keep_prob=0.9)

        def plain(xx, ws):
            return fused_csgu.convolution_branch_reference(
                xx, mask, fused_csgu.kernel_weights(ws), keep=keep, keep_prob=0.9)
        counter = fused_csgu.fused_convolution_branch
    g = torch.Generator(device="cuda").manual_seed(5)
    n_out = weights[-1].shape[0]
    g_out = torch.randn(x.shape[0], t, n_out, generator=g, device="cuda").to(torch.bfloat16)
    n0, b0 = counter.launches, counter.backwards
    out_k, grads_k = _grads(kern, x, weights, g_out)
    assert (counter.launches, counter.backwards) == (n0 + 1, b0 + 1)
    out_p, grads_p = _grads(plain, x, weights, g_out)
    assert _max_rel_err(out_k, out_p) <= (CELL_TOL if kernel == "cell" else CSGU_TOL)
    assert grads_k[0].dtype == torch.bfloat16
    assert all(gw.dtype == torch.float32 for gw in grads_k[1:])
    for gk, gp in zip(grads_k, grads_p):
        assert torch.equal(gk, gp)


@pytest.mark.gpu
def test_train_step_fills_every_grad_on_card():
    """One train step of the flagship at full width, cut to 2 encoder and 1
    decoder layers, with dropout, speed perturbation and SpecAugment: a
    finite loss, a gradient for every parameter, and each kernel launched
    and differentiated once per encoder layer."""
    _setup(8, [8])   # skips without a card
    from summarymixing_tpu_torch.config import build_model, build_trainer
    from summarymixing_tpu_torch.config.schema import ModelConfig, RecipeConfig, TrainingConfig

    cfg = RecipeConfig(model=ModelConfig(num_encoder_layers=2, num_decoder_layers=1),
                       training=TrainingConfig(grad_accumulation_factor=1))
    model, fbank = build_model(cfg)
    trainer = build_trainer(cfg, model, fbank)
    state = trainer.init_state(0)
    g = torch.Generator().manual_seed(0)
    lens = torch.tensor([32000, 20000])
    batch = {"wav": 0.1 * torch.randn(2, 32000, generator=g), "wav_lens": lens,
             "tokens": torch.randint(3, 5000, (2, 6), generator=g),
             "token_lens": torch.tensor([6, 4])}
    batch = {k: v.cuda() for k, v in batch.items()}
    counts = [(fn.launches, fn.backwards) for fn in
              (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)]
    state, metrics = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    assert metrics["nonfinite_skipped"] == 0 and torch.isfinite(metrics["loss"])
    assert [n for n, p in model.named_parameters() if p.grad is None] == []
    assert [(fn.launches - a, fn.backwards - b) for fn, (a, b) in zip(
        (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch), counts)] \
        == [(2, 2), (2, 2)]


@pytest.mark.gpu
def test_configuration_kernels_do_not_take_runs_plain_path_on_card():
    """A d128 float32 Branchformer layer (the hard synthetic recipe's):
    neither kernel takes float32, so on the card the cell and the cgMLP
    branch run their plain PyTorch paths, counted in `plain_calls` with no
    launch, and the layer equals the same layer on the CPU within 1e-5 of
    max |card - cpu| / (1 + |cpu|) (float32 with TF32 off, another order of
    sums)."""
    import copy

    from summarymixing_tpu_torch.models.branchformer import BranchformerEncoderLayer
    from summarymixing_tpu_torch.utils.init import init_parameters

    _setup(8, [8])   # skips without a card; TF32 off
    layer = BranchformerEncoderLayer(
        128, 1, kernel_size=15, csgu_linear_units=256, local_proj_hid_dim=(128,),
        local_proj_out_dim=128, summary_hid_dim=(128,), summary_out_dim=128,
        activation="gelu").eval()
    init_parameters(layer, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 45, 128, generator=g)
    mask = (torch.arange(45)[None, :] < torch.tensor([45, 30, 7])[:, None]).float()
    counters = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch)
    before = [(fn.launches, fn.plain_calls) for fn in counters]
    with torch.no_grad():
        want = layer(x, pad_mask=mask)
        got = copy.deepcopy(layer).cuda()(x.cuda(), pad_mask=mask.cuda())
    assert [(fn.launches - a, fn.plain_calls - b) for fn, (a, b) in zip(counters, before)] \
        == [(0, 1), (0, 1)]
    assert _max_rel_err(got.cpu(), want) <= 1e-5
