"""The port's three CUDA kernels against their plain PyTorch versions, and the
W8A8 int8 product against its CPU route, on the card. This file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_card.py -m gpu --noconftest -q

(`--noconftest` because tests/conftest.py sets JAX up.) Without a card the
tests skip; the CPU tests hold the plain versions against the JAX package.

Tolerance: max |kernel - plain| / (1 + |plain|) of 2^-5 (cell) and 2^-4
(cgMLP), the bf16 rounding budget chip_smoke.py states, with or without a
dropout keep-mask; 2^-7 (RelPosMHAXL's attention): its scores and softmax
are float32 on both sides, so the two differ by the bf16 rounding of the
probabilities (normalised in the plain version, not yet in the kernel's
online softmax) and one bf16 ulp of the output, under 2^-7 of 1 + |plain|.
The cell's and RelPosMHAXL's autograd Functions' gradients must equal the
plain versions' autograd gradients bit for bit: their backward is that VJP.
The cgMLP's backward is a kernel too: its gradients are held against its
plain version (`convolution_branch_backward_reference`, the same rounding
points) within CSGU_BWD_TOL and against the float32 VJP of the forward's
plain version within CSGU_VJP_TOL, both as max |kernel - plain| over
max |plain| per gradient (the reasons beside the constants).
"""

import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu_torch.ops import attention, fused_csgu, fused_summary

CELL_TOL, CSGU_TOL, RELPOS_TOL = 2.0 ** -5, 2.0 ** -4, 2.0 ** -7
# The cgMLP backward against its plain version: the same bf16 roundings (h,
# g, dh, dz), but sums in another order and tanh.approx in GELU', so a value
# near a bf16 rounding boundary lands a step (2^-8 relative) away; dx, one
# bf16 rounding from dz, shows it most (3.8e-3 at most over the cases).
CSGU_BWD_TOL = 2.0 ** -6
# ... and against the float32 VJP (fp32 h, dh, dz): three bf16 roundings of
# 2^-9 relative, which LayerNorm's backward (a difference of row means) and
# the transposed conv lift to 6.9e-3 of the largest gradient at most.
CSGU_VJP_TOL = 2.0 ** -5

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
@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_split_route_matches_plain_versions_on_card(case, shards):
    """The cell's split route (`sm_partial` on each time shard, the sums and
    counts added as the all-reduce adds them, `sm_finish` on each) against
    its plain versions on the same shards and against the whole-T plain
    version, and a launch counted for each half."""
    x, mask, cell, _ = _setup(*CASES[case])
    pad = mask[..., None].contiguous()
    t = x.shape[1]
    local = -(-t // shards)
    bounds = [(a, min(a + local, t)) for a in range(0, t, local)]
    cell_fn = fused_summary.fused_summary_mixing
    n0, p0, f0 = cell_fn.launches, cell_fn.partial_launches, cell_fn.finish_launches

    def split(partial, finish):
        parts = [partial(x[:, a:z].contiguous(), pad[:, a:z].contiguous(), cell, "gelu")
                 for a, z in bounds]
        total, count = sum(p[0] for p in parts), sum(p[1] for p in parts)
        return torch.cat([finish(p[2], pad[:, a:z].contiguous(), total, count)
                          for p, (a, z) in zip(parts, bounds)], dim=1)

    got = split(fused_summary.fused_summary_partial,
                lambda pre, p, total, count: fused_summary.fused_summary_finish(
                    pre, p, total, count, cell, "gelu"))
    want = split(fused_summary.summary_partial_reference,
                 lambda pre, p, total, count: fused_summary.summary_finish_reference(
                     pre, total, count, cell, "gelu"))
    n = len(bounds)
    assert (cell_fn.launches - n0, cell_fn.partial_launches - p0,
            cell_fn.finish_launches - f0) == (2 * n, n, n)
    assert _max_rel_err(got, want) <= CELL_TOL
    assert _max_rel_err(got, fused_summary.summary_mixing_reference(x, pad, cell, "gelu")) \
        <= CELL_TOL


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
        if kernel == "cell":
            assert torch.equal(gk, gp)
        else:   # the cgMLP's backward is a kernel of its own (below)
            assert gk.dtype == gp.dtype and _grad_err(gk, gp) <= CSGU_VJP_TOL


def _grad_err(got, want):
    got, want = got.detach().float(), want.detach().float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


# (T, valid lengths, D, 2C, K) of the cgMLP backward's cases: the flagship
# decode shape (B = 8, T = 751); a training batch's (40 utterances of 240-340
# frames, 13,600 rows as a 500 s batch gives); narrow widths with K = 15
BWD_CASES = {
    "flagship": (751, [751, 700, 512, 751, 300, 751, 1, 640], 512, 3072, 31),
    "train_batch": (340, [340 - (i * 37) % 101 for i in range(40)], 512, 3072, 31),
    "narrow_k15": (150, [150, 97, 1], 256, 512, 15),
}


def _bwd_inputs(case):
    t, lengths, d, c2, k = BWD_CASES[case]
    x, mask, _, branch = _setup(t, lengths, d, c2, k)
    keep = _keep(lengths, t, c2 // 2, seed=3)
    g = torch.Generator(device="cuda").manual_seed(6)
    g_out = torch.randn(len(lengths), t, d, generator=g, device="cuda").to(torch.bfloat16)
    return x, mask, keep, [w.float() for w in branch], g_out


def _kernel_grads(x, mask, keep, weights, g_out, need_x=True, need_w=True):
    xx = x.detach().requires_grad_(need_x)
    ws = [w.detach().requires_grad_(need_w) for w in weights]
    out = fused_csgu.fused_convolution_branch(xx, mask, tuple(ws), keep=keep, keep_prob=0.9)
    leaves = [v for v in [xx] + ws if v.requires_grad]
    return torch.autograd.grad(out, leaves, g_out)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_cgmlp_backward_matches_plain_versions_on_card(case):
    """The cgMLP backward's kernels, through the wrapper on float32 weights
    with a keep-mask (rate 0.1) over ragged lengths: every gradient against
    the plain backward (`convolution_branch_backward_reference`, called
    here on the card's tensors) within CSGU_BWD_TOL and against the float32 VJP of the forward's
    plain version (the backward before the kernel) within CSGU_VJP_TOL, in
    the parameters' own dtype. One forward launch, one backward launch,
    one backward; the backward launches no forward."""
    x, mask, keep, weights, g_out = _bwd_inputs(case)
    fn = fused_csgu.fused_convolution_branch
    n0, b0, bl0 = fn.launches, fn.backwards, fn.backward_launches
    got = _kernel_grads(x, mask, keep, weights, g_out)
    torch.cuda.synchronize()
    assert (fn.launches - n0, fn.backwards - b0, fn.backward_launches - bl0) == (1, 1, 1)
    launch = fused_csgu.kernel_weights(weights)
    plain = fused_csgu.convolution_branch_backward_reference(g_out, x, mask, launch, 1e-5, keep,
                                                             0.9)
    xx = x.detach().requires_grad_()
    ws = [w.detach().requires_grad_() for w in weights]
    out = fused_csgu.convolution_branch_reference(xx, mask, fused_csgu.kernel_weights(ws),
                                                  keep=keep, keep_prob=0.9)
    vjp = torch.autograd.grad(out, [xx] + ws, g_out)
    assert [v.dtype for v in got] == [torch.bfloat16] + [torch.float32] * 8
    for i, (k, p, v) in enumerate(zip(got, plain, vjp)):
        assert k.shape == v.shape, i
        assert _grad_err(k, p) <= CSGU_BWD_TOL, (i, _grad_err(k, p))
        assert _grad_err(k, v) <= CSGU_VJP_TOL, (i, _grad_err(k, v))


@pytest.mark.gpu
def test_cgmlp_backward_repeats_bit_for_bit_on_card():
    """No atomics: two backward passes on the same inputs give the same
    bits, and one that needs only x, or only the weights, gives the same
    bits as the one that needs all."""
    x, mask, keep, weights, g_out = _bwd_inputs("train_batch")
    first = _kernel_grads(x, mask, keep, weights, g_out)
    again = _kernel_grads(x, mask, keep, weights, g_out)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    (x_only,) = _kernel_grads(x, mask, keep, weights, g_out, need_w=False)
    assert torch.equal(x_only, first[0])
    w_only = _kernel_grads(x, mask, keep, weights, g_out, need_x=False)
    assert all(torch.equal(a, b) for a, b in zip(w_only, first[1:]))


def _span_device_us(trace_path, name):
    """Occurrences of the program span `smt::<name>` in a Chrome trace and
    the device microseconds of the kernels launched inside them (matched by
    correlation, launched on any thread)."""
    import json

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == f"smt::{name}"]
    inside = {e["args"]["correlation"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {}) and any(a <= e["ts"] <= b for a, b in spans)}
    device = sum(e["dur"] for e in events
                 if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in inside)
    return len(spans), device


@pytest.mark.gpu
def test_train_step_traces_cgmlp_backward_span_on_card(tmp_path):
    """A profiled training step of the flagship cut to 2 encoder layers:
    the span `train.cgmlp_backward` opens once a layer, in autograd's
    thread, and the kernels launched inside it ran on the card; every
    backward of the branch ran the kernel."""
    from summarymixing_tpu_torch.config import build_model, build_trainer
    from summarymixing_tpu_torch.config.schema import ModelConfig, RecipeConfig, TrainingConfig
    from summarymixing_tpu_torch.training import profiling

    _setup(8, [8])   # skips without a card
    cfg = RecipeConfig(model=ModelConfig(num_encoder_layers=2, num_decoder_layers=1),
                       training=TrainingConfig(grad_accumulation_factor=1))
    model, fbank = build_model(cfg)
    trainer = build_trainer(cfg, model, fbank)
    state = trainer.init_state(0)
    g = torch.Generator().manual_seed(0)
    batch = {"wav": 0.1 * torch.randn(2, 32000, generator=g),
             "wav_lens": torch.tensor([32000, 20000]),
             "tokens": torch.randint(3, 5000, (2, 6), generator=g),
             "token_lens": torch.tensor([6, 4])}
    batch = {k: v.cuda() for k, v in batch.items()}
    state, _ = trainer.train_step(state, batch)   # warm-up: builds the kernels
    fn = fused_csgu.fused_convolution_branch
    b0, bl0 = fn.backwards, fn.backward_launches
    prof = profiling.start_trace()
    state, metrics = trainer.train_step(state, batch)
    path = profiling.stop_trace(prof, str(tmp_path))
    assert torch.isfinite(metrics["loss"])
    assert (fn.backwards - b0, fn.backward_launches - bl0) == (2, 2)
    count, device_us = _span_device_us(path, "train.cgmlp_backward")
    assert count == 2 and device_us > 0


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


@pytest.mark.gpu
@pytest.mark.parametrize("rows,k,n", [(3, 512, 3072), (16, 1536, 512), (6008, 512, 3072)])
def test_int8_product_equals_the_cpu_route_on_card(rows, k, n):
    """W8A8's int32 accumulators (`ops/quant.py`, `torch._int_mm` on the
    card) equal the CPU route's exactly, also below the card's 17 rows
    (padded with zero rows)."""
    from summarymixing_tpu_torch.ops import quant

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests hold the CPU route against JAX")
    g = torch.Generator().manual_seed(rows)
    qa, _ = quant.quantize_act(torch.randn(rows, k, generator=g))
    qw, _ = quant.quantize_weight(torch.randn(n, k, generator=g))
    card = quant.int8_accumulate(qa.cuda(), qw.cuda())
    assert card.shape == (rows, n) and card.dtype == torch.int32
    assert torch.equal(card.cpu(), quant.int8_accumulate(qa, qw))


# RelPosMHAXL's attention at d512, 8 heads: (B, T, each row's valid keys or
# None); a row is a valid length n (keys [0, n)), one run (start, end) or a
# list of runs:
# - ragged: one row of a single valid key;
# - untiled: T = 261 is a multiple of neither the 128-query nor the 64-key
#   tile, and one row has no valid key (the plain version's uniform softmax);
# - unpadded: no pad mask;
# - long: the long-form cell's longest batch, B = 4 at T = 3,000;
# - left_buffer: a streaming Conformer's [left buffer | chunk] keys while the
#   buffer fills (its valid keys at the end: causal rows before them have
#   none), starts inside and at the edge of a 64-key tile;
# - gaps: valid keys in several runs, one of them a single key.
RELPOS_CASES = {
    "ragged": (3, 150, [150, 97, 1]),
    "untiled": (3, 261, [261, 133, 0]),
    "unpadded": (2, 200, None),
    "long": (4, 3000, [3000, 2712, 2100, 1499]),
    "left_buffer": (3, 200, [(136, 200), (70, 200), (64, 200)]),
    "gaps": (2, 190, [[(0, 30), (70, 190)], [(5, 6), (100, 101), (150, 170)]]),
}


def _key_mask(t, rows):
    mask = torch.zeros(len(rows), t)
    for i, row in enumerate(rows):
        runs = [(0, row)] if isinstance(row, int) else [row] if isinstance(row, tuple) else row
        for start, end in runs:
            mask[i, start:end] = 1.0
    return mask


def _relpos_inputs(b, t, rows, h=8, hd=64, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests hold the plain versions instead")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    q, k, v = n(b, t, h, hd), n(b, t, h, hd), n(b, t, h, hd)
    p = n(1, 2 * t - 1, h, hd)
    u, vb = n(h, hd, dtype=torch.float32, scale=0.3), n(h, hd, dtype=torch.float32, scale=0.3)
    pad = None if rows is None else _key_mask(t, rows).cuda()
    return q, k, v, p, u, vb, pad


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(RELPOS_CASES))
def test_relpos_kernel_matches_plain_version_on_card(case, causal):
    """The kernel against the plain version in bf16, with and without
    `mask_pos_future`, one launch a call."""
    q, k, v, p, u, vb, pad = _relpos_inputs(*RELPOS_CASES[case])
    fn = attention.fused_relpos_attention
    with torch.no_grad():
        n0 = fn.launches
        got = fn(q, k, v, p, u, vb, pad, causal)
        want = attention.relpos_attention_reference(q, k, v, p, u, vb, None, pad, causal)
    assert fn.launches == n0 + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _max_rel_err(got, want) <= RELPOS_TOL


@pytest.mark.gpu
def test_relpos_kernel_repeats_bit_for_bit_on_card():
    """No atomics: the same inputs give the same bits on a second call."""
    q, k, v, p, u, vb, pad = _relpos_inputs(*RELPOS_CASES["untiled"])
    with torch.no_grad():
        first = attention.fused_relpos_attention(q, k, v, p, u, vb, pad, True)
        assert torch.equal(first, attention.fused_relpos_attention(q, k, v, p, u, vb, pad, True))


@pytest.mark.gpu
def test_relpos_function_gradients_equal_plain_autograd_on_card():
    """Through the wrapper under autograd, over ragged lengths: the gradients
    of q, k, v, p and both biases equal, bit for bit, those of the plain
    version run under autograd on the same inputs."""
    q, k, v, p, u, vb, pad = _relpos_inputs(*RELPOS_CASES["ragged"])
    g = torch.Generator(device="cuda").manual_seed(5)
    g_out = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)

    def grads(fn):
        leaves = [x.detach().requires_grad_() for x in (q, k, v, p, u, vb)]
        out = fn(*leaves)
        return out, torch.autograd.grad(out, leaves, g_out)

    fn = attention.fused_relpos_attention
    n0, b0 = fn.launches, fn.backwards
    out_k, grads_k = grads(lambda *xs: fn(*xs, pad, False))
    assert (fn.launches, fn.backwards) == (n0 + 1, b0 + 1)
    out_p, grads_p = grads(lambda *xs: attention.relpos_attention_reference(*xs, None, pad))
    assert _max_rel_err(out_k, out_p) <= RELPOS_TOL
    for gk, gp in zip(grads_k, grads_p):
        assert gk.dtype == gp.dtype and torch.equal(gk, gp)


@pytest.mark.gpu
def test_relpos_module_routes_on_card():
    """A bf16 RelPosMHAXL at d512, 8 heads, in eval: a call with a pad mask
    (and with `mask_pos_future`) launches the kernel; a call with an
    attn_mask, a float32 call and a training call with dropout run the
    plain version, counted in `plain_calls`. The launched call agrees with
    the same module's plain version."""
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype
    from summarymixing_tpu_torch.ops.positional import relpos_xl_table

    _relpos_inputs(1, 8, None)   # skips without a card; TF32 off
    torch.manual_seed(0)
    mod = attention.RelPosMHAXL(512, 8, dropout_rate=0.1).cuda().eval()
    mod.reset_parameters()
    x = torch.randn(2, 150, 512, device="cuda")
    pos = relpos_xl_table(150, 512).cuda()
    pad = (torch.arange(150, device="cuda")[None, :]
           < torch.tensor([150, 61], device="cuda")[:, None]).float()
    fn = attention.fused_relpos_attention

    def route(m, *args, **kw):
        n0, p0 = fn.launches, fn.plain_calls
        with torch.no_grad():
            out = m(x, x, x, *args, pos_embs=pos, **kw)
        return out, (fn.launches - n0, fn.plain_calls - p0)

    assert route(mod, pad_mask=pad)[1] == (0, 1)   # float32 parameters, no compute dtype
    set_compute_dtype(mod, torch.bfloat16)
    got, counts = route(mod, pad_mask=pad)
    assert counts == (1, 0)
    mod.mask_pos_future = True
    assert route(mod, pad_mask=pad)[1] == (1, 0)
    mod.mask_pos_future = False
    chunk = torch.ones(150, 150, device="cuda")
    want, counts = route(mod, attn_mask=chunk, pad_mask=pad)
    assert counts == (0, 1)
    assert _max_rel_err(got, want) <= CELL_TOL
    mod.train()
    assert route(mod, pad_mask=pad)[1] == (0, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_relpos_conformer_streams_as_its_plain_version_on_card(causal):
    """`encode_streaming` of a bf16 RelPosMHAXL Conformer at d512, 8 heads:
    each call attends over [left buffer | chunk], whose valid keys lie at the
    end while the buffer fills. With the kernel (two launches a chunk, no
    plain call) the chunks' outputs lie as close to the same model's float32
    run as those of the bf16 run under `plain_kernels()`: two layers carry
    bf16 rounding a few hundredths far on both routes (max |bf16 - f32| /
    (1 + |f32|) 0.026-0.032, mean 0.0034), where attending to the wrong keys
    moves the outputs by order 1."""
    from summarymixing_tpu_torch.models.asr import DynChunkTrainConfig, TransformerASR
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype
    from summarymixing_tpu_torch.ops.plain import plain_kernels
    from summarymixing_tpu_torch.utils.init import init_parameters

    _relpos_inputs(1, 8, None)   # skips without a card; TF32 off
    chunk, left, b, n_chunks = 16, 3, 2, 6
    model = TransformerASR(tgt_vocab=11, input_size=80, d_model=512, nhead=8,
                           num_encoder_layers=2, num_decoder_layers=0, d_ffn=1024,
                           kernel_size=15, encoder_module="conformer",
                           attention_type="RelPosMHAXL", causal=causal)
    init_parameters(model, torch.Generator().manual_seed(3))
    model = model.cuda().eval()
    g = torch.Generator(device="cuda").manual_seed(4)
    src = torch.randn(b, n_chunks * chunk, 80, generator=g, device="cuda")
    fn = attention.fused_relpos_attention

    def stream():
        state = model.init_streaming_state(b, DynChunkTrainConfig(chunk, left))
        outs = []
        with torch.no_grad():
            for c in range(n_chunks):
                out, state = model.encode_streaming(src[:, c * chunk:(c + 1) * chunk], state)
                outs.append(out)
        return torch.cat(outs, dim=1).float()

    def errs(got, want):
        rel = (got - want).abs() / (1 + want.abs())
        return float(rel.max()), float(rel.mean())

    exact = stream()                        # float32: the plain route
    set_compute_dtype(model, torch.bfloat16)
    n0, p0 = fn.launches, fn.plain_calls
    got = stream()
    assert (fn.launches - n0, fn.plain_calls - p0) == (2 * n_chunks, 0)
    with plain_kernels():
        plain = stream()
    (got_max, got_mean), (plain_max, plain_mean) = errs(got, exact), errs(plain, exact)
    assert got_max <= 1.25 * plain_max and got_mean <= 1.1 * plain_mean
