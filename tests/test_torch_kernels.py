"""The port's kernel modules against the JAX package on the CPU.

Each kernel's plain PyTorch version is held against the Pallas kernel in
interpret mode and against its jnp twin, and the port's modules against
the flax modules, float32, tolerance 2e-5 (as tests/test_pallas_*.py).
On the CPU the wrappers take the plain version. The kernels themselves
run only on a card (tests/test_torch_card.py); the checks their wrappers
make before a launch are plain Python and are tested here, as is the
route that sends a RelPosMHAXL call to its kernel or to the plain version
(whose parity with the JAX module tests/test_torch_mixers.py holds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.ops import pallas_csgu as jcsgu
from summarymixing_tpu.ops import pallas_summary as jps
from summarymixing_tpu.ops.convolution import ConvolutionBranch as JConvolutionBranch
from summarymixing_tpu.ops.summary_mixing import SummaryMixing as JSummaryMixing
from summarymixing_tpu_torch.ops import _build, attention, fused_csgu, fused_summary
from summarymixing_tpu_torch.ops.convolution import ConvolutionBranch
from summarymixing_tpu_torch.ops.positional import relpos_xl_table
from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing
from summarymixing_tpu_torch.utils.convert import load_jax_params

TOL = 2e-5
GELU = {"gelu": functools.partial(jax.nn.gelu, approximate=True),
        "gelu_exact": functools.partial(jax.nn.gelu, approximate=False)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    if isinstance(want, torch.Tensor):
        want = want.detach().numpy()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _pad(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def _cell_weights(rng, d=32, h=24, o=16, out=32):
    """JAX layout ([in, out] matrices), as tests/test_pallas_summary.py."""
    def w(*shape):
        return (rng.standard_normal(shape) * 0.2).astype(np.float32)
    return (w(d, h), w(h), w(h, o), w(o), w(d, h), w(h), w(h, o), w(o),
            w(o, out), w(o, out), w(out))


def _to_port_layout(weights):
    return tuple(_t(a.T if a.ndim == 2 else a) for a in weights)


@pytest.mark.parametrize("lengths", [[10, 6], [10, 1]])
def test_summary_reference_matches_pallas_interpret_and_jnp(rng, lengths):
    b, t, d = 2, 10, 32
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    pad = _pad(lengths, t)[..., None]
    weights = _cell_weights(rng)
    jw = tuple(jnp.asarray(a) for a in weights)
    want = jps._jnp_reference(jnp.asarray(x), jnp.asarray(pad), jw)
    orig = jps.pl.pallas_call
    jps.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        with jax.disable_jit():
            kernel = jps._pallas_forward(jnp.asarray(x), jnp.asarray(pad), jw)
    finally:
        jps.pl.pallas_call = orig
    # the Pallas kernel hard-codes erf-GELU (through a rational erf)
    got = fused_summary.summary_mixing_reference(_t(x), _t(pad), _to_port_layout(weights),
                                                 "gelu_exact")
    _close(got, want)
    _close(got, kernel)


@pytest.mark.parametrize("activation", ["gelu", "gelu_exact"])
def test_summary_mixing_module_matches_flax(rng, activation):
    b, t, d = 3, 9, 32
    cell = JSummaryMixing(enc_dim=d, nhead=1, local_proj_hid_dim=(24,), local_proj_out_dim=16,
                          summary_hid_dim=(24,), summary_out_dim=16, mode="SummaryMixing",
                          activation=GELU[activation])
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    pad = _pad([9, 5, 2], t)
    x[1, 5:] = 7.7   # poison the padding
    params = cell.init(jax.random.PRNGKey(0), jnp.asarray(x), pad_mask=jnp.asarray(pad))
    want = cell.apply(params, jnp.asarray(x), pad_mask=jnp.asarray(pad))
    port = load_jax_params(
        SummaryMixing(d, 1, (24,), 16, (24,), 16, activation=activation), params)
    _close(port(_t(x), pad_mask=_t(pad)), want)
    # the kernel's plain version computes the same cell from the flattened weights
    got = fused_summary.fused_summary_mixing(
        _t(x), _t(pad)[..., None], fused_summary.params_to_weights(port), activation)
    _close(got, want)
    jw = jps.params_to_weights(params["params"], dtype=jnp.float32)
    for mine, theirs in zip(fused_summary.params_to_weights(port), jw):
        _close(mine.T if mine.dim() == 2 else mine, theirs, 0)


def test_summary_mixing_multihead_and_sum_mask_match_flax(rng):
    b, t, d = 2, 8, 32
    cell = JSummaryMixing(enc_dim=d, nhead=4, local_proj_hid_dim=(16,), local_proj_out_dim=16,
                          summary_hid_dim=(24, 16), summary_out_dim=16, mode="SummaryMixing")
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    pad = _pad([8, 5], t)
    causal = np.tril(np.ones((t, t), np.float32))
    params = cell.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = load_jax_params(SummaryMixing(d, 4, (16,), 16, (24, 16), 16), params)
    for sm in (None, causal):
        want = cell.apply(params, jnp.asarray(x), sum_mask=None if sm is None else jnp.asarray(sm),
                          pad_mask=jnp.asarray(pad))
        got = port(_t(x), sum_mask=None if sm is None else _t(sm), pad_mask=_t(pad))
        _close(got, want)
    # lite (refused until it was ported): the multihead summary branch alone
    lite = JSummaryMixing(enc_dim=d, nhead=4, summary_hid_dim=(24, 16), summary_out_dim=16,
                          mode="SummaryMixing-lite")
    params = lite.init(jax.random.PRNGKey(2), jnp.asarray(x))
    port = load_jax_params(SummaryMixing(d, 4, summary_hid_dim=(24, 16), summary_out_dim=16,
                                         mode="SummaryMixing-lite"), params)
    _close(port(_t(x), pad_mask=_t(pad)),
           lite.apply(params, jnp.asarray(x), pad_mask=jnp.asarray(pad)))


def _branch_params(rng, d, units, k):
    branch = JConvolutionBranch(input_size=d, linear_units=units, kernel_size=k,
                                activation=GELU["gelu"], dropout_rate=0.0)
    x = jnp.zeros((1, 4, d), jnp.float32)
    params = branch.init(jax.random.PRNGKey(0), x)["params"]
    # non-trivial LayerNorm and conv parameters, so a padded frame that
    # reached the conv as the LayerNorm bias would show
    csgu = dict(params["csgu"])
    csgu["norm"] = {"scale": jnp.asarray(1 + 0.3 * rng.standard_normal(units // 2), jnp.float32),
                    "bias": jnp.asarray(0.5 * rng.standard_normal(units // 2), jnp.float32)}
    csgu["conv_kernel"] = jnp.asarray(0.3 * rng.standard_normal((k, units // 2)), jnp.float32)
    params = dict(params, csgu=csgu)
    return branch, params


@pytest.mark.parametrize("t,lengths", [(16, [16, 9]), (20, [13, 1])])
def test_convolution_branch_matches_pallas_interpret_and_flax(rng, t, lengths):
    d, units, k = 16, 32, 5
    branch, params = _branch_params(rng, d, units, k)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    mask = _pad(lengths, t)
    for row, n in enumerate(lengths):
        x[row, n:] = 7.7   # poison the padding
    want = branch.apply({"params": params}, jnp.asarray(x), pad_mask=jnp.asarray(mask))
    kernel = jcsgu.fused_convolution_branch(jnp.asarray(x), jnp.asarray(mask), params,
                                            kernel_size=k, tile=8, interpret=True)
    port = load_jax_params(ConvolutionBranch(d, units, k, activation="gelu"), params)
    plain = fused_csgu.convolution_branch_reference(_t(x), _t(mask),
                                                    fused_csgu.branch_weights(port))
    module = port(_t(x), pad_mask=_t(mask))
    _close(plain, kernel)
    _close(module, want)
    _close(plain, want)
    # padding invariance: more padding leaves the valid frames alone
    x2 = np.concatenate([x, np.full((2, 8, d), -3.3, np.float32)], axis=1)
    mask2 = np.concatenate([mask, np.zeros((2, 8), np.float32)], axis=1)
    plain2 = fused_csgu.fused_convolution_branch(_t(x2), _t(mask2),
                                                 fused_csgu.branch_weights(port))
    for row, n in enumerate(lengths):
        _close(plain2[row, :n], plain[row, :n])


@pytest.mark.parametrize("linear_after_conv,gate", [(True, None), (False, "gelu")])
def test_convolution_branch_options_match_flax(rng, linear_after_conv, gate):
    """Options of the CPU path that the kernel does not take (on a CUDA
    tensor the module raises for them)."""
    d, units, k, t = 16, 32, 5, 12
    jbranch = JConvolutionBranch(
        input_size=d, linear_units=units, kernel_size=k, activation=GELU["gelu"],
        gate_activation=GELU[gate] if gate else (lambda v: v),
        use_linear_after_conv=linear_after_conv, dropout_rate=0.0)
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    mask = _pad([12, 7], t)
    params = jbranch.init(jax.random.PRNGKey(0), jnp.asarray(x), pad_mask=jnp.asarray(mask))
    want = jbranch.apply(params, jnp.asarray(x), pad_mask=jnp.asarray(mask))
    port = load_jax_params(
        ConvolutionBranch(d, units, k, activation="gelu", gate_activation=gate,
                          use_linear_after_conv=linear_after_conv), params)
    _close(port(_t(x), pad_mask=_t(mask)), want)


# The cgMLP backward's plain version against autograd of the forward's plain
# version. In float32 its rounding points (casts to x's dtype) round nothing,
# so the two differ by the order of fp32 sums: 1e-5 of the largest gradient.
# In bf16 it rounds h, dh and dz where the forward's plain version keeps fp32
# (the kernel's rounding points): three roundings of 2^-9 relative, which
# LayerNorm's backward (a difference of row means) and the sums over tokens
# lift to under 2^-5 of the largest gradient (about 2^-7 measured).
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -5}
BWD_NEEDS = {"all": (True,) * 9, "x": (True,) + (False,) * 8, "weights": (False,) + (True,) * 8}


def _grad_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("needs", sorted(BWD_NEEDS))
@pytest.mark.parametrize("k", [15, 31])
@pytest.mark.parametrize("keep_rate", [0.0, 0.1], ids=["no_keep", "keep"])
@pytest.mark.parametrize("pad", ["none", "ragged"])
def test_convolution_branch_backward_reference_matches_autograd(pad, keep_rate, k, needs, dtype):
    """`convolution_branch_backward_reference` (the kernel's backward in
    plain PyTorch) against `torch.autograd.grad` of
    `convolution_branch_reference` on the launch weights, over pad masks,
    keep-masks, both conv widths and which gradients are needed: each
    needed gradient within BWD_TOL of the largest, x's in x's dtype, the
    weights' in float32, and None for the others."""
    g = torch.Generator().manual_seed(k + 7 * len(needs))
    b, t, d, c2 = 3, 40, 16, 32
    x = torch.randn(b, t, d, generator=g).to(dtype)
    f32 = torch.float32
    def r(*shape, scale=0.3, shift=0.0):
        return shift + scale * torch.randn(*shape, generator=g)
    c = c2 // 2
    weights = (r(c2, d), r(c2, scale=0.1), r(c, shift=1.0), r(c), r(k, c),
               r(c, scale=0.1, shift=1.0), r(d, c), r(d, scale=0.1))
    launch = fused_csgu.kernel_weights(weights) if dtype == torch.bfloat16 else weights
    mask = None if pad == "none" else _t(_pad([40, 23, 1], t))
    keep = (torch.rand(b, t, c2 // 2, generator=g) >= keep_rate) if keep_rate else None
    keep_prob = 1.0 - keep_rate
    want_grads = BWD_NEEDS[needs]
    xr = x.clone().requires_grad_(want_grads[0])
    wr = [w.clone().requires_grad_(need) for w, need in zip(launch, want_grads[1:])]
    out = fused_csgu.convolution_branch_reference(xr, mask, tuple(wr), 1e-5, keep, keep_prob)
    g_out = torch.randn(out.shape, generator=g).to(dtype)
    leaves = [v for v in [xr] + wr if v.requires_grad]
    want = iter(torch.autograd.grad(out, leaves, g_out))
    got = fused_csgu.convolution_branch_backward_reference(g_out, x, mask, launch, 1e-5, keep,
                                                           keep_prob, want_grads)
    assert len(got) == 9
    for i, (v, need) in enumerate(zip(got, want_grads)):
        if not need:
            assert v is None, i
            continue
        w = next(want)
        assert v.shape == w.shape and v.dtype == (dtype if i == 0 else f32), i
        assert _grad_err(v, w) <= BWD_TOL[dtype], (i, _grad_err(v, w))


def test_cgmlp_routes_without_a_card_keep_nothing_for_the_backward(monkeypatch):
    """What each route keeps for a backward, on CPU tensors: the CPU route
    is autograd of the plain version (no Function, the training op never
    called); the kernel route under no_grad is one bare call of the
    inference op and records nothing; the Function on CPU tensors keeps its
    inputs and the launch weights only (no `h`, statistics or `g`), and its
    backward is the plain backward, counted in `backwards` and not in
    `backward_launches`."""
    g = torch.Generator().manual_seed(3)
    b, t, d, c2, k = 2, 12, 16, 32, 5
    weights = tuple(0.3 * torch.randn(*shape, generator=g) for shape in
                    ((c2, d), (c2,), (c2 // 2,), (c2 // 2,), (k, c2 // 2), (c2 // 2,),
                     (d, c2 // 2), (d,)))
    weights = tuple(w.requires_grad_() for w in weights)
    x = torch.randn(b, t, d, generator=g).requires_grad_()

    def refuse(*args):
        raise AssertionError("the training op runs only where a backward will read it")
    monkeypatch.setattr(fused_csgu, "convolution_branch_train_op", refuse)
    out = fused_csgu.fused_convolution_branch(x, None, weights)
    seen, stack = set(), [out.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            stack.extend(f for f, _ in fn.next_functions)
    assert not any("FusedConvolutionBranch" in type(fn).__name__ for fn in seen)
    calls = []

    def op(*args):
        calls.append(args)
        return fused_csgu.convolution_branch_reference(args[0], args[1], tuple(args[2]),
                                                       *args[3:])
    monkeypatch.setattr(fused_csgu, "convolution_branch_op", op)
    with torch.no_grad():
        bare = fused_csgu.kernel_call(x, None, weights, 1e-5, None, 1.0)
    assert len(calls) == 1 and bare.grad_fn is None
    fn = fused_csgu.fused_convolution_branch
    b0, bl0 = fn.backwards, fn.backward_launches
    out = fused_csgu.kernel_call(x, None, weights, 1e-5, None, 1.0)
    assert len(calls) == 2 and "FusedConvolutionBranch" in type(out.grad_fn).__name__
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 3 + 8 and saved[0] is not None and saved[1] is None
    out.sum().backward()
    assert (fn.backwards - b0, fn.backward_launches - bl0) == (1, 0)
    assert x.grad is not None and all(w.grad is not None for w in weights)


def test_wrappers_take_plain_version_on_cpu_only(rng):
    x = _t(rng.standard_normal((2, 6, 32)))
    pad = torch.ones(2, 6, 1)
    weights = _to_port_layout(_cell_weights(rng))
    before = fused_summary.fused_summary_mixing.launches
    _close(fused_summary.fused_summary_mixing(x, pad, weights, "gelu"),
           fused_summary.summary_mixing_reference(x, pad, weights, "gelu").numpy())
    assert fused_summary.fused_summary_mixing.launches == before
    with pytest.raises(ValueError):
        fused_summary.fused_summary_mixing(x.to("meta"), pad.to("meta"), weights, "gelu")
    with pytest.raises(ValueError):
        fused_csgu.fused_convolution_branch(x.to("meta"), None, weights)


@pytest.mark.parametrize("kind", ["branch", "cell"])
def test_cached_weights_follow_parameter_updates(kind):
    """The modules flatten their weights for the kernels once and again only
    after a parameter changed in place or was replaced."""
    if kind == "branch":
        module, flatten = ConvolutionBranch(16, 32, 5, activation="gelu"), fused_csgu.branch_weights
        param = module.csgu.conv_bias
    else:
        module = SummaryMixing(32, 1, (24,), 16, (24,), 16)
        flatten, param = fused_summary.params_to_weights, module.local_proj.layers()[0].bias
    with torch.no_grad():
        for p in module.parameters():
            p.normal_()
    first = _build.cached_weights(module, flatten)
    assert _build.cached_weights(module, flatten) is first
    with torch.no_grad():
        param.add_(1.0)
    again = _build.cached_weights(module, flatten)
    assert again is not first
    for mine, fresh in zip(again, flatten(module)):
        torch.testing.assert_close(mine, fresh, rtol=0, atol=0)


def _cell_inputs(d=256, merge_stride=None, m2_offset=0):
    bf = torch.bfloat16
    sq, vec = torch.zeros(d, d, dtype=bf), torch.zeros(d, dtype=bf)
    merge = torch.zeros(d, merge_stride or 2 * d + m2_offset, dtype=bf)
    weights = (sq, vec, sq, vec, sq, vec, sq, vec, merge[:, :d],
               merge[:, d + m2_offset:2 * d + m2_offset], vec)
    return torch.zeros(2, 5, d, dtype=bf), torch.ones(2, 5, 1), weights, "gelu"


def _branch_inputs(c2=512, k=31):
    d, bf = 128, torch.bfloat16
    weights = (torch.zeros(c2, d, dtype=bf), torch.zeros(c2), torch.ones(c2 // 2),
               torch.zeros(c2 // 2), torch.zeros(k, c2 // 2), torch.zeros(c2 // 2),
               torch.zeros(d, c2 // 2, dtype=bf), torch.zeros(d))
    return torch.zeros(2, 5, d, dtype=bf), torch.ones(2, 5), weights


def _replace(seq, i, value):
    return tuple(value if j == i else v for j, v in enumerate(seq))


def _bad_call(case):
    """(check, good arguments, bad arguments, the error the bad ones raise)."""
    if case.startswith("cell"):
        x, pad, w, act = good = _cell_inputs()
        misaligned = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
        bad = {"cell_x_float32": (x.float(), pad, w, act),
               "cell_x_misaligned": (misaligned, pad, w, act),
               "cell_pad_2d": (x, pad[..., 0], w, act),
               "cell_pad_bf16": (x, pad.bfloat16(), w, act),
               "cell_w1_transposed": (x, pad, _replace(w, 0, w[0].t()), act),
               "cell_width_96": _cell_inputs(96),
               # products are walked in 256-column chunks
               "cell_width_384": _cell_inputs(384),
               # a resident [64, D] operand holds at most 512 columns
               "cell_width_768": _cell_inputs(768),
               # TMA needs a row stride of a multiple of 16 bytes
               "cell_merge_stride_516": _cell_inputs(merge_stride=2 * 256 + 4),
               # and a 16-byte aligned start (M2 starts 1 element in)
               "cell_m2_misaligned": _cell_inputs(m2_offset=1),
               "cell_activation_relu": (x, pad, w, "relu"),
               # the dropout keep-mask is bool over [local, pooled]
               "cell_keep_float": (x, pad, w, act, torch.ones(2, 5, 512)),
               "cell_keep_narrow": (x, pad, w, act, torch.ones(2, 5, 256, dtype=torch.bool))}[case]
        error = NotImplementedError if case == "cell_activation_relu" else ValueError
        return fused_summary._check, good, bad, error
    x, mask, w = good = _branch_inputs()
    bad = {"branch_conv_width_5": _branch_inputs(k=5),
           "branch_units_192": _branch_inputs(c2=192),
           "branch_b_pre_bf16": (x, mask, _replace(w, 1, w[1].bfloat16())),
           "branch_mask_3d": (x, mask[..., None], w),
           "branch_w_post_transposed": (x, mask, _replace(w, 6, w[6].t())),
           # TMA reads x and W_pre from 16-byte aligned addresses
           "branch_x_misaligned": (torch.zeros(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape),
                                   mask, w),
           "branch_w_pre_misaligned": (x, mask, _replace(
               w, 0, torch.zeros(w[0].numel() + 1, dtype=w[0].dtype)[1:].view(w[0].shape))),
           "branch_keep_wide": (x, mask, w, torch.ones(2, 5, 512, dtype=torch.bool))}[case]
    error = NotImplementedError if case == "branch_conv_width_5" else ValueError
    return fused_csgu._check, good, bad, error


@pytest.mark.parametrize("case", [
    "cell_x_float32", "cell_x_misaligned", "cell_pad_2d", "cell_pad_bf16",
    "cell_w1_transposed", "cell_width_96", "cell_width_384", "cell_width_768",
    "cell_merge_stride_516", "cell_m2_misaligned", "cell_activation_relu",
    "cell_keep_float", "cell_keep_narrow", "branch_keep_wide",
    "branch_conv_width_5", "branch_units_192", "branch_b_pre_bf16", "branch_mask_3d",
    "branch_w_post_transposed", "branch_x_misaligned", "branch_w_pre_misaligned"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The checks each wrapper makes before a launch, run on CPU tensors
    (the wrappers reach them only for CUDA tensors)."""
    check, good, bad, error = _bad_call(case)
    check(*good)
    with pytest.raises(error):
        check(*bad)


# -- RelPosMHAXL's attention kernel: the route and the launch's checks --------------------

def _relpos_module(d=128, nhead=2, dtype=torch.bfloat16, rate=0.0):
    from summarymixing_tpu_torch.ops.layers import set_compute_dtype

    torch.manual_seed(0)
    mod = attention.RelPosMHAXL(d, nhead, dropout_rate=rate).eval()
    mod.reset_parameters()
    return set_compute_dtype(mod, None if dtype == torch.float32 else dtype)


# (module keywords, call keywords, whether the kernel takes it)
RELPOS_ROUTES = {
    "padded": ({}, {"pad": True}, True),
    "left_buffer": ({}, {"pad": "suffix"}, True),
    "unpadded": ({}, {}, True),
    "causal": ({"causal": True}, {"pad": True}, True),
    "eval_with_a_dropout_rate": ({"rate": 0.1}, {"pad": True}, True),
    "training_at_rate_0": ({"train": True}, {"pad": True}, True),
    "training_with_dropout": ({"rate": 0.1, "train": True}, {"pad": True}, False),
    "attn_mask": ({}, {"pad": True, "attn_mask": True}, False),
    "float32": ({"dtype": torch.float32}, {"pad": True}, False),
    "head_128": ({"nhead": 1}, {"pad": True}, False),
}


@pytest.mark.parametrize("case", sorted(RELPOS_ROUTES))
def test_relpos_route_launches_what_the_kernel_takes(case, monkeypatch):
    """With the card's route taken on the CPU (`uses_kernel` patched) and the
    launch stubbed by the plain version: which RelPosMHAXL calls go to the
    kernel and which run the plain version, counted in `plain_calls`; both
    routes give the plain version's output."""
    mod_kw, call_kw, takes = RELPOS_ROUTES[case]
    mod = _relpos_module(nhead=mod_kw.get("nhead", 2), dtype=mod_kw.get("dtype", torch.bfloat16),
                         rate=mod_kw.get("rate", 0.0))
    mod.mask_pos_future = mod_kw.get("causal", False)
    mod.train(mod_kw.get("train", False))
    t = 10
    x = torch.randn(2, t, 128, generator=torch.Generator().manual_seed(1))
    pos = relpos_xl_table(t, 128)
    # a streaming left buffer that is not full yet leaves its valid keys at the end
    second = ([0.0] * 4 + [1.0] * (t - 4) if call_kw.get("pad") == "suffix"
              else [1.0] * 6 + [0.0] * (t - 6))
    pad = torch.tensor([[1.0] * t, second]) if call_kw.get("pad") else None
    amask = torch.ones(t, t) if call_kw.get("attn_mask") else None
    launched = []

    def stub(q, k, v, p, u, vb, pad_mask=None, causal=False):
        launched.append((q.dtype, tuple(q.shape), pad_mask is pad, causal))
        return attention.relpos_attention_reference(q, k, v, p, u, vb, None, pad_mask, causal)

    wrapper = attention.fused_relpos_attention
    monkeypatch.setattr(wrapper, "plain_calls", wrapper.plain_calls)
    monkeypatch.setattr(attention, "uses_kernel", lambda x: True)
    monkeypatch.setattr(attention, "fused_relpos_attention", stub)
    p0 = wrapper.plain_calls
    with torch.no_grad():
        got = mod(x, x, x, attn_mask=amask, pad_mask=pad, pos_embs=pos)
    plain_calls = wrapper.plain_calls - p0
    monkeypatch.undo()
    with torch.no_grad():
        want = mod(x, x, x, attn_mask=amask, pad_mask=pad, pos_embs=pos)
    if takes:
        assert launched == [(torch.bfloat16, (2, t, 2, 64), True, mod.mask_pos_future)]
        assert plain_calls == 0
    else:
        assert launched == [] and plain_calls == 1
    if not mod.training:   # a training call draws a new dropout mask each time
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_relpos_route_counts_non_square_attention_then_refuses_it(monkeypatch):
    """Cross-attention with other query and key lengths is not the kernel's:
    it is counted as a plain call, and the plain version refuses it as the
    JAX module does (`rel_shift`)."""
    mod = _relpos_module()
    wrapper = attention.fused_relpos_attention
    monkeypatch.setattr(wrapper, "plain_calls", wrapper.plain_calls)
    monkeypatch.setattr(attention, "uses_kernel", lambda x: True)
    p0 = wrapper.plain_calls
    q, kv = torch.randn(2, 6, 128), torch.randn(2, 10, 128)
    with pytest.raises(ValueError, match="square attention"):
        mod(q, kv, kv, pos_embs=relpos_xl_table(10, 128))
    assert wrapper.plain_calls == p0 + 1


def _relpos_launch_args(b=2, t=5, h=2, hd=64):
    bf = torch.bfloat16
    return (torch.zeros(b, t, h, hd, dtype=bf), torch.zeros(b, t, h, hd, dtype=bf),
            torch.zeros(b, t, h, hd, dtype=bf), torch.zeros(1, 2 * t - 1, h, hd, dtype=bf),
            torch.zeros(h, hd, dtype=bf), torch.zeros(h, hd, dtype=bf),
            (torch.arange(t)[None, :] < torch.tensor([t, 3] + [1] * (b - 2))[:, None]).float())


@pytest.mark.parametrize("case", ["float32", "head_128", "non_square", "k_transposed",
                                  "v_misaligned", "p_short", "bias_shape", "bias_float32",
                                  "mask_int64", "mask_transposed"])
def test_relpos_launch_refuses_what_the_kernel_does_not_take(case):
    """The checks the launch makes, run on CPU tensors (the wrapper reaches
    them only for CUDA tensors)."""
    good = _relpos_launch_args()
    attention._relpos_check(*good)
    attention._relpos_check(*good[:-1], None)
    q, k, v, p, u, vb, pad = good
    bad = {"float32": lambda: (q.float(), k, v, p, u, vb, pad),
           "head_128": lambda: _relpos_launch_args(hd=128),
           "non_square": lambda: (q[:, :4], k, v, p, u, vb, pad),
           "k_transposed": lambda: (q, k.transpose(0, 1).contiguous().transpose(0, 1), v, p, u,
                                    vb, pad),
           "v_misaligned": lambda: (q, k, torch.zeros(v.numel() + 1, dtype=v.dtype)[1:].view(
               v.shape), p, u, vb, pad),
           "p_short": lambda: (q, k, v, p[:, 1:], u, vb, pad),
           "bias_shape": lambda: (q, k, v, p, u[:1], vb, pad),
           # the launch casts the biases to q's dtype before its check
           "bias_float32": lambda: (q, k, v, p, u, vb.float(), pad),
           # the wrapper casts the mask to float32 and makes it contiguous first
           "mask_int64": lambda: (q, k, v, p, u, vb, pad.long()),
           "mask_transposed": lambda: (q, k, v, p, u, vb,
                                       pad.t().contiguous().t())}[case]()
    with pytest.raises(ValueError):
        attention._relpos_check(*bad)


def test_relpos_key_lengths_and_cpu_wrapper():
    """Key padding reaches the op as the pad mask itself, whatever its
    pattern (the kernel finds each row's allowed keys): on the CPU the
    wrapper is the plain version under a bf16 mask whose valid keys lie at
    the end (a streaming left buffer not yet full), with a row with none and
    a row with a gap, and launches nothing; another device raises; the op's
    fake gives the context's shape and dtype."""
    q, k, v, p, u, vb, _ = _relpos_launch_args(b=3)
    q = torch.randn(q.shape).to(q.dtype)
    pad = torch.tensor([[0.0, 0, 1, 1, 1], [0.0, 0, 0, 0, 0], [1.0, 0, 1, 1, 0]])
    n0 = attention.fused_relpos_attention.launches
    for causal in (False, True):
        got = attention.fused_relpos_attention(q, q, q, p, u, vb, pad.to(torch.bfloat16), causal)
        want = attention.relpos_attention_reference(q, q, q, p, u, vb, None, pad, causal)
        assert torch.equal(got, want)
    got = attention.fused_relpos_attention(q, q, q, p, u, vb, None, True)
    want = attention.relpos_attention_reference(q, q, q, p, u, vb, None, None, True)
    assert torch.equal(got, want) and attention.fused_relpos_attention.launches == n0
    with pytest.raises(ValueError, match="no kernel"):
        attention.fused_relpos_attention(*(x.to("meta") for x in (q, k, v, p, u, vb)))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        args = [mode.from_tensor(x) for x in _relpos_launch_args(b=3, t=9)]
        out = attention.relpos_attention_op(*args, False)
    assert tuple(out.shape) == (3, 9, 2, 64) and out.dtype == torch.bfloat16
