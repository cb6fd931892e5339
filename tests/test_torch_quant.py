"""The port's W8A8 inference path (`summarymixing_tpu_torch/ops/quant.py`)
against `summarymixing_tpu/ops/quant.py` on the CPU, on the same seeded
numpy inputs: `quantize_act`, `quantize_weight` and `int8_matmul` equal
in the int8 values, the scales, the int32 accumulators and the float32
result (both sides round half to even after a float32 division);
`Int8Linear` against `Int8Dense`; `ConvolutionBranch(act_int8=True)` and
a small `act_int8` recognizer's encode against the JAX modules on the
same weights, in float32. There the only source of difference is float32
rounding in the GELU, the LayerNorm and the conv before the second
quantization, which can move a value across a rounding boundary of the
int8 grid: the count of such flipped values is printed, and the outputs
are held within 1e-4 relative to their largest magnitude (one flip moves
an output by about a 1/127 step of one activation times a weight column).
`build_model` with `model.act_int8: true` builds the W8A8 branch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.ops import quant as jquant
from summarymixing_tpu.ops.convolution import ConvolutionBranch as JConvolutionBranch
from summarymixing_tpu.ops.convolution import ConvolutionalSpatialGatingUnit as JCSGU
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.ops import fused_csgu, quant
from summarymixing_tpu_torch.ops.convolution import ConvolutionBranch
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.utils.convert import load_jax_params
from test_torch_decoder import RECIPE, TINY_DEC

REL_TOL = 1e-4   # of max |output|, float32 (see the module docstring)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", [(5, 7, 96), (3, 64)])
def test_quantize_act_equals_jax(rng, shape):
    x = (rng.standard_normal(shape) * rng.uniform(0.1, 30.0, shape[:-1] + (1,))).astype(np.float32)
    x[0, ...] = 0.0   # an all-zero row takes the eps scale
    jq, js = jquant.quantize_act(jnp.asarray(x))
    q, s = quant.quantize_act(_t(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_weight_equals_jax(rng):
    """The JAX function scales each column of the flax `[C, O]` kernel; the
    port each row of the Linear's `[O, C]`."""
    w = rng.standard_normal((96, 40)).astype(np.float32) * 0.05
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    q, s = quant.quantize_weight(_t(w.T.copy()))
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("k", [96, 3072])
def test_int8_matmul_accumulators_and_result_equal_jax(rng, k):
    """K = 3072 is the flagship's second product's width: 127² · 3072
    exceeds float32's exact integers, so the accumulation must be int32."""
    x = rng.standard_normal((2, 9, k)).astype(np.float32)
    w = rng.standard_normal((k, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jqa, jsa = jquant.quantize_act(jnp.asarray(x))
    jqw, jsw = jquant.quantize_weight(jnp.asarray(w))
    qa, sa = quant.quantize_act(_t(x))
    qw, sw = quant.quantize_weight(_t(w.T.copy()))
    want_acc = jax.lax.dot_general(jqa, jqw, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    acc = quant.int8_accumulate(qa, qw)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    exact = np.einsum("btk,ko->bto", np.asarray(jqa, np.int64), np.asarray(jqw, np.int64))
    np.testing.assert_array_equal(acc.numpy(), exact)
    want = jquant.int8_matmul(jqa, jsa, jqw, jsw, jnp.asarray(b), dtype=jnp.float32)
    got = quant.int8_matmul(qa, sa, qw, sw, _t(b), dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_linear_equals_int8_dense(rng):
    x = rng.standard_normal((3, 11, 32)).astype(np.float32)
    jm = jquant.Int8Dense(48, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = load_jax_params(quant.Int8Linear(32, 48), params)
    with torch.no_grad():
        got = port(_t(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.apply(params, jnp.asarray(x))))


def test_w8a8_branch_matches_jax(rng, monkeypatch):
    """`ConvolutionBranch(act_int8=True)`: Int8 pre-projection, exact
    GELU, the plain CSGU with a pad mask, Int8 post-projection; counted
    in `int8_calls`, never in `launches` or `plain_calls`."""
    monkeypatch.setattr(fused_csgu.fused_convolution_branch, "int8_calls", 0)
    d, units, k = 32, 64, 5
    x = rng.standard_normal((2, 19, d)).astype(np.float32)
    pad = (np.arange(19)[None, :] < np.array([19, 12])[:, None]).astype(np.float32)
    jm = JConvolutionBranch(input_size=d, linear_units=units, kernel_size=k, act_int8=True)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(pad))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(pad)))
    port = load_jax_params(ConvolutionBranch(d, units, k, "gelu_exact", act_int8=True), params)
    assert isinstance(port.pre_channel_proj, quant.Int8Linear)
    assert isinstance(port.post_channel_proj, quant.Int8Linear)
    before = common.kernel_counts()
    with torch.no_grad():
        got = port(_t(x), _t(pad)).numpy()
        h = port.csgu(torch.nn.functional.gelu(port.pre_channel_proj(_t(x))), _t(pad))
    assert common.kernel_counts(since=before)["csgu"] == {
        "launches": 0, "plain_calls": 0, "int8_calls": 1}
    # the second quantization's input on both sides: flips across the grid
    p = params["params"]
    jh = jax.nn.gelu(jquant.Int8Dense(units, dtype=jnp.float32).apply(
        {"params": p["pre_channel_proj"]}, jnp.asarray(x)), approximate=False)
    jh = JCSGU(input_size=units, kernel_size=k).apply({"params": p["csgu"]}, jh, jnp.asarray(pad))
    flips = int((quant.quantize_act(h)[0].numpy() != np.asarray(jquant.quantize_act(jh)[0])).sum())
    print(f"W8A8 branch: {flips} of {h.numel()} second-stage int8 values flipped against JAX")
    np.testing.assert_allclose(got, want, rtol=0, atol=REL_TOL * np.abs(want).max())


def _asr_pair(over):
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    tmodel, _ = build_model(load_recipe(RECIPE, overrides=over), device="cpu")
    feats = jnp.zeros((1, 16, 80), jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), feats, jnp.asarray([16]),
                                  jnp.ones((1, 3), jnp.int32))
    load_jax_params(tmodel, params)
    return jmodel, tmodel, params


def test_act_int8_recipe_builds_w8a8_and_encodes_as_jax(rng, monkeypatch):
    """`model.act_int8: true` through both loaders: every Branchformer
    cgMLP of the port is W8A8 (on the tree before this module the loader
    dropped the flag and built bf16 Dense layers), and the encode of
    ragged features agrees with the JAX encode in float32."""
    monkeypatch.setattr(fused_csgu.fused_convolution_branch, "int8_calls", 0)
    jmodel, tmodel, params = _asr_pair(dict(TINY_DEC, **{"model.act_int8": True,
                                                          "model.num_decoder_layers": 0}))
    branches = [m for m in tmodel.modules() if isinstance(m, ConvolutionBranch)]
    assert len(branches) == 2 and all(b.act_int8 for b in branches)
    assert all(isinstance(b.pre_channel_proj, quant.Int8Linear) and
               isinstance(b.post_channel_proj, quant.Int8Linear) for b in branches)
    feats = rng.standard_normal((3, 37, 80)).astype(np.float32)
    lens = np.array([37, 20, 29], np.int32)
    want, want_len = jax.jit(lambda p, f, n: jmodel.apply(p, f, n, method=jmodel.encode))(
        params, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got, got_len = tmodel.encode(_t(feats), torch.from_numpy(lens))
    assert fused_csgu.fused_convolution_branch.int8_calls == 2
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    want = np.asarray(want)
    valid = np.arange(want.shape[1])[None, :, None] < np.asarray(want_len)[:, None, None]
    print(f"act_int8 encode: max |d| {np.abs(got.numpy() - want)[valid[..., 0]].max():.3e}")
    np.testing.assert_allclose(np.where(valid, got.numpy(), 0), np.where(valid, want, 0),
                               rtol=0, atol=REL_TOL * np.abs(want).max())


def test_cgmlp_kernel_refuses_act_int8():
    branch = dict(d=512, units=3072, kernel_size=31, activation="gelu", dtype=torch.bfloat16)
    assert fused_csgu.takes(**branch)
    assert not fused_csgu.takes(**branch, act_int8=True)
    kind, message = fused_csgu.refusal(**branch, act_int8=True)
    assert kind is NotImplementedError and "W8A8" in message


def test_card_product_refuses_widths_off_the_multiple_of_8():
    """`torch._int_mm` on the card takes K and N multiples of 8 (checked
    before the product); the flagship cgMLP's two products meet it."""
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.check_card_shape(20, 16)
    quant.check_card_shape(512, 3072)
    quant.check_card_shape(1536, 512)
