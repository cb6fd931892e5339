"""The port's attention decoder and its layers against the JAX package on
the CPU: the regularMHA decoder's `seq_log_probs` through the whole
recognizer, multi-head attention with both masks, and the bf16 rounding of
the port's Dense and LayerNorm against flax's at dtype=bf16,
param_dtype=float32. Weights come from flax `init` through
`load_jax_params`; inputs from a numpy seed."""

import copy
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.ops import attention as jattn
from summarymixing_tpu.ops import masks as jmasks
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.ops import attention as tattn
from summarymixing_tpu_torch.ops import masks as tmasks
from summarymixing_tpu_torch.ops.layers import Dense, LayerNorm
from summarymixing_tpu_torch.utils.convert import load_jax_params

RECIPE = os.path.join(os.path.dirname(__file__), "..", "recipes", "LibriSpeech",
                      "branchformer_summarymixing.yaml")
# tests/test_torch_model.py's TINY with a two-layer decoder
TINY_DEC = {
    "model.num_encoder_layers": 2, "model.num_decoder_layers": 2, "model.d_model": 32,
    "model.d_ffn": 64, "model.csgu_linear_units": 64, "model.csgu_kernel_size": 5,
    "model.local_proj_hid_dim": [32], "model.local_proj_out_dim": 32,
    "model.summary_hid_dim": [32], "model.summary_out_dim": 32, "model.output_neurons": 16,
    "model.frontend_channels": [8, 4], "model.input_size": 80, "training.precision": "fp32",
    "model.transformer_dropout": 0.0,
}


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.asarray(a, dtype))


@functools.lru_cache(maxsize=None)
def _tiny_models(overrides):
    over = dict(TINY_DEC, **dict(overrides))
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    tmodel, _ = build_model(load_recipe(RECIPE, overrides=over), device="cpu")
    feats = jnp.zeros((1, 16, 80), jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), feats, jnp.asarray([16]),
                                  jnp.ones((1, 3), jnp.int32))
    load_jax_params(tmodel, params)
    return jmodel, tmodel, params


def tiny_models(overrides=None):
    """(flax model, port model, flax params) of the tiny recipe with a
    decoder, the port filled from the flax init (built once per overrides;
    each call gets its own copy of the port model)."""
    key = tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                       for k, v in (overrides or {}).items()))
    jmodel, tmodel, params = _tiny_models(key)
    return jmodel, copy.deepcopy(tmodel), params


def test_decoder_seq_log_probs_match_flax(rng):
    """Recognizer with the regularMHA decoder, fp32: ragged features and
    BOS-prefixed, pad-ended targets. seq_log_probs (and the CTC head)
    within 2e-5."""
    jmodel, tmodel, params = tiny_models()
    feats = rng.standard_normal((3, 37, 80)).astype(np.float32)
    feat_len = np.array([37, 20, 29], np.int32)
    tokens = np.array([[1, 5, 7, 3, 9], [1, 4, 0, 0, 0], [1, 12, 3, 3, 0]], np.int32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(feats), jnp.asarray(feat_len),
                                 jnp.asarray(tokens))
    with torch.no_grad():
        got = tmodel(_t(feats), torch.from_numpy(feat_len), torch.from_numpy(tokens).long())
    assert got["seq_log_probs"].shape == (3, 5, 16)
    for key in ("seq_log_probs", "ctc_log_probs", "dec_out"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-5,
                                   rtol=2e-5, err_msg=key)


@pytest.mark.parametrize("self_attention", [True, False])
def test_multihead_attention_matches_flax(rng, self_attention):
    """Four heads, fp32: a causal attention mask with a key padding mask
    (self-attention), or a padding mask over a longer memory."""
    b, t, d = 2, 6, 32
    s = t if self_attention else 9
    q = rng.standard_normal((b, t, d)).astype(np.float32)
    kv = q if self_attention else rng.standard_normal((b, s, d)).astype(np.float32)
    pad = (np.arange(s)[None, :] < np.array([s, s - 3])[:, None]).astype(np.float32)
    attn_mask = np.tril(np.ones((t, s), np.float32)) if self_attention else None
    jm = jattn.MultiheadAttention(d_model=d, nhead=4)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv))
    want, _ = jm.apply(params, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                       attn_mask=None if attn_mask is None else jnp.asarray(attn_mask),
                       pad_mask=jnp.asarray(pad))
    port = load_jax_params(tattn.MultiheadAttention(d, 4), params)
    got = port(_t(q), _t(kv), _t(kv), attn_mask=None if attn_mask is None else _t(attn_mask),
               pad_mask=_t(pad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_flagship_with_decoder_parameter_count_matches_jax():
    """The flagship with its 6-layer attention decoder, as the recipe file
    builds it in each package, has the parameter count chip_smoke.py
    holds its training phase to; the port's parameters are float32."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE))
    tmodel, _ = build_model(load_recipe(RECIPE), device="meta")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 16, 80), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.int32),
                            jax.ShapeDtypeStruct((1, 3), jnp.int32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    n_port = sum(p.numel() for p in tmodel.parameters())
    assert n_port == n_jax == chip_smoke.FLAGSHIP_TRAIN_PARAMS == 119_304_304
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}


def test_decoder_masks_match_jax():
    tokens = np.array([[1, 5, 0, 0], [1, 0, 3, 2]], np.int32)
    np.testing.assert_array_equal(
        tmasks.key_padding_mask_from_tokens(torch.from_numpy(tokens)).numpy(),
        np.asarray(jmasks.key_padding_mask_from_tokens(jnp.asarray(tokens))))
    np.testing.assert_array_equal(tmasks.lookahead_mask(5).numpy(),
                                  np.asarray(jmasks.lookahead_mask(5)))
    m = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    np.testing.assert_array_equal(tmasks.mask_to_additive(_t(m)).numpy(),
                                  np.asarray(jmasks.mask_to_additive(jnp.asarray(m))))


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> np.ndarray:
    """Distance in bf16 steps between two bf16 tensors (as int16 bit patterns
    of same-sign values)."""
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = torch.from_numpy(np.asarray(want.astype(jnp.float32))).to(torch.bfloat16)
    return np.abs(a - b.view(torch.int16).numpy().astype(np.int32))


@pytest.mark.parametrize("layer", ["dense", "layer_norm"])
def test_bf16_rounding_matches_flax(rng, layer):
    """Port layers with compute dtype bf16 on float32 parameters against
    flax's at dtype=bf16, param_dtype=float32: every output in bf16, at most
    one bf16 step apart (the float32 sums run in another order and may
    round the other way), and at least 99% of them identical."""
    x = (3.0 * rng.standard_normal((4, 7, 48)) + 0.5).astype(np.float32)
    if layer == "dense":
        jm = nn.Dense(40, dtype=jnp.bfloat16, param_dtype=jnp.float32)
        port = Dense(48, 40)
    else:
        jm = nn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16, param_dtype=jnp.float32)
        port = LayerNorm(48, eps=1e-5)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(rng.standard_normal(a.shape),
                                                          jnp.float32), params)
    want = jm.apply(params, jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    load_jax_params(port, params)
    port.compute_dtype = torch.bfloat16
    with torch.no_grad():
        got = port(_t(x))
    assert got.dtype == torch.bfloat16
    assert next(port.parameters()).dtype == torch.float32
    ulps = _bf16_ulps(got, np.asarray(want))
    assert ulps.max() <= 1 and (ulps == 0).mean() >= 0.99, (ulps.max(), (ulps == 0).mean())
