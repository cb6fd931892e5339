"""The port's Transformer LM and Transformer encoder against the JAX package
on the CPU: the full causal forward with both heads, the KV-cached step
against the flax `step` and against the port's own forward, the
encoder stack pre- and post-LN, and the full-width parameter count. Weights
come from flax `init` through `load_jax_params`; inputs from a numpy seed.
Everything is float32 (the JAX recipes build the LM without a compute
dtype); tolerance 2e-5 absolute and relative."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config.schema import LMConfig as JLMConfig
from summarymixing_tpu.models import lm as jlm
from summarymixing_tpu.models import transformer as jtransformer
from summarymixing_tpu.ops.linear import gelu_exact
from summarymixing_tpu.ops.masks import lookahead_mask
from summarymixing_tpu_torch.config import LMConfig, build_lm
from summarymixing_tpu_torch.models import lm as tlm
from summarymixing_tpu_torch.models import transformer as ttransformer
from summarymixing_tpu_torch.utils.convert import load_jax_params

TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB, D, HEADS, LAYERS, FFN = 30, 64, 4, 2, 128


def _lm_pair(output_proj):
    jm = jlm.TransformerLM(vocab=VOCAB, d_model=D, nhead=HEADS, num_layers=LAYERS, d_ffn=FFN,
                           output_proj=output_proj)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))
    port = tlm.TransformerLM(VOCAB, D, HEADS, LAYERS, FFN, output_proj=output_proj).eval()
    return jm, params, load_jax_params(port, params)


@pytest.mark.parametrize("output_proj", ["linear", "sb"])
def test_lm_forward_matches_flax(rng, output_proj):
    """Causal logits of ragged token rows, with a key padding mask."""
    jm, params, port = _lm_pair(output_proj)
    toks = rng.integers(0, VOCAB, (3, 9)).astype(np.int32)
    pad = (np.arange(9)[None, :] < np.array([9, 5, 7])[:, None]).astype(np.float32)
    want = jm.apply(params, jnp.asarray(toks), jnp.asarray(pad))
    with torch.no_grad():
        got = port(torch.from_numpy(toks).long(), torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("output_proj", ["linear", "sb"])
def test_lm_cached_step_matches_flax_and_full_forward(rng, output_proj):
    """Position by position, the port's cached step gives the flax step's
    logits and its own full forward's, into a cache longer than the
    sequence."""
    jm, params, port = _lm_pair(output_proj)
    b, u = 3, 7
    toks = rng.integers(0, VOCAB, (b, u)).astype(np.int32)
    bound = jm.bind(params)
    jcache = bound.init_cache(b, u + 2)
    tcache = port.init_cache(b, u + 2)
    assert tcache[0]["k"].dtype == torch.float32
    with torch.no_grad():
        full = port(torch.from_numpy(toks).long()).numpy()
        for pos in range(u):
            want, jcache = bound.step(jnp.asarray(toks[:, pos]), pos, jcache)
            got, tcache = port.step(torch.from_numpy(toks[:, pos]).long(), pos, tcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(pos))
            np.testing.assert_allclose(got.numpy(), full[:, pos], **TOL, err_msg=str(pos))


@pytest.mark.parametrize("normalize_before", [True, False])
def test_transformer_encoder_and_step_match_flax(rng, normalize_before):
    """The regularMHA encoder stack, pre-LN and post-LN (the LM's), with a
    causal mask: forward and cached step against flax."""
    b, t = 2, 6
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    je = jtransformer.TransformerEncoder(num_layers=LAYERS, d_model=D, d_ffn=FFN, nhead=HEADS,
                                         activation=gelu_exact,
                                         normalize_before=normalize_before,
                                         attention_type="regularMHA")
    params = je.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = load_jax_params(ttransformer.TransformerEncoder(
        LAYERS, D, FFN, HEADS, activation="gelu_exact", normalize_before=normalize_before), params)
    want = je.apply(params, jnp.asarray(x), src_mask=lookahead_mask(t))
    bound = je.bind(params)
    jcache = bound.init_cache(b, t)
    tcache = port.init_cache(b, t)
    with torch.no_grad():
        got = port(torch.from_numpy(x), src_mask=torch.tril(torch.ones(t, t)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for pos in range(t):
            jh, jcache = bound.step(jnp.asarray(x[:, pos]), pos, jcache)
            th, tcache = port.step(torch.from_numpy(x[:, pos]), pos, tcache)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL, err_msg=str(pos))


def test_full_width_lm_parameter_count_matches_flax():
    """`LMConfig()` at vocab 5000 (the flagship's fusion LM: 12 layers,
    d768, 12 heads, d_ffn 3072, linear head), built by each package: the
    count chip_smoke.py holds its beam phase to."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    jm = jlm.build_lm(JLMConfig(), 5000)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 4), jnp.int32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    port = build_lm(LMConfig(), 5000, device="meta")
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == n_jax == chip_smoke.FLAGSHIP_LM_PARAMS == 92_741_000
    assert {p.dtype for p in port.parameters()} == {torch.float32}


def test_build_lm_seeds_weights_and_refuses_the_rnnlm():
    """The same seed draws the same weights, for the Transformer LM and (since
    the RNNLM is ported, no longer refused) the RNNLM; an unknown model type
    is refused."""
    for cfg in (LMConfig(d_model=32, nhead=2, num_layers=1, d_ffn=64),
                LMConfig(model_type="rnn", embedding_dim=8, rnn_neurons=16, dnn_neurons=12)):
        a = build_lm(cfg, 20, device="cpu", seed=5)
        b = build_lm(cfg, 20, device="cpu", seed=5)
        assert not a.training
        for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(pa, pb), name
    assert type(a).__name__ == "RNNLM"
    with pytest.raises(ValueError, match="model_type"):
        build_lm(LMConfig(model_type="gru"), 20, device="cpu")
