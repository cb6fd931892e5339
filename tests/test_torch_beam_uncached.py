"""`EncoderASR` / `EncoderWrapper` and the uncached beam route of
`evaluate.make_beam_step` against the JAX package on the CPU in float32,
on the tiny recognizer of `tests/test_torch_decoder.py` (flax init carried
by `load_jax_params`):

- `EncoderWrapper(asr)` is `asr.encode`, within 2e-5 of the JAX wrapper;
- a decoder type with no cached step takes the JAX `make_beam_step`'s
  other route: `decode_position` over the beam-tiled encoder output,
  within 2e-5 of the JAX `decode_position` and of the cached step on the
  same weights, and the whole search with `cache=None` gives the cached
  search's hypotheses (scores within 1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.models import EncoderWrapper as JEncoderWrapper
from summarymixing_tpu_torch.config import load_recipe
from summarymixing_tpu_torch.decoding.s2s_beam import S2SBeamConfig, s2s_beam_search
from summarymixing_tpu_torch.evaluate import make_beam_step
from summarymixing_tpu_torch.models import EncoderASR, EncoderWrapper
from test_torch_decoder import RECIPE, TINY_DEC, tiny_models

TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB = 30


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_encoder_wrapper_is_encode(rng):
    jmodel, tmodel, params = tiny_models({"model.output_neurons": VOCAB})
    src = rng.standard_normal((2, 9, 80)).astype(np.float32)   # the frontend's output
    lens = np.array([1.0, 0.6], np.float32)
    want = JEncoderWrapper(asr=jmodel.asr).apply(
        {"params": {"asr": params["params"]["asr"]}}, jnp.asarray(src), jnp.asarray(lens))
    wrapper = EncoderWrapper(tmodel.asr)
    assert EncoderWrapper is EncoderASR
    with torch.no_grad():
        got = wrapper(_t(src), _t(lens))
        same = tmodel.asr.encode(_t(src), _t(lens))
    assert torch.equal(got, same)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_uncached_beam_route_matches_jax_and_the_cached_search(rng):
    """A decoder type with no cached step takes the JAX fallback: the step
    is `decode_position` over the beam-tiled encoder output, and the
    search runs with `cache=None`."""
    jmodel, tmodel, params = tiny_models({"model.output_neurons": VOCAB})
    b, beam = 2, 3
    feats = rng.standard_normal((b, 41, 80)).astype(np.float32)
    feat_len = np.array([41, 30], np.int32)
    with torch.no_grad():
        enc, lens = tmodel.encode(_t(feats), torch.from_numpy(feat_len))
        ctc = tmodel.ctc_head(enc)
    cfg = load_recipe(RECIPE, overrides=dict(TINY_DEC, **{"model.output_neurons": VOCAB}))
    other = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, decoder_attention_type="RelPosMHAXL"))
    bc = S2SBeamConfig(beam_size=beam, ctc_weight=0.4, max_length=6, bos_id=1, eos_id=2)
    step, cache, lm_cache = make_beam_step(other, tmodel, enc, lens, beam, bc)
    assert cache is None and lm_cache is None
    toks = np.concatenate([np.ones((b * beam, 1), np.int64),
                           rng.integers(3, VOCAB, (b * beam, 5))], 1)
    enc_t = jnp.asarray(np.repeat(enc.numpy(), beam, 0))
    len_t = jnp.asarray(np.repeat(lens.numpy(), beam, 0))
    c_step, c_cache, _ = make_beam_step(cfg, tmodel, enc, lens, beam, bc)
    with torch.no_grad():
        for pos in range(5):
            got = step(torch.from_numpy(toks), pos)
            want = jmodel.apply(params, jnp.asarray(toks), enc_t, len_t, pos,
                                method=jmodel.decode_position)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=str(pos))
            cached, c_cache = c_step(torch.from_numpy(toks[:, pos]), pos, c_cache)
            np.testing.assert_allclose(got.numpy(), cached.numpy(), **TOL, err_msg=str(pos))
        tiled = lens.repeat_interleave(beam)
        plain = s2s_beam_search(step, enc, tiled, ctc, bc, cache=None)
        c_step, c_cache, _ = make_beam_step(cfg, tmodel, enc, lens, beam, bc)
        cached = s2s_beam_search(c_step, enc, tiled, ctc, bc, cache=c_cache)
    assert torch.equal(plain[0], cached[0]) and torch.equal(plain[1], cached[1])
    np.testing.assert_allclose(plain[2].numpy(), cached[2].numpy(), rtol=1e-5, atol=1e-5)
