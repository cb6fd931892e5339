"""The paper's Summary Decoder in the port against the JAX package, weights
from flax `init` carried across by `load_jax_params`, inputs from a numpy
seed, float32:

- the SummaryMixing cell's `decode_step` (full and fast modes) against the
  flax `decode_step`, and against the port's own forward under a causal
  `sum_mask` at every position;
- the decoder layer, forward and cached step, against flax;
- the recognizer with the Summary Decoder: `seq_log_probs` against flax,
  and the cached step against the whole-prefix decode on every row;
- the `(sum, denom)` carry through the search's parent gather (two
  buffers, the cross-attention K/V untouched);
- the cached joint CTC/attention beam search against the JAX search at
  the same weights: the same tokens, scores within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.decoding import s2s_beam as jbeam
from summarymixing_tpu.models.transformer import TransformerDecoderLayer as JDecoderLayer
from summarymixing_tpu.ops.masks import length_to_mask as jlength_to_mask
from summarymixing_tpu.ops.summary_mixing import SummaryMixing as JSummaryMixing
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.decoding import s2s_beam as tbeam
from summarymixing_tpu_torch.evaluate import make_beam_step
from summarymixing_tpu_torch.models.transformer import TransformerDecoderLayer
from summarymixing_tpu_torch.ops.masks import lookahead_mask
from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing
from summarymixing_tpu_torch.utils.convert import load_jax_params
from test_torch_decoder import RECIPE, TINY_DEC

TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB = 30
SD = {"model.decoder_attention_type": "SummaryMixing", "model.output_neurons": VOCAB}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _params(module, *args, seed=1):
    """A flax params tree for `module.init(key, *args)`, its leaves drawn
    with numpy at the scale of an init (a kernel N(0, 1/fan_in), a
    LayerNorm scale near 1): tracing the init's shapes costs a fraction of
    compiling it."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * noise
        if name == "bias":
            return 0.1 * noise
        fan_in = int(np.prod(leaf.shape[:-1])) if name != "embedding" else 1
        return noise / np.sqrt(fan_in)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@functools.lru_cache(maxsize=None)
def _models(mode):
    """(flax model, port model, flax params) of the tiny recipe with a
    two-layer Summary Decoder in `mode`, the port filled from the tree."""
    over = dict(TINY_DEC, **SD, **{"model.mode": mode})
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    tmodel, _ = build_model(load_recipe(RECIPE, overrides=over), device="cpu")
    params = _params(jmodel, jnp.zeros((1, 16, 80)), jnp.asarray([16]),
                     jnp.ones((1, 3), jnp.int32))
    load_jax_params(tmodel, params)
    return jmodel, tmodel.eval(), params


@pytest.mark.parametrize("mode", ["SummaryMixing", "SummaryMixing-fast"])
def test_decode_step_matches_jax_and_the_causal_forward(rng, mode):
    """Six positions of two rows, nhead 2 in full mode: each step's output
    and carry against the flax `decode_step` (within 2e-5), and against
    the port's forward under the lookahead `sum_mask` at that position
    (within 2e-5: the running mean sums the same terms in another order)."""
    b, t, d = 2, 6, 32
    kw = dict(enc_dim=d, nhead=2 if mode == "SummaryMixing" else 1, local_proj_hid_dim=(48,),
              local_proj_out_dim=d, summary_hid_dim=(48,), summary_out_dim=d, mode=mode)
    jcell = JSummaryMixing(**kw, dropout_rate=0.0)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    params = _params(jcell, jnp.asarray(x), seed=3)
    cell = load_jax_params(SummaryMixing(**kw).eval(), params)
    jcarry = jcell.apply(params, b, method=jcell.decode_init)
    jstep = jax.jit(functools.partial(jcell.apply, method=jcell.decode_step))
    with torch.no_grad():
        whole = cell(_t(x), sum_mask=lookahead_mask(t))
        carry = cell.decode_init(b)
        assert carry["sum"].dtype == carry["denom"].dtype == torch.float32
        assert carry["sum"].shape == (b, d) and carry["denom"].shape == (b, 1)
        for pos in range(t):
            want, jcarry = jstep(params, jnp.asarray(x[:, pos]), jcarry)
            got, carry = cell.decode_step(_t(x[:, pos]), carry)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(got.numpy(), whole[:, pos].numpy(), **TOL)
            for key in ("sum", "denom"):
                np.testing.assert_allclose(carry[key].numpy(), np.asarray(jcarry[key]), **TOL)


def test_summary_decoder_layer_matches_flax(rng):
    """One Summary Decoder layer (d32, nhead 2): the forward over a ragged
    BOS-first target with the lookahead mask, its padding and a padded
    memory, within 2e-5 of flax; then `init_cache` with 2 rows per
    utterance and `step` position by position against the flax step."""
    b, u, s, d = 2, 5, 7, 32
    jlayer = JDecoderLayer(d_model=d, d_ffn=64, nhead=2, attention_type="SummaryMixing",
                           local_proj_hid_dim=(48,), local_proj_out_dim=d,
                           summary_hid_dim=(48,), activation=jax.nn.gelu)
    tgt = rng.standard_normal((b, u, d)).astype(np.float32)
    mem = rng.standard_normal((b, s, d)).astype(np.float32)
    tgt_pad = (np.arange(u)[None, :] < np.array([u, 3])[:, None]).astype(np.float32)
    mem_pad = (np.arange(s)[None, :] < np.array([s, 4])[:, None]).astype(np.float32)
    causal = np.tril(np.ones((u, u), np.float32))
    params = _params(jlayer, jnp.asarray(tgt), jnp.asarray(mem), jnp.asarray(causal), seed=5)
    layer = load_jax_params(TransformerDecoderLayer(
        d, 64, 2, activation="gelu", attention_type="SummaryMixing", local_proj_hid_dim=(48,),
        local_proj_out_dim=d, summary_hid_dim=(48,)).eval(), params)
    want = jax.jit(jlayer.apply)(params, jnp.asarray(tgt), jnp.asarray(mem), jnp.asarray(causal),
                                 tgt_pad_mask=jnp.asarray(tgt_pad),
                                 memory_pad_mask=jnp.asarray(mem_pad))
    with torch.no_grad():
        got = layer(_t(tgt), _t(mem), _t(causal), _t(tgt_pad), _t(mem_pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    rows = 2 * b
    x = rng.standard_normal((u, rows, d)).astype(np.float32)
    jcache = jax.jit(functools.partial(jlayer.apply, method=jlayer.init_cache),
                     static_argnums=(2, 3))(params, jnp.asarray(mem), u, rows)
    jstep = jax.jit(functools.partial(jlayer.apply, method=jlayer.step))
    with torch.no_grad():
        cache = layer.init_cache(_t(mem), u, rows)
        assert cache["mem_k"].shape[0] == b and cache["sm"]["sum"].shape == (rows, d)
        for pos in range(u):
            want, jcache = jstep(params, jnp.asarray(x[pos]), pos, jcache, jnp.asarray(mem_pad))
            got, cache = layer.step(_t(x[pos]), pos, cache, _t(mem_pad))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=None)
def _encoded(mode="SummaryMixing", seed=7):
    """The tiny recognizer with the Summary Decoder (vocab 30) and its
    encoder output for three ragged utterances: (flax model, port model,
    flax params, enc_out, enc_lens, ctc log-probs), tensors as numpy."""
    jmodel, tmodel, params = _models(mode)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 41, 80)).astype(np.float32)
    feat_len = np.array([41, 30, 22], np.int32)
    with torch.no_grad():
        enc, lens = tmodel.encode(_t(feats), torch.from_numpy(feat_len))
        ctc = tmodel.ctc_head(enc)
    return jmodel, tmodel, params, enc.numpy(), lens.numpy(), ctc.numpy()


@pytest.mark.parametrize("mode", ["SummaryMixing", "SummaryMixing-fast"])
def test_recognizer_with_summary_decoder_matches_flax(rng, mode):
    """The recognizer with a two-layer Summary Decoder: `seq_log_probs`
    and the decoder states for ragged, pad-ended targets within 2e-5 of
    flax; then, at 4 rows per utterance with different prefixes, the
    cached step against the whole-prefix `decode_prefix` at every position
    of every row, within 2e-5."""
    jmodel, tmodel, params = _models(mode)
    feats = rng.standard_normal((3, 37, 80)).astype(np.float32)
    feat_len = np.array([37, 20, 29], np.int32)
    tokens = np.array([[1, 5, 7, 3, 9], [1, 4, 0, 0, 0], [1, 12, 3, 3, 0]], np.int32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(feats), jnp.asarray(feat_len),
                                 jnp.asarray(tokens))
    with torch.no_grad():
        got = tmodel(_t(feats), torch.from_numpy(feat_len), torch.from_numpy(tokens).long())
    for key in ("seq_log_probs", "dec_out"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key, **TOL)

    beam, u = 4, 6
    with torch.no_grad():
        enc, lens = tmodel.encode(_t(feats), torch.from_numpy(feat_len))
        n = enc.shape[0] * beam
        toks = torch.cat([torch.ones(n, 1, dtype=torch.long),
                          torch.from_numpy(rng.integers(3, VOCAB, (n, u - 1)))], dim=1)
        whole = tmodel.asr.decode_prefix(toks, tbeam.tile_for_beam(enc, beam),
                                         tbeam.tile_for_beam(lens, beam))
        cache = tmodel.asr.decode_cache_init(enc, u, n)
        pad = (torch.arange(enc.shape[1])[None, :] < lens[:, None]).float()
        for pos in range(u):
            h, cache = tmodel.asr.decode_step_cached(toks[:, pos], pos, cache, pad)
            np.testing.assert_allclose(h.numpy(), whole[:, pos].numpy(), **TOL)


def test_summary_carry_takes_the_two_buffer_gather():
    """After a search step the N-row leaves are gathered by parent into the
    previous step's buffers: the `[N, D]` float32 sum and the `[N, 1]`
    denom of every layer take that path; the cross-attention K/V at B rows
    pass through as they are."""
    _, tmodel, _, enc, _, _ = _encoded()
    beam = 4
    n = enc.shape[0] * beam
    with torch.no_grad():
        cache = tmodel.asr.decode_cache_init(torch.from_numpy(enc), 8, n)
    for layer in cache:
        layer["sm"]["sum"].normal_()
        layer["sm"]["denom"].copy_(torch.arange(n, dtype=torch.float32)[:, None])
    parent = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    originals = [{k: v.clone() for k, v in layer["sm"].items()} for layer in cache]
    first, spare = tbeam._gather_rows(cache, None, parent, n)
    second, _ = tbeam._gather_rows(first, spare, parent, n)
    for before, orig, one, two in zip(cache, originals, first, second):
        assert two["mem_k"] is before["mem_k"] and one["mem_v"] is before["mem_v"]
        for key in ("sum", "denom"):
            assert one["sm"][key].dtype == torch.float32
            assert two["sm"][key].data_ptr() == before["sm"][key].data_ptr()
            assert torch.equal(two["sm"][key], orig[key][parent][parent])
        assert torch.equal(one["sm"]["denom"][:, 0], parent.float())


def _jax_search(config, lm):
    jmodel, _, params, enc, lens, ctc = _encoded()
    jm_lm, lm_params, _ = _lm_pair()
    beam, n = config.beam_size, enc.shape[0] * config.beam_size

    def search(params, lm_params, enc, lens, ctc):
        enc_pad = jlength_to_mask(lens, enc.shape[1])
        cache = jmodel.apply(params, enc, config.max_length + 1, n,
                             method=jmodel.decode_cache_init)

        def step(tok, i, c):
            return jmodel.apply(params, tok, i, c, enc_pad, method=jmodel.decode_step_cached)

        def lm_step(tok, i, c):
            logits, c = jm_lm.apply(lm_params, tok, i, c, method=jm_lm.step)
            return jax.nn.log_softmax(logits, axis=-1), c

        lm_cache = jm_lm.apply(lm_params, n, config.max_length + 1, method=jm_lm.init_cache)
        return jbeam.s2s_beam_search(step, enc, jbeam.tile_for_beam(lens, beam), ctc, config,
                                     lm_step_fn=lm_step if lm else None,
                                     cache=cache, lm_cache=lm_cache if lm else None)

    out = jax.jit(search)(params, lm_params, jnp.asarray(enc), jnp.asarray(lens),
                          jnp.asarray(ctc))
    return [np.asarray(a) for a in out]


@functools.lru_cache(maxsize=None)
def _lm_pair():
    from summarymixing_tpu.models import lm as jlm
    from summarymixing_tpu_torch.models import lm as tlm

    jm = jlm.TransformerLM(vocab=VOCAB, d_model=32, nhead=4, num_layers=1, d_ffn=64)
    params = _params(jm, jnp.zeros((1, 4), jnp.int32), seed=11)
    return jm, params, load_jax_params(tlm.TransformerLM(VOCAB, 32, 4, 1, 64), params).eval()


@pytest.mark.parametrize("lm", [False, True])
def test_beam_search_with_summary_decoder_matches_jax(lm):
    """Beam 4, CTC weight 0.4, decoder temperature 1.15 (both Summary
    Decoder recipes' `test_temperature`), with and without a Transformer LM
    fused at 0.6, through `make_beam_step`'s cached step: the JAX search's
    tokens and lengths exactly, its scores within 1e-4 relative."""
    _, tmodel, _, enc, lens, ctc = _encoded()
    kw = dict(beam_size=4, ctc_weight=0.4, lm_weight=0.6 if lm else 0.0, max_length=8,
              temperature=1.15)
    want = _jax_search(jbeam.S2SBeamConfig(**kw), lm)
    cfg = load_recipe(RECIPE, overrides=dict(TINY_DEC, **SD))
    cfg.decoding.lm_temperature = 1.0
    config = tbeam.S2SBeamConfig(**kw)
    enc_t, lens_t = torch.from_numpy(enc), torch.from_numpy(lens)
    lm_step = lm_make_cache = None
    if lm:
        from summarymixing_tpu_torch.evaluate import make_lm_fusion

        lm_step, lm_make_cache = make_lm_fusion(cfg, _lm_pair()[2])
    with torch.no_grad():
        step, cache, lm_cache = make_beam_step(cfg, tmodel, enc_t, lens_t, 4, config, lm_step,
                                               lm_make_cache)
        assert all("sm" in layer and "self_k" not in layer for layer in cache)
        got = tbeam.s2s_beam_search(step, enc_t, tbeam.tile_for_beam(lens_t, 4),
                                    torch.from_numpy(ctc), config, lm_step_fn=lm_step,
                                    cache=cache, lm_cache=lm_cache)
    toks, lengths, scores = (a.numpy() for a in got)
    np.testing.assert_array_equal(lengths, want[1])
    np.testing.assert_array_equal(toks, want[0])
    np.testing.assert_allclose(scores, want[2], rtol=1e-4)
