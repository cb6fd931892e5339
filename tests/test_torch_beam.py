"""The port's beam-search evaluation path against the JAX package on the CPU:
the KV-cached attention and decoder steps, every CTC prefix-scoring
function, the top-k tie order, the joint CTC/attention search with LM
fusion, and `evaluate.evaluate_beam`. Small sizes: encoder 2 layers,
decoder 2 (d 32), LM 2 layers d 64, vocab 30, beam 4; float32; weights
from flax `init` through `load_jax_params`, inputs from a numpy seed.

Tolerances: the steps 2e-5 absolute and relative (float32, the same
products in another association); the CTC scorer 1e-4 absolute (float32
cumulative sums over T against JAX's associative scan); the search's best
tokens and lengths identical, its scores within 1e-4 relative."""

import copy
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.decoding import ctc_prefix as jctc
from summarymixing_tpu.decoding import s2s_beam as jbeam
from summarymixing_tpu.models import lm as jlm
from summarymixing_tpu.ops import attention as jattn
from summarymixing_tpu.ops.masks import length_to_mask as jlength_to_mask
from summarymixing_tpu_torch.config import load_recipe
from summarymixing_tpu_torch.decoding import ctc_prefix as tctc
from summarymixing_tpu_torch.decoding import s2s_beam as tbeam
from summarymixing_tpu_torch.evaluate import (
    beam_config,
    beam_slices,
    evaluate_beam,
    make_beam_step,
    make_lm_fusion,
    static_decode_length,
)
from summarymixing_tpu_torch.models import lm as tlm
from summarymixing_tpu_torch.ops import attention as tattn
from summarymixing_tpu_torch.ops.masks import length_to_mask
from summarymixing_tpu_torch.transcribe import batch_waveforms
from summarymixing_tpu_torch.utils.convert import load_jax_params
from test_torch_decoder import RECIPE, TINY_DEC, tiny_models

STEP_TOL = dict(atol=2e-5, rtol=2e-5)
VOCAB = 30
ASR = {"model.output_neurons": VOCAB}


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.asarray(a, dtype))


def _i(a):
    return torch.from_numpy(np.asarray(a, np.int64))


# -- cached attention and decoder steps ---------------------------------------

@pytest.mark.parametrize("route", ["self", "cross", "cross_grouped"])
def test_attention_step_matches_flax(rng, route):
    """Four heads: the appending self-attention step over 5 positions, the
    cross-attention step with a pad mask, and the grouped one whose 3
    query rows per utterance share an untiled cache."""
    b, s, d, g = 2, 7, 32, 3
    jm = jattn.MultiheadAttention(d_model=d, nhead=4)
    x0 = jnp.zeros((1, 1, d), jnp.float32)
    params = jm.init(jax.random.PRNGKey(2), x0, x0, x0)
    port = load_jax_params(tattn.MultiheadAttention(d, 4), params)
    bound = jm.bind(params)
    with torch.no_grad():
        if route == "self":
            jk = jv = jnp.zeros((b, 5, 4, d // 4), jnp.float32)
            tk, tv = torch.zeros(b, 4, 5, d // 4), torch.zeros(b, 4, 5, d // 4)
            for pos in range(5):
                x = rng.standard_normal((b, d)).astype(np.float32)
                want, jk, jv = bound.step(jnp.asarray(x), jk, jv, pos)
                got, tk, tv = port.step(_t(x), tk, tv, pos)
                np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
            np.testing.assert_allclose(tk.transpose(1, 2).numpy(), np.asarray(jk), **STEP_TOL)
            return
        mem = rng.standard_normal((b, s, d)).astype(np.float32)
        pad = (np.arange(s)[None, :] < np.array([s, 4])[:, None]).astype(np.float32)
        rows = b * g if route == "cross_grouped" else b
        x = rng.standard_normal((rows, d)).astype(np.float32)
        jk, jv = bound.kv(jnp.asarray(mem))
        tk, tv = port.kv(_t(mem))
        want, _, _ = bound.step(jnp.asarray(x), jk, jv, 0, pad_mask=jnp.asarray(pad), append=False)
        got, _, _ = port.step(_t(x), tk, tv, 0, pad_mask=_t(pad), append=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


@functools.lru_cache(maxsize=None)
def _encoded(seed=7, b=3):
    """Encoder output of the tiny recognizer (vocab 30) for ragged random
    features: (flax model, port model, flax params, enc_out, enc_lens,
    ctc log-probs), each tensor as numpy."""
    jmodel, tmodel, params = tiny_models(ASR)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, 41, 80)).astype(np.float32)
    feat_len = np.array([41, 30, 22][:b], np.int32)
    with torch.no_grad():
        enc, lens = tmodel.encode(_t(feats), torch.from_numpy(feat_len))
        ctc = tmodel.ctc_head(enc)
    return jmodel, tmodel, params, enc.numpy(), lens.numpy(), ctc.numpy()


@pytest.mark.parametrize("beam", [1, 4])
def test_decoder_cached_step_matches_flax_and_decode_position(rng, beam):
    """`decode_cache_init` with rows = B·beam over the untiled encoder
    output, then `decode_step_cached` position by position: the flax
    cached step's log-probs, and the port's own uncached
    `decode_position` over the same prefixes."""
    jmodel, tmodel, params, enc, lens, _ = _encoded()
    b, u = enc.shape[0], 6
    n = b * beam
    toks = np.concatenate([np.ones((n, 1), np.int64), rng.integers(3, VOCAB, (n, u - 1))], 1)
    enc_pad = jlength_to_mask(jnp.asarray(lens), enc.shape[1])
    jcache = jmodel.apply(params, jnp.asarray(enc), u + 1, n, method=jmodel.decode_cache_init)
    enc_t = torch.from_numpy(enc)
    tcache = tmodel.decode_cache_init(enc_t, u + 1, n)
    assert tcache[0]["mem_k"].shape[0] == b and tcache[0]["self_k"].shape[0] == n
    enc_tiled = enc_t.repeat_interleave(beam, 0)
    lens_tiled = torch.from_numpy(lens).repeat_interleave(beam, 0)
    with torch.no_grad():
        for pos in range(u):
            want, jcache = jmodel.apply(params, jnp.asarray(toks[:, pos]), pos, jcache, enc_pad,
                                        method=jmodel.decode_step_cached)
            got, tcache = tmodel.decode_step_cached(_i(toks[:, pos]), pos, tcache,
                                                    length_to_mask(torch.from_numpy(lens),
                                                                   enc.shape[1]))
            oracle = tmodel.decode_position(_i(toks), enc_tiled, lens_tiled, pos)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL, err_msg=str(pos))
            np.testing.assert_allclose(got.numpy(), oracle.numpy(), **STEP_TOL, err_msg=str(pos))


# -- CTC prefix scoring ---------------------------------------------------------

def _lattice(rng, b=2, t=13, v=9):
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * 2.0
    x = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return x.astype(np.float32), np.array([t, t - 5][:b], np.int64)


@functools.lru_cache(maxsize=None)
def _jit(fn):
    """`fn` jitted, its int options static."""
    names = {"blank_id", "eos_id", "beam"} & set(inspect.signature(fn).parameters)
    return jax.jit(fn, static_argnames=tuple(names))


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("beam", [1, 3])
def test_ctc_prefix_functions_match_jax(rng, beam):
    """Two rounds of scoring candidates that include eos and repeats of
    each row's last token, then extending each row by one chosen
    candidate: `ctc_prefix_init`, `ctc_prefix_score` (parallel and the
    sequential oracle), `ctc_prefix_score_only`, `ctc_prefix_select` and
    `ctc_prefix_advance`, against the JAX functions (beam 1: a pre-tiled
    lattice; beam 3: the untiled one)."""
    x, lens = _lattice(rng)
    b, t, v = x.shape
    n, k = b * beam, 4
    lens_n = np.repeat(lens, beam)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if beam == 1:
        lens_n = lens
    st_t = tctc.ctc_prefix_init(xt, _i(lens_n), 0, beam=beam)
    st_j = jctc.ctc_prefix_init(xj, jnp.asarray(lens_n), 0, beam=beam)
    for i, leaf in enumerate(st_t):
        _close(leaf.numpy(), st_j[i])
    for _ in range(2):
        cand = rng.integers(1, v, (n, k))
        cand[:, 0] = 2                                              # eos
        cand[:, 1] = np.where(st_t.last.numpy() >= 0, st_t.last.numpy(), 3)   # a repeat
        args_t = (st_t, xt, _i(lens_n), _i(cand), 0, 2)
        args_j = (st_j, xj, jnp.asarray(lens_n), jnp.asarray(cand, jnp.int32))
        sc_t, cs_t = tctc.ctc_prefix_score(*args_t, beam=beam)
        sc_j, cs_j = _jit(jctc.ctc_prefix_score)(*args_j, blank_id=0, eos_id=2, beam=beam)
        sc_s, cs_s = tctc.ctc_prefix_score(*args_t, impl="scan", beam=beam)
        only_t, psi_t = tctc.ctc_prefix_score_only(*args_t, beam=beam)
        only_j, psi_j = _jit(jctc.ctc_prefix_score_only)(*args_j, blank_id=0, eos_id=2,
                                                          beam=beam)
        _close(sc_t, sc_j)
        _close(only_t, only_j)
        _close(psi_t, psi_j)
        _close(sc_s, sc_t)
        valid = np.arange(t)[None, None, :] < lens_n[:, None, None]
        for name in ("r_nb", "r_b"):
            got, scan = getattr(cs_t, name).numpy(), getattr(cs_s, name).numpy()
            _close(np.where(valid, got, 0), np.where(valid, np.asarray(getattr(cs_j, name)), 0))
            _close(np.where(valid, got, 0), np.where(valid, scan, 0))
        pick = rng.integers(1, k, n)                                # never eos
        rows = np.arange(n)
        sel_t = tctc.ctc_prefix_select(cs_t, _i(rows), _i(pick))
        adv_t = tctc.ctc_prefix_advance(st_t, xt, _i(lens_n), _i(cand[rows, pick]),
                                        psi_t[rows, pick], 0, beam=beam)
        adv_j = _jit(jctc.ctc_prefix_advance)(st_j, xj, jnp.asarray(lens_n),
                                        jnp.asarray(cand[rows, pick], jnp.int32),
                                        psi_j[rows, pick], blank_id=0, beam=beam)
        for i in range(4):
            _close(adv_t[i].numpy(), adv_j[i])
            _close(adv_t[i].numpy(), sel_t[i].numpy())
        st_t, st_j = adv_t, adv_j


def test_ctc_prefix_eos_scores_the_ctc_loss(rng):
    """Advancing the empty prefix along a transcript and scoring eos gives
    -ctc_loss of that transcript, minus psi (the oracle chip_smoke.py
    holds the card to)."""
    x, lens = _lattice(rng, t=17)
    targets = np.array([[3, 3, 5, 7], [4, 6, 6, 1]], np.int64)
    xt = torch.from_numpy(x)
    state = tctc.ctc_prefix_init(xt, _i(lens))
    for j in range(targets.shape[1]):
        cand = _i(targets[:, j:j + 1])
        _, psi = tctc.ctc_prefix_score_only(state, xt, _i(lens), cand)
        state = tctc.ctc_prefix_advance(state, xt, _i(lens), cand[:, 0], psi[:, 0])
    eos, _ = tctc.ctc_prefix_score_only(state, xt, _i(lens), torch.full((2, 1), 2), eos_id=2)
    want = -torch.nn.functional.ctc_loss(xt.transpose(0, 1), _i(targets), _i(lens),
                                         torch.full((2,), 4), reduction="none")
    _close((eos[:, 0] + state.psi).numpy(), want.numpy())


def test_compact_blank_frames_is_not_ported():
    """It raised until blank-skip compaction was ported; now at threshold
    1.0 with no cap it keeps every valid frame and appends the tail frame
    (`tests/test_torch_blank_skip.py` holds it against the JAX function)."""
    x = torch.log_softmax(torch.arange(6.0).reshape(1, 2, 3), dim=-1)
    x2, lens2, kept = tctc.compact_blank_frames(x, torch.ones(1, dtype=torch.int64), 0, 0, 1.0)
    assert x2.shape == (1, 8, 3) and lens2.tolist() == [2] and kept.tolist() == [1]
    assert torch.equal(x2[0, 0], x[0, 0])


# -- the search -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 9), (3, 4)])
def test_topk_puts_the_lower_index_first_among_ties(rng, shape):
    x = rng.integers(0, 3, shape).astype(np.float32)
    x[:, -2:] = -1e9
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 3)
    got_v, got_i = tbeam.topk(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@functools.lru_cache(maxsize=None)
def _lm_pair():
    jm = jlm.TransformerLM(vocab=VOCAB, d_model=64, nhead=4, num_layers=2, d_ffn=128)
    params = jm.init(jax.random.PRNGKey(11), jnp.zeros((1, 4), jnp.int32))
    port = load_jax_params(tlm.TransformerLM(VOCAB, 64, 4, 2, 128), params).eval()
    return jm, params, port


def _jax_search(config, nbest, eos_bias):
    jmodel, _, params, enc, lens, ctc = _encoded()
    jm_lm, lm_params, _ = _lm_pair()
    if eos_bias:
        params = jax.tree_util.tree_map(lambda a: a, params)
        params["params"]["seq_lin"]["bias"] = params["params"]["seq_lin"]["bias"].at[2].add(
            eos_bias)
    beam, n = config.beam_size, enc.shape[0] * config.beam_size
    enc_pad = jlength_to_mask(jnp.asarray(lens), enc.shape[1])
    cache = jmodel.apply(params, jnp.asarray(enc), config.max_length + 1, n,
                         method=jmodel.decode_cache_init)
    lm_cache = jm_lm.apply(lm_params, n, config.max_length + 1, method=jm_lm.init_cache)

    def step(tok, i, c):
        return jmodel.apply(params, tok, i, c, enc_pad, method=jmodel.decode_step_cached)

    def lm_step(tok, i, c):
        logits, c = jm_lm.apply(lm_params, tok, i, c, method=jm_lm.step)
        return jax.nn.log_softmax(logits / 1.15, axis=-1), c

    out = jbeam.s2s_beam_search(step, jnp.asarray(enc),
                                jbeam.tile_for_beam(jnp.asarray(lens), beam), jnp.asarray(ctc),
                                config, lm_step_fn=lm_step, cache=cache, lm_cache=lm_cache,
                                nbest=nbest)
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("nbest,defer,eos_bias", [(1, True, 0.0), (2, True, 0.0),
                                                  (1, False, 0.0), (2, True, 20.0)])
def test_beam_search_matches_jax(nbest, defer, eos_bias):
    """Beam 4, CTC weight 0.4, LM fusion at 0.6 with LM temperature 1.15,
    decoder temperature 1.15, both KV caches; 1-best and 2-best, the
    deferred CTC states and the materialised ones, and an eos bias that
    finishes every row before the cap (the early exit: the port runs
    fewer steps than max_length, as the JAX while_loop does)."""
    _, tmodel, _, enc, lens, ctc = _encoded()
    tmodel = copy.deepcopy(tmodel)
    _, _, tlm_port = _lm_pair()
    cfg = load_recipe(RECIPE, overrides=dict(TINY_DEC, **ASR))
    cfg.decoding.lm_temperature = 1.15
    config = tbeam.S2SBeamConfig(beam_size=4, ctc_weight=0.4, lm_weight=0.6, max_length=8,
                                 temperature=1.15, ctc_defer_states=defer)
    jconfig = jbeam.S2SBeamConfig(beam_size=4, ctc_weight=0.4, lm_weight=0.6, max_length=8,
                                  temperature=1.15, ctc_defer_states=defer)
    want = _jax_search(jconfig, nbest, eos_bias)
    if eos_bias:
        with torch.no_grad():
            tmodel.seq_lin.bias[2] += eos_bias
    enc_t, lens_t = torch.from_numpy(enc), torch.from_numpy(lens)
    lm_step, lm_make_cache = make_lm_fusion(cfg, tlm_port)
    calls = [0]
    with torch.no_grad():
        step, cache, lm_cache = make_beam_step(cfg, tmodel, enc_t, lens_t, 4, config, lm_step,
                                               lm_make_cache)

        def counted(tok, i, c):
            calls[0] += 1
            return step(tok, i, c)

        got = tbeam.s2s_beam_search(counted, enc_t, tbeam.tile_for_beam(lens_t, 4),
                                    torch.from_numpy(ctc), config, lm_step_fn=lm_step,
                                    cache=cache, lm_cache=lm_cache, nbest=nbest)
    toks, lengths, scores = (a.numpy() for a in got)
    np.testing.assert_array_equal(lengths, want[1])
    np.testing.assert_array_equal(toks, want[0])
    np.testing.assert_allclose(scores, want[2], rtol=1e-4)
    assert (calls[0] < config.max_length) == bool(eos_bias), calls[0]


def test_evaluate_beam_scores_every_utterance_once_and_slices_exactly(rng):
    """`evaluate_beam` over 5 waveforms in batches of 2 (the last batch
    repeats an utterance): every utterance decoded once; searching in
    row-capped slices gives the unsliced hypotheses; WER against the
    hypotheses themselves is 0; the decode length follows the longest
    waveform."""
    _, tmodel, _, _, _, _ = _encoded()
    _, _, tlm_port = _lm_pair()
    cfg = load_recipe(RECIPE, overrides=dict(TINY_DEC, **ASR, **{
        "decoding.test_beam_size": 3, "decoding.test_temperature": 1.15}))
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (4000, 3000, 5200, 2500, 3600)]
    batches = list(batch_waveforms(wavs, 2, 800, device="cpu"))
    fbank_cfg = cfg.features
    from summarymixing_tpu_torch.frontend.features import Fbank, NormStats

    fbank = Fbank(fbank_cfg.sample_rate, fbank_cfg.n_fft, float(fbank_cfg.win_length),
                  float(fbank_cfg.hop_length), fbank_cfg.n_mels)
    stats = NormStats.init(80)
    outs = []
    for rows in (0, 3):
        cfg.decoding.max_beam_rows = rows
        outs.append(evaluate_beam(tmodel, fbank, stats, batches, cfg, lm=tlm_port,
                                  references=None))
    whole, sliced = outs
    assert sorted(whole["hyps"]) == list(range(5))
    assert whole["hyps"] == sliced["hyps"]
    # 5200 samples: 1 + 5200 // 160 = 33 Fbank frames, ceil(33 / 2 / 2) = 9 encoder frames
    assert whole["max_length"] == static_decode_length(cfg, 5200, fbank) == 9
    assert 0 < whole["steps"] and whole["steps"] <= 3 * whole["max_length"]
    refs = {u: h for u, h in whole["hyps"].items()}
    again = evaluate_beam(tmodel, fbank, stats, batches, cfg, lm=tlm_port, references=refs)
    assert again["summary"]["WER"] == 0.0 and again["summary"]["num_sentences"] == 5


def test_beam_slices_cap_rows_and_repeat_the_last_utterance():
    """At most max_rows // beam utterances per slice; the last slice is
    shorter and repeats no utterance."""
    idx = [10, 11, 12, 13, 14]
    arr = torch.arange(5)
    got = [(s, a.tolist()) for s, a in beam_slices(8, 4, idx, arr)]
    assert got == [([10, 11], [0, 1]), ([12, 13], [2, 3]), ([14], [4])]
    assert [s for s, _ in beam_slices(0, 4, idx, arr)] == [idx]


@pytest.mark.parametrize("with_lm", [False, True])
def test_beam_config_reads_the_recipe(with_lm):
    """The flagship recipe's decoding section: beam 66, CTC 0.4, decoder
    temperature 1.15, and lm_weight 0.6 only when an LM step is fused."""
    cfg = load_recipe(RECIPE)
    _, _, tlm_port = _lm_pair()
    lm_step, _ = make_lm_fusion(cfg, tlm_port if with_lm else None)
    bc = beam_config(cfg, 256, lm_step)
    assert (bc.beam_size, bc.ctc_weight, bc.temperature, bc.max_length) == (66, 0.4, 1.15, 256)
    assert bc.lm_weight == (0.6 if with_lm else 0.0)
    assert (bc.blank_id, bc.bos_id, bc.eos_id) == (cfg.model.blank_index, cfg.model.bos_index,
                                                   cfg.model.eos_index)
