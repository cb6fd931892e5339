"""The SummaryMixing cell's lite and expdecay modes in the port against the
JAX package and the clean-room torch oracle, float32 on the CPU:

- the cell in each mode against the flax cell, weights from flax `init`
  carried across by `load_jax_params` (no mask, padding, a causal `[T, T]`
  `sum_mask`, the `[B, T, T]` mask with padded columns, two heads), and
  against `tests/torch_oracle.py` where the JAX package's own test holds
  it (`tests/test_summary_mixing.py:57-120`);
- lite's refusal of a `sum_mask`, and expdecay's padding invariance;
- `decode_step`: expdecay against the flax step and the whole-prefix
  forward under the lookahead mask, lite against a direct running mean;
- the card's route: neither mode is taken by the kernel, so on the card
  each call is a counted plain call, and nothing launches;
- a 2-layer lite and expdecay Branchformer ASR's CTC log-probs, and a
  2-layer expdecay Summary Decoder's, against the JAX models;
- the flagship's parameter count in lite mode, port against flax;
- a lite SpeechBrain-layout checkpoint (the clean-room oracle's state
  dict without the local branch and the merge) through
  `convert_full_model`: every key read, the tree equal to the JAX
  converter's bit for bit, the port's lite model filled from it against
  the JAX model on the JAX tree.

Tolerances: 2e-5 on a cell or a layer (float32 sums in another order), 1e-4
on a whole model (two encoder layers of them).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.utils import convert as jconvert
from summarymixing_tpu.ops.summary_mixing import SummaryMixing as JSummaryMixing
from summarymixing_tpu.ops.summary_mixing import laplace_weights as jlaplace_weights
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.ops import fused_summary, summary_mixing
from summarymixing_tpu_torch.ops.masks import combine_padding, lookahead_mask
from summarymixing_tpu_torch.ops.summary_mixing import MODES, SummaryMixing, laplace_weights
from summarymixing_tpu_torch.utils import convert as tconvert
from summarymixing_tpu_torch.utils.convert import load_jax_params
from test_torch_convert_reference import NDEC, NENC, ORACLE_WIDTHS
from test_torch_model import TINY
from test_torch_summary_decoder import _models as summary_decoder_models
from torch_full_oracle import build_oracle
from torch_oracle import draw_summary_mixing, summary_mixing_forward, to_flax_params

RECIPE = os.path.join(os.path.dirname(__file__), "..", "recipes", "LibriSpeech",
                      "branchformer_summarymixing.yaml")
TOL = dict(atol=2e-5, rtol=2e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
LITE, EXPDECAY = "SummaryMixing-lite", "SummaryMixing-expdecay"
# 88,954,088 less 18 x (local_proj 525,312 + summary_local_merging 524,800)
FLAGSHIP_LITE_PARAMS = 70_052_072
B, T, D = 3, 9, 16
LENS = np.array([T, 6, 3])


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _kw(mode, nhead=1):
    return dict(enc_dim=D, nhead=nhead, local_proj_hid_dim=(24,), local_proj_out_dim=D,
                summary_hid_dim=(32,), summary_out_dim=D, mode=mode)


@functools.lru_cache(maxsize=None)
def _cells(mode, nhead=1):
    """(flax cell, its params, the port's cell from them)."""
    jcell = JSummaryMixing(**_kw(mode, nhead), dropout_rate=0.0)
    params = jax.jit(jcell.init)(jax.random.PRNGKey(nhead), jnp.zeros((1, T, D)))
    return jcell, params, load_jax_params(SummaryMixing(**_kw(mode, nhead)).eval(), params)


def _pad():
    return (np.arange(T)[None, :] < LENS[:, None]).astype(np.float32)


def test_modes_and_laplace_weights_are_the_jax_package_s():
    from summarymixing_tpu.ops.summary_mixing import MODES as JMODES

    assert MODES == JMODES
    for size, decay in ((3, 0.5), (40, 0.995)):
        np.testing.assert_allclose(laplace_weights(size, decay).numpy(),
                                   np.asarray(jlaplace_weights(size, decay)), rtol=1e-6)
    with pytest.raises(ValueError, match="mode must be one of"):
        SummaryMixing(D, mode="SummaryMixing-slow")


@pytest.mark.parametrize("mode,mask,nhead", [
    (LITE, "none", 1), (LITE, "pad", 1), (LITE, "pad", 2),
    (EXPDECAY, "none", 1), (EXPDECAY, "pad", 1), (EXPDECAY, "pad", 2),
    (EXPDECAY, "causal", 1), (EXPDECAY, "causal+pad", 1),
])
def test_cell_matches_flax(rng, mode, mask, nhead):
    """Every output position, padded ones included: the port computes what
    flax computes there too. "causal+pad" is the `[B, T, T]` mask an
    encoder passes (`combine_padding`)."""
    jcell, params, cell = _cells(mode, nhead)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pad = _pad() if "pad" in mask else None
    causal = np.tril(np.ones((T, T), np.float32)) if "causal" in mask else None
    sm = causal
    if causal is not None and pad is not None:
        sm = combine_padding(_t(causal), _t(pad)).numpy()
    want = jcell.apply(params, jnp.asarray(x), sum_mask=None if sm is None else jnp.asarray(sm),
                       pad_mask=None if pad is None else jnp.asarray(pad))
    with torch.no_grad():
        got = cell(_t(x), sum_mask=None if sm is None else _t(sm),
                   pad_mask=None if pad is None else _t(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode,masked", [(LITE, "none"), (LITE, "pad"), (EXPDECAY, "none"),
                                         (EXPDECAY, "pad"), (EXPDECAY, "pad+sum")])
def test_cell_matches_the_torch_oracle(rng, mode, masked):
    """The published equations (`tests/torch_oracle.py`), nhead 2, as the
    JAX package's own test holds its cell: valid steps under padding, and
    expdecay under padding on each row's unpadded prefix alone (the port,
    as the JAX package, normalises by the valid decay mass, where the
    reference counts the padded columns)."""
    fea, nhead = 8, 2
    p = draw_summary_mixing(1234 + nhead, fea, nhead, [32], 32, [64], fea, mode)
    cell = load_jax_params(SummaryMixing(fea, nhead, (32,), 32, (64,), fea, mode=mode).eval(),
                           to_flax_params(p))
    x = torch.from_numpy(rng.standard_normal((3, 7, fea)).astype(np.float32))
    lens = [7, 5, 3]
    pad = (torch.arange(7)[None, :] < torch.tensor(lens)[:, None]).float()
    sm = None
    if masked == "pad+sum":
        sm = (torch.from_numpy(rng.random((7, 7))) < 0.6).float()
        sm[torch.arange(7), torch.arange(7)] = 1.0
    with torch.no_grad():
        got = cell(x, sum_mask=sm, pad_mask=None if masked == "none" else pad)
        if masked == "none":
            np.testing.assert_allclose(got.numpy(), summary_mixing_forward(x, p).numpy(), **TOL)
            return
        for i, n in enumerate(lens):
            if mode == EXPDECAY and masked == "pad":
                want = summary_mixing_forward(x[i:i + 1, :n], p)[0]
            else:
                want = summary_mixing_forward(x, p, sum_mask=sm, pad_mask=pad)[i, :n]
            np.testing.assert_allclose(got[i, :n].numpy(), want.numpy(), **TOL)


def test_lite_refuses_a_sum_mask(rng):
    """The lite summary is one global mean: a causal or chunked mask would
    be ignored and the model would train non-causally, so both packages
    raise."""
    jcell, params, cell = _cells(LITE)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    causal = np.tril(np.ones((T, T), np.float32))
    with pytest.raises(ValueError, match="no sum_mask path"):
        jcell.apply(params, jnp.asarray(x), sum_mask=jnp.asarray(causal))
    with pytest.raises(ValueError, match="no sum_mask path"):
        cell(_t(x), sum_mask=_t(causal))


def test_expdecay_is_invariant_to_padding(rng):
    """Outputs at valid steps do not move when trailing padding grows and
    the padded frames hold garbage: the decay weights' padded columns are
    zeroed, so each row is normalised by its valid decay mass."""
    _, _, cell = _cells(EXPDECAY)
    n = 5
    x = rng.standard_normal((1, n, D)).astype(np.float32)
    with torch.no_grad():
        alone = cell(_t(x))
        for extra in (1, 4):
            padded = np.concatenate(
                [x, 1e3 * rng.standard_normal((1, extra, D)).astype(np.float32)], axis=1)
            pad = (np.arange(n + extra) < n).astype(np.float32)[None]
            got = cell(_t(padded), pad_mask=_t(pad))
            np.testing.assert_allclose(got[:, :n].numpy(), alone.numpy(), **TOL)


def test_expdecay_decode_step_matches_jax_and_the_causal_forward(rng):
    """Six positions of two rows at nhead 2: each step's output and its
    decayed carry against the flax `decode_step`, and the output against
    the port's forward under the lookahead `sum_mask` at that position."""
    b, t = 2, 6
    jcell, params, cell = _cells(EXPDECAY, 2)
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    jcarry = jcell.apply(params, b, method=jcell.decode_init)
    jstep = jax.jit(functools.partial(jcell.apply, method=jcell.decode_step))
    with torch.no_grad():
        whole = cell(_t(x), sum_mask=lookahead_mask(t))
        carry = cell.decode_init(b)
        for pos in range(t):
            want, jcarry = jstep(params, jnp.asarray(x[:, pos]), jcarry)
            got, carry = cell.decode_step(_t(x[:, pos]), carry)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(got.numpy(), whole[:, pos].numpy(), **TOL)
            for key in ("sum", "denom"):
                np.testing.assert_allclose(carry[key].numpy(), np.asarray(jcarry[key]), **TOL)
    np.testing.assert_allclose(carry["denom"].numpy(),
                               sum(0.995 ** k for k in range(t)) * np.ones((b, 1)), rtol=1e-6)


def test_lite_decode_step_is_the_running_mean(rng):
    """Lite's whole-prefix forward refuses the lookahead mask, so its step
    is held against the running mean of s(x_1..t) taken directly (as the
    JAX package's own test leaves lite out), and against the flax step."""
    b, t = 2, 5
    jcell, params, cell = _cells(LITE, 2)
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    jcarry = jcell.apply(params, b, method=jcell.decode_init)
    jstep = jax.jit(functools.partial(jcell.apply, method=jcell.decode_step))
    with torch.no_grad():
        s = cell.summary_proj(_t(x))
        carry = cell.decode_init(b)
        for pos in range(t):
            want, jcarry = jstep(params, jnp.asarray(x[:, pos]), jcarry)
            got, carry = cell.decode_step(_t(x[:, pos]), carry)
            np.testing.assert_allclose(got.numpy(), s[:, :pos + 1].mean(1).numpy(), **TOL)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", [LITE, EXPDECAY])
def test_card_route_is_the_counted_plain_path(rng, monkeypatch, mode):
    """The kernel computes full mode only (`fused_summary.refusal`), so with
    the card's route taken (`uses_kernel` patched) a lite or expdecay cell
    in the flagship's configuration counts one plain call and launches
    nothing, and computes what it computes off the route."""
    assert fused_summary.refusal(d=512, local_dims=(512, 512), summary_dims=(512, 512), n=512,
                                 activation="gelu", dtype=torch.bfloat16, mode=mode)
    _, _, cell = _cells(mode)
    x = _t(rng.standard_normal((B, T, D)))
    with torch.no_grad():
        want = cell(x, pad_mask=_t(_pad()))
        monkeypatch.setattr(summary_mixing, "uses_kernel", lambda x: True)
        fn = fused_summary.fused_summary_mixing
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "plain_calls", 0)
        got = cell(x, pad_mask=_t(_pad()))
    assert (fn.launches, fn.plain_calls) == (0, 1)
    assert torch.equal(got, want)


@functools.lru_cache(maxsize=None)
def _asr(mode):
    over = dict(TINY, **{"model.mode": mode})
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    tmodel, _ = build_model(load_recipe(RECIPE, overrides=over), device="cpu")
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)),
                                  jnp.asarray([16]))
    load_jax_params(tmodel, params)
    return jmodel, tmodel.eval(), params


@pytest.mark.parametrize("mode", [LITE, EXPDECAY])
def test_branchformer_asr_ctc_log_probs_match_jax(rng, mode):
    """The 2-layer Branchformer recognizer (d32) in lite and expdecay mode:
    CTC log-probs of three ragged utterances within 1e-4 of flax, and the
    encoder lengths equal."""
    jmodel, tmodel, params = _asr(mode)
    feats = rng.standard_normal((3, 45, 80)).astype(np.float32)
    feat_len = np.array([45, 30, 17], np.int32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(feats), jnp.asarray(feat_len))
    with torch.no_grad():
        got = tmodel(_t(feats), torch.from_numpy(feat_len))
    assert np.array_equal(got["enc_lengths"].numpy(), np.asarray(want["enc_lengths"]))
    for i, n in enumerate(got["enc_lengths"].tolist()):
        np.testing.assert_allclose(got["ctc_log_probs"][i, :n].numpy(),
                                   np.asarray(want["ctc_log_probs"])[i, :n], **MODEL_TOL)
    if mode == LITE:
        cell = tmodel.asr.encoder.layer_0.mixer
        assert not hasattr(cell, "local_proj") and not hasattr(cell, "summary_local_merging")


def test_expdecay_summary_decoder_matches_flax(rng):
    """The recognizer with a 2-layer Summary Decoder whose self-attention
    cells are expdecay (`model.mode` reaches the decoder, as in flax):
    `seq_log_probs` and the decoder states within 2e-5 of flax, and the
    cached step (the decayed carry) against the whole-prefix decode."""
    jmodel, tmodel, params = summary_decoder_models(EXPDECAY)
    assert tmodel.asr.decoder.layer_0.self_attn.mode == EXPDECAY
    feats = rng.standard_normal((2, 33, 80)).astype(np.float32)
    feat_len = np.array([33, 21], np.int32)
    tokens = np.array([[1, 5, 7, 3, 9], [1, 4, 6, 0, 0]], np.int32)
    want = jax.jit(jmodel.apply)(params, jnp.asarray(feats), jnp.asarray(feat_len),
                                 jnp.asarray(tokens))
    with torch.no_grad():
        got = tmodel(_t(feats), torch.from_numpy(feat_len), torch.from_numpy(tokens).long())
        for key in ("seq_log_probs", "dec_out"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), err_msg=key,
                                       **TOL)
        enc, lens = tmodel.encode(_t(feats), torch.from_numpy(feat_len))
        toks = torch.from_numpy(tokens).long()
        whole = tmodel.asr.decode_prefix(toks, enc, lens)
        cache = tmodel.asr.decode_cache_init(enc, tokens.shape[1])
        pad = (torch.arange(enc.shape[1])[None, :] < lens[:, None]).float()
        for pos in range(tokens.shape[1]):
            h, cache = tmodel.asr.decode_step_cached(toks[:, pos], pos, cache, pad)
            np.testing.assert_allclose(h.numpy(), whole[:, pos].numpy(), **TOL)


def test_lite_recipe_keeps_full_mode_in_its_summary_decoder():
    """A lite recipe's Summary Decoder takes the full mode, as flax builds
    it: a causal summary needs the `sum_mask` path that lite has not."""
    over = dict(TINY, **{"model.mode": LITE, "model.num_decoder_layers": 1,
                         "model.decoder_attention_type": "SummaryMixing"})
    tmodel, _ = build_model(load_recipe(RECIPE, overrides=over), device="meta")
    assert tmodel.asr.decoder.layer_0.self_attn.mode == "SummaryMixing"
    assert tmodel.asr.encoder.layer_0.mixer.mode == LITE


def test_flagship_lite_parameter_count():
    """`recipes/LibriSpeech/branchformer_summarymixing.yaml` in lite mode
    with no decoder (the decode model `chip_smoke.py` builds): the port's
    parameters, on the meta device, count what flax's init counts."""
    over = {"model.mode": LITE, "model.num_decoder_layers": 0}
    tmodel, _ = build_model(load_recipe(RECIPE, overrides=over), device="meta")
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)),
                            jnp.asarray([16]))
    flax_count = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tmodel.parameters()) == flax_count == FLAGSHIP_LITE_PARAMS


def test_lite_speechbrain_checkpoint_converts_and_loads(rng):
    """A lite reference cell holds `summary_proj` alone: the oracle's state
    dict without `local_proj` and `summary_local_merging` is read to its
    last key by the port's `convert_full_model` in lite mode, gives the
    JAX converter's tree bit for bit, and fills the port's lite model,
    whose CTC log-probs are within 1e-4 of the JAX model's on that tree."""
    sd = {k: v.numpy() for k, v in build_oracle(nhead=1, seed=3).state_dict().items()
          if ".mha_layer.local_proj." not in k and ".mha_layer.summary_local_merging." not in k}
    kw = dict(nhead=1, mode=LITE, num_encoder_layers=NENC, num_decoder_layers=NDEC)
    tracked = tconvert.TrackedStateDict(dict(sd))
    tree = tconvert.convert_full_model(tracked, **kw)
    tconvert.assert_fully_consumed(tracked, "lite")
    want = jconvert.convert_full_model(dict(sd), **kw)
    got_leaves = jax.tree_util.tree_leaves_with_path(tree)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got_leaves, want_leaves))
    over = dict(ORACLE_WIDTHS, **{"model.mode": LITE})
    model, _ = build_model(load_recipe(RECIPE, overrides=over), device="cpu")
    load_jax_params(model, tree)
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    feats = rng.standard_normal((2, 29, 80)).astype(np.float32)
    lens = np.array([29, 17], np.int32)
    jout = jax.jit(jmodel.apply)({"params": want}, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        out = model.eval()(_t(feats), torch.from_numpy(lens))
    for i, n in enumerate(out["enc_lengths"].tolist()):
        np.testing.assert_allclose(out["ctc_log_probs"][i, :n].numpy(),
                                   np.asarray(jout["ctc_log_probs"])[i, :n], **MODEL_TOL)
