"""The last public names of the JAX package in the port, against the JAX
package on the CPU in float32, on seeded numpy inputs and flax-initialised
weights carried by `load_jax_params` (`EncoderASR` and the uncached beam
route: `tests/test_torch_beam_uncached.py`):

- `ConformerDecoder` (regularMHA and RelPosMHAXL cross-attention, causal
  and not, with a memory pad mask) within 2e-5, and the Transformer
  decoder with RelPosMHAXL self- and cross-attention (square) within 2e-5;
- `ctc_forward_logprob` (the log-space alpha recursion) against the JAX
  function within 1e-4 absolute (float32 log-sum-exp chains over T), and
  against `F.ctc_loss` through `ctc_loss`, impossible alignments at the
  -1e30 floor;
- `BranchformerEncoder(scan_layers=True)`'s stacked tree through
  `load_jax_params` (also in `tests/test_torch_pipeline.py`), and the
  bridge's leaf layouts;
- the feature helpers `hamming_window`, `frame_signal` and
  `stft_magnitude` (1e-5 relative to the largest power), the augment
  wrappers `spectrogram_drop`, `time_warp` and `Augmenter` (their draws
  and transforms as the split functions, which `test_torch_train.py`
  holds against JAX), and `native_available`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.frontend import features as jfeatures
from summarymixing_tpu.losses.ctc import ctc_forward_logprob as jctc_forward_logprob
from summarymixing_tpu.models.branchformer import BranchformerEncoder as JBranchformerEncoder
from summarymixing_tpu.models.conformer import ConformerDecoder as JConformerDecoder
from summarymixing_tpu.models.transformer import TransformerDecoder as JTransformerDecoder
from summarymixing_tpu.ops.positional import relpos_xl_table as jrelpos_xl_table
from summarymixing_tpu_torch.data import native_loader
from summarymixing_tpu_torch.frontend import augment, features
from summarymixing_tpu_torch.losses.ctc import ctc_forward_logprob, ctc_loss
from summarymixing_tpu_torch.models import ConformerDecoder
from summarymixing_tpu_torch.models.branchformer import BranchformerEncoder
from summarymixing_tpu_torch.models.transformer import TransformerDecoder
from summarymixing_tpu_torch.ops.positional import relpos_xl_table
from summarymixing_tpu_torch.utils.convert import leaf_layouts, load_jax_params

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("attention_type", ["regularMHA", "RelPosMHAXL"])
@pytest.mark.parametrize("causal", [True, False])
def test_conformer_decoder_matches_flax(rng, attention_type, causal):
    """One layer and the final norm, d 32, d_ffn 64, 4 heads, kernel 3. RelPosMHAXL's
    rel-shift is square attention only, so its target is as long as the
    memory; regularMHA's is shorter."""
    b, s, d = 2, 9, 32
    u = s if attention_type == "RelPosMHAXL" else 5
    tgt = rng.standard_normal((b, u, d)).astype(np.float32)
    mem = rng.standard_normal((b, s, d)).astype(np.float32)
    pad = (np.arange(s)[None, :] < np.array([s, s - 3])[:, None]).astype(np.float32)
    kw = dict(num_layers=1, d_model=d, d_ffn=64, nhead=4, kernel_size=3, causal=causal,
              attention_type=attention_type)
    jm = JConformerDecoder(**kw)
    pos = (jrelpos_xl_table(s, d), relpos_xl_table(s, d)) if attention_type == "RelPosMHAXL" \
        else (None, None)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(tgt), jnp.asarray(mem), None,
                     jnp.asarray(pad), pos[0])
    want = jm.apply(params, jnp.asarray(tgt), jnp.asarray(mem), None, jnp.asarray(pad), pos[0])
    port = load_jax_params(ConformerDecoder(**kw), params)
    with torch.no_grad():
        got = port(_t(tgt), _t(mem), None, _t(pad), pos[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_relpos_transformer_decoder_matches_flax(rng, causal=True):
    """The JAX decoder layer's RelPosMHAXL route: self- and cross-attention
    over relative positions (`pos_embs_tgt`, `pos_embs_src`), the target as
    long as the memory (rel-shift is square), a lookahead mask and pad
    masks; no cached step (refused, as in JAX)."""
    import jax.nn as jnn

    b, s, d = 2, 7, 32
    tgt = rng.standard_normal((b, s, d)).astype(np.float32)
    mem = rng.standard_normal((b, s, d)).astype(np.float32)
    tpad = (np.arange(s)[None, :] < np.array([s, s - 2])[:, None]).astype(np.float32)
    mpad = (np.arange(s)[None, :] < np.array([s, s - 3])[:, None]).astype(np.float32)
    look = np.tril(np.ones((s, s), np.float32))
    jm = JTransformerDecoder(num_layers=1, d_model=d, d_ffn=64, nhead=4, activation=jnn.gelu,
                             attention_type="RelPosMHAXL", causal=causal)
    table = jrelpos_xl_table(s, d)
    args = (jnp.asarray(tgt), jnp.asarray(mem), jnp.asarray(look), None, jnp.asarray(tpad),
            jnp.asarray(mpad), table, table)
    params = jm.init(jax.random.PRNGKey(4), *args)
    want = jm.apply(params, *args)
    port = load_jax_params(TransformerDecoder(1, d, 64, 4, activation="gelu",
                                              attention_type="RelPosMHAXL", causal=causal),
                           params)
    ttable = relpos_xl_table(s, d)
    with torch.no_grad():
        got = port(_t(tgt), _t(mem), _t(look), _t(tpad), _t(mpad), None, ttable, ttable)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="cached decoding"):
        port.init_cache(_t(mem), 4)


def test_conformer_decoder_refuses_other_attention():
    with pytest.raises(ValueError, match="regularMHA/RelPosMHAXL"):
        ConformerDecoder(1, 16, 32, 2, attention_type="hypermixing")


def test_ctc_forward_logprob_matches_jax_and_ctc_loss(rng):
    b, t, v, u = 4, 17, 9, 6
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * 3
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    targets = rng.integers(1, v, (b, u)).astype(np.int32)
    targets[1, 1] = targets[1, 0]                       # a repeat
    in_lens = np.array([17, 12, 3, 17], np.int32)       # row 2: impossible
    tg_lens = np.array([6, 4, 5, 0], np.int32)          # row 3: empty target
    want = np.asarray(jctc_forward_logprob(lp, jnp.asarray(in_lens), jnp.asarray(targets),
                                           jnp.asarray(tg_lens)))
    got = ctc_forward_logprob(_t(np.asarray(lp)), _t(in_lens), _t(targets), _t(tg_lens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    assert got[2].item() == float(np.float32(-1e30))
    per = ctc_loss(_t(np.asarray(lp)), _t(in_lens), _t(targets), _t(tg_lens), reduction="none")
    np.testing.assert_allclose(-got.numpy(), per.numpy(), rtol=1e-5, atol=1e-4)


def test_scan_layers_tree_loads_into_the_unrolled_layers(rng):
    """The stacked `layers: {...: [L, ...]}` tree of
    `BranchformerEncoder(scan_layers=True)` fills `layer_{i}`, and the two
    compute the same thing (the JAX `test_models.py` holds the same for
    its two layouts)."""
    kw = dict(num_layers=3, d_model=16, nhead=2, kernel_size=5, attention_type="SummaryMixing",
              csgu_linear_units=32, local_proj_hid_dim=(16,), local_proj_out_dim=16,
              summary_hid_dim=(16,), summary_out_dim=16, mode="SummaryMixing")
    x = rng.standard_normal((2, 11, 16)).astype(np.float32)
    pad = (np.arange(11)[None, :] < np.array([11, 7])[:, None]).astype(np.float32)
    jm = JBranchformerEncoder(scan_layers=True, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), None, jnp.asarray(pad))
    assert "layers" in params["params"] and "layer_0" not in params["params"]
    want = jax.jit(jm.apply)(params, jnp.asarray(x), None, jnp.asarray(pad))
    port = load_jax_params(BranchformerEncoder(scan_layers=True, **kw), params)
    for i in range(3):
        np.testing.assert_array_equal(
            getattr(port, f"layer_{i}").norm_conv.weight.detach().numpy(),
            np.asarray(params["params"]["layers"]["norm_conv"]["scale"][i]))
    with torch.no_grad():
        got = port(_t(x), None, _t(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_leaf_layouts_map_flax_axes_to_the_port():
    """The bridge's layout of each parameter: the flax leaf's shape and the
    port axis of each of its axes."""
    enc = BranchformerEncoder(1, 16, 2, kernel_size=5, csgu_linear_units=32,
                              local_proj_hid_dim=(16,), local_proj_out_dim=16,
                              summary_hid_dim=(16,), summary_out_dim=16)
    lay = leaf_layouts(enc)
    pre = lay["layer_0.convolution_branch.pre_channel_proj.weight"]
    assert pre.shape == (16, 32) and pre.axes == (1, 0) and pre.count == 1
    assert lay["norm.weight"].axes == (0,)
    assert set(lay) == {n for n, _ in enc.named_parameters()}


def test_feature_helpers_match_jax(rng):
    x = rng.standard_normal((2, 1601)).astype(np.float32)
    np.testing.assert_allclose(features.hamming_window(400).numpy(),
                               np.asarray(jfeatures.hamming_window(400)), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(features.frame_signal(_t(x), 400, 160).numpy(),
                                  np.asarray(jfeatures.frame_signal(jnp.asarray(x), 400, 160)))
    for power in (1.0, 0.5):
        want = np.asarray(jfeatures.stft_magnitude(jnp.asarray(x), 512, 400, 160, power))
        got = features.stft_magnitude(_t(x), 512, 400, 160, power).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_augment_wrappers_draw_then_transform(rng, monkeypatch):
    x = _t(rng.standard_normal((3, 40, 16)).astype(np.float32))
    pad = (torch.arange(40)[None, :] < torch.tensor([40, 31, 22])[:, None]).float()

    def gen():
        g = torch.Generator()
        g.manual_seed(9)
        return g

    got = augment.spectrogram_drop(gen(), x, pad, 5, 8, 2, axis=2, replace="zeros")
    g = gen()
    want = augment.spectrogram_drop_apply(
        x, *augment.spectrogram_drop_draw(g, 3, 2, 5, 8), pad, axis=2, replace="zeros")
    assert torch.equal(got, want) and not torch.equal(got, x)
    g = gen()
    want = augment.time_warp_apply(x, *augment.time_warp_draw(g, 3, 4), pad, 4)
    assert torch.equal(augment.time_warp(gen(), x, pad, 4), want)
    both = augment.Augmenter((augment.spectrogram_drop, augment.time_warp), 1.0)
    g = gen()
    g.manual_seed(9)
    torch.rand((), generator=g)          # the gate's draw
    want = augment.time_warp(g, augment.spectrogram_drop(g, x, pad), pad)
    assert torch.equal(both(gen(), x, pad), want)
    assert torch.equal(augment.Augmenter((augment.time_warp,), 0.0)(gen(), x, pad), x)
    monkeypatch.setattr(native_loader, "load_library", lambda: None)
    assert native_loader.native_available()

    def broken():
        raise RuntimeError("no compiler")
    monkeypatch.setattr(native_loader, "load_library", broken)
    assert not native_loader.native_available()
