"""Port ops against their JAX counterparts on the CPU: the same numpy inputs
through both, weights moved across with `load_jax_params`. float32
throughout; tolerance 2e-5 unless a test says otherwise (the same as the
JAX package's Pallas parity tests)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.decoding import ctc as jctc
from summarymixing_tpu.frontend import features as jfeat
from summarymixing_tpu.ops import convolution as jconv
from summarymixing_tpu.ops import linear as jlinear
from summarymixing_tpu.ops import masks as jmasks
from summarymixing_tpu.ops import positional as jpos
from summarymixing_tpu.ops import summary_mixing as jsm
from summarymixing_tpu_torch.decoding import ctc as tctc
from summarymixing_tpu_torch.frontend import features as tfeat
from summarymixing_tpu_torch.ops import convolution as tconv
from summarymixing_tpu_torch.ops import linear as tlinear
from summarymixing_tpu_torch.ops import masks as tmasks
from summarymixing_tpu_torch.ops import positional as tpos
from summarymixing_tpu_torch.ops import summary_mixing as tsm
from summarymixing_tpu_torch.utils.convert import load_jax_params

TOL = 2e-5
JAX_ACTS = {"gelu": partial(jax.nn.gelu, approximate=True),
            "gelu_exact": partial(jax.nn.gelu, approximate=False)}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("n_split,activation", [(1, "gelu_exact"), (1, "gelu"), (4, "gelu")])
def test_summary_net_matches_flax(rng, n_split, activation):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    net = jlinear.SummaryNet(features=(32, 24), n_split=n_split, activation=JAX_ACTS[activation])
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = load_jax_params(tlinear.SummaryNet(16, (32, 24), n_split, activation), params)
    _close(port(_t(x)), net.apply(params, jnp.asarray(x)))


def test_masks_match_jax():
    lengths = np.array([5, 0, 7, 3])
    _close(tmasks.length_to_mask(torch.from_numpy(lengths), 7),
           jmasks.length_to_mask(jnp.asarray(lengths), 7), 0)
    # 0.6 * 5 is 3.0000000000000004 in float64 but 3.0 in float32; 0.7 * 751
    # and friends are the lengths the recognizer computes
    rel = np.array([0.6, 0.5, 1.0, 525.0 / 751.0, 0.1], np.float32)
    for t in (5, 751):
        _close(tmasks.rel_length_to_mask(torch.from_numpy(rel), t),
               jmasks.rel_length_to_mask(jnp.asarray(rel), t), 0)
    pad = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    tri = np.tril(np.ones((3, 3), np.float32))
    for s in (tri, np.stack([tri, tri.T])):
        _close(tmasks.combine_padding(_t(s), _t(pad)),
               jmasks.combine_padding(jnp.asarray(s), jnp.asarray(pad)), 0)
    assert tmasks.combine_padding(None, _t(pad)) is None


def test_positional_encoding_matches_jax():
    _close(tpos.positional_encoding(37, 32), jpos.positional_encoding(37, 32), 1e-6)
    with pytest.raises(ValueError):
        tpos.sinusoid_table(4, 3)


def test_masked_time_mean_and_summary_matmul_match_jax(rng):
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    pad = (np.arange(6)[None, :] < np.array([6, 4])[:, None]).astype(np.float32)[..., None]
    _close(tsm.masked_time_mean(_t(x), _t(pad)),
           jsm.masked_time_mean(jnp.asarray(x), jnp.asarray(pad)))
    for mask in (np.tril(np.ones((6, 6), np.float32)),
                 np.tril(np.ones((6, 6), np.float32))[None] * pad[:, None, :, 0]):
        _close(tsm.summary_matmul(_t(mask), _t(x)),
               jsm.summary_matmul(jnp.asarray(mask), jnp.asarray(x)))


@pytest.mark.parametrize("k", [5, 4])
def test_depthwise_conv1d_matches_jax(rng, k):
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((k, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    _close(tconv.depthwise_conv1d(_t(x), _t(w), _t(bias)),
           jconv.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias)))


@pytest.mark.parametrize("t", [17, 24])
def test_convolution_frontend_matches_flax(rng, t):
    x = rng.standard_normal((2, t, 20)).astype(np.float32)
    fe = jconv.ConvolutionFrontEnd(out_channels=(8, 4), dropout_rate=0.0)
    params = fe.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = load_jax_params(tconv.ConvolutionFrontEnd(out_channels=(8, 4)), params)
    got = port(_t(x))
    assert tuple(got.shape) == (2, -(-(-(-t // 2)) // 2), 5 * 4)
    _close(got, fe.apply(params, jnp.asarray(x)))
    lens = np.array([t, 5, 1])
    np.testing.assert_array_equal(
        tconv.ConvolutionFrontEnd.subsampled_length(torch.from_numpy(lens)).numpy(),
        np.asarray(jconv.ConvolutionFrontEnd.subsampled_length(jnp.asarray(lens))))


@pytest.mark.parametrize("win_ms,n", [(32.0, 5600), (25.0, 4321)])
def test_fbank_matches_jax(rng, win_ms, n):
    wav = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    wav[1, n // 2:] = 0.0
    jfb = jfeat.Fbank(win_length_ms=win_ms, n_mels=40)
    tfb = tfeat.Fbank(win_length_ms=win_ms, n_mels=40)
    want = np.asarray(jfb(jnp.asarray(wav)))
    got = tfb(_t(wav))
    assert tuple(got.shape) == want.shape == (2, jfb.num_frames(n), 40)
    # log-mel in dB: an absolute 1e-3 dB on values of tens of dB
    _close(got, want, 1e-3)
    lens = np.array([n, n // 2])
    np.testing.assert_array_equal(tfb.frame_lengths(torch.from_numpy(lens)).numpy(),
                                  np.asarray(jfb.frame_lengths(jnp.asarray(lens))))


def test_input_normalization_matches_jax(rng):
    x = rng.standard_normal((2, 7, 5)).astype(np.float32) * 3 + 1
    stats_np = {"count": np.float32(50.0), "mean": rng.standard_normal(5).astype(np.float32),
                "m2": (rng.random(5) * 40 + 1).astype(np.float32)}
    for stats in (stats_np, {k: np.zeros_like(v) for k, v in stats_np.items()}):
        want, _ = jfeat.InputNormalization()(jnp.asarray(x),
                                             {k: jnp.asarray(v) for k, v in stats.items()})
        got, _ = tfeat.InputNormalization()(_t(x), {k: _t(v) for k, v in stats.items()})
        _close(got, want, 1e-5)
    fresh = tfeat.NormStats.init(5)
    assert set(fresh) == {"count", "mean", "m2"} and float(fresh["count"]) == 0.0


def test_ctc_greedy_decode_matches_jax(rng):
    lp = rng.standard_normal((3, 12, 6)).astype(np.float32)
    lp[0, 3:6] = lp[0, 3:6] + 10 * np.eye(6, dtype=np.float32)[2]   # a repeat to collapse
    lens = np.array([12, 7, 0])
    jids, jkeep = jctc.ctc_greedy_decode(jnp.asarray(lp), jnp.asarray(lens))
    tids, tkeep = tctc.ctc_greedy_decode(_t(lp), torch.from_numpy(lens))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert tctc.collapse_ctc(tids, tkeep) == jctc.collapse_ctc(jids, jkeep)
    assert tctc.collapse_ctc(tids, tkeep)[2] == []
