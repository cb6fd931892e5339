"""Blank-skip decoding and the uncached decoder step on the CPU against the
JAX package: `decoding.ctc_prefix.compact_blank_frames` against the JAX
function on seeded peaky log-probs (several thresholds and caps, tied
frames, an all-blank row, a one-frame row), `evaluate.evaluate_beam` with
`decoding.ctc_blank_skip` 1.0 and no cap against no skip, its n-best, and
`SpeechRecognizer.decode_position` against the flax method.

Tolerances: the compacted lattice's kept frames, lengths and kept counts
are identical; its synthetic blank frames are differences of cumulative
sums of blank log-probs, summed in another order by torch and XLA, so
they are held within 8 float32 steps of the largest cumulative sum
(`_gap_tol`). The search's hypotheses are identical with and without the
skip, its scores within 1e-5 (the trailing synthetic frame goes through
the scorer's closed forms). `decode_position` within 2e-5 (float32, the
same products in another association), as the decoder's other steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.decoding.ctc_prefix import compact_blank_frames as jax_compact
from summarymixing_tpu_torch.config import load_recipe
from summarymixing_tpu_torch.decoding.ctc_prefix import _pad_time_axis, compact_blank_frames
from summarymixing_tpu_torch.evaluate import evaluate_beam, maybe_compact_ctc
from summarymixing_tpu_torch.frontend.features import Fbank, NormStats
from summarymixing_tpu_torch.transcribe import batch_waveforms
from test_torch_decoder import RECIPE, TINY_DEC, tiny_models

VOCAB = 30
ASR = {"model.output_neurons": VOCAB}
_jax_compact = jax.jit(jax_compact, static_argnums=(2, 3, 4))


def _peaky(rng, b: int, t: int, v: int) -> np.ndarray:
    """Log-probs `[B, T, V]`: blank near-certain except on a quarter of the
    frames; frames 5 and 6 of row 0 tied; the last row all blank."""
    probs = np.full((b, t, v), 1e-6)
    probs[:, :, 0] = 1.0
    for row in range(b - 1):
        for frame in rng.choice(t, size=t // 4, replace=False):
            probs[row, frame] = rng.dirichlet(np.ones(v) * 0.3)
    probs[0, 5] = probs[0, 6]
    probs /= probs.sum(-1, keepdims=True)
    return np.log(probs).astype(np.float32)


def _gap_tol(x: np.ndarray, lengths: np.ndarray) -> float:
    valid = np.arange(x.shape[1])[None, :] < lengths[:, None]
    return 8 * float(np.finfo(np.float32).eps) * (1.0 + np.abs(
        np.cumsum(np.where(valid, x[..., 0], 0.0), axis=1)).max())


@pytest.mark.parametrize("threshold", [1.0, 0.95, 0.5])
@pytest.mark.parametrize("cap", [0, 4, 12])
@pytest.mark.parametrize("shape", [(4, 48, 7), (3, 200, 9)])
def test_compact_blank_frames_matches_jax(threshold, cap, shape):
    b, t, v = shape
    rng = np.random.default_rng(t + cap)
    x = _peaky(rng, b, t, v)
    lengths = np.array([t, t - 7, 1, t - 3][:b], np.int32)
    want = [np.asarray(a) for a in _jax_compact(jnp.asarray(x), jnp.asarray(lengths), 0, cap,
                                                 threshold)]
    got = [a.numpy() for a in compact_blank_frames(torch.from_numpy(x),
                                                   torch.from_numpy(lengths).long(), 0, cap,
                                                   threshold)]
    assert got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0][..., 1:], want[0][..., 1:])
    np.testing.assert_allclose(got[0][..., 0], want[0][..., 0], rtol=0,
                               atol=_gap_tol(x, lengths))
    if cap == 0 and threshold == 1.0:   # every valid frame kept, plus the tail frame
        np.testing.assert_array_equal(got[2], lengths)
        np.testing.assert_array_equal(got[1], lengths + 1)
    assert got[2][-1] == 0 or threshold == 1.0   # the all-blank row keeps nothing below 1.0


def test_maybe_compact_ctc_cap_follows_the_recipe():
    """Off at 0; the default cap min(max(T // 4, 32), T); `ctc_frame_cap`
    replaces it."""
    x = torch.from_numpy(_peaky(np.random.default_rng(1), 2, 200, 5))
    lens = torch.tensor([200, 150])
    cfg = load_recipe(RECIPE, overrides=dict(TINY_DEC, **ASR))
    out, sl = maybe_compact_ctc(cfg, x, lens)
    assert out is x and sl is lens
    cfg.decoding.ctc_blank_skip = 0.999999
    out, sl = maybe_compact_ctc(cfg, x, lens)
    assert out.shape[1] == 128 and int(sl.max()) <= 2 * 50 + 1   # cap 50 -> 101 -> 128
    cfg.decoding.ctc_frame_cap = 8
    out, _ = maybe_compact_ctc(cfg, x, lens)
    assert out.shape[1] == 32   # 2 * 8 + 1 -> 32


def test_evaluate_beam_with_blank_skip_at_one_equals_no_skip(rng):
    """At threshold 1.0 with no cap every frame is kept: the same
    hypotheses as without the skip, the scores within 1e-5; the scorer's
    time axis is the padded 2T + 1. With `nbest` 3 the
    first of each n-best is the 1-best, and the n-best is score-sorted.
    The decode length (`max_decode_ratio` 0.4 of 21-26 frames) keeps every
    hypothesis CTC-feasible (scores far above the -1e3 of a synthetic
    frame): a prefix longer than its frames allow scores near the "log
    zero" floors, -1e5 in the lattice and -1e3 in a synthetic frame, and
    there the two lattices differ, in the JAX package as here."""
    _, tmodel, _ = tiny_models(ASR)
    cfg = load_recipe(RECIPE, overrides=dict(TINY_DEC, **ASR, **{
        "decoding.test_beam_size": 3, "decoding.test_temperature": 1.15,
        "decoding.max_decode_ratio": 0.4}))
    f = cfg.features
    fbank = Fbank(f.sample_rate, f.n_fft, float(f.win_length), float(f.hop_length), f.n_mels)
    wavs = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (16000, 12800, 14400)]
    batches = list(batch_waveforms(wavs, 3, 800, device="cpu"))
    stats = NormStats.init(80)
    plain = evaluate_beam(tmodel, fbank, stats, batches, cfg)
    cfg.decoding.ctc_blank_skip, cfg.decoding.ctc_frame_cap = 1.0, 10 ** 6
    skipped = evaluate_beam(tmodel, fbank, stats, batches, cfg, nbest=3)
    assert skipped["hyps"] == plain["hyps"]
    for u, score in plain["scores"].items():
        assert score > -100.0
        assert skipped["scores"][u] == pytest.approx(score, abs=1e-5)
        ranked = skipped["nbest"][u]
        assert len(ranked) == 3 and ranked[0] == (skipped["hyps"][u], skipped["scores"][u])
        assert [s for _, s in ranked] == sorted((s for _, s in ranked), reverse=True)
    t = plain["ctc_frames"]
    assert skipped["ctc_frames"] == _pad_time_axis(2 * t + 1) > t


@pytest.mark.parametrize("pos", [0, 2, 4])
def test_decode_position_matches_flax(rng, pos):
    """Next-token log-probs at `pos` of a padded BOS-first prefix, over
    ragged encoder outputs."""
    jmodel, tmodel, params = tiny_models(ASR)
    enc = rng.standard_normal((3, 9, 32)).astype(np.float32)
    enc_len = np.array([9, 6, 4], np.int32)
    tgt = np.concatenate([np.ones((3, 1)), rng.integers(3, VOCAB, (3, 5))], 1).astype(np.int32)
    tgt[1, pos + 1:] = 0
    want = jax.jit(jmodel.apply, static_argnames="method")(
        params, jnp.asarray(tgt), jnp.asarray(enc), jnp.asarray(enc_len), pos,
        method=jmodel.decode_position)
    with torch.no_grad():
        got = tmodel.decode_position(torch.from_numpy(tgt).long(), torch.from_numpy(enc),
                                     torch.from_numpy(enc_len), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
