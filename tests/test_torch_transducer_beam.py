"""The port's transducer test stage against the JAX package on the CPU,
float32: the RNNLM (forward and step), the batched beam search with and
without RNNLM fusion (and its n-best surface) against the JAX batched
search, and the sequential beam search against the JAX sequential search
and against the batched one. A transducer of vocabulary 12 (joint 16,
predictor 12) and an RNNLM of 2 layers of 24 carry their flax weights
across with `load_jax_params`; the projected encoder frames come from a
numpy seed, 3 ragged rows of up to 12 frames, at beam 4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.decoding.transducer_search import (
    transducer_beam_search as jax_beam_seq,
)
from summarymixing_tpu.decoding.transducer_search import (
    transducer_beam_search_batched as jax_beam,
)
from summarymixing_tpu.models.lm import RNNLM as JRNNLM
from summarymixing_tpu.models.transducer import TransducerModel as JTransducer
from summarymixing_tpu_torch.config.schema import LMConfig
from summarymixing_tpu_torch.decoding.transducer_search import (
    transducer_beam_search,
    transducer_beam_search_batched,
)
from summarymixing_tpu_torch.models.lm import RNNLM, build_lm
from summarymixing_tpu_torch.models.transducer import TransducerModel
from summarymixing_tpu_torch.utils.convert import load_jax_params

VOCAB, JOINT, DEC, BEAM = 12, 16, 12, 4
LENS = np.asarray([12, 7, 3], np.int32)
LM_WEIGHT = 0.5
# float32 on both sides, the same products in another order
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    jtd = JTransducer(vocab=VOCAB, dec_dim=DEC, joint_dim=JOINT, activation=jax.nn.gelu,
                      emb_dropout=0.0, dec_dropout=0.0)
    tparams = jax.jit(lambda k: jtd.init(k, jnp.zeros((1, 3, 20)), jnp.zeros((1, 2), jnp.int32),
                                         method=jtd.init_all))(jax.random.PRNGKey(3))
    td = load_jax_params(TransducerModel(VOCAB, enc_dim=20, dec_dim=DEC, joint_dim=JOINT,
                                         activation="gelu"), tparams).eval()
    jlm = JRNNLM(vocab=VOCAB, embedding_dim=8, rnn_layers=2, rnn_neurons=24, dnn_neurons=16)
    lparams = jax.jit(lambda k: jlm.init(k, jnp.zeros((1, 3), jnp.int32)))(jax.random.PRNGKey(4))
    lm = load_jax_params(RNNLM(VOCAB, 8, 2, 24, 16), lparams).eval()
    rng = np.random.default_rng(5)
    # scaled up so that the joint's distributions are peaked and the beams part
    enc_proj = (3.0 * rng.standard_normal((3, int(LENS.max()), JOINT))).astype(np.float32)
    return dict(jtd=jtd.bind(tparams), td=td, jlm=jlm.bind(lparams), lm=lm, enc_proj=enc_proj)


def _fns(m, jax_side: bool, with_lm: bool):
    td, lm = (m["jtd"], m["jlm"]) if jax_side else (m["td"], m["lm"])
    kw = dict(blank_id=0, bos_id=0, beam_size=BEAM, state_beam=2.3, expand_beam=2.3)
    if with_lm:
        kw.update(lm_step=lm.step, lm_init=lm.initial_state, lm_weight=LM_WEIGHT)
    return (td.predictor_init, td.predictor_step, td.joint_step), kw


def test_rnnlm_forward_and_step_match_flax(models, rng):
    """`RNNLM` over a token sequence and step by step from `initial_state`,
    against the flax module with the same weights; `build_lm` builds it from
    `LMConfig(model_type="rnn")`."""
    jlm, lm = models["jlm"], models["lm"]
    toks = rng.integers(0, VOCAB, (3, 6)).astype(np.int32)
    with torch.no_grad():
        got = lm(_t(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(jlm(jnp.asarray(toks))), atol=TOL,
                                   rtol=TOL)
        carry, jcarry = lm.initial_state(3), jlm.initial_state(3)
        for u in range(toks.shape[1]):
            carry, y = lm.step(carry, _t(toks[:, u]))
            jcarry, jy = jlm.step(jcarry, jnp.asarray(toks[:, u]))
            np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
            np.testing.assert_allclose(y.numpy(), got[:, u].numpy(), atol=TOL, rtol=TOL)
        for (c, h), (jc, jh) in zip(carry, jcarry):
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=TOL, rtol=TOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    with torch.device("meta"):
        big = build_lm(LMConfig(model_type="rnn"), 1000)
    assert [c.hidden_size for c in big.cells()] == [2048, 2048]
    assert sum(p.numel() for p in big.parameters()) == 53_086_696


@pytest.mark.parametrize("with_lm", [False, True], ids=["no_lm", "rnnlm"])
def test_batched_beam_matches_jax(models, with_lm):
    """The batched search (beam 4, `max_expand` at its default of the beam)
    gives the JAX batched search's tokens, lengths and scores."""
    e, lens = models["enc_proj"], LENS
    fns, kw = _fns(models, False, with_lm)
    jfns, jkw = _fns(models, True, with_lm)
    with torch.no_grad():
        toks, tl, scores = transducer_beam_search_batched(_t(e), _t(lens), *fns, **kw)
    jtoks, jl, jscores = jax_beam(jnp.asarray(e), jnp.asarray(lens), *jfns, **jkw)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=TOL, rtol=TOL)
    assert int(tl.min()) > 0


def test_batched_nbest_matches_jax(models):
    """The n-best surface (nbest 3 of beam 4, with fusion): the top three
    hypotheses per row, score-sorted, as the JAX search gives them."""
    e = models["enc_proj"]
    fns, kw = _fns(models, False, True)
    jfns, jkw = _fns(models, True, True)
    with torch.no_grad():
        toks, tl, scores = transducer_beam_search_batched(_t(e), _t(LENS), *fns, nbest=3, **kw)
    jtoks, jl, jscores = jax_beam(jnp.asarray(e), jnp.asarray(LENS), *jfns, nbest=3, **jkw)
    assert toks.shape == (3, 3, e.shape[1])
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=TOL, rtol=TOL)
    assert (np.diff(scores.numpy(), axis=1) <= 0).all()


@pytest.mark.parametrize("with_lm", [False, True], ids=["no_lm", "rnnlm"])
def test_sequential_beam_matches_jax_and_batched(models, with_lm):
    """The sequential search row by row against the JAX sequential search
    (3-best: the same token lists, scores within TOL), and its best against
    the batched search with `max_expand` covering the whole vocabulary."""
    e = models["enc_proj"]
    fns, kw = _fns(models, False, with_lm)
    jfns, jkw = _fns(models, True, with_lm)
    with torch.no_grad():
        btoks, blens, bscores = transducer_beam_search_batched(
            _t(e), _t(LENS), *fns, max_expand=VOCAB - 1, **kw)
        for i, n in enumerate(LENS):
            got = transducer_beam_search(_t(e[i, :n]), int(n), *fns, nbest=3, **kw)
            want = jax_beam_seq(e[i, :n], int(n), *jfns, nbest=3, **jkw)
            assert [g[0] for g in got] == [w[0] for w in want]
            np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], atol=TOL,
                                       rtol=TOL)
            assert got[0][0] == btoks[i, :int(blens[i])].tolist()
            np.testing.assert_allclose(got[0][1], float(bscores[i]), atol=TOL, rtol=TOL)


def test_batched_beam_keeps_rows_past_their_length_and_a_full_buffer(models):
    """A row's hypotheses stop at its length (a row of 3 frames decodes as
    it does alone), and with a token buffer of 2 the lengths never pass it."""
    e = models["enc_proj"]
    fns, kw = _fns(models, False, False)
    with torch.no_grad():
        toks, tl, scores = transducer_beam_search_batched(_t(e), _t(LENS), *fns, **kw)
        alone = transducer_beam_search_batched(_t(e[2:, :3]), _t(LENS[2:]), *fns, **kw)
        short = transducer_beam_search_batched(_t(e), _t(LENS), *fns, max_tokens=2, **kw)
    assert toks[2, :int(tl[2])].tolist() == alone[0][0, :int(alone[1][0])].tolist()
    np.testing.assert_allclose(float(scores[2]), float(alone[2][0]), atol=TOL, rtol=TOL)
    assert short[0].shape == (3, 2) and int(short[1].max()) <= 2
