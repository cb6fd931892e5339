"""The port's transducer slice against the JAX package on the CPU, float32:
the LSTM cell and the transducer model's heads, greedy decoding offline and
carried across chunks, the transducer recipe's greedy transcription, the
chunked streaming decode and the raw-audio streaming pipeline, the recipe's
parameter count, and `chip_smoke.py`'s Python-built recipe. The recipe is
cut to 2 layers, d_model 32, d_ffn 64, kernel 5, vocabulary 11, joint 16,
with chunks of 4 encoder frames over about 1.2 s of audio. Weights come
from flax `init` and move across with `load_jax_params`."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.decoding.transducer_search import (
    transducer_greedy_decode as jax_greedy,
)
from summarymixing_tpu.frontend.features import InputNormalization as JNorm
from summarymixing_tpu.models.asr import DynChunkTrainConfig as JDynChunk
from summarymixing_tpu.models.transducer import TransducerModel as JTransducer
from summarymixing_tpu.streaming import make_streaming_infer_fns as jax_stream_fns
from summarymixing_tpu.streaming import run_stream as jax_run_stream
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.decoding.transducer_search import transducer_greedy_decode
from summarymixing_tpu_torch.evaluate import streaming_decode
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.models.transducer import LSTMCell, TransducerModel
from summarymixing_tpu_torch.streaming import make_streaming_infer_fns, run_stream
from summarymixing_tpu_torch.transcribe import transducer_greedy_transcribe
from summarymixing_tpu_torch.utils.convert import load_jax_params

ROOT = os.path.join(os.path.dirname(__file__), "..")
RECIPE = os.path.join(ROOT, "recipes", "LibriSpeech", "conformer_summarymixing_transducer.yaml")
TINY = {
    "model.num_encoder_layers": 2, "model.d_model": 32, "model.d_ffn": 64,
    "model.csgu_kernel_size": 5, "model.local_proj_hid_dim": [16],
    "model.local_proj_out_dim": 32, "model.summary_hid_dim": [16], "model.output_neurons": 11,
    "model.frontend_channels": [8, 4], "model.input_size": 80, "transducer.joint_dim": 16,
    "transducer.dec_dim": 12, "training.precision": "fp32",
}
VOCAB, JOINT, CHUNK, LEFT = 11, 16, 4, 2
# float32 on both sides, the same products in another order
TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _same_hyps(toks, lens, jtoks, jlens):
    toks, lens = np.asarray(toks), np.asarray(lens)
    jtoks, jlens = np.asarray(jtoks), np.asarray(jlens)
    np.testing.assert_array_equal(lens, jlens)
    for i in range(len(lens)):
        np.testing.assert_array_equal(toks[i, :lens[i]], jtoks[i, :jlens[i]])


def _init_transducer(jtd, enc_dim, seed):
    """flax init of every transducer head, jitted (eager init is slow)."""
    return jax.jit(lambda k: jtd.init(k, jnp.zeros((1, 3, enc_dim)), jnp.zeros((1, 2), jnp.int32),
                                      method=jtd.init_all))(jax.random.PRNGKey(seed))


def test_lstm_cell_steps_match_flax(rng):
    """Three steps of flax's OptimizedLSTMCell against the port's LSTMCell,
    whose weights stack the eight flax leaves in gate order i, f, g, o;
    the carry is (c, h) on both sides."""
    import flax.linen as fnn

    cell = fnn.OptimizedLSTMCell(12)
    xs = rng.standard_normal((3, 2, 7)).astype(np.float32)
    carry = cell.initialize_carry(jax.random.PRNGKey(0), (2, 7))
    params = cell.init(jax.random.PRNGKey(1), carry, jnp.asarray(xs[0]))
    params = {"params": {k: dict(v, bias=v["bias"] + 0.3) if "bias" in v else v
                         for k, v in params["params"].items()}}
    port = load_jax_params(LSTMCell(7, 12), params)
    assert sorted(params["params"]) == ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"]
    _close(port.weight_ih[24:36].T, params["params"]["ig"]["kernel"], 0)
    tcarry = port.initial_state(2)
    with torch.no_grad():
        for x in xs:
            carry, h = cell.apply(params, carry, jnp.asarray(x))
            tcarry, th = port(tcarry, _t(x))
            _close(tcarry[0], carry[0])
            _close(tcarry[1], carry[1])
            _close(th, h)


@pytest.fixture(scope="module")
def transducer():
    jtd = JTransducer(vocab=VOCAB, dec_dim=12, joint_dim=JOINT, activation=jax.nn.gelu,
                      emb_dropout=0.0, dec_dropout=0.0)
    params = _init_transducer(jtd, 24, 7)
    port = load_jax_params(TransducerModel(VOCAB, enc_dim=24, dec_dim=12, joint_dim=JOINT,
                                           activation="gelu"), params).eval()
    return jtd, params, port


def test_transducer_model_matches_flax(rng, transducer):
    """The predictor over a blank-prefixed sequence and step by step, the
    full joint, the CTC head and the CE head."""
    jtd, params, port = transducer
    enc = rng.standard_normal((2, 5, 24)).astype(np.float32)
    toks = np.asarray([[0, 3, 10, 1], [0, 7, 7, 2]], np.int32)
    with torch.no_grad():
        full = port.predictor(_t(toks))
        _close(port.joint(port.encode_proj(_t(enc)), full),
               jtd.apply(params, jnp.asarray(enc), jnp.asarray(toks)))
        _close(port.ctc_head(_t(enc)), jtd.apply(params, jnp.asarray(enc),
                                                 method=jtd.ctc_head))
        _close(port.ce_from_dec(full), jtd.apply(params, jnp.asarray(toks), method=jtd.ce_head))
        carry = port.predictor_init(2)
        for u in range(toks.shape[1]):
            carry, proj = port.predictor_step(carry, _t(toks[:, u]))
            _close(proj, full[:, u].numpy())


@pytest.mark.parametrize("carried", [False, True])
def test_greedy_decode_matches_jax(rng, transducer, carried):
    """Random projected encoder frames, ragged rows, up to 3 symbols per
    frame: the port's tokens and lengths equal the JAX decode's, offline or
    with the carry threaded through chunks of 4 frames."""
    jtd, params, port = transducer
    bound = jtd.bind(params)
    b, t = 3, 14
    enc_proj = rng.standard_normal((b, t, JOINT)).astype(np.float32)
    lens = np.asarray([14, 9, 3], np.int32)
    fns = (port.predictor_init, port.predictor_step, port.joint_step)
    jfns = (bound.predictor_init, bound.predictor_step, bound.joint_step)
    with torch.no_grad():
        if not carried:
            want = jax_greedy(jnp.asarray(enc_proj), jnp.asarray(lens), *jfns)
            got = transducer_greedy_decode(_t(enc_proj), _t(lens), *fns)
            assert got[0].shape == (b, 2 * t)
        else:
            jcarry = carry = None
            for c in range(0, t, CHUNK):
                valid = np.clip(lens - c, 0, CHUNK)
                e = enc_proj[:, c:c + CHUNK]
                *want, jcarry = jax_greedy(jnp.asarray(e), jnp.asarray(valid), *jfns,
                                           max_tokens=3 * t, carry=jcarry, return_carry=True)
                *got, carry = transducer_greedy_decode(_t(e), _t(valid), *fns, max_tokens=3 * t,
                                                       carry=carry, return_carry=True)
                _same_hyps(*got, *want)
            assert got[0].shape == (b, 3 * t)
            with pytest.raises(ValueError, match="max_tokens"):
                transducer_greedy_decode(_t(e), _t(valid), *fns, return_carry=True)
    _same_hyps(*got, *want)
    assert int(got[1].min()) > 0


@pytest.fixture(scope="module")
def recipe_models():
    """The LibriSpeech transducer recipe cut to size, built by each package,
    with the JAX weights in the port, seeded normalisation statistics and
    two ragged waveforms."""
    rng = np.random.default_rng(12)
    jmodel, jfbank, jtd = jax_build_model(jax_load_recipe(RECIPE, overrides=TINY))
    model, fbank, td = build_model(load_recipe(RECIPE, overrides=TINY), device="cpu")
    n = 19200
    wav = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    wav[:, :200] *= 20.0       # the peak in chunk 0: the streamed top-dB clamp is exact
    wav_lens = np.asarray([n, n - 5000], np.int32)
    stats = {"count": np.float32(50.0), "mean": (rng.standard_normal(80) - 5.0).astype(np.float32),
             "m2": (49.0 * (2.0 + rng.random(80)) ** 2).astype(np.float32)}
    feats = jfbank(jnp.asarray(wav))
    eparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), feats,
                                   jfbank.frame_lengths(jnp.asarray(wav_lens)))
    tparams = _init_transducer(jtd, 32, 1)
    load_jax_params(model, eparams)
    load_jax_params(td, tparams)
    return dict(jmodel=jmodel, jfbank=jfbank, jtd=jtd, eparams=eparams, tparams=tparams,
                model=model, fbank=fbank, td=td, wav=wav, wav_lens=wav_lens,
                jstats={k: jnp.asarray(v) for k, v in stats.items()},
                stats={k: _t(v) for k, v in stats.items()})


def test_transducer_greedy_transcribe_matches_jax(recipe_models):
    """Fbank -> normalisation -> encoder -> proj_enc -> greedy decode, as the
    JAX `recipes/transcribe.py` transducer branch runs it."""
    s = recipe_models
    jmodel, jfbank, bound = s["jmodel"], s["jfbank"], s["jtd"].bind(s["tparams"])
    feats, _ = JNorm()(jfbank(jnp.asarray(s["wav"])), s["jstats"])
    enc, enc_lens = jax.jit(lambda f, n: jmodel.apply(s["eparams"], f, n, method=jmodel.encode))(
        feats, jfbank.frame_lengths(jnp.asarray(s["wav_lens"])))
    jtoks, jlens = jax_greedy(bound.encode_proj(enc), enc_lens, bound.predictor_init,
                              bound.predictor_step, bound.joint_step)
    hyps, out = transducer_greedy_transcribe(s["model"], s["td"], s["fbank"], s["stats"],
                                             _t(s["wav"]), _t(s["wav_lens"]))
    _close(out["enc_out"], enc, 1e-4)
    _same_hyps(out["tokens"], out["lengths"], jtoks, jlens)
    assert hyps == [np.asarray(jtoks)[i, :int(jlens[i])].tolist() for i in range(2)]


def test_streaming_decode_and_run_stream_match_jax(recipe_models):
    """`evaluate.streaming_decode` (CNN once, then chunks of 4 frames with 2
    chunks of left context and the greedy carry) against the same loop on
    the JAX model, and `streaming.run_stream` (raw audio in chunks) against
    the JAX `run_stream`: identical tokens and lengths."""
    s = recipe_models
    jmodel, jfbank, jtd = s["jmodel"], s["jfbank"], s["jtd"]
    bound = jtd.bind(s["tparams"])
    cs = CHUNK * 4 * jfbank.hop_length
    n_cov = -(-s["wav"].shape[1] // cs) * cs
    wav_cov = np.pad(s["wav"], ((0, 0), (0, n_cov - s["wav"].shape[1])))

    feats, _ = JNorm()(jfbank(jnp.asarray(wav_cov)), s["jstats"])
    src = jmodel.apply(s["eparams"], feats, method=jmodel.frontend)
    enc_lens = jmodel.apply(s["eparams"], jfbank.frame_lengths(jnp.asarray(s["wav_lens"])),
                            method=jmodel.subsampled_length)
    t_enc = src.shape[1]
    src = jnp.pad(src, ((0, 0), (0, -(-t_enc // CHUNK) * CHUNK - t_enc), (0, 0)))
    st = jmodel.apply(s["eparams"], 2, JDynChunk(CHUNK, LEFT), method=jmodel.streaming_init)
    encode_chunk = jax.jit(lambda x, st: jmodel.apply(s["eparams"], x, st,
                                                      method=jmodel.encode_streaming_chunk))
    carry = None
    for c in range(src.shape[1] // CHUNK):
        enc_c, st = encode_chunk(src[:, c * CHUNK:(c + 1) * CHUNK], st)
        jtoks, jlens, carry = jax_greedy(
            bound.encode_proj(enc_c), jnp.clip(enc_lens - c * CHUNK, 0, CHUNK),
            bound.predictor_init, bound.predictor_step, bound.joint_step,
            max_tokens=2 * t_enc, carry=carry, return_carry=True)
    times = []
    toks, lens = streaming_decode(s["model"], s["td"], s["fbank"], s["stats"], _t(wav_cov),
                                  _t(s["wav_lens"]), CHUNK, LEFT, chunk_times=times)
    _same_hyps(toks, lens, jtoks, jlens)
    assert len(times) == src.shape[1] // CHUNK

    jinit, jstep, info = jax_stream_fns(
        jmodel, jtd, jfbank, JNorm(), {"encoder": s["eparams"]["params"],
                                       "transducer": s["tparams"]["params"]},
        s["jstats"], chunk_frames=CHUNK, left_context_chunks=LEFT)
    want = jax_run_stream(jinit, jstep, s["wav"], s["wav_lens"], info["chunk_samples"])
    init_fn, step_fn, tinfo = make_streaming_infer_fns(
        s["model"], s["td"], s["fbank"], InputNormalization(), s["stats"], chunk_frames=CHUNK,
        left_context_chunks=LEFT)
    assert tinfo == info
    got = run_stream(init_fn, step_fn, _t(s["wav"]), _t(s["wav_lens"]), tinfo["chunk_samples"])
    _same_hyps(*got, *want)
    assert int(got[1].min()) > 0
    with pytest.raises(ValueError, match="samples per chunk"):
        step_fn(init_fn(1), torch.zeros(1, 123), torch.zeros(1, dtype=torch.long))


def test_transducer_recipe_parameter_count():
    """The LibriSpeech transducer recipe at full size (12 layers, d512,
    vocabulary 1000) has 79,254,832 parameters in each package: 73,581,896
    in the recognizer and 5,672,936 in the transducer, the count
    `chip_smoke.py` holds its transducer phase to."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    model, _, td = build_model(load_recipe(RECIPE), device="meta")
    jmodel, _, jtd = jax_build_model(jax_load_recipe(RECIPE))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 16, 80), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.int32))
    tshapes = jax.eval_shape(lambda k: jtd.init(k, jnp.zeros((1, 3, 512)),
                                                jnp.zeros((1, 2), jnp.int32), method=jtd.init_all),
                             jax.random.PRNGKey(0))
    n_jax = [sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))
             for tree in (shapes, tshapes)]
    n_model = sum(p.numel() for p in model.parameters())
    n_td = sum(p.numel() for p in td.parameters())
    assert [n_model, n_td] == n_jax == [73_581_896, 5_672_936]
    assert n_model + n_td == chip_smoke.TRANSDUCER_PARAMS == 79_254_832
    assert model.asr.src_proj.compute_dtype == torch.bfloat16
    assert td.proj_enc.compute_dtype is None


def test_chip_smoke_transducer_config_is_the_recipe():
    """`chip_smoke.py` builds the transducer recipe in Python (the card has
    no YAML package): it must equal the port's `load_recipe` of the file."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.transducer_config() == load_recipe(RECIPE)
