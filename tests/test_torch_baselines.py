"""The paper's baselines as whole recognizers, the port against the JAX
package on the CPU, each built by both packages from the flagship recipe
file with `model.encoder_module`, `model.attention_type` and `model.causal`
set as `--set` sets them:

- `TransformerASR` over encoder x mixer (Branchformer, Conformer and
  Transformer with regularMHA, vanillaMHA, RelPosMHAXL, hypermixing,
  SummaryMixing; the Branchformer with cnnonly) and causal: CTC log-probs
  of ragged utterances within 1e-4, as `tests/test_torch_model.py`;
- the Conformer with RelPosMHAXL streamed chunk by chunk against the JAX
  `encode_streaming`, and against its own offline Dynamic Chunk Training
  encode;
- the Branchformer's merge beside an attention mixer: one Dense(2·d_model
  -> d_model), as the flax layer builds it, where a SummaryMixing merge
  reads summary_out_dim + d_model features;
- the parameter counts of the paper's configurations at full width, port
  against flax, and `load_jax_params` filling every port parameter from
  flax's tree with no leaf left over (at d32);
- `greedy_ctc_decode` on a regularMHA recognizer gives the JAX tokens, and
  regularMHA and RelPosMHAXL recipes run through train, evaluate,
  transcribe, serve and export_model;
- the JAX errors: an unknown mixer or encoder, `cnnonly` outside the
  Branchformer, a RelPosMHAXL decoder, Dynamic Chunk Training with causal.

2 layers, d_model 32, 2 heads, d_ffn 64 (the hypernetwork of the
Conformer and Transformer), kernel 5, vocab 16, float32.
"""

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
from summarymixing_tpu.decoding.ctc import collapse_ctc, ctc_greedy_decode
from summarymixing_tpu.frontend.features import InputNormalization
from summarymixing_tpu.models.asr import DynChunkTrainConfig as JDynChunk
from summarymixing_tpu.models.asr import TransformerASR as JASR
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.data.dataio import read_manifest_csv
from summarymixing_tpu_torch.models.asr import DynChunkTrainConfig, TransformerASR
from summarymixing_tpu_torch.ops.layers import Dense
from summarymixing_tpu_torch.recipes import common, evaluate, export_model, serve, train
from summarymixing_tpu_torch.recipes import transcribe as transcribe_runner
from summarymixing_tpu_torch.serving import DynamicBatchingServer, ServingConfig
from summarymixing_tpu_torch.transcribe import batch_waveforms, greedy_ctc_decode
from summarymixing_tpu_torch.utils.convert import load_jax_params
from test_torch_data import make_corpus
from test_torch_model import TINY
from test_torch_recipes import SMALL_BATCHES, SYNTH
from test_torch_serving import _Http
from test_torch_tooling import SMALL as SMALL_RUN

RECIPE = os.path.join(os.path.dirname(__file__), "..", "recipes", "LibriSpeech",
                      "branchformer_summarymixing.yaml")
SMALL = dict(TINY, **{"model.nhead": 2, "model.d_ffn": 64})
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
# (encoder_module, attention_type, causal)
CASES = [
    ("branchformer", "regularMHA", False), ("branchformer", "vanillaMHA", False),
    ("branchformer", "RelPosMHAXL", False), ("branchformer", "hypermixing", False),
    ("branchformer", "cnnonly", False), ("branchformer", "regularMHA", True),
    ("conformer", "regularMHA", False), ("conformer", "RelPosMHAXL", False),
    ("conformer", "hypermixing", False), ("conformer", "RelPosMHAXL", True),
    ("transformer", "SummaryMixing", False), ("transformer", "regularMHA", False),
    ("transformer", "RelPosMHAXL", False), ("transformer", "hypermixing", False),
    ("transformer", "SummaryMixing", True), ("transformer", "regularMHA", True),
]
# the paper's configurations at full width (bench.py's: 18-layer d512
# Branchformer, cgMLP 3072, summary widths 512, vocab 5000, CTC head only;
# nhead 4 for the attention mixers), and the 12-layer Transformer encoder
FULL_WIDTH = [
    ({"model.attention_type": "SummaryMixing"}, 88_954_088),
    ({"model.attention_type": "regularMHA", "model.nhead": 4}, 74_779_880),
    ({"model.attention_type": "RelPosMHAXL", "model.nhead": 4}, 79_516_904),
    ({"model.attention_type": "hypermixing", "model.nhead": 4}, 98_418_920),
    ({"model.attention_type": "cnnonly", "model.nhead": 4}, 46_403_816),
    ({"model.encoder_module": "transformer", "model.num_encoder_layers": 12,
      "model.attention_type": "regularMHA", "model.nhead": 4}, 40_742_120),
    ({"model.encoder_module": "transformer", "model.num_encoder_layers": 12}, 47_039_720),
]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _sets(encoder, at, causal):
    """The overrides `--set` gives, parsed as the runners parse them."""
    return common.parse_overrides([f"model.encoder_module={encoder}", f"model.attention_type={at}",
                            f"model.causal={str(causal).lower()}"])


def _models(overrides):
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=overrides))
    tmodel, tfbank = build_model(load_recipe(RECIPE, overrides=overrides), device="cpu")
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)),
                                  jnp.asarray([16]))
    load_jax_params(tmodel, params)
    return jmodel, tmodel.eval(), tfbank, params


@pytest.mark.parametrize("encoder,at,causal", CASES)
def test_recognizer_ctc_log_probs_match_jax(rng, encoder, at, causal):
    """Three ragged utterances: CTC log-probs over each row's valid frames
    within 1e-4 of flax, and the encoder lengths equal."""
    sets = _sets(encoder, at, causal)
    assert sets["model.causal"] is causal
    jmodel, tmodel, _, params = _models(dict(SMALL, **sets))
    asr = tmodel.asr
    assert (asr.encoder_module, asr.attention_type, asr.causal) == (encoder, at, causal)
    feats = rng.standard_normal((3, 45, 80)).astype(np.float32)
    feat_len = np.array([45, 30, 17], np.int32)
    want = jmodel.apply(params, jnp.asarray(feats), jnp.asarray(feat_len))
    with torch.no_grad():
        got = tmodel(_t(feats), torch.from_numpy(feat_len))
    assert np.array_equal(got["enc_lengths"].numpy(), np.asarray(want["enc_lengths"]))
    for i, n in enumerate(got["enc_lengths"].tolist()):
        np.testing.assert_allclose(got["ctc_log_probs"][i, :n].numpy(),
                                   np.asarray(want["ctc_log_probs"])[i, :n], **MODEL_TOL)


def test_relposmhaxl_conformer_streams_as_jax_and_as_offline_dct(rng):
    """`encode_streaming` with RelPosMHAXL (the table of left + chunk
    positions per chunk, no absolute sine): 4 chunks of 4 frames with 2
    chunks of left context against the flax model chunk by chunk, and the
    chunks together against the port's offline encode under
    `DynChunkTrainConfig(4, 2)`."""
    chunk, left, b, n_chunks, d = 4, 2, 2, 4, 32
    kw = dict(tgt_vocab=11, input_size=20, d_model=d, nhead=4, num_encoder_layers=2,
              num_decoder_layers=0, d_ffn=64, kernel_size=5, encoder_module="conformer",
              attention_type="RelPosMHAXL")
    jasr = JASR(dropout_rate=0.0, conformer_activation=jax.nn.gelu, activation=jax.nn.gelu, **kw)
    src = rng.standard_normal((b, n_chunks * chunk, 20)).astype(np.float32)
    params = jax.jit(jasr.init)(jax.random.PRNGKey(6), jnp.asarray(src))
    port = load_jax_params(TransformerASR(conformer_activation="gelu", activation="gelu", **kw),
                           params).eval()
    jstate = jasr.apply(params, b, JDynChunk(chunk, left), method=jasr.init_streaming_state)
    jstep = jax.jit(lambda x, st: jasr.apply(params, x, st, method=jasr.encode_streaming))
    state = port.init_streaming_state(b, DynChunkTrainConfig(chunk, left))
    outs = []
    with torch.no_grad():
        for c in range(n_chunks):
            piece = src[:, c * chunk:(c + 1) * chunk]
            want, jstate = jstep(jnp.asarray(piece), jstate)
            got, state = port.encode_streaming(_t(piece), state)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
            outs.append(got)
        offline = port.encode(_t(src), dynchunktrain=DynChunkTrainConfig(chunk, left))
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), offline.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("at,merge_in", [("regularMHA", 64), ("hypermixing", 64),
                                         ("SummaryMixing", 24 + 32)])
def test_branchformer_merge_is_a_dense_beside_an_attention_mixer(at, merge_in):
    """With summary_out_dim 24 and d_model 32: an attention mixer's output
    is d_model wide, so its merge is one Dense over 2·d_model features;
    SummaryMixing's deep merge reads summary_out_dim + d_model. With
    `cnnonly` the layer has no mixer, norm or merge."""
    over = dict(SMALL, **{"model.attention_type": at, "model.summary_out_dim": 24})
    model, _ = build_model(load_recipe(RECIPE, overrides=over), device="meta")
    layer = model.asr.encoder.layer_0
    merge = layer.merge_proj
    if at == "SummaryMixing":
        assert merge.layers()[0].weight.shape[1] == merge_in
    else:
        assert type(merge) is Dense and (merge.in_features, merge.out_features) == (merge_in, 32)
    over["model.attention_type"] = "cnnonly"
    model, _ = build_model(load_recipe(RECIPE, overrides=over), device="meta")
    names = {n.split(".")[0] for n, _ in model.asr.encoder.layer_0.named_parameters()}
    assert names == {"convolution_branch", "norm_conv"}


@pytest.mark.parametrize("overrides,count", FULL_WIDTH)
def test_full_width_parameter_counts_match_flax(overrides, count):
    over = dict(overrides, **{"model.num_decoder_layers": 0})
    tmodel, _ = build_model(load_recipe(RECIPE, overrides=over), device="meta")
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 16, 80), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.int32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in tmodel.parameters()) == n_jax == count


def test_chip_smoke_holds_the_baselines_to_flax_s_counts():
    """`chip_smoke.py` phase 24 fails a baseline whose count differs from
    its table; the table is flax's (the counts of the test above)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    counts = {count for _, count in FULL_WIDTH}
    assert set(chip_smoke.BASELINES.values()) | set(chip_smoke.TRANSFORMER_PARAMS.values()) \
        == counts - {chip_smoke.FLAGSHIP_PARAMS}
    assert chip_smoke.BASELINE_NHEAD == 4


@pytest.mark.parametrize("encoder,at", [("branchformer", "RelPosMHAXL"),
                                        ("branchformer", "hypermixing"),
                                        ("transformer", "SummaryMixing")])
def test_flax_tree_fills_every_parameter(encoder, at):
    """`load_jax_params` raises on a leaf left over or a parameter left
    unfilled; here it fills a fresh model, every tensor of which then
    equals its flax leaf's values (pos_bias_u/v, the bias-free pos_proj,
    hyper_in/out, the Dense merge)."""
    over = dict(SMALL, **_sets(encoder, at, False))
    jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 80)),
                                  jnp.asarray([16]))
    tmodel, _ = build_model(load_recipe(RECIPE, overrides=over), device="cpu")
    n_flax = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tmodel.parameters()) == n_flax
    load_jax_params(tmodel, params)
    enc = params["params"]["asr"]["encoder"]["layer_0"]
    if at == "RelPosMHAXL":
        mixer = tmodel.asr.encoder.layer_0.mixer
        assert mixer.pos_bias_u.equal(_t(enc["mixer"]["pos_bias_u"]))
        assert mixer.pos_proj.weight.equal(_t(enc["mixer"]["pos_proj"]["kernel"]).T)
    with pytest.raises(KeyError, match="not used"):
        extra = jax.tree_util.tree_map(np.asarray, params)
        extra["params"]["asr"]["encoder"]["layer_0"]["stray"] = {"kernel": np.zeros(2)}
        load_jax_params(tmodel, extra)


def test_greedy_ctc_decode_with_regular_mha_gives_the_jax_tokens(rng):
    """wav -> Fbank -> normalise -> the regularMHA Branchformer (2 heads)
    -> greedy CTC, both packages from the same recipe file: the same
    tokens, the log-probs within 1e-4."""
    over = dict(SMALL, **_sets("branchformer", "regularMHA", False))
    jmodel, tmodel, tfbank, params = _models(over)
    _, jfbank, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
    wavs = [(0.3 * rng.standard_normal(int(16000 * s))).astype(np.float32) for s in (0.4, 0.25)]
    stats = {"count": np.float32(100.0),
             "mean": (rng.standard_normal(80) - 20.0).astype(np.float32),
             "m2": (99.0 * (1.0 + rng.random(80)) ** 2).astype(np.float32)}
    for _, wav, lens in batch_waveforms(wavs, 2, 800, device="cpu"):
        jwav, jlens = jnp.asarray(wav.numpy()), jnp.asarray(lens.numpy())
        feats, _ = InputNormalization()(jfbank(jwav), {k: jnp.asarray(v) for k, v in
                                                        stats.items()})
        out = jmodel.apply(params, feats, jfbank.frame_lengths(jlens))
        want = collapse_ctc(*ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"]))
        hyps, tout = greedy_ctc_decode(tmodel, tfbank, {k: _t(v) for k, v in stats.items()},
                                       wav, lens)
        np.testing.assert_allclose(tout["ctc_log_probs"].numpy(),
                                   np.asarray(out["ctc_log_probs"]), **MODEL_TOL)
        assert hyps == want and any(want)


@pytest.mark.parametrize("over,match", [
    ({"model.attention_type": "linformer"}, "attention_type must be one of"),
    ({"model.encoder_module": "lstm"}, "unknown encoder_module"),
    ({"model.encoder_module": "conformer", "model.attention_type": "cnnonly"},
     "only supported by the Branchformer"),
    ({"model.num_decoder_layers": 1, "model.decoder_attention_type": "RelPosMHAXL"},
     "decoder_attention_type must be"),
])
def test_bad_configurations_fail_as_in_jax(over, match):
    over = dict(SMALL, **over)
    with pytest.raises(ValueError, match=match):
        jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                       jax.ShapeDtypeStruct((1, 16, 80), jnp.float32),
                       jax.ShapeDtypeStruct((1,), jnp.int32))
    with pytest.raises(ValueError, match=match):
        build_model(load_recipe(RECIPE, overrides=over), device="meta")


def test_dynamic_chunk_training_refuses_causal():
    kw = dict(tgt_vocab=11, input_size=20, d_model=32, nhead=2, num_encoder_layers=1,
              d_ffn=64, kernel_size=5, encoder_module="conformer", attention_type="regularMHA",
              causal=True)
    jasr = JASR(**kw)
    src = jnp.zeros((1, 8, 20))
    with pytest.raises(ValueError, match="incompatible with causal"):
        jasr.init(jax.random.PRNGKey(0), src, dynchunktrain=JDynChunk(4, 1))
    with pytest.raises(ValueError, match="incompatible with causal"):
        TransformerASR(**kw).encode(_t(src), dynchunktrain=DynChunkTrainConfig(4, 1))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), n=40)


@pytest.mark.parametrize("at", ["regularMHA", "RelPosMHAXL"])
def test_runners_take_the_baseline(corpus, tmp_path, at):
    """`--set model.attention_type=... --set model.nhead=4` through train
    (2 steps), evaluate (greedy), transcribe, serve (one WAV body through
    the HTTP handler) and export_model (`--check`: the artifact, exported
    with a symbolic length, equal to the live model)."""
    over = SMALL_RUN + ["--set", f"model.attention_type={at}", "--set", "model.nhead=4",
                        "--device", "cpu"]
    run = str(tmp_path / "run")
    res = train.main([SYNTH, "--train-manifest", corpus["train"], "--valid-manifest",
                      corpus["dev"], "--output", run, "--steps", "2"] + SMALL_BATCHES + over)
    assert res["steps"] == 2 and np.isfinite(res["valid"]["loss"])
    summary = evaluate.main([SYNTH, "--test-manifest", corpus["test"], "--ckpt", run + "/save"]
                            + over)
    assert summary["utterances"] == 4 and np.isfinite(summary["WER"])
    wav_path = read_manifest_csv(corpus["test"])[0].wav_path
    assert transcribe_runner.main([SYNTH, wav_path, "--ckpt", run + "/save"] + over)[
        "utterances"] == 1
    cfg = load_recipe(SYNTH, overrides=common.parse_overrides(over[1:-2:2]))
    infer, _ = serve.build_infer(cfg, run + "/save", 0, torch.device("cpu"))
    with DynamicBatchingServer(infer, ServingConfig(batch_size=2, max_wait_ms=5.0),
                               device="cpu") as srv:
        http = _Http(serve.make_handler(srv, 16000))
        try:
            with open(wav_path, "rb") as f:
                assert "text" in http.post("/transcribe", f.read())
        finally:
            http.close()
    out = export_model.main([SYNTH, "--ckpt", run + "/save", "--output",
                             str(tmp_path / "m.smt"), "--check"] + over)
    assert out["check"] is True
    model, _, _, _ = common.restore_inference(cfg, run + "/save", 0, "cpu")
    assert type(model.asr.encoder.layer_0.mixer).__name__ == {
        "regularMHA": "MultiheadAttention", "RelPosMHAXL": "RelPosMHAXL"}[at]
