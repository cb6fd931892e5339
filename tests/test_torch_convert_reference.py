"""The port's SpeechBrain checkpoint path against the JAX package and the
clean-room oracles (`tests/torch_full_oracle.py`, `tests/torch_lm_oracle.py`)
on the CPU: the converters' flax-layout trees against the JAX converters'
(bit for bit), the converted port modules against the oracles' own
forwards and against the JAX modules, the consumption check, the
`convert_checkpoint` runner on a `--ref-dir` followed by `evaluate --beam
--nbest 2 --lm-ckpt`, and `Pretrainer`.

Widths are `tests/test_convert_full.py`'s (d 16, 2 encoder layers, 1
decoder layer, vocabulary 12) and `tests/test_convert_lm.py`'s; float32
with the exact GELU, as the oracles compute. Tolerance: 1e-4 absolute and
relative, the JAX tests' own."""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.utils import convert as jconvert
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.config.loader import build_lm
from summarymixing_tpu_torch.config.schema import LMConfig
from summarymixing_tpu_torch.data.sentencepiece_model import serialize_model_proto
from summarymixing_tpu_torch.data.tokenizer import SentencePieceTokenizer
from summarymixing_tpu_torch.recipes import convert_checkpoint, evaluate
from summarymixing_tpu_torch.utils import convert as tconvert
from summarymixing_tpu_torch.utils.pretrained import Pretrainer
from torch_full_oracle import (
    build_oracle,
    build_transducer_oracle,
    oracle_forward,
    transducer_oracle_forward,
)
from torch_lm_oracle import build_lm_oracles

ROOT = os.path.join(os.path.dirname(__file__), "..")
FLAGSHIP = os.path.join(ROOT, "recipes", "LibriSpeech", "branchformer_summarymixing.yaml")
TRANSDUCER = os.path.join(ROOT, "recipes", "LibriSpeech",
                          "conformer_summarymixing_transducer.yaml")
TOL = dict(atol=1e-4, rtol=1e-4)
V, NENC, NDEC = 12, 2, 1
# the flagship recipe at build_oracle's widths (tests/test_convert_full.py)
ORACLE_WIDTHS = {
    "model.d_model": 16, "model.nhead": 1, "model.num_encoder_layers": NENC,
    "model.num_decoder_layers": NDEC, "model.d_ffn": 24, "model.transformer_dropout": 0.0,
    "model.activation": "gelu_exact", "model.csgu_linear_units": 16,
    "model.csgu_kernel_size": 5, "model.local_proj_hid_dim": [8],
    "model.local_proj_out_dim": 16, "model.summary_hid_dim": [8],
    "model.summary_out_dim": 16, "model.input_size": 40, "model.output_neurons": V,
    "model.frontend_channels": [4, 2], "training.precision": "fp32",
}
# the transducer recipe at build_transducer_oracle's widths
TD_VOCAB = 10
TRANSDUCER_WIDTHS = {
    "model.d_model": 16, "model.nhead": 4, "model.num_encoder_layers": 2, "model.d_ffn": 24,
    "model.transformer_dropout": 0.0, "model.activation": "gelu_exact",
    "model.csgu_kernel_size": 5, "model.local_proj_hid_dim": [8],
    "model.local_proj_out_dim": 16, "model.summary_hid_dim": [8],
    "model.input_size": 40, "model.output_neurons": TD_VOCAB,
    "model.frontend_channels": [4, 2], "training.precision": "fp32",
    "transducer.dec_dim": 12, "transducer.joint_dim": 20,
    "transducer.dec_emb_dropout": 0.0, "transducer.dec_dropout": 0.0,
}


def _state_dict(module) -> dict:
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _oracle(kind: str):
    """(oracle module, port converter, JAX converter, converter kwargs)."""
    if kind == "full":
        return (build_oracle(nhead=1, seed=3), "convert_full_model",
                dict(nhead=1, mode="SummaryMixing", num_encoder_layers=NENC,
                     num_decoder_layers=NDEC))
    if kind == "transducer":
        return (build_transducer_oracle(vocab=TD_VOCAB, d_model=16, n_layers=2, seed=11),
                "convert_transducer_model",
                dict(nhead=4, mode="SummaryMixing-fast", num_encoder_layers=2))
    tlm, rlm = build_lm_oracles(vocab=13, seed=5)
    if kind == "transformer_lm":
        return tlm, "convert_transformer_lm", {}
    return rlm, "convert_rnnlm", {}


def _convert(kind: str):
    """(oracle, the port's tree, the JAX tree), the port's state dict fully
    consumed."""
    oracle, name, kw = _oracle(kind)
    sd = tconvert.TrackedStateDict(_state_dict(oracle))
    tree = getattr(tconvert, name)(sd, **kw)
    if name != "convert_rnnlm":   # the RNNLM converter checks its own leftovers
        tconvert.assert_fully_consumed(sd, kind)
    return oracle, tree, getattr(jconvert, name)(_state_dict(oracle), **kw)


@pytest.mark.parametrize("kind", ["full", "transducer", "transformer_lm", "rnnlm"])
def test_trees_equal_the_jax_converters_bit_for_bit(kind):
    _, tree, want = _convert(kind)
    got_leaves = jax.tree_util.tree_leaves_with_path(tree)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        if isinstance(b, str):   # the LM's "__output_proj__" tag
            assert a == b, path
            continue
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.fixture(scope="module")
def flagship():
    """(oracle, port model filled from the port's tree, JAX model, JAX params
    from the JAX converter)."""
    oracle, tree, jtree = _convert("full")
    model, _ = build_model(load_recipe(FLAGSHIP, overrides=ORACLE_WIDTHS), device="cpu")
    tconvert.load_jax_params(model, tree)
    jmodel, _, _ = jax_build_model(jax_load_recipe(FLAGSHIP, overrides=ORACLE_WIDTHS))
    return oracle, model, jmodel, {"params": jtree}


def test_converted_model_matches_the_oracle_and_jax(flagship, rng):
    """Encoder output, CTC and decoder log-probs of the port against the
    oracle's forward and against the JAX model on the JAX converter's tree,
    within 1e-4; the same greedy CTC tokens."""
    oracle, model, jmodel, jparams = flagship
    feats = rng.standard_normal((2, 16, 80)).astype(np.float32)
    tokens = np.concatenate([np.ones((2, 1)), rng.integers(3, V, (2, 4))], 1).astype(np.int64)
    enc_o, ctc_o, seq_o = oracle_forward(oracle, feats, tokens)
    with torch.no_grad():
        got = model(torch.from_numpy(feats), torch.full((2,), 16), torch.from_numpy(tokens))
    jout = jax.jit(jmodel.apply)(jparams, jnp.asarray(feats), jnp.full((2,), 16, jnp.int32),
                                 jnp.asarray(tokens, jnp.int32))
    for key, want in (("enc_out", enc_o), ("ctc_log_probs", ctc_o), ("seq_log_probs", seq_o)):
        np.testing.assert_allclose(got[key].numpy(), want, err_msg=key, **TOL)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(jout[key]), err_msg=key, **TOL)
    assert np.array_equal(got["ctc_log_probs"].argmax(-1).numpy(), ctc_o.argmax(-1))


def test_converted_greedy_attention_decode_matches_the_oracle(flagship, rng):
    """Step-by-step greedy decode over the decoder head, `decode_position`
    against the oracle's decoder: the same tokens."""
    oracle, model, _, _ = flagship
    feats = torch.from_numpy(rng.standard_normal((1, 16, 80)).astype(np.float32))
    cnn, asr, seq_lin, _ = oracle
    with torch.no_grad():
        enc_o = asr.encode(cnn(feats))
        enc, enc_len = model.encode(feats, torch.full((1,), 16))
        hyp_o, hyp = [1], [1]
        for step in range(5):
            nxt_o = int(seq_lin(asr.decode(torch.tensor([hyp_o]), enc_o))[0, -1].argmax())
            nxt = int(model.decode_position(torch.tensor([hyp]), enc, enc_len, step)[0].argmax())
            assert nxt == nxt_o, (step, nxt, nxt_o)
            hyp_o.append(nxt_o)
            hyp.append(nxt)


@pytest.mark.parametrize("kind", ["transducer", "transformer_lm", "rnnlm"])
def test_other_converters_match_their_oracles(kind, rng):
    """The transducer (encoder output, joint and CTC log-probs) and both
    fusion LMs (logits) through the port's converters and `load_jax_params`,
    against the oracles' forwards within 1e-4."""
    oracle, tree, _ = _convert(kind)
    if kind == "transducer":
        cfg = load_recipe(TRANSDUCER, overrides=TRANSDUCER_WIDTHS)
        model, _, td = build_model(cfg, device="cpu")
        target = torch.nn.ModuleDict({"encoder": model, "transducer": td})
        tconvert.load_jax_params(target, *convert_checkpoint.transducer_tree(tree))
        feats = rng.standard_normal((2, 16, 80)).astype(np.float32)
        tokens = np.concatenate([np.zeros((2, 1)), rng.integers(1, TD_VOCAB, (2, 3))],
                                1).astype(np.int64)
        enc_o, joint_o, ctc_o = transducer_oracle_forward(oracle, feats, tokens, TD_VOCAB)
        with torch.no_grad():
            enc, _ = model.encode(torch.from_numpy(feats), torch.full((2,), 16))
            joint = torch.log_softmax(td.joint(td.encode_proj(enc),
                                               td.predictor(torch.from_numpy(tokens))), -1)
            ctc = td.ctc_head(enc)
        for got, want in ((enc, enc_o), (joint, joint_o), (ctc, ctc_o)):
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        return
    tree = dict(tree)
    if kind == "transformer_lm":
        lm_cfg = LMConfig(model_type="transformer", d_model=16, nhead=2, num_layers=2, d_ffn=24,
                          output_proj=tree.pop("__output_proj__"))
    else:
        lm_cfg = LMConfig(model_type="rnn", embedding_dim=8, rnn_layers=2, rnn_neurons=16,
                          dnn_neurons=12)
    lm = tconvert.load_jax_params(build_lm(lm_cfg, 13, device="cpu"), tree)
    tokens = torch.from_numpy(rng.integers(0, 13, (3, 7)).astype(np.int64))
    with torch.no_grad():
        np.testing.assert_allclose(lm(tokens).numpy(), oracle(tokens).numpy(), **TOL)


def test_unconsumed_keys_raise():
    """A parameter block the converter does not read stops the conversion;
    the positional-encoding buffer is ignored, not unconsumed; a port
    parameter the tree does not fill raises."""
    sd = _state_dict(build_oracle(nhead=1, seed=3))
    kw = dict(nhead=1, mode="SummaryMixing", num_encoder_layers=NENC, num_decoder_layers=NDEC)
    extra = tconvert.TrackedStateDict(
        dict(sd, **{"1.encoder.layers.0.extra_adapter.weight": np.zeros((4, 4), np.float32)}))
    tree = tconvert.convert_full_model(extra, **kw)
    with pytest.raises(KeyError, match="extra_adapter"):
        tconvert.assert_fully_consumed(extra)
    with pytest.raises(SystemExit, match="extra_adapter"):
        convert_checkpoint.check_consumption(extra, "model.ckpt", False, False)
    buffers = tconvert.TrackedStateDict(
        dict(sd, **{"1.positional_encoding.pe": np.zeros((1, 8, 16), np.float32)}))
    tconvert.convert_full_model(buffers, **kw)
    assert tconvert.assert_fully_consumed(buffers)["ignored"] == ["1.positional_encoding.pe"]
    del tree["ctc_lin"]
    model, _ = build_model(load_recipe(FLAGSHIP, overrides=ORACLE_WIDTHS), device="cpu")
    with pytest.raises(KeyError, match="ctc_lin"):
        tconvert.load_jax_params(model, tree)


def _spm_model(path, words) -> None:
    """A tiny unigram ModelProto: <unk>, <s>, </s>, then one piece per word."""
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [("▁" + w, -float(i + 1), 1) for i, w in enumerate(words)]
    with open(path, "wb") as f:
        f.write(serialize_model_proto(pieces))


ORACLE_RECIPE = """
name: convert_reference_cpu
tokenizer_type: sentencepiece
model:
  attention_type: SummaryMixing
  mode: SummaryMixing
  encoder_module: branchformer
  d_model: 16
  nhead: 1
  num_encoder_layers: 2
  num_decoder_layers: 1
  d_ffn: 24
  transformer_dropout: 0.0
  activation: gelu_exact
  csgu_linear_units: 16
  csgu_kernel_size: 5
  local_proj_hid_dim: [8]
  local_proj_out_dim: 16
  summary_hid_dim: [8]
  summary_out_dim: 16
  input_size: 40
  output_neurons: 12
  frontend_channels: [4, 2]
lm:
  model_type: transformer
  d_model: 16
  nhead: 2
  num_layers: 2
  d_ffn: 24
training:
  precision: fp32
  num_buckets: 1
decoding:
  valid_beam_size: 3
  test_beam_size: 3
  lm_weight: 0.3
  ctc_weight_decode: 0.4
"""


def test_ref_dir_conversion_then_nbest_beam_evaluation(tmp_path):
    """`convert_checkpoint --ref-dir` on the Pretrainer layout (model, LM,
    normaliser and a SentencePiece `tokenizer.ckpt`), then `evaluate --beam
    --nbest 2 --lm-ckpt`: every key consumed, the tokenizer placed as
    `tokenizer.model`, the LM's widths read from its weights, and
    `nbest.jsonl` with 2 score-sorted entries per utterance whose first is
    the scored hypothesis."""
    ref = tmp_path / "ref"
    ref.mkdir()
    torch.save(build_oracle(nhead=1, seed=3).state_dict(), ref / "model.ckpt")
    torch.manual_seed(5)
    from torch_lm_oracle import TransformerLMTorch

    torch.save(TransformerLMTorch(V, d_model=16, nhead=2, n_layers=2, d_ffn=24).state_dict(),
               ref / "lm.ckpt")
    torch.save({"glob_mean": torch.zeros(80), "glob_std": torch.ones(80),
                "count": torch.tensor(100.0)}, ref / "normalizer.ckpt")
    _spm_model(ref / "tokenizer.ckpt", ["ba", "do", "ki"])
    recipe = tmp_path / "oracle.yaml"
    recipe.write_text(ORACLE_RECIPE)
    run = tmp_path / "run"
    out = convert_checkpoint.main([str(recipe), "--ref-dir", str(ref), "--output", str(run),
                                   "--device", "cpu"])
    assert out["keys"]["unconsumed"] == 0 and out["lm"]["keys"]["unconsumed"] == 0
    assert out["tokenizer"] == "tokenizer.model" and (run / "tokenizer.model").exists()
    lm_cfg = json.loads((run / "lm" / "lm_config.json").read_text())
    assert (lm_cfg["output_proj"], lm_cfg["d_model"], lm_cfg["num_layers"]) == ("sb", 16, 2)

    rng = np.random.default_rng(3)
    rows = ["ID,duration,wav,spk_id,wrd"]
    for i, n in enumerate((4800, 3200, 4000)):
        path = tmp_path / f"u{i}.wav"
        with wave.open(str(path), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((rng.standard_normal(n) * 3000).astype(np.int16).tobytes())
        rows.append(f"u{i},{n / 16000},{path},spk0,ba do")
    manifest = tmp_path / "test.csv"
    manifest.write_text("\n".join(rows) + "\n")
    eval_dir = tmp_path / "eval"
    summary = evaluate.main([str(recipe), "--test-manifest", str(manifest), "--ckpt",
                             str(run / "save"), "--beam", "--nbest", "2", "--lm-ckpt",
                             str(run / "lm"), "--output", str(eval_dir), "--device", "cpu"])
    assert summary["decode"] == "beam+lm" and summary["nbest"] == 2
    lines = [json.loads(x) for x in (eval_dir / "nbest.jsonl").read_text().splitlines()]
    assert sorted(x["id"] for x in lines) == ["u0", "u1", "u2"]
    for line in lines:
        scores = [h["score"] for h in line["nbest"]]
        assert len(scores) == 2 and scores == sorted(scores, reverse=True)
        assert line["nbest"][0]["text"].split() == summary["hyps"][line["id"]]


def test_pretrainer_loads_local_files_and_refuses_urls(tmp_path):
    torch.save({"w": torch.arange(3.0)}, tmp_path / "lm.ckpt")
    _spm_model(tmp_path / "tokenizer.model", ["ba", "do"])
    pre = Pretrainer(collect_in=str(tmp_path),
                     loadables={"lm": "lm.ckpt", "tokenizer": "tokenizer.model",
                                "remote": "https://example.invalid/lm.ckpt"})
    lm = pre.load("lm")
    assert isinstance(lm["w"], np.ndarray) and lm["w"].tolist() == [0.0, 1.0, 2.0]
    tok = pre.load("tokenizer")
    assert isinstance(tok, SentencePieceTokenizer) and tok.encode("do ba") == [4, 3]
    with pytest.raises(RuntimeError, match="remote"):
        pre.load("remote")
    with pytest.raises(FileNotFoundError):
        Pretrainer(str(tmp_path), {"x": "missing.ckpt"}).load("x")
