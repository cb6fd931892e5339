"""The port's model and the whole decode slice against the JAX package on
the CPU: 2 layers, d 32, 64 cgMLP units, kernel 5, vocab 16, frontend
channels (8, 4), 0.2-0.5 s waveforms. Weights come from flax `init` and
move across with `load_jax_params`."""

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
from summarymixing_tpu.models.branchformer import BranchformerEncoder as JEncoder
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.models.branchformer import BranchformerEncoder
from summarymixing_tpu_torch.transcribe import batch_waveforms, greedy_ctc_decode
from summarymixing_tpu_torch.utils.convert import load_jax_params

RECIPE = os.path.join(os.path.dirname(__file__), "..", "recipes", "LibriSpeech",
                      "branchformer_summarymixing.yaml")
TINY = {
    "model.num_encoder_layers": 2, "model.num_decoder_layers": 0, "model.d_model": 32,
    "model.csgu_linear_units": 64, "model.csgu_kernel_size": 5,
    "model.local_proj_hid_dim": [32], "model.local_proj_out_dim": 32,
    "model.summary_hid_dim": [32], "model.summary_out_dim": 32, "model.output_neurons": 16,
    "model.frontend_channels": [8, 4], "model.input_size": 80, "training.precision": "fp32",
}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_branchformer_encoder_matches_flax(rng):
    kw = dict(kernel_size=5, csgu_linear_units=64, local_proj_hid_dim=(16,),
              local_proj_out_dim=32, summary_hid_dim=(24,), summary_out_dim=24)
    enc = JEncoder(num_layers=2, d_model=32, nhead=1, dropout_rate=0.0,
                   activation=jax.nn.gelu, **kw)
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    pad = (np.arange(11)[None, :] < np.array([11, 6])[:, None]).astype(np.float32)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x), pad_mask=jnp.asarray(pad))
    want = enc.apply(params, jnp.asarray(x), pad_mask=jnp.asarray(pad))
    port = load_jax_params(BranchformerEncoder(2, 32, 1, activation="gelu", **kw), params)
    with torch.no_grad():
        got = port(_t(x), pad_mask=_t(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_wav_to_tokens_matches_jax(rng):
    """wav -> Fbank -> normalize -> SpeechRecognizer -> greedy -> collapse,
    both packages built from the same recipe file. CTC log-probs within
    1e-4 (two layers of float32 reassociation); tokens identical."""
    jcfg = jax_load_recipe(RECIPE, overrides=TINY)
    tcfg = load_recipe(RECIPE, overrides=TINY)
    jmodel, jfbank, _ = jax_build_model(jcfg)
    tmodel, tfbank = build_model(tcfg, device="cpu")
    secs = [0.2, 0.5, 0.35]
    wavs = [(0.3 * rng.standard_normal(int(16000 * s))).astype(np.float32) for s in secs]
    stats = {"count": np.float32(100.0),
             "mean": (rng.standard_normal(80) - 20.0).astype(np.float32),
             "m2": (99.0 * (1.0 + rng.random(80)) ** 2).astype(np.float32)}
    jstats = {k: jnp.asarray(v) for k, v in stats.items()}

    @jax.jit
    def jax_features(jwav, jlens):
        feats, _ = InputNormalization()(jfbank(jwav), jstats)
        return feats, jfbank.frame_lengths(jlens)

    @jax.jit
    def jax_decode(params, feats, feat_len):
        out = jmodel.apply(params, feats, feat_len)
        return out, ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])

    params = None
    n_rows = 0
    for idx, wav, lens in batch_waveforms(wavs, 2, 800, device="cpu"):
        assert wav.shape[1] % 800 == 0 and int(lens.max()) <= wav.shape[1]
        feats, feat_len = jax_features(jnp.asarray(wav.numpy()), jnp.asarray(lens.numpy()))
        if params is None:
            params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), feats, feat_len)
            load_jax_params(tmodel, params)
        out, (ids, keep) = jax_decode(params, feats, feat_len)
        want = collapse_ctc(ids, keep)
        hyps, tout = greedy_ctc_decode(tmodel, tfbank, {k: _t(v) for k, v in stats.items()},
                                       wav, lens)
        np.testing.assert_array_equal(tout["enc_lengths"].numpy(), np.asarray(out["enc_lengths"]))
        np.testing.assert_allclose(tout["ctc_log_probs"].numpy(),
                                   np.asarray(out["ctc_log_probs"]), atol=1e-4, rtol=1e-4)
        assert hyps == want and any(want)
        n_rows += len(idx)
        assert [len(wavs[i]) for i in idx] == [int(v) for v in lens]
    assert n_rows == 4   # 3 utterances, the last batch repeat-padded


def test_flagship_parameter_count_matches_jax():
    """The flagship (18 layers, d512, vocab 5000, no decoder) built by each
    package has 88,954,088 parameters."""
    jcfg = jax_load_recipe(RECIPE, overrides={"model.num_decoder_layers": 0})
    tcfg = load_recipe(RECIPE, overrides={"model.num_decoder_layers": 0})
    tmodel, _ = build_model(tcfg, device="meta")
    jmodel, _, _ = jax_build_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 16, 80), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.int32))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    n_port = sum(p.numel() for p in tmodel.parameters())
    assert n_port == n_jax == 88_954_088
    # float32 parameters computing in bf16, as the flax model's
    # param_dtype and dtype
    assert {p.dtype for p in tmodel.parameters()} == {torch.float32}
    assert tmodel.asr.src_proj.compute_dtype == torch.bfloat16
    assert tmodel.asr.encoder.norm.compute_dtype == torch.bfloat16


def test_load_jax_params_rejects_leftovers_and_gaps():
    enc = JEncoder(num_layers=1, d_model=32, nhead=1, csgu_linear_units=64, kernel_size=5,
                   local_proj_hid_dim=(16,), local_proj_out_dim=32, summary_hid_dim=(16,),
                   summary_out_dim=16)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 32)))["params"]
    kw = dict(kernel_size=5, csgu_linear_units=64, local_proj_hid_dim=(16,),
              local_proj_out_dim=32, summary_hid_dim=(16,), summary_out_dim=16)
    load_jax_params(BranchformerEncoder(1, 32, 1, **kw), {"params": params})
    with pytest.raises(KeyError, match="not used"):
        load_jax_params(BranchformerEncoder(1, 32, 1, **kw), dict(params, extra={"kernel": 0}))
    short = {k: v for k, v in params.items() if k != "norm"}
    with pytest.raises(KeyError, match="norm.weight"):
        load_jax_params(BranchformerEncoder(1, 32, 1, **kw), short)
    with pytest.raises(KeyError, match="layer_1"):
        load_jax_params(BranchformerEncoder(2, 32, 1, **kw), params)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(BranchformerEncoder(1, 32, 1, **dict(kw, kernel_size=7)), params)
