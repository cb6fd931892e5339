"""The port's Conformer-SummaryMixing pieces against the JAX package on the
CPU, float32: the fast-mode cell, the chunked-context mask, the
convolution module in its three forms, the CNN frontend's stream-start
offset, the Conformer encoder offline and under Dynamic Chunk Training,
and chunk-by-chunk `encode_streaming`. 2 layers, d_model 32, d_ffn 64,
kernel 5, chunks of 4 frames. Weights come from flax `init` and move
across with `load_jax_params`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.models.asr import DynChunkTrainConfig as JDynChunk
from summarymixing_tpu.models.asr import TransformerASR as JASR
from summarymixing_tpu.models.conformer import ConformerEncoder as JEncoder
from summarymixing_tpu.ops import masks as jmasks
from summarymixing_tpu.ops.convolution import ConvolutionFrontEnd as JFrontEnd
from summarymixing_tpu.ops.convolution import ConvolutionModule as JConvModule
from summarymixing_tpu.ops.summary_mixing import SummaryMixing as JSummaryMixing
from summarymixing_tpu_torch.models.asr import DynChunkTrainConfig, TransformerASR
from summarymixing_tpu_torch.models.conformer import ConformerEncoder
from summarymixing_tpu_torch.ops.convolution import ConvolutionFrontEnd, ConvolutionModule
from summarymixing_tpu_torch.ops.masks import chunked_context_mask, combine_padding
from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing
from summarymixing_tpu_torch.utils.convert import load_jax_params

D, CHUNK = 32, 4
# float32 on both sides, the same products in another order: a few ulps
# per op, a few hundred ops deep
TOL = 2e-5
LAYER_KW = dict(kernel_size=5, local_proj_hid_dim=(16,), local_proj_out_dim=D,
                summary_hid_dim=(16,), mode="SummaryMixing-fast")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def _pad(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def _perturb(rng, params, names):
    """Non-trivial values for parameters flax initialises to constants
    (biases at 0, LayerNorm scales at 1), so that they are checked too."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _perturb(rng, v, names)
        elif k in names:
            out[k] = jnp.asarray(np.asarray(v) + 0.2 * rng.standard_normal(v.shape), jnp.float32)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("with_sum_mask", [False, True])
def test_fast_cell_matches_flax(rng, with_sum_mask):
    """SummaryMixing-fast, nhead 4 (fast mode splits no heads): the masked
    time mean without a sum_mask, summary_matmul over a [B, T, T]
    chunked-context mask with padded columns with one."""
    b, t = 2, 9
    cell = JSummaryMixing(enc_dim=D, nhead=4, local_proj_hid_dim=(16,), local_proj_out_dim=16,
                          summary_hid_dim=(16,), summary_out_dim=D, mode="SummaryMixing-fast")
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    pad = _pad([9, 6], t)
    params = jax.jit(cell.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    port = load_jax_params(SummaryMixing(D, 4, (16,), 16, (16,), D, mode="SummaryMixing-fast"),
                           params)
    assert not hasattr(port, "local_proj") and port.global_proj.layer_0.weight.shape == (32, D)
    sm = jsm = None
    if with_sum_mask:
        jsm = jmasks.combine_padding(jmasks.chunked_context_mask(t, 3, 1), jnp.asarray(pad))
        sm = combine_padding(chunked_context_mask(t, 3, 1), _t(pad))
        _close(sm, jsm, 0)
    want = cell.apply(params, jnp.asarray(x), sum_mask=jsm, pad_mask=jnp.asarray(pad))
    with torch.no_grad():
        got = port(_t(x), sum_mask=sm, pad_mask=_t(pad))
    _close(got, want)


@pytest.mark.parametrize("form", ["same", "causal", "dcconv"])
def test_convolution_module_matches_flax(rng, form):
    """LayerNorm -> bottleneck -> GLU -> pad mask -> depthwise conv (SAME,
    causal, or DCConv over chunks of 3 frames) -> LayerNorm -> tanh-GELU ->
    pointwise -> pad mask; ragged rows."""
    b, t = 2, 11
    causal = form == "causal"
    chunk = 3 if form == "dcconv" else None
    mod = JConvModule(input_size=D, kernel_size=5, activation=jax.nn.gelu, causal=causal)
    x = rng.standard_normal((b, t, D)).astype(np.float32)
    pad = _pad([11, 7], t)
    params = jax.jit(mod.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    params = {"params": _perturb(rng, params["params"], {"bias", "scale", "conv_bias"})}
    want = mod.apply(params, jnp.asarray(x), pad_mask=jnp.asarray(pad), chunk_size=chunk)
    port = load_jax_params(ConvolutionModule(D, 5, activation="gelu", causal=causal), params)
    np.testing.assert_array_equal(port.conv_kernel.detach().numpy()[:, 0, :],
                                  np.asarray(params["params"]["conv_kernel"]).T)
    with torch.no_grad():
        got = port(_t(x), pad_mask=_t(pad), chunk_size=chunk)
    _close(got, want)
    if causal:
        with pytest.raises(ValueError, match="DCConv"):
            port(_t(x), chunk_size=3)


def test_frontend_stream_start_offset_matches_flax(rng):
    """Per-row `input_frame_offset`, one negative (the chunk starts before
    the stream) and one positive: the frames before global frame 0 are
    zeroed at the input and after each block, as in the flax frontend."""
    b, t = 2, 16
    fe = JFrontEnd(out_channels=(8, 4), dropout_rate=0.0)
    x = rng.standard_normal((b, t, 20)).astype(np.float32)
    params = jax.jit(fe.init)(jax.random.PRNGKey(4), jnp.asarray(x))
    port = load_jax_params(ConvolutionFrontEnd(out_channels=(8, 4)), params)
    offset = np.asarray([-8, 4], np.int32)
    want = jax.jit(lambda p, x, o: fe.apply(p, x, input_frame_offset=o))(
        params, jnp.asarray(x), jnp.asarray(offset))
    with torch.no_grad():
        got = port(_t(x), input_frame_offset=_t(offset))
        plain = port(_t(x))
    _close(got, want)
    assert float(got[0, :2].abs().max()) == 0.0 and float(got[0, 2:].abs().min()) > 0.0
    _close(got[1], plain[1], 0)


def _encoder(rng):
    enc = JEncoder(num_layers=2, d_model=D, d_ffn=64, nhead=4, attention_type="SummaryMixing",
                   activation=jax.nn.gelu, **LAYER_KW)
    x = rng.standard_normal((2, 14, D)).astype(np.float32)
    params = jax.jit(enc.init)(jax.random.PRNGKey(5), jnp.asarray(x))
    params = {"params": _perturb(rng, params["params"], {"bias", "scale", "conv_bias"})}
    port = load_jax_params(ConformerEncoder(2, D, 64, 4, activation="gelu", **LAYER_KW), params)
    return enc, params, port, x


@pytest.mark.parametrize("dct", [False, True])
def test_conformer_encoder_matches_flax(rng, dct):
    """Two layers with ragged rows: offline (masked mean, SAME conv) or
    under Dynamic Chunk Training (chunks of 4, 2 chunks of left context:
    summary_matmul over the [B, T, T] mask and the DCConv)."""
    enc, params, port, x = _encoder(rng)
    t = x.shape[1]
    pad = _pad([14, 9], t)
    jmask = jmasks.chunked_context_mask(t, CHUNK, 2) if dct else None
    want = jax.jit(lambda p, x, m, pm: enc.apply(p, x, src_mask=m, pad_mask=pm,
                                                 chunk_size=CHUNK if dct else None))(
        params, jnp.asarray(x), jmask, jnp.asarray(pad))
    mask = chunked_context_mask(t, CHUNK, 2) if dct else None
    with torch.no_grad():
        got = port(_t(x), src_mask=mask, pad_mask=_t(pad), chunk_size=CHUNK if dct else None)
    valid = pad[..., None] > 0
    _close(got * _t(valid), np.asarray(want) * valid)


def test_encode_streaming_matches_flax_and_offline_dct(rng):
    """`TransformerASR.encode_streaming`, 4 chunks of 4 frames with 2 chunks
    of left context, against the flax model chunk by chunk, and against the
    port's own offline encode under `DynChunkTrainConfig(4, 2)`: the
    carried buffers must reproduce the chunked mask and the DCConv."""
    kw = dict(tgt_vocab=11, input_size=20, d_model=D, nhead=4, num_encoder_layers=2,
              num_decoder_layers=0, d_ffn=64, encoder_module="conformer",
              attention_type="SummaryMixing", **LAYER_KW)
    jasr = JASR(dropout_rate=0.0, conformer_activation=jax.nn.gelu, activation=jax.nn.gelu, **kw)
    b, n_chunks = 2, 4
    src = rng.standard_normal((b, n_chunks * CHUNK, 20)).astype(np.float32)
    params = jax.jit(jasr.init)(jax.random.PRNGKey(6), jnp.asarray(src))
    params = {"params": _perturb(rng, params["params"], {"bias", "scale", "conv_bias"})}
    port = load_jax_params(TransformerASR(conformer_activation="gelu", **kw), params).eval()

    jstate = jasr.apply(params, b, JDynChunk(CHUNK, 2), method=jasr.init_streaming_state)
    jstep = jax.jit(lambda x, st: jasr.apply(params, x, st, method=jasr.encode_streaming))
    state = port.init_streaming_state(b, DynChunkTrainConfig(CHUNK, 2))
    outs = []
    with torch.no_grad():
        for c in range(n_chunks):
            chunk = src[:, c * CHUNK:(c + 1) * CHUNK]
            want, jstate = jstep(jnp.asarray(chunk), jstate)
            got, state = port.encode_streaming(_t(chunk), state)
            _close(got, want)
            outs.append(got)
        offline = port.encode(_t(src), dynchunktrain=DynChunkTrainConfig(CHUNK, 2))
    assert state.frame_offset.tolist() == [16, 16] and state.chunk_size == CHUNK
    assert state.encoder.layers[0].mha_left.shape == (b, 2 * CHUNK, D)
    _close(torch.cat(outs, dim=1), offline.numpy())
    with pytest.raises(ValueError, match="chunk_size"):
        port.encode_streaming(_t(src[:, :3]), state)
