"""The port's attention-family mixers and the encoder layers that carry them
against the JAX package on the CPU, float32: `relpos_xl_table`,
`rel_shift` (and its refusal of non-square attention), `RelPosMHAXL` with
and without `mask_pos_future`, `HyperMixing` under a ragged pad mask, each
of the five attention types of `tests/test_models.py:36` in the
Branchformer, Conformer (offline and causal) and Transformer encoder
layers (the two that need a token mixer refuse `cnnonly`, as in JAX),
`Conv1dFFN` causal and SAME, and layerdrop at 0 and at 1.

d_model 16, 4 heads, T = 12 with rows of 12 and 7 valid frames. Weights
come from flax `init` with biases and
LayerNorm scales perturbed, and move across with `load_jax_params`.
Tolerance 2e-5: float32 on both sides, the same products in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.models import branchformer as jbranchformer
from summarymixing_tpu.models import conformer as jconformer
from summarymixing_tpu.models import transformer as jtransformer
from summarymixing_tpu.ops import attention as jattention
from summarymixing_tpu.ops.positional import relpos_xl_table as jrelpos_xl_table
from summarymixing_tpu_torch.models import branchformer, conformer, transformer
from summarymixing_tpu_torch.models.mixers import ATTENTION_TYPES, make_mixer
from summarymixing_tpu_torch.ops import attention
from summarymixing_tpu_torch.ops.masks import lookahead_mask
from summarymixing_tpu_torch.ops.positional import relpos_xl_table
from summarymixing_tpu_torch.utils.convert import load_jax_params

D, H, T, FFN = 16, 4, 12, 32
LENS = [T, 7]
TOL = dict(atol=2e-5, rtol=2e-5)
TYPES = ["SummaryMixing", "regularMHA", "RelPosMHAXL", "hypermixing", "cnnonly"]
SM_KW = dict(local_proj_hid_dim=(16,), local_proj_out_dim=D, summary_hid_dim=(24,))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _x(seed, b=2, t=T, d=D):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)


def _pad(t=T):
    return (np.arange(t)[None, :] < np.array(LENS)[:, None]).astype(np.float32)


def _perturb(params, seed=3):
    """Non-trivial values for the leaves flax initialises to constants
    (biases at 0, LayerNorm scales at 1), so that they are checked too."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (jnp.asarray(np.asarray(v) + 0.2 * rng.standard_normal(v.shape), jnp.float32)
                 if k in ("bias", "scale", "conv_bias") else v) for k, v in tree.items()}
    return {"params": walk(params["params"])}


def _pos(at, t=T):
    return (jrelpos_xl_table(t, D), relpos_xl_table(t, D)) if at == "RelPosMHAXL" else (None, None)


def _close(got, want, valid=None):
    got, want = got.detach().numpy(), np.asarray(want)
    if valid is not None:
        got, want = got * valid[..., None], want * valid[..., None]
    np.testing.assert_allclose(got, want, **TOL)


def _init(module, *args, **kwargs):
    """flax `init` with the constant leaves perturbed."""
    arrays = [None if a is None else jnp.asarray(a) for a in args]
    return _perturb(module.init(jax.random.PRNGKey(0), *arrays, **kwargs))


@pytest.mark.parametrize("length,dim", [(1, 4), (12, 16), (40, 32)])
def test_relpos_xl_table_matches_jax(length, dim):
    got = relpos_xl_table(length, dim)
    assert got.shape == (1, 2 * length - 1, dim) and got.dtype == torch.float32
    _close(got, jrelpos_xl_table(length, dim))
    np.testing.assert_array_equal(relpos_xl_table(length, dim, torch.bfloat16).float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


def test_rel_shift_matches_jax_and_the_formula():
    t = 5
    x = np.random.default_rng(1).standard_normal((2, 3, t, 2 * t - 1)).astype(np.float32)
    got = attention.rel_shift(_t(x))
    want = np.asarray(jattention.rel_shift(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    for q in range(t):
        for s in range(t):
            assert got[..., q, s].equal(_t(x)[..., q, t - 1 - q + s])


def test_rel_shift_refuses_non_square_attention():
    x = np.zeros((1, 2, 4, 9), np.float32)
    with pytest.raises(ValueError, match="requires square attention"):
        jattention.rel_shift(jnp.asarray(x))
    with pytest.raises(ValueError, match="requires square attention"):
        attention.rel_shift(_t(x))


@pytest.mark.parametrize("mask_pos_future", [False, True])
def test_relposmhaxl_matches_flax(mask_pos_future):
    """Self-attention over ragged rows under a chunked attention mask; with
    `mask_pos_future` the causal mask joins it."""
    jm = jattention.RelPosMHAXL(d_model=D, nhead=H, mask_pos_future=mask_pos_future)
    x, pad = _x(0), _pad()
    amask = (np.arange(T)[None, :] < (np.arange(T) // 4 + 1)[:, None] * 4).astype(np.float32)
    jpos, pos = _pos("RelPosMHAXL")
    params = _init(jm, x, x, x, amask, pad, jpos)
    want, _ = jm.apply(params, *(jnp.asarray(a) for a in (x, x, x, amask, pad)), jpos)
    port = load_jax_params(attention.RelPosMHAXL(D, H, mask_pos_future=mask_pos_future), params)
    assert {n for n, _ in port.named_parameters()} >= {"pos_bias_u", "pos_bias_v",
                                                        "pos_proj.weight"}
    assert port.pos_proj.bias is None
    with torch.no_grad():
        got = port(_t(x), _t(x), _t(x), _t(amask), _t(pad), pos)
    _close(got, want)
    with pytest.raises(ValueError, match="requires pos_embs"):
        port(_t(x), _t(x), _t(x))


@pytest.mark.parametrize("nhead", [1, 2])
def test_hypermixing_matches_flax(nhead):
    """Ragged rows whose padded frames hold garbage: both packages zero
    them in x and the values before mixing."""
    jm = jattention.HyperMixing(d_model=D, hypernet_size=FFN, nhead=nhead)
    x, pad = _x(1), _pad()
    x[1, LENS[1]:] = 1e3
    params = _init(jm, x, x, x, None, pad)
    want, _ = jm.apply(params, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                       pad_mask=jnp.asarray(pad))
    port = load_jax_params(attention.HyperMixing(D, FFN, nhead), params)
    with torch.no_grad():
        got = port(_t(x), _t(x), _t(x), pad_mask=_t(pad))
    _close(got, want)


def test_mixer_factory_names_the_jax_types():
    assert ATTENTION_TYPES == __import__(
        "summarymixing_tpu.models.mixers", fromlist=["ATTENTION_TYPES"]).ATTENTION_TYPES
    assert isinstance(make_mixer("vanillaMHA", D, H), attention.MultiheadAttention)
    assert make_mixer("hypermixing", D, H, local_proj_hid_dim=(24,)).hypernet_size == 24
    with pytest.raises(ValueError, match="must be one of"):
        make_mixer("linformer", D, H)
    with pytest.raises(ValueError, match="only supported by the Branchformer"):
        make_mixer("cnnonly", D, H)


@pytest.mark.parametrize("at", TYPES)
def test_branchformer_layer_matches_flax(at):
    kw = dict(kernel_size=5, csgu_linear_units=32, attention_type=at, summary_out_dim=24, **SM_KW)
    jm = jbranchformer.BranchformerEncoderLayer(d_model=D, nhead=H, **kw)
    x, pad = _x(2), _pad()
    jpos, pos = _pos(at)
    params = _init(jm, x, None, pad, jpos)
    want = jm.apply(params, jnp.asarray(x), None, jnp.asarray(pad), jpos)
    port = load_jax_params(branchformer.BranchformerEncoderLayer(D, H, **kw), params)
    with torch.no_grad():
        got = port(_t(x), None, _t(pad), pos)
    _close(got, want, _pad())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("at", TYPES)
def test_conformer_layer_matches_flax(at, causal):
    """Offline (ragged rows) and causal (the lookahead mask, RelPosMHAXL's
    `mask_pos_future`, the causal depthwise conv)."""
    kw = dict(kernel_size=5, causal=causal, attention_type=at, **SM_KW)
    jm = jconformer.ConformerEncoderLayer(d_model=D, d_ffn=FFN, nhead=H, **kw)
    if at == "cnnonly":
        x = jnp.zeros((1, T, D))
        with pytest.raises(ValueError, match="only supported by the Branchformer"):
            jm.init(jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError, match="only supported by the Branchformer"):
            conformer.ConformerEncoderLayer(D, FFN, H, **kw)
        return
    x, pad = _x(3), _pad()
    mask = np.tril(np.ones((T, T), np.float32)) if causal else None
    jpos, pos = _pos(at)
    params = _init(jm, x, mask, pad, jpos)
    want = jm.apply(params, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                    jnp.asarray(pad), jpos)
    port = load_jax_params(conformer.ConformerEncoderLayer(D, FFN, H, activation="swish", **kw),
                           params)
    assert port.convolution_module.causal == causal
    with torch.no_grad():
        got = port(_t(x), None if mask is None else lookahead_mask(T), _t(pad), pos)
    _close(got, want, _pad())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("at", TYPES)
def test_transformer_layer_matches_flax(at, causal):
    """The encoder layer with its mixer as `self_att`: SummaryMixing's
    output at d_model, HyperMixing's hypernetwork at d_ffn; causal with the
    lookahead mask and RelPosMHAXL's `mask_pos_future`."""
    kw = dict(attention_type=at, causal=causal, **SM_KW)
    jm = jtransformer.TransformerEncoderLayer(d_model=D, d_ffn=FFN, nhead=H,
                                              activation=jax.nn.gelu, **kw)
    if at == "cnnonly":
        with pytest.raises(ValueError, match="only supported by the Branchformer"):
            jm.init(jax.random.PRNGKey(0), jnp.zeros((1, T, D)))
        with pytest.raises(ValueError, match="only supported by the Branchformer"):
            transformer.TransformerEncoderLayer(D, FFN, H, **kw)
        return
    x, pad = _x(4), _pad()
    mask = np.tril(np.ones((T, T), np.float32)) if causal else None
    jpos, pos = _pos(at)
    params = _init(jm, x, mask, pad, jpos)
    want = jm.apply(params, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                    jnp.asarray(pad), jpos)
    port = load_jax_params(transformer.TransformerEncoderLayer(D, FFN, H, activation="gelu", **kw),
                           params)
    if at == "hypermixing":
        assert port.self_att.hypernet_size == FFN
    if at == "SummaryMixing":
        assert port.self_att.summary_local_merging.layers()[0].weight.shape[0] == D
    with torch.no_grad():
        got = port(_t(x), None if mask is None else lookahead_mask(T), _t(pad), pos)
    _close(got, want, _pad())


@pytest.mark.parametrize("causal", [False, True])
def test_conv1d_ffn_matches_flax(causal):
    """Kernels of 3 and 4 (an even width pads one frame more after than
    before in SAME form), as `conv_0` and `conv_1` `[out, in, K]`."""
    jm = jtransformer.Conv1dFFN(d_ffn=FFN, d_model=D, kernel_sizes=(3, 4), causal=causal)
    x = _x(5)
    params = _init(jm, x)
    port = load_jax_params(transformer.Conv1dFFN(FFN, D, (3, 4), causal), params)
    assert port.conv_1.weight.shape == (D, FFN, 4)
    with torch.no_grad():
        got = port(_t(x))
        if causal:   # the first frames do not see the later ones
            x2 = x.copy()
            x2[:, 6:] = 0.0
            assert port(_t(x2))[:, :6].equal(got[:, :6])
    _close(got, jm.apply(params, jnp.asarray(x)))


@pytest.mark.parametrize("prob", [0.0, 1.0])
def test_layerdrop_matches_flax(prob):
    """A training forward (dropout 0) of the 2-layer regularMHA stack with
    layerdrop 0 (every layer kept) and 1 (every layer skipped: the final
    LayerNorm of the input)."""
    jm = jtransformer.TransformerEncoder(num_layers=2, d_model=D, d_ffn=FFN, nhead=H,
                                         activation=jax.nn.gelu, layerdrop_prob=prob,
                                         attention_type="regularMHA")
    x, pad = _x(6), _pad()
    params = _init(jm, x, None, pad)
    want = jm.apply(params, jnp.asarray(x), None, jnp.asarray(pad), deterministic=False,
                    rngs={"layerdrop": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)})
    port = load_jax_params(transformer.TransformerEncoder(2, D, FFN, H, layerdrop_prob=prob),
                           params).train()
    with torch.no_grad():
        got = port(_t(x), None, _t(pad))
        if prob == 1.0:
            assert got.equal(port.norm(_t(x)))
    _close(got, want)
