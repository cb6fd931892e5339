"""Weight bridges: `load_jax_params` fills a port module from the flax params
tree of its counterpart, and the SpeechBrain converters (a copy of the
numpy-only converters of `summarymixing_tpu/utils/convert.py`) turn a
reference-trained state dict into that flax-layout tree, so a SpeechBrain
checkpoint reaches a port module through both:

    sd = TrackedStateDict(load_torch_checkpoint("save/model.ckpt"))
    tree = convert_full_model(sd, nhead=1, mode="SummaryMixing",
                              num_encoder_layers=18, num_decoder_layers=6)
    assert_fully_consumed(sd)               # every key of the file was read
    load_jax_params(model, tree)            # every port parameter is filled

The SpeechBrain layout rules (`convert_full_model` and its helpers):

- torch `nn.Linear` weight `[out, in]` -> Dense `kernel` `[in, out]`;
- ParallelLinear weights `[m, in/m, out/m]` -> its `kernel` as it is;
- torch `Conv2d` `[out, in, kh, kw]` -> Conv `kernel` `[kh, kw, in, out]`;
- a depthwise `Conv1d` `[C, 1, K]` -> `[K, C]`;
- LayerNorm `weight`/`bias` -> `scale`/`bias`;
- `nn.MultiheadAttention`'s `in_proj_weight` `[3d, d]` -> `q_proj`,
  `k_proj`, `v_proj`; an LSTM's stacked gates -> flax's eight leaves.

The `load_jax_params` layout rules:

The port's modules carry the flax tree's names (the attention decoder's
too: `decoder.layer_i.{self_attn,cross_attn}.{q,k,v,out}_proj`, or for
the Summary Decoder `decoder.layer_i.self_attn.{local_proj,summary_proj,
summary_local_merging}`,
`pos_ffn.{ffn_in,ffn_out}`, `norm1`-`norm3`, `seq_lin`; the Transformer
LM's: `emb.emb`, `encoder.layer_i.{self_att,pos_ffn,norm1,norm2}`,
`encoder.norm`, `out`, with `out_proj` and `out_norm` for the "sb" head;
the Conformer's `ffn1`, `ffn2`, `norm_ffn1`, `norm_ffn2`, `norm1`,
`norm2`, `mixer.global_proj`, `convolution_module.{layer_norm,bottleneck,
after_norm,pointwise_out}`; the Conformer decoder's `layer_i.{ffn1,ffn2,
norm_ffn1,norm_ffn2,norm1,norm2,mha_layer,convolution_module}` and `norm`; the encoders' attention mixers'
`{q,k,v,out}_proj`, RelPosMHAXL's bias-free `pos_proj` and its `pos_bias_u`,
`pos_bias_v`, HyperMixing's `hyper_in`, `hyper_out`, the Branchformer's
Dense `merge_proj` beside an attention mixer; the transducer's `proj_enc`, `predictor.lstm`,
`predictor.proj_dec`, `joint.transducer_lin`, `proj_ctc`, `dec_lin`; the
RNNLM's `emb`, `lstm_0`, `lstm_1`, ..., `dnn`, `out`), so the bridge is a
tree walk with these layout rules:

- `torch.nn.Linear`: the Dense `kernel` `[in, out]` becomes `weight`
  `[out, in]`;
- `torch.nn.Conv1d` (`Conv1dFFN`'s `conv_0`, `conv_1`): the `kernel`
  `[K, in, out]` becomes `weight` `[out, in, K]`;
- `torch.nn.Conv2d`: the `kernel` `HWIO` becomes `weight` `OIHW`;
- `torch.nn.LayerNorm`: `scale` becomes `weight`;
- `torch.nn.Embedding`: `embedding` becomes `weight`;
- `ConvolutionModule`: the depthwise `conv_kernel` `[K, C]` becomes
  `[C, 1, K]`, the layout of `torch.nn.functional.conv1d` with C groups;
- `LSTMCell`: flax's `OptimizedLSTMCell` keeps eight Dense leaves,
  `i{i,f,g,o}.kernel` `[in, H]` without bias and `h{i,f,g,o}.{kernel
  [H, H], bias}`; they become `weight_ih` `[4H, in]`, `weight_hh`
  `[4H, H]` and `bias` `[4H]`, the gates stacked in the order i, f, g, o.

Every other parameter keeps its name and layout. A scanned stack (the JAX
encoders' `scan_layers=True`: one `layers` subtree whose leaves carry a
leading `[L]` axis) fills `layer_0` ... `layer_{L-1}`. The walk raises if
a leaf of the tree is left over or a port parameter is left unfilled; a
converter whose `TrackedStateDict` holds a key it did not read fails
`assert_fully_consumed`.

`leaf_layouts(module)` reads the same rules the other way: for every port
parameter, the shape its flax leaf has and the port axis each flax axis
lands on, which is what the sharding rules of `parallel/mesh.py` decide
on. The one parameter that packs several leaves is the LSTM cell's
(`weight_ih`, `weight_hh`, `bias`: four gates along axis 0).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from summarymixing_tpu_torch.models.transducer import LSTMCell
from summarymixing_tpu_torch.ops.convolution import ConvolutionModule

_GATES = ("i", "f", "g", "o")


class _Rule(NamedTuple):
    """How a port parameter is read from flax leaves: `leaves`, the flax
    names it consumes; `read`, the reader of the subtree; `axes[j]`, the
    port axis that holds axis j of each leaf (None: the same axis);
    `packed`, whether the leaves are concatenated along the port's axis 0
    (the LSTM's gates)."""
    leaves: Tuple[str, ...]
    read: Callable
    axes: Optional[Tuple[int, ...]] = None
    packed: bool = False


def _leaf(name: str, transform=None, axes=None) -> _Rule:
    """A rule that reads one flax leaf, optionally changing its layout."""
    def read(tree):
        value = np.asarray(tree[name])
        return value if transform is None else transform(value)
    return _Rule((name,), read, axes)


def _stacked(side: str, leaf: str, transform, axes) -> _Rule:
    """A rule that stacks the four gates' `<side><gate>.<leaf>` along axis 0."""
    names = tuple(side + g for g in _GATES)
    return _Rule(names, lambda tree: np.concatenate(
        [transform(np.asarray(tree[n][leaf])) for n in names], axis=0), axes, True)


def _leaf_rules(mod: nn.Module) -> Dict[str, _Rule]:
    """port parameter name -> the `_Rule` that fills it."""
    if isinstance(mod, nn.Linear):
        return {"weight": _leaf("kernel", lambda a: a.T, (1, 0)), "bias": _leaf("bias")}
    if isinstance(mod, nn.Conv1d):
        return {"weight": _leaf("kernel", lambda a: a.transpose(2, 1, 0), (2, 1, 0)),
                "bias": _leaf("bias")}
    if isinstance(mod, nn.Conv2d):
        return {"weight": _leaf("kernel", lambda a: a.transpose(3, 2, 0, 1), (2, 3, 1, 0)),
                "bias": _leaf("bias")}
    if isinstance(mod, nn.LayerNorm):
        return {"weight": _leaf("scale"), "bias": _leaf("bias")}
    if isinstance(mod, nn.Embedding):
        return {"weight": _leaf("embedding")}
    if isinstance(mod, ConvolutionModule):
        return {"conv_kernel": _leaf("conv_kernel", lambda a: a.T[:, None, :], (2, 0)),
                "conv_bias": _leaf("conv_bias")}
    if isinstance(mod, LSTMCell):
        return {"weight_ih": _stacked("i", "kernel", lambda a: a.T, (1, 0)),
                "weight_hh": _stacked("h", "kernel", lambda a: a.T, (1, 0)),
                "bias": _stacked("h", "bias", lambda a: a, (0,))}
    return {name: _leaf(name) for name, _ in mod.named_parameters(recurse=False)}


class LeafLayout(NamedTuple):
    """Where a port parameter's flax leaves lie in it: `shape`, each
    leaf's shape in the flax tree; `axes[j]`, the port axis that holds
    the leaf's axis j; `count`, how many leaves are packed along the
    port's axis 0 (1 but for the LSTM's gates)."""
    shape: Tuple[int, ...]
    axes: Tuple[int, ...]
    count: int


def leaf_layouts(module: nn.Module) -> Dict[str, LeafLayout]:
    """Every parameter of `module` (by `named_parameters` name) -> its
    `LeafLayout`, read from the bridge's own rules: the shape each flax
    leaf has, and the port axis each of its axes maps to (the flax Dense
    `[in, out]` is the Linear's `[out, in]`: axes (1, 0); a conv's
    `[K, in/g, out]` is `[out, in/g, K]`: axes (2, 1, 0)). The sharding
    rules of `parallel/mesh.py` decide on these shapes and place the
    parameter through `axes`, as the JAX rules decide on the leaves."""
    out: Dict[str, LeafLayout] = {}
    for prefix, mod in module.named_modules():
        for pname, rule in _leaf_rules(mod).items():
            param = mod._parameters.get(pname)
            if param is None:
                continue
            shape = tuple(param.shape)
            axes = rule.axes if rule.axes is not None else tuple(range(len(shape)))
            count = len(rule.leaves) if rule.packed else 1
            leaf = tuple(shape[a] // (count if a == 0 else 1) for a in axes)
            out[f"{prefix}.{pname}" if prefix else pname] = LeafLayout(leaf, axes, count)
    return out


def _unstack(tree: Mapping, n: int) -> Dict:
    """A scanned `layers: {...: [L, ...]}` subtree -> `layer_0` ... `layer_{L-1}`."""
    def index(node, i):
        if isinstance(node, Mapping):
            return {k: index(v, i) for k, v in node.items()}
        return np.asarray(node)[i]
    return {f"layer_{i}": index(tree, i) for i in range(n)}


def _walk(mod: nn.Module, tree: Mapping, path: str, leftover: List[str],
          unfilled: List[str]) -> None:
    if "layers" in tree and "layer_0" not in tree and hasattr(mod, "layer_0"):
        # the JAX encoders' scan_layers=True layout: one stacked subtree
        n = sum(1 for name, _ in mod.named_children() if name.startswith("layer_"))
        tree = dict({k: v for k, v in tree.items() if k != "layers"},
                    **_unstack(tree["layers"], n))
    used = set()
    for pname, rule in _leaf_rules(mod).items():
        param = getattr(mod, pname)
        if param is None:
            continue
        if any(leaf not in tree for leaf in rule.leaves):
            unfilled.append(f"{path}{pname}")
            continue
        value = rule.read(tree)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}{pname}: flax leaves {rule.leaves} have shape "
                             f"{value.shape} after layout change, the port wants "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value)))
        used.update(rule.leaves)
    for name, child in mod.named_children():
        if not any(True for _ in child.parameters()):
            continue
        if name not in tree:
            unfilled.extend(f"{path}{name}.{p}" for p, _ in child.named_parameters())
            continue
        _walk(child, tree[name], f"{path}{name}.", leftover, unfilled)
        used.add(name)
    leftover.extend(f"{path}{k}" for k in tree if k not in used)


def load_jax_params(module: nn.Module, params: Mapping, may_lack: Tuple[str, ...] = ()
                    ) -> nn.Module:
    """Fill `module` in place from a flax params tree (nested dicts of numpy
    or JAX arrays; the `{"params": ...}` wrapper is accepted too). A port
    parameter whose name starts with one of `may_lack` may be missing from
    the tree and keeps its value (a transducer checkpoint without the
    training-only CE head `dec_lin`)."""
    if set(params) == {"params"}:
        params = params["params"]
    leftover: List[str] = []
    unfilled: List[str] = []
    _walk(module, params, "", leftover, unfilled)
    unfilled = [name for name in unfilled if not name.startswith(tuple(may_lack))]
    if leftover or unfilled:
        raise KeyError(f"flax leaves not used: {leftover[:20]}; "
                       f"port parameters not filled: {unfilled[:20]}")
    return module


# -- SpeechBrain state dicts -> flax-layout trees ----------------------------

def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A torch state-dict file (a SpeechBrain `model.ckpt`, `lm.ckpt`) as
    numpy arrays on the host."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() for k, v in sd.items()}


# Deterministic (non-learnable) buffers a real state dict carries that no
# converter should consume: the reference overlay registers exactly one
# buffer — PositionalEncoding.pe (reference Transformer.py:322) — which
# the flax models compute analytically; num_batches_tracked is torch
# BatchNorm bookkeeping (not used by the reference frontend, listed for
# robustness against fork variants).
_IGNORABLE_KEY_SUFFIXES = (".pe", ".num_batches_tracked")


def _is_ignorable_key(key: str) -> bool:
    return key.endswith(_IGNORABLE_KEY_SUFFIXES)


class TrackedStateDict(dict):
    """A state dict that records every key a converter actually READS
    (``sd[k]`` or a successful ``sd.get(k)``). Membership tests (``in``)
    and iteration do NOT count as consumption — converters probe with
    ``in`` to pick layouts.

    This is the mechanism behind converter key-consumption strictness
    (reference Pretrainer contract, branchformer_summarymixing.yaml:349-360):
    a key-naming or module-nesting mismatch between a real SpeechBrain
    checkpoint and the converter's expectations surfaces as unconsumed
    keys in :func:`consumption_report` — a loud pre-decode error instead
    of silently-wrong numerics."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        super().__init__(sd)
        self.consumed: set = set()

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.consumed.add(key)
        return value

    def get(self, key, default=None):
        if dict.__contains__(self, key):
            return self[key]
        return default


def consumption_report(sd: TrackedStateDict) -> Dict[str, list]:
    """Classify every state-dict key after a converter ran over a
    :class:`TrackedStateDict`: ``consumed`` (read and mapped),
    ``ignored`` (deterministic buffers, see ``_IGNORABLE_KEY_SUFFIXES``),
    ``unconsumed`` (present but never read — a layout mismatch or an
    unmodelled block)."""
    consumed, ignored, unconsumed = [], [], []
    for k in sd:
        if k in sd.consumed:
            consumed.append(k)
        elif _is_ignorable_key(k):
            ignored.append(k)
        else:
            unconsumed.append(k)
    return {"consumed": sorted(consumed), "ignored": sorted(ignored),
            "unconsumed": sorted(unconsumed)}


def assert_fully_consumed(sd: TrackedStateDict, what: str = "checkpoint"):
    """Raise if the converter left any non-buffer key unread."""
    rep = consumption_report(sd)
    if rep["unconsumed"]:
        raise KeyError(
            f"{len(rep['unconsumed'])} unconsumed {what} keys — the state "
            "dict contains parameters the converter did not map, so the "
            "converted model would silently diverge from the original: "
            + ", ".join(rep["unconsumed"][:20])
            + (" ..." if len(rep["unconsumed"]) > 20 else ""))
    return rep


def convert_linear(weight: np.ndarray, bias: np.ndarray | None = None) -> dict:
    out = {"kernel": np.ascontiguousarray(weight.T)}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def convert_parallel_linear(weights: np.ndarray, biases: np.ndarray) -> dict:
    return {"kernel": np.asarray(weights), "bias": np.asarray(biases)}


def convert_layernorm(weight: np.ndarray, bias: np.ndarray) -> dict:
    return {"scale": np.asarray(weight), "bias": np.asarray(bias)}


def convert_conv2d(weight: np.ndarray, bias: np.ndarray | None = None) -> dict:
    # [out, in, kh, kw] -> [kh, kw, in, out]
    out = {"kernel": np.ascontiguousarray(weight.transpose(2, 3, 1, 0))}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def convert_depthwise_conv1d(weight: np.ndarray) -> np.ndarray:
    # torch depthwise Conv1d [C, 1, K] -> [K, C]
    return np.ascontiguousarray(weight[:, 0, :].T)


def _mlp_from_torch(prefix: str, sd: Dict[str, np.ndarray]) -> dict:
    """Convert a VanillaNN (reference VanillaNN.py) subtree. SpeechBrain
    Sequential names blocks `linear`, `linear_0`, ... with the underlying
    torch module at `.w` for plain Linear and direct weights for
    ParallelLinear."""
    out = {}
    i = 0
    while True:
        block = "linear" if i == 0 else f"linear_{i - 1}"
        plain_w = f"{prefix}.{block}.w.weight"
        par_w = f"{prefix}.{block}.weights"
        if plain_w in sd:
            out[f"layer_{i}"] = convert_linear(
                sd[plain_w], sd.get(f"{prefix}.{block}.w.bias")
            )
        elif par_w in sd:
            out[f"layer_{i}"] = convert_parallel_linear(
                sd[par_w], sd[f"{prefix}.{block}.biases"]
            )
        else:
            break
        i += 1
    if not out:
        raise KeyError(f"no VanillaNN layers found under {prefix!r}")
    return out


def convert_mha(prefix: str, sd: Dict[str, np.ndarray]) -> dict:
    """speechbrain MultiheadAttention (torch nn.MultiheadAttention at `.att`)
    -> flax q/k/v/out projections. in_proj_weight is [3d, d] rows [q; k; v]."""
    w = sd[f"{prefix}.att.in_proj_weight"]
    b = sd[f"{prefix}.att.in_proj_bias"]
    d = w.shape[1]
    out = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[name] = convert_linear(w[i * d:(i + 1) * d], b[i * d:(i + 1) * d])
    out["out_proj"] = convert_linear(
        sd[f"{prefix}.att.out_proj.weight"], sd[f"{prefix}.att.out_proj.bias"]
    )
    return out


def _ln(prefix: str, sd: Dict[str, np.ndarray]) -> dict:
    """speechbrain LayerNorm (torch LayerNorm at `.norm`)."""
    return convert_layernorm(sd[f"{prefix}.norm.weight"],
                             sd[f"{prefix}.norm.bias"])


def convert_branchformer_layer(
    prefix: str, sd: Dict[str, np.ndarray], nhead: int, mode: str
) -> dict:
    """One reference BranchformerEncoderLayer (Branchformer.py:100-334,
    SummaryMixing mixer) -> flax BranchformerEncoderLayer params."""
    tree = {
        "mixer": convert_summary_mixing(f"{prefix}.mha_layer", sd, nhead,
                                        mode),
        "norm_mhsa": _ln(f"{prefix}.norm_mhsa", sd),
        "norm_conv": _ln(f"{prefix}.norm_conv", sd),
        "convolution_branch": {
            "pre_channel_proj": convert_linear(
                sd[f"{prefix}.convolution_branch.pre_channel_proj.weight"],
                sd[f"{prefix}.convolution_branch.pre_channel_proj.bias"]),
            "post_channel_proj": convert_linear(
                sd[f"{prefix}.convolution_branch.post_channel_proj.weight"],
                sd[f"{prefix}.convolution_branch.post_channel_proj.bias"]),
            "csgu": {
                "norm": _ln(f"{prefix}.convolution_branch.csgu.norm", sd),
                "conv_kernel": convert_depthwise_conv1d(
                    sd[f"{prefix}.convolution_branch.csgu.conv.weight"]),
                "conv_bias": np.asarray(
                    sd[f"{prefix}.convolution_branch.csgu.conv.bias"]),
            },
        },
    }
    if f"{prefix}.merge_proj.weight" in sd:  # plain Linear (MHA mixers)
        tree["merge_proj"] = convert_linear(
            sd[f"{prefix}.merge_proj.weight"], sd[f"{prefix}.merge_proj.bias"])
    else:  # deep VanillaNN merge (SummaryMixing, Branchformer.py:221-226)
        tree["merge_proj"] = _mlp_from_torch(f"{prefix}.merge_proj", sd)
    return tree


def convert_conformer_layer(
    prefix: str, sd: Dict[str, np.ndarray], nhead: int, mode: str
) -> dict:
    """One reference ConformerEncoderLayer (Conformer.py:336-638,
    SummaryMixing mixer): macaron ffn_module1/2 are Sequential(LayerNorm,
    PositionalwiseFeedForward, Dropout) -> flax norm_ffn{i} + ffn{i};
    ConvolutionModule bottleneck is a 1x1 Conv1d [2C, C, 1] -> Dense."""
    cm = f"{prefix}.convolution_module"
    bk = sd[f"{cm}.bottleneck.0.weight"]  # [2C, C, 1]
    tree = {
        "mixer": convert_summary_mixing(f"{prefix}.mha_layer", sd, nhead,
                                        mode),
        "norm1": _ln(f"{prefix}.norm1", sd),
        "norm2": _ln(f"{prefix}.norm2", sd),
        "norm_ffn1": convert_layernorm(sd[f"{prefix}.ffn_module1.0.weight"],
                                       sd[f"{prefix}.ffn_module1.0.bias"]),
        "norm_ffn2": convert_layernorm(sd[f"{prefix}.ffn_module2.0.weight"],
                                       sd[f"{prefix}.ffn_module2.0.bias"]),
        "ffn1": {
            "ffn_in": convert_linear(sd[f"{prefix}.ffn_module1.1.ffn.0.weight"],
                                     sd[f"{prefix}.ffn_module1.1.ffn.0.bias"]),
            "ffn_out": convert_linear(sd[f"{prefix}.ffn_module1.1.ffn.3.weight"],
                                      sd[f"{prefix}.ffn_module1.1.ffn.3.bias"]),
        },
        "ffn2": {
            "ffn_in": convert_linear(sd[f"{prefix}.ffn_module2.1.ffn.0.weight"],
                                     sd[f"{prefix}.ffn_module2.1.ffn.0.bias"]),
            "ffn_out": convert_linear(sd[f"{prefix}.ffn_module2.1.ffn.3.weight"],
                                      sd[f"{prefix}.ffn_module2.1.ffn.3.bias"]),
        },
        "convolution_module": {
            "layer_norm": convert_layernorm(sd[f"{cm}.layer_norm.weight"],
                                            sd[f"{cm}.layer_norm.bias"]),
            "bottleneck": convert_linear(bk[:, :, 0],
                                         sd.get(f"{cm}.bottleneck.0.bias")),
            "conv_kernel": convert_depthwise_conv1d(sd[f"{cm}.conv.weight"]),
            "conv_bias": np.asarray(sd[f"{cm}.conv.bias"]),
            "after_norm": convert_layernorm(sd[f"{cm}.after_conv.0.weight"],
                                            sd[f"{cm}.after_conv.0.bias"]),
            "pointwise_out": convert_linear(sd[f"{cm}.after_conv.2.weight"],
                                            sd.get(f"{cm}.after_conv.2.bias")),
        },
    }
    return tree


def convert_lstm(prefix: str, sd: Dict[str, np.ndarray], layer: int = 0
                 ) -> dict:
    """torch nn.LSTM layer (speechbrain RNN wraps it at `.rnn`) -> flax
    OptimizedLSTMCell params. torch stacks gates [i, f, g, o] in
    weight_ih/hh [4H, *]; flax keeps per-gate Dense modules ii/if/ig/io
    (no bias) and hi/hf/hg/ho (bias = b_ih + b_hh)."""
    w_ih = sd[f"{prefix}.weight_ih_l{layer}"]
    w_hh = sd[f"{prefix}.weight_hh_l{layer}"]
    b = (sd[f"{prefix}.bias_ih_l{layer}"]
         + sd[f"{prefix}.bias_hh_l{layer}"])
    h = w_hh.shape[1]
    gates = ("i", "f", "g", "o")
    out = {}
    for gi, g in enumerate(gates):
        out[f"i{g}"] = {"kernel": np.ascontiguousarray(
            w_ih[gi * h:(gi + 1) * h].T)}
        out[f"h{g}"] = {
            "kernel": np.ascontiguousarray(w_hh[gi * h:(gi + 1) * h].T),
            "bias": np.asarray(b[gi * h:(gi + 1) * h]),
        }
    return out


def convert_transducer_model(sd: Dict[str, np.ndarray], *, nhead: int,
                             mode: str, num_encoder_layers: int) -> dict:
    """Convert the transducer recipe's model ModuleList
    [CNN, enc(EncoderWrapper), emb, dec(LSTM), proj_enc, proj_dec,
    proj_ctc, transducer_lin] (reference transducer yaml:369-370) into
    {"encoder": SpeechRecognizer params, "transducer": TransducerModel
    params}. The one-hot embedding ("2.") has no learnable weights (flax
    computes it analytically)."""
    t = "1.transformer"
    enc = {}
    for i in range(num_encoder_layers):
        enc[f"layer_{i}"] = convert_conformer_layer(
            f"{t}.encoder.layers.{i}", sd, nhead, mode)
    enc["norm"] = _ln(f"{t}.encoder.norm", sd)
    encoder_params = {
        "cnn": _convert_frontend(sd, "0."),
        "asr": {
            "src_proj": convert_linear(sd[f"{t}.custom_src_module.0.w.weight"],
                                       sd[f"{t}.custom_src_module.0.w.bias"]),
            "encoder": enc,
        },
        # the recipe's proj_ctc applies over proj_enc(enc_out); the flax
        # SpeechRecognizer ctc_lin is unused in the transducer path but
        # must exist — fill from proj_ctc for completeness
        "ctc_lin": convert_linear(sd["6.w.weight"], sd["6.w.bias"]),
    }
    transducer_params = {
        "proj_enc": {"kernel": np.ascontiguousarray(sd["4.w.weight"].T)},
        "predictor": {
            "lstm": convert_lstm("3.rnn", sd),
            "proj_dec": {"kernel": np.ascontiguousarray(sd["5.w.weight"].T)},
        },
        "proj_ctc": convert_linear(sd["6.w.weight"], sd["6.w.bias"]),
        "joint": {"transducer_lin": {
            "kernel": np.ascontiguousarray(sd["7.w.weight"].T)}},
    }
    if "8.w.weight" in sd:  # optional dec_lin CE head (yaml:312-315)
        transducer_params["dec_lin"] = {
            "kernel": np.ascontiguousarray(sd["8.w.weight"].T)}
    return {"encoder": encoder_params, "transducer": transducer_params}


def convert_decoder_layer(prefix: str, sd: Dict[str, np.ndarray]) -> dict:
    """Reference TransformerDecoderLayer (Transformer.py:693-830)."""
    return {
        "self_attn": convert_mha(f"{prefix}.self_attn", sd),
        "cross_attn": convert_mha(f"{prefix}.multihead_attn", sd),
        "pos_ffn": {
            "ffn_in": convert_linear(sd[f"{prefix}.pos_ffn.ffn.0.weight"],
                                     sd[f"{prefix}.pos_ffn.ffn.0.bias"]),
            "ffn_out": convert_linear(sd[f"{prefix}.pos_ffn.ffn.3.weight"],
                                      sd[f"{prefix}.pos_ffn.ffn.3.bias"]),
        },
        "norm1": _ln(f"{prefix}.norm1", sd),
        "norm2": _ln(f"{prefix}.norm2", sd),
        "norm3": _ln(f"{prefix}.norm3", sd),
    }


def _convert_frontend(sd: Dict[str, np.ndarray], prefix: str = "0.") -> dict:
    """ConvolutionFrontEnd subtree: extracted ORDER-BASED (state dicts keep
    registration order), robust to speechbrain's block naming: 4-D weights
    are the conv kernels, and the 1-D weight/bias pair following each conv
    is its LayerNorm."""
    cnn = {}
    conv_i = norm_i = 0
    keys = [k for k in sd if k.startswith(prefix)]
    i = 0
    while i < len(keys):
        k = keys[i]
        if not k.endswith(".weight"):
            # .bias keys are consumed alongside their .weight; anything
            # else (a buffer) is left for the consumption report
            i += 1
            continue
        w = sd[k]
        if w.ndim == 4:
            bias_k = k[: -len(".weight")] + ".bias"
            cnn[f"conv_{conv_i}"] = convert_conv2d(w, sd.get(bias_k))
            conv_i += 1
            i += 2 if bias_k in sd else 1
        elif w.ndim == 1:
            bias_k = k[: -len(".weight")] + ".bias"
            cnn[f"norm_{norm_i}"] = convert_layernorm(w, sd[bias_k])
            norm_i += 1
            i += 2
        else:
            # a weight shape this extractor does not model (the reference
            # ConvolutionFrontEnd is strictly conv2d + layernorm blocks,
            # ContainerCNN.py) — dropping it silently would convert to
            # different numerics
            raise KeyError(
                f"unrecognised frontend weight {k} (ndim={w.ndim}): the "
                "frontend extractor models conv2d + layernorm blocks only")
    if not cnn:
        raise KeyError(f"no frontend convs under {prefix!r}")
    return cnn


def convert_full_model(sd: Dict[str, np.ndarray], *, nhead: int, mode: str,
                       num_encoder_layers: int, num_decoder_layers: int
                       ) -> dict:
    """Convert a complete reference flagship state dict — the
    torch.nn.ModuleList [CNN, Transformer, seq_lin, ctc_lin] of
    branchformer_summarymixing.yaml:214-215 — into the flax SpeechRecognizer
    parameter tree (models/speech_recognizer.py). Key prefixes:

      "0." CNN (ConvolutionFrontEnd)      -> cnn/ (order-based extraction)
      "1." TransformerASR                 -> asr/
      "2." seq_lin (sb Linear at .w)      -> seq_lin/
      "3." ctc_lin                        -> ctc_lin/

    Transformer subtree names come from the vendored reference sources
    (TransformerASR.py:349-357 custom_src_module/custom_tgt_module,
    Branchformer.py:184-241 layer attrs, Transformer.py:743-772 decoder)."""
    params = {"cnn": _convert_frontend(sd, "0.")}
    enc = {}
    for i in range(num_encoder_layers):
        enc[f"layer_{i}"] = convert_branchformer_layer(
            f"1.encoder.layers.{i}", sd, nhead, mode)
    enc["norm"] = _ln("1.encoder.norm", sd)
    asr = {
        "src_proj": convert_linear(sd["1.custom_src_module.0.w.weight"],
                                   sd["1.custom_src_module.0.w.bias"]),
        "encoder": enc,
    }
    if num_decoder_layers > 0:
        dec = {}
        for i in range(num_decoder_layers):
            dec[f"layer_{i}"] = convert_decoder_layer(f"1.decoder.layers.{i}",
                                                      sd)
        dec["norm"] = _ln("1.decoder.norm", sd)
        asr["decoder"] = dec
        asr["tgt_emb"] = {"emb": {"embedding": np.asarray(
            sd["1.custom_tgt_module.0.emb.Embedding.weight"])}}
    params["asr"] = asr
    if "2.w.weight" in sd:
        params["seq_lin"] = convert_linear(sd["2.w.weight"], sd["2.w.bias"])
    params["ctc_lin"] = convert_linear(sd["3.w.weight"], sd["3.w.bias"])
    return params


def convert_encoder_layer(prefix: str, sd: Dict[str, np.ndarray]) -> dict:
    """Reference TransformerEncoderLayer with regularMHA
    (Transformer.py:404-467: attrs self_att/pos_ffn/norm1/norm2) -> flax
    TransformerEncoderLayer params (models/transformer.py)."""
    return {
        "self_att": convert_mha(f"{prefix}.self_att", sd),
        "pos_ffn": {
            "ffn_in": convert_linear(sd[f"{prefix}.pos_ffn.ffn.0.weight"],
                                     sd[f"{prefix}.pos_ffn.ffn.0.bias"]),
            "ffn_out": convert_linear(sd[f"{prefix}.pos_ffn.ffn.3.weight"],
                                      sd[f"{prefix}.pos_ffn.ffn.3.bias"]),
        },
        "norm1": _ln(f"{prefix}.norm1", sd),
        "norm2": _ln(f"{prefix}.norm2", sd),
    }


def convert_transformer_lm(sd: Dict[str, np.ndarray]) -> dict:
    """Convert a SpeechBrain TransformerLM `lm.ckpt` state dict (the
    Pretrainer's published LM, reference branchformer yaml:182-191:
    768d/12h/12L, d_ffn 3072, GELU, normalize_before False, causal) into
    the flax TransformerLM parameter tree (models/lm.py).

    SpeechBrain layout (speechbrain TransformerLM over the encoder classes
    of the vendored Transformer.py):

      custom_src_module.emb.Embedding.weight   NormalizedEmbedding
      encoder.layers.{i}.{self_att,pos_ffn,norm1,norm2}
      encoder.norm                              stack-final LN (eps 1e-6)
      output_proj.layers.{0,1,2}                Linear(d,d) -> LayerNorm
                                                -> Linear(d,vocab)
      (older/simpler heads: a single output-projection Linear)

    The 3-module head maps onto the flax model's output_proj="sb" variant
    (out_proj/out_norm/out); a single-Linear head maps onto the default
    output_proj="linear". The returned dict carries the inferred variant
    under the "__output_proj__" key for the caller (convert_checkpoint.py)
    to build the matching LMConfig."""
    if "embedding_proj.w.weight" in sd:
        raise NotImplementedError(
            "TransformerLM with d_embedding != d_model (embedding_proj) "
            "is not supported; the published 768d LM does not use it")
    params = {"emb": {"emb": {"embedding": np.asarray(
        sd["custom_src_module.emb.Embedding.weight"])}}}
    enc = {}
    i = 0
    while f"encoder.layers.{i}.self_att.att.in_proj_weight" in sd:
        enc[f"layer_{i}"] = convert_encoder_layer(f"encoder.layers.{i}", sd)
        i += 1
    if not enc:
        raise KeyError("no encoder layers found: not a SpeechBrain "
                       "TransformerLM state dict?")
    enc["norm"] = _ln("encoder.norm", sd)
    params["encoder"] = enc
    if "output_proj.layers.0.w.weight" in sd:
        params["out_proj"] = convert_linear(
            sd["output_proj.layers.0.w.weight"],
            sd["output_proj.layers.0.w.bias"])
        params["out_norm"] = _ln("output_proj.layers.1", sd)
        params["out"] = convert_linear(sd["output_proj.layers.2.w.weight"],
                                       sd["output_proj.layers.2.w.bias"])
        params["__output_proj__"] = "sb"
    elif "output_proj.w.weight" in sd:
        params["out"] = convert_linear(sd["output_proj.w.weight"],
                                       sd["output_proj.w.bias"])
        params["__output_proj__"] = "linear"
    else:
        raise KeyError("no output_proj head found in the LM state dict")
    return params


def convert_rnnlm(sd: Dict[str, np.ndarray]) -> dict:
    """Convert a SpeechBrain RNNLM `lm.ckpt` (the transducer recipes'
    fusion LM, reference transducer yaml:339-348: emb 128, 2-layer LSTM
    2048, one 512 DNN block) into the flax RNNLM tree (models/lm.py:
    emb -> lstm_{i} -> dnn -> leaky_relu -> out).

    Key discovery is shape-driven so SpeechBrain container-naming
    variants all convert: the embedding is the [vocab, emb] matrix under
    an 'emb' key, LSTM layers are the torch `weight_ih_l{k}` stacks, the
    DNN linear is [dnn, rnn] and the head [vocab, dnn]. Any unconsumed
    parameters (e.g. a normalisation block this converter does not model)
    raise instead of silently converting to different numerics."""
    emb_key = next((k for k in sd if "emb" in k.lower()
                    and k.endswith(".weight") and sd[k].ndim == 2), None)
    ih0 = next((k for k in sd if k.endswith("weight_ih_l0")), None)
    if emb_key is None or ih0 is None:
        raise KeyError("no embedding / LSTM weights found: not an RNNLM "
                       "state dict?")
    rnn_prefix = ih0[: -len(".weight_ih_l0")]
    n_layers = 0
    while f"{rnn_prefix}.weight_ih_l{n_layers}" in sd:
        n_layers += 1
    rnn_neurons = sd[f"{rnn_prefix}.weight_hh_l0"].shape[1]
    vocab = sd[emb_key].shape[0]
    params = {"emb": {"embedding": np.asarray(sd[emb_key])}}
    consumed = {emb_key}
    for li in range(n_layers):
        params[f"lstm_{li}"] = convert_lstm(rnn_prefix, sd, layer=li)
        consumed |= {f"{rnn_prefix}.{n}_l{li}"
                     for n in ("weight_ih", "weight_hh", "bias_ih",
                               "bias_hh")}
    # remaining 2-D linears in registration order (state dicts preserve
    # it): the DNN block's linear, then the output head
    linears = [k for k in sd if k.endswith(".weight") and sd[k].ndim == 2
               and k not in consumed]
    if len(linears) != 2:
        raise KeyError(
            f"expected exactly [dnn, out] linears after the LSTM, found "
            f"{linears}; convert_rnnlm models the reference transducer "
            "RNNLM topology (one 512 DNN block)")
    dnn_k, out_k = linears
    if (sd[dnn_k].shape[1] != rnn_neurons
            or sd[out_k].shape[1] != sd[dnn_k].shape[0]
            or sd[out_k].shape[0] != vocab):
        raise KeyError(
            f"linear shapes do not chain emb->lstm({rnn_neurons})->dnn->"
            f"out({vocab}): {dnn_k}={sd[dnn_k].shape}, "
            f"{out_k}={sd[out_k].shape}")
    params["dnn"] = convert_linear(sd[dnn_k],
                                   sd.get(dnn_k[:-len(".weight")] + ".bias"))
    params["out"] = convert_linear(sd[out_k],
                                   sd.get(out_k[:-len(".weight")] + ".bias"))
    consumed |= {dnn_k, dnn_k[:-len(".weight")] + ".bias",
                 out_k, out_k[:-len(".weight")] + ".bias"}
    leftovers = [k for k in sd if k not in consumed
                 and not k.endswith("num_batches_tracked")]
    if any(sd[k].ndim >= 1 and sd[k].size > 1 for k in leftovers):
        raise KeyError(
            f"unconsumed RNNLM parameters {sorted(leftovers)}: the state "
            "dict contains blocks (e.g. normalisation) this converter "
            "does not model — converting would silently change numerics")
    return params


def convert_summary_mixing(
    prefix: str, sd: Dict[str, np.ndarray], nhead: int, mode: str
) -> dict:
    """Convert a reference SummaryMixing cell (summary_mixing.py:112-157)
    state-dict subtree into the flax SummaryMixing param tree."""
    tree = {}
    if mode in ("SummaryMixing", "SummaryMixing-expdecay"):
        tree["local_proj"] = _mlp_from_torch(f"{prefix}.local_proj", sd)
        tree["summary_proj"] = _mlp_from_torch(f"{prefix}.summary_proj", sd)
        tree["summary_local_merging"] = _mlp_from_torch(
            f"{prefix}.summary_local_merging", sd)
    elif mode == "SummaryMixing-fast":
        tree["global_proj"] = _mlp_from_torch(f"{prefix}.global_proj", sd)
        tree["summary_local_merging"] = _mlp_from_torch(
            f"{prefix}.summary_local_merging", sd)
    else:
        tree["summary_proj"] = _mlp_from_torch(f"{prefix}.summary_proj", sd)
    return tree
