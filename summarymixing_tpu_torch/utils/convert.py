"""Weight bridge from the JAX package: `load_jax_params` fills a port module
from the flax params tree of its counterpart.

The port's modules carry the flax tree's names (the attention decoder's
too: `decoder.layer_i.{self_attn,cross_attn}.{q,k,v,out}_proj`, or for
the Summary Decoder `decoder.layer_i.self_attn.{local_proj,summary_proj,
summary_local_merging}`,
`pos_ffn.{ffn_in,ffn_out}`, `norm1`-`norm3`, `seq_lin`; the Transformer
LM's: `emb.emb`, `encoder.layer_i.{self_att,pos_ffn,norm1,norm2}`,
`encoder.norm`, `out`, with `out_proj` and `out_norm` for the "sb" head;
the Conformer's `ffn1`, `ffn2`, `norm_ffn1`, `norm_ffn2`, `norm1`,
`norm2`, `mixer.global_proj`, `convolution_module.{layer_norm,bottleneck,
after_norm,pointwise_out}`; the transducer's `proj_enc`, `predictor.lstm`,
`predictor.proj_dec`, `joint.transducer_lin`, `proj_ctc`, `dec_lin`; the
RNNLM's `emb`, `lstm_0`, `lstm_1`, ..., `dnn`, `out`), so the bridge is a
tree walk with these layout rules:

- `torch.nn.Linear`: the Dense `kernel` `[in, out]` becomes `weight`
  `[out, in]`;
- `torch.nn.Conv2d`: the `kernel` `HWIO` becomes `weight` `OIHW`;
- `torch.nn.LayerNorm`: `scale` becomes `weight`;
- `torch.nn.Embedding`: `embedding` becomes `weight`;
- `ConvolutionModule`: the depthwise `conv_kernel` `[K, C]` becomes
  `[C, 1, K]`, the layout of `torch.nn.functional.conv1d` with C groups;
- `LSTMCell`: flax's `OptimizedLSTMCell` keeps eight Dense leaves,
  `i{i,f,g,o}.kernel` `[in, H]` without bias and `h{i,f,g,o}.{kernel
  [H, H], bias}`; they become `weight_ih` `[4H, in]`, `weight_hh`
  `[4H, H]` and `bias` `[4H]`, the gates stacked in the order i, f, g, o.

Every other parameter keeps its name and layout. The walk raises if a leaf
of the tree is left over or a port parameter is left unfilled.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from summarymixing_tpu_torch.models.transducer import LSTMCell
from summarymixing_tpu_torch.ops.convolution import ConvolutionModule

_GATES = ("i", "f", "g", "o")


def _leaf(name: str, transform=None) -> Tuple[Tuple[str, ...], Callable]:
    """A rule that reads one flax leaf, optionally changing its layout."""
    def read(tree):
        value = np.asarray(tree[name])
        return value if transform is None else transform(value)
    return (name,), read


def _stacked(side: str, leaf: str, transform) -> Tuple[Tuple[str, ...], Callable]:
    """A rule that stacks the four gates' `<side><gate>.<leaf>` along axis 0."""
    names = tuple(side + g for g in _GATES)
    return names, lambda tree: np.concatenate(
        [transform(np.asarray(tree[n][leaf])) for n in names], axis=0)


def _leaf_rules(mod: nn.Module) -> Dict[str, tuple]:
    """port parameter name -> (flax names it consumes, reader of the subtree)."""
    if isinstance(mod, nn.Linear):
        return {"weight": _leaf("kernel", lambda a: a.T), "bias": _leaf("bias")}
    if isinstance(mod, nn.Conv2d):
        return {"weight": _leaf("kernel", lambda a: a.transpose(3, 2, 0, 1)),
                "bias": _leaf("bias")}
    if isinstance(mod, nn.LayerNorm):
        return {"weight": _leaf("scale"), "bias": _leaf("bias")}
    if isinstance(mod, nn.Embedding):
        return {"weight": _leaf("embedding")}
    if isinstance(mod, ConvolutionModule):
        return {"conv_kernel": _leaf("conv_kernel", lambda a: a.T[:, None, :]),
                "conv_bias": _leaf("conv_bias")}
    if isinstance(mod, LSTMCell):
        return {"weight_ih": _stacked("i", "kernel", lambda a: a.T),
                "weight_hh": _stacked("h", "kernel", lambda a: a.T),
                "bias": _stacked("h", "bias", lambda a: a)}
    return {name: _leaf(name) for name, _ in mod.named_parameters(recurse=False)}


def _walk(mod: nn.Module, tree: Mapping, path: str, leftover: List[str],
          unfilled: List[str]) -> None:
    used = set()
    for pname, (leaves, read) in _leaf_rules(mod).items():
        param = getattr(mod, pname)
        if param is None:
            continue
        if any(leaf not in tree for leaf in leaves):
            unfilled.append(f"{path}{pname}")
            continue
        value = read(tree)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}{pname}: flax leaves {leaves} have shape {value.shape} "
                             f"after layout change, the port wants {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value)))
        used.update(leaves)
    for name, child in mod.named_children():
        if not any(True for _ in child.parameters()):
            continue
        if name not in tree:
            unfilled.extend(f"{path}{name}.{p}" for p, _ in child.named_parameters())
            continue
        _walk(child, tree[name], f"{path}{name}.", leftover, unfilled)
        used.add(name)
    leftover.extend(f"{path}{k}" for k in tree if k not in used)


def load_jax_params(module: nn.Module, params: Mapping) -> nn.Module:
    """Fill `module` in place from a flax params tree (nested dicts of numpy
    or JAX arrays; the `{"params": ...}` wrapper is accepted too)."""
    if set(params) == {"params"}:
        params = params["params"]
    leftover: List[str] = []
    unfilled: List[str] = []
    _walk(module, params, "", leftover, unfilled)
    if leftover or unfilled:
        raise KeyError(f"flax leaves not used: {leftover[:20]}; "
                       f"port parameters not filled: {unfilled[:20]}")
    return module
