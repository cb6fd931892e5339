"""Weight bridge from the JAX package: `load_jax_params` fills a port module
from the flax params tree of its counterpart.

The port's modules carry the flax tree's names (the attention decoder's
too: `decoder.layer_i.{self_attn,cross_attn}.{q,k,v,out}_proj`,
`pos_ffn.{ffn_in,ffn_out}`, `norm1`-`norm3`, `seq_lin`; and the
Transformer LM's: `emb.emb`, `encoder.layer_i.{self_att,pos_ffn,norm1,
norm2}`, `encoder.norm`, `out`, with `out_proj` and `out_norm` for the
"sb" head), so the bridge is a tree walk with four layout rules:

- `torch.nn.Linear`: the Dense `kernel` `[in, out]` becomes `weight`
  `[out, in]`;
- `torch.nn.Conv2d`: the `kernel` `HWIO` becomes `weight` `OIHW`;
- `torch.nn.LayerNorm`: `scale` becomes `weight`;
- `torch.nn.Embedding`: `embedding` becomes `weight`.

Every other parameter keeps its name and layout. The walk raises if a leaf
of the tree is left over or a port parameter is left unfilled.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
from torch import nn


def _leaf_rules(mod: nn.Module) -> Dict[str, tuple]:
    """port parameter name -> (flax leaf name, layout transform)."""
    if isinstance(mod, nn.Linear):
        return {"weight": ("kernel", lambda a: a.T), "bias": ("bias", None)}
    if isinstance(mod, nn.Conv2d):
        return {"weight": ("kernel", lambda a: a.transpose(3, 2, 0, 1)), "bias": ("bias", None)}
    if isinstance(mod, nn.LayerNorm):
        return {"weight": ("scale", None), "bias": ("bias", None)}
    if isinstance(mod, nn.Embedding):
        return {"weight": ("embedding", None)}
    return {name: (name, None) for name, _ in mod.named_parameters(recurse=False)}


def _walk(mod: nn.Module, tree: Mapping, path: str, leftover: List[str],
          unfilled: List[str]) -> None:
    used = set()
    for pname, (leaf, transform) in _leaf_rules(mod).items():
        param = getattr(mod, pname)
        if param is None:
            continue
        if leaf not in tree:
            unfilled.append(f"{path}{pname}")
            continue
        value = np.asarray(tree[leaf])
        if transform is not None:
            value = transform(value)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{path}{pname}: flax leaf {leaf} has shape {value.shape} "
                             f"after layout change, the port wants {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(value)))
        used.add(leaf)
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
