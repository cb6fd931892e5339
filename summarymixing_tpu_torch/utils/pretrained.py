"""Pretrained-component transfer — the port's copy of
`summarymixing_tpu/utils/pretrained.py`, the counterpart of SpeechBrain's
Pretrainer (the recipes' `pretrainer:` block: collect the `loadables`, an
LM and a tokenizer, from paths and load them before training or
decoding).

Loadables are local paths: a remote source (`http://`, `https://`,
`hf://`) raises, since the port fetches nothing. A `.ckpt`, `.pt` or
`.pth` loads as a torch state dict of numpy arrays
(`utils.convert.load_torch_checkpoint`, the SpeechBrain converters' input),
a `.model` as a `data.tokenizer.SentencePieceTokenizer`."""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import numpy as np


@dataclass
class Pretrainer:
    """collect_in: directory where loadables are expected; loadables maps
    names to file paths (relative ones under `collect_in`); custom_loaders
    maps names to load functions (default: by extension)."""

    collect_in: str
    loadables: Dict[str, str] = field(default_factory=dict)
    custom_loaders: Dict[str, Callable[[str], Any]] = field(default_factory=dict)

    def resolve(self, name: str) -> str:
        path = self.loadables[name]
        if path.startswith(("http://", "https://", "hf://")):
            raise RuntimeError(
                f"loadable {name!r} points at a remote source ({path}); the port fetches "
                f"nothing: download it out of band and place it under {self.collect_in}")
        if not os.path.isabs(path):
            path = os.path.join(self.collect_in, path)
        if not os.path.exists(path):
            raise FileNotFoundError(f"loadable {name!r}: {path} not found")
        return path

    def load(self, name: str) -> Any:
        path = self.resolve(name)
        if name in self.custom_loaders:
            return self.custom_loaders[name](path)
        if path.endswith((".ckpt", ".pt", ".pth")):
            from summarymixing_tpu_torch.utils.convert import load_torch_checkpoint

            return load_torch_checkpoint(path)
        if path.endswith(".npz"):
            return dict(np.load(path, allow_pickle=True))
        if path.endswith((".pkl", ".pickle")):
            with open(path, "rb") as f:
                return pickle.load(f)
        if path.endswith(".model"):
            from summarymixing_tpu_torch.data.tokenizer import SentencePieceTokenizer

            return SentencePieceTokenizer(path)
        raise ValueError(f"don't know how to load {path}")

    def collect(self) -> Dict[str, Any]:
        return {name: self.load(name) for name in self.loadables}
