"""Tokenizers — the port's copy of `summarymixing_tpu/data/tokenizer.py`:
the character tokenizer (AISHELL-style recipes and the synthetic ones)
and `load_tokenizer`. The subword recipes train their tokenizer with
`data/subword.py` when no SentencePiece `.model` is given (as the JAX
recipes do without the wheel). Reading a SentencePiece `.model` file is
still to port: the JAX package's pure-Python ModelProto reader
(`data/sentencepiece_model.py`) has no copy here yet, and neither machine
has the `sentencepiece` wheel (ROADMAP.md, queue 1 item 7)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence


@dataclass
class CharTokenizer:
    """Character tokenizer with reserved ids: 0=blank/pad, 1=bos, 2=eos,
    3=unk (matching the recipes' blank_index/bos_index/eos_index layout)."""

    vocab: Dict[str, int] = field(default_factory=dict)
    blank_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    unk_id: int = 3

    @classmethod
    def build(cls, texts: Sequence[str]) -> "CharTokenizer":
        chars = sorted({c for t in texts for c in t})
        vocab = {c: i + 4 for i, c in enumerate(chars)}
        return cls(vocab=vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + 4

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(c, self.unk_id) for c in text]

    def decode(self, ids: Sequence[int]) -> str:
        # cached inverse map (rebuilt per hypothesis otherwise — O(vocab)
        # in the eval scoring loop); keyed by the vocab OBJECT (replacing
        # self.vocab with a different same-size mapping invalidates it)
        # AND its size (growing the same dict in place invalidates too)
        cached = getattr(self, "_inv", None)
        if (cached is None or cached[0] is not self.vocab
                or len(cached[1]) != len(self.vocab)):
            inv = {i: c for c, i in self.vocab.items()}
            cached = (self.vocab, inv)
            object.__setattr__(self, "_inv", cached)
        inv = cached[1]
        return "".join(inv.get(i, "") for i in ids if i >= 4)


class SentencePieceTokenizer:
    """A trained SentencePiece `.model` file: not ported yet."""

    def __init__(self, model_path: str):
        raise NotImplementedError(
            f"reading the SentencePiece model {model_path} is not ported (the JAX package's "
            "data/sentencepiece_model.py); see ROADMAP.md queue 1 item 7")


def load_tokenizer(kind: str, **kwargs):
    if kind == "char":
        return CharTokenizer(**kwargs)
    if kind == "sentencepiece":
        return SentencePieceTokenizer(**kwargs)
    raise ValueError(f"unknown tokenizer kind {kind!r}")
