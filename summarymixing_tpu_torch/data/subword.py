"""Subword tokenizer training — the port's copy of
`summarymixing_tpu/data/subword.py`: SentencePiece-style unigram LM and
BPE in pure Python, with no C++ dependency.

Capability parity: the reference trains SentencePiece unigram models of
5000/1000/350 pieces from the training transcripts
(reference LibriSpeech branchformer yaml:193 `token_type: unigram`,
`character_coverage: 1.0`; CommonVoice yaml:55). This module replaces the
sentencepiece wheel with an equivalent trainer:

- words are whitespace-split and prefixed with the word marker U+2581 ("▁"),
  pieces never cross word boundaries (sentencepiece split_by_whitespace);
- unigram: seed vocab from frequent substrings, EM (forward-backward
  expected counts) + iterative pruning to the target size, Viterbi encoding
  (Kudo 2018, arXiv:1804.10959);
- bpe: classic highest-count pair merging;
- ids: 0=<unk>/blank, 1=<bos>, 2=<eos> reserved to match the recipes'
  blank_index/bos_index/eos_index layout (ModelConfig schema.py:62-65);
  pieces start at id 3. vocab_size == output_neurons of the recipe.

The model persists as JSON (pieces + log-probs) and loads through
`SubwordTokenizer`, giving train/evaluate the same id map.
"""

from __future__ import annotations

import json
import math
import os
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

_WORD_MARK = "▁"  # ▁
_RESERVED = 3          # 0=<unk>/blank, 1=<bos>, 2=<eos>
_LP_UNK = -1e4         # per-char score for unknown characters


def _word_counts(texts: Sequence[str]) -> Counter:
    counts: Counter = Counter()
    for t in texts:
        for w in t.split():
            counts[_WORD_MARK + w] += 1
    return counts


# ---------------------------------------------------------------- unigram --


def _seed_vocab(words: Counter, seed_size: int, max_piece_len: int):
    """All single chars + the most frequent substrings, scored by
    count * len (the sentencepiece seed heuristic)."""
    sub_counts: Counter = Counter()
    chars: Counter = Counter()
    for w, c in words.items():
        n = len(w)
        for i in range(n):
            chars[w[i]] += c
            for j in range(i + 2, min(i + max_piece_len, n) + 1):
                sub_counts[w[i:j]] += c
    multi = sorted(
        sub_counts.items(), key=lambda kv: (-kv[1] * len(kv[0]), kv[0])
    )[: max(seed_size - len(chars), 0)]
    total = sum(chars.values()) + sum(c for _, c in multi) or 1
    lp = {p: math.log(max(c, 1) / total) for p, c in chars.items()}
    lp.update({p: math.log(max(c, 1) / total) for p, c in multi})
    return lp


def _lse2(a: float, b: float) -> float:
    """logsumexp of two values with -inf sentinels."""
    if a < b:
        a, b = b, a
    if b <= -1e29:
        return a
    return a + math.log1p(math.exp(b - a))


def _forward_backward(word: str, lp: Dict[str, float], max_len: int):
    """Returns (alpha, beta, total-logprob) for the segmentation lattice of
    `word`; alpha[i] = logsumexp over segmentations of word[:i]."""
    n = len(word)
    neg = -1e30
    alpha = [neg] * (n + 1)
    alpha[0] = 0.0
    for i in range(1, n + 1):
        acc = neg
        for j in range(max(0, i - max_len), i):
            if alpha[j] <= -1e29:
                continue
            piece = word[j:i]
            p = lp.get(piece)
            if p is None:
                if i - j == 1:
                    p = _LP_UNK
                else:
                    continue
            acc = _lse2(acc, alpha[j] + p)
        alpha[i] = acc
    beta = [neg] * (n + 1)
    beta[n] = 0.0
    for i in range(n - 1, -1, -1):
        acc = neg
        for j in range(i + 1, min(i + max_len, n) + 1):
            if beta[j] <= -1e29:
                continue
            piece = word[i:j]
            p = lp.get(piece)
            if p is None:
                if j - i == 1:
                    p = _LP_UNK
                else:
                    continue
            acc = _lse2(acc, p + beta[j])
        beta[i] = acc
    return alpha, beta, alpha[n]


def _em_step(words: Counter, lp: Dict[str, float], max_len: int):
    """One EM iteration: expected piece counts under the current model."""
    expected: defaultdict = defaultdict(float)
    total_ll = 0.0
    for w, c in words.items():
        alpha, beta, z = _forward_backward(w, lp, max_len)
        if z <= -1e29:
            continue
        total_ll += c * z
        n = len(w)
        for i in range(n):
            if alpha[i] <= -1e29:
                continue
            for j in range(i + 1, min(i + max_len, n) + 1):
                piece = w[i:j]
                p = lp.get(piece)
                if p is None:
                    continue
                post = alpha[i] + p + beta[j] - z
                if post > -30.0:
                    expected[piece] += c * math.exp(post)
    total = sum(expected.values()) or 1.0
    new_lp = {
        p: math.log(max(e, 1e-10) / total)
        for p, e in expected.items()
    }
    # pieces with no expected usage keep a floor so chars never vanish
    for p in lp:
        if p not in new_lp and len(p) == 1:
            new_lp[p] = math.log(1e-10 / total)
    return new_lp, expected, total_ll


def _check_char_budget(n_chars: int, vocab_size: int) -> None:
    """Single characters are mandatory pieces (coverage), so a corpus with
    more unique characters than `vocab_size - reserved` cannot be trained to
    the requested size. SentencePiece errors here too; silently exceeding
    the budget would emit token ids >= the model's output_neurons, which XLA
    gathers would clamp without any error."""
    if n_chars > vocab_size - _RESERVED:
        raise ValueError(
            f"vocab_size {vocab_size} too small: the corpus has {n_chars} "
            f"unique characters and {_RESERVED} ids are reserved. Raise "
            f"model.output_neurons to at least {n_chars + _RESERVED} or use "
            "the char tokenizer."
        )


def train_unigram(
    texts: Sequence[str],
    vocab_size: int,
    max_piece_len: int = 12,
    seed_factor: int = 6,
    em_iters: int = 2,
    shrink: float = 0.75,
) -> "SubwordTokenizer":
    """Train a unigram subword model to (at most) `vocab_size` total ids
    (including the 3 reserved)."""
    words = _word_counts(texts)
    if not words:
        raise ValueError("empty corpus")
    target_pieces = max(vocab_size - _RESERVED, 1)
    lp = _seed_vocab(words, seed_factor * vocab_size, max_piece_len)
    chars = {p for p in lp if len(p) == 1}
    _check_char_budget(len(chars), vocab_size)
    # never more single chars than budget allows; chars are mandatory
    while True:
        for _ in range(em_iters):
            lp, expected, _ = _em_step(words, lp, max_piece_len)
            for ch in chars:           # chars always survive
                lp.setdefault(ch, _LP_UNK / 10)
        multi = [p for p in lp if len(p) > 1]
        n_now = len(chars) + len(multi)
        # done when at target; if the mandatory chars alone exceed the
        # target (tiny vocab_size on char-rich text) stop with chars only
        if n_now <= target_pieces or (not multi and n_now > target_pieces):
            break
        if len(chars) >= target_pieces:
            lp = {ch: lp.get(ch, _LP_UNK / 10) for ch in chars}
            break
        keep = max(int(n_now * shrink), target_pieces) - len(chars)
        keep = max(keep, 0)
        multi.sort(key=lambda p: expected.get(p, 0.0), reverse=True)
        lp = {p: lp[p] for p in multi[:keep]}
        for ch in chars:
            lp.setdefault(ch, _LP_UNK / 10)
    # renormalise
    z = math.log(sum(math.exp(v) for v in lp.values()) or 1.0)
    lp = {p: v - z for p, v in lp.items()}
    pieces = sorted(lp, key=lambda p: (-lp[p], p))
    return SubwordTokenizer(
        pieces={p: lp[p] for p in pieces}, model_type="unigram",
        max_piece_len=max_piece_len,
    )


# -------------------------------------------------------------------- bpe --


def train_bpe(
    texts: Sequence[str], vocab_size: int, max_piece_len: int = 12
) -> "SubwordTokenizer":
    """Classic BPE: repeatedly merge the most frequent adjacent pair."""
    words = _word_counts(texts)
    seqs: Dict[Tuple[str, ...], int] = {tuple(w): c for w, c in words.items()}
    vocab = Counter()
    for w, c in seqs.items():
        for ch in w:
            vocab[ch] += c
    pieces = set(vocab)
    _check_char_budget(len(pieces), vocab_size)
    target = max(vocab_size - _RESERVED, 1)
    while len(pieces) < target:
        pairs: Counter = Counter()
        for w, c in seqs.items():
            for a, b in zip(w, w[1:]):
                if len(a) + len(b) <= max_piece_len:
                    pairs[(a, b)] += c
        if not pairs:
            break
        (a, b), cnt = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if cnt < 2:
            break
        merged = a + b
        pieces.add(merged)
        new_seqs: Dict[Tuple[str, ...], int] = {}
        for w, c in seqs.items():
            out: List[str] = []
            i = 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_seqs[tuple(out)] = new_seqs.get(tuple(out), 0) + c
        seqs = new_seqs
    # score pieces by final usage for Viterbi encoding
    usage: Counter = Counter()
    for w, c in seqs.items():
        for p in w:
            usage[p] += c
    total = sum(usage.values()) or 1
    lp = {
        p: math.log(max(usage.get(p, 1), 1) / total)
        for p in pieces
    }
    ordered = sorted(lp, key=lambda p: (-lp[p], p))
    return SubwordTokenizer(
        pieces={p: lp[p] for p in ordered}, model_type="bpe",
        max_piece_len=max_piece_len,
    )


# ---------------------------------------------------------------- wrapper --


class SubwordTokenizer:
    """Viterbi-encoding subword tokenizer over a piece->logprob table.

    ids: 0=<unk>/blank, 1=<bos>, 2=<eos>, pieces from 3 (reserved layout of
    the recipes; schema.py ModelConfig)."""

    unk_id = 0
    bos_id = 1
    eos_id = 2

    def __init__(self, pieces: Dict[str, float], model_type: str = "unigram",
                 max_piece_len: int = 12):
        self.pieces = dict(pieces)
        self.model_type = model_type
        self.max_piece_len = max_piece_len
        self._id_of = {p: i + _RESERVED for i, p in enumerate(self.pieces)}
        self._piece_of = {i: p for p, i in self._id_of.items()}

    # -- persistence -----------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({
                "model_type": self.model_type,
                "max_piece_len": self.max_piece_len,
                "pieces": self.pieces,
            }, f, ensure_ascii=False)

    @classmethod
    def load(cls, path: str) -> "SubwordTokenizer":
        with open(path) as f:
            data = json.load(f)
        return cls(pieces=data["pieces"], model_type=data["model_type"],
                   max_piece_len=data["max_piece_len"])

    # -- encode/decode -----------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.pieces) + _RESERVED

    def _encode_word(self, word: str) -> List[int]:
        n = len(word)
        neg = -1e30
        best = [neg] * (n + 1)
        back: List[Optional[Tuple[int, Optional[str]]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(1, n + 1):
            for j in range(max(0, i - self.max_piece_len), i):
                piece = word[j:i]
                p = self.pieces.get(piece)
                if p is None:
                    if i - j == 1:
                        p, piece = _LP_UNK, None
                    else:
                        continue
                v = best[j] + p
                if v > best[i]:
                    best[i] = v
                    back[i] = (j, piece)
        ids: List[int] = []
        i = n
        while i > 0:
            j, piece = back[i]
            ids.append(self._id_of[piece] if piece is not None else self.unk_id)
            i = j
        return ids[::-1]

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for w in text.split():
            out.extend(self._encode_word(_WORD_MARK + w))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        chunks = [self._piece_of.get(int(i), "") for i in ids]
        return "".join(chunks).replace(_WORD_MARK, " ").strip()


def train_subword(texts: Sequence[str], vocab_size: int,
                  token_type: str = "unigram") -> SubwordTokenizer:
    if token_type == "unigram":
        return train_unigram(texts, vocab_size)
    if token_type == "bpe":
        return train_bpe(texts, vocab_size)
    raise ValueError(f"unknown token_type {token_type!r}")
