"""Pure-Python reader for SentencePiece ``.model`` files (ModelProto) — the
port's copy of `summarymixing_tpu/data/sentencepiece_model.py` (numpy-free,
no JAX), so a published tokenizer (the reference Pretrainer's
`tokenizer.ckpt`, a SentencePiece ``.model`` protobuf) loads with no
native dependency: neither machine has the `sentencepiece` wheel.

Wire format (protobuf), from the public sentencepiece_model.proto:

    ModelProto:     repeated SentencePiece pieces = 1;
                    TrainerSpec trainer_spec = 2;      (skipped)
                    NormalizerSpec normalizer_spec = 3
    SentencePiece:  string piece = 1; float score = 2; Type type = 3
    Type enum:      NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4
                    UNUSED=5 BYTE=6
    NormalizerSpec: string name = 1; bytes precompiled_charsmap = 2;
                    bool add_dummy_prefix = 3;
                    bool remove_extra_whitespaces = 4;
                    bool escape_whitespaces = 5 (others skipped)

Encoding reproduces sentencepiece's unigram Viterbi under the defaults
the ASR recipes train with (``add_dummy_prefix`` + ``split_by_whitespace``:
whitespace-split words, each prefixed with U+2581): best-scoring
segmentation per word; characters outside the vocabulary fall back to
BYTE pieces when the model has them (``byte_fallback``) and to the UNK
piece otherwise, scored ``min_score - 10`` (sentencepiece's unknown
penalty). Ids follow the file's order.

Normalisation: the NormalizerSpec's ``precompiled_charsmap`` (the
NFKC/NMT-NFKC rule table compiled into a darts-clone double-array trie
+ replacement-string pool) is applied before segmentation, by a
longest-prefix-match pass over the UTF-8 bytes (:class:`Charsmap`). An
empty charsmap (the in-repo trainer's output) skips the pass.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

_WORD_MARK = "▁"  # ▁

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ------------------------------------------------------------------ wire --


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 63:
            raise ValueError("malformed varint")


def _skip_field(wire: int, buf: bytes, pos: int) -> int:
    if wire == 0:                      # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == 1:                      # 64-bit
        return pos + 8
    if wire == 2:                      # length-delimited
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire == 5:                      # 32-bit
        return pos + 4
    raise ValueError(f"unsupported protobuf wire type {wire}")


def _parse_sentence_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, ptype = "", 0.0, NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:       # piece
            n, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:     # score (float32)
            score = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif field == 3 and wire == 0:     # type
            ptype, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(wire, buf, pos)
    return piece, score, ptype


def _parse_normalizer_spec(buf: bytes) -> Dict[str, object]:
    spec: Dict[str, object] = {
        "name": "", "precompiled_charsmap": b"",
        "add_dummy_prefix": True, "remove_extra_whitespaces": True,
        "escape_whitespaces": True,
    }
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:       # name
            n, pos = _read_varint(buf, pos)
            spec["name"] = buf[pos:pos + n].decode("utf-8", "replace")
            pos += n
        elif field == 2 and wire == 2:     # precompiled_charsmap
            n, pos = _read_varint(buf, pos)
            spec["precompiled_charsmap"] = buf[pos:pos + n]
            pos += n
        elif field == 3 and wire == 0:
            v, pos = _read_varint(buf, pos)
            spec["add_dummy_prefix"] = bool(v)
        elif field == 4 and wire == 0:
            v, pos = _read_varint(buf, pos)
            spec["remove_extra_whitespaces"] = bool(v)
        elif field == 5 and wire == 0:
            v, pos = _read_varint(buf, pos)
            spec["escape_whitespaces"] = bool(v)
        else:
            pos = _skip_field(wire, buf, pos)
    return spec


def parse_model_proto(data: bytes) -> List[Tuple[str, float, int]]:
    """Decode a serialized ModelProto into [(piece, score, type)] in file
    order — file order IS the sentencepiece id layout."""
    pieces, _ = parse_model_proto_full(data)
    return pieces


def parse_model_proto_full(
    data: bytes,
) -> Tuple[List[Tuple[str, float, int]], Dict[str, object]]:
    """Like :func:`parse_model_proto` but also returns the
    NormalizerSpec (field 3) as a dict — notably
    ``precompiled_charsmap``, the compiled normalisation table the
    published tokenizers carry."""
    pieces: List[Tuple[str, float, int]] = []
    spec: Dict[str, object] = {}
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:       # repeated SentencePiece
            n, pos = _read_varint(data, pos)
            pieces.append(_parse_sentence_piece(data[pos:pos + n]))
            pos += n
        elif field == 3 and wire == 2:     # NormalizerSpec
            n, pos = _read_varint(data, pos)
            spec = _parse_normalizer_spec(data[pos:pos + n])
            pos += n
        else:
            pos = _skip_field(wire, data, pos)
    if not pieces:
        raise ValueError("no pieces found: not a sentencepiece ModelProto?")
    return pieces, spec


# ------------------------------------------------------------- charsmap --


class Charsmap:
    """Longest-prefix-match normaliser over a sentencepiece
    ``precompiled_charsmap`` blob.

    Blob layout (sentencepiece normalizer.cc::DecodePrecompiledCharsMap):
    ``uint32-LE trie_size | trie (darts-clone double-array, uint32-LE
    units) | normalized pool (\\0-separated replacement strings)``.
    Keys are UTF-8 byte sequences; a match's value is a byte offset into
    the pool. darts-clone unit decoding (XOR double-array):
    ``offset(u) = (u >> 10) << ((u & 0x200) >> 6)``,
    ``label(u) = u & 0x800000FF``, ``has_leaf(u) = (u >> 8) & 1``,
    ``value(u) = u & 0x7FFFFFFF``; child(pos, c) = pos ^ offset ^ c."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("charsmap blob too short")
        (trie_size,) = struct.unpack("<I", blob[:4])
        if 4 + trie_size > len(blob) or trie_size % 4:
            raise ValueError("malformed charsmap blob")
        self._units = struct.unpack(f"<{trie_size // 4}I",
                                    blob[4:4 + trie_size])
        self._pool = blob[4 + trie_size:]

    @staticmethod
    def _offset(u: int) -> int:
        return (u >> 10) << ((u & 0x200) >> 6)

    def _longest_match(self, data: bytes, start: int):
        """Longest key matching a prefix of data[start:]; returns
        (replacement bytes, matched length) or None."""
        units = self._units
        pos = 0
        unit = units[pos]
        pos ^= self._offset(unit)
        best = None
        for i in range(start, len(data)):
            c = data[i]
            nxt = pos ^ c
            if nxt >= len(units):
                break
            unit = units[nxt]
            if (unit & 0x800000FF) != c:
                break
            pos = nxt ^ self._offset(unit)
            if (unit >> 8) & 1:            # has_leaf: value unit at base
                v = units[pos] & 0x7FFFFFFF
                end = self._pool.index(b"\0", v)
                best = (self._pool[v:end], i - start + 1)
        return best

    def normalize(self, text: str) -> str:
        """Apply the charsmap by greedy longest match over the UTF-8
        bytes (sentencepiece NormalizePrefix semantics); unmatched
        characters pass through unchanged."""
        data = text.encode("utf-8")
        out: List[bytes] = []
        i, n = 0, len(data)
        while i < n:
            m = self._longest_match(data, i)
            if m is not None:
                out.append(m[0])
                i += m[1]
            else:
                # copy one UTF-8 character unchanged
                b0 = data[i]
                ln = (1 if b0 < 0x80 else 2 if b0 < 0xE0 else
                      3 if b0 < 0xF0 else 4)
                out.append(data[i:i + ln])
                i += ln
        return b"".join(out).decode("utf-8", errors="replace")


# ------------------------------------------------------------- tokenizer --


@dataclass(frozen=True)
class _Piece:
    piece: str
    score: float
    type: int


class SentencePieceModel:
    """Viterbi encoder/decoder over a parsed ModelProto, id-compatible
    with the sentencepiece runtime (ids = piece file order)."""

    def __init__(
        self,
        pieces: Sequence[Tuple[str, float, int]],
        normalizer_spec: Dict[str, object] | None = None,
    ):
        self.pieces = [_Piece(*p) for p in pieces]
        self.normalizer_spec = dict(normalizer_spec or {})
        blob = self.normalizer_spec.get("precompiled_charsmap") or b""
        self._charsmap = Charsmap(blob) if blob else None
        self._scores: Dict[str, float] = {}
        self._id_of: Dict[str, int] = {}
        self._byte_of: Dict[int, int] = {}   # byte value -> piece id
        self.unk_id = 0
        self.bos_id = self.eos_id = -1
        controls = []
        for i, p in enumerate(self.pieces):
            if p.type in (NORMAL, USER_DEFINED):
                # first occurrence wins on duplicates (sentencepiece
                # forbids them anyway)
                self._scores.setdefault(p.piece, p.score)
                self._id_of.setdefault(p.piece, i)
            elif p.type == UNKNOWN:
                self.unk_id = i
            elif p.type == CONTROL:
                controls.append((p.piece, i))
            elif p.type == BYTE:
                # "<0xNN>"
                self._byte_of[int(p.piece[1:-1], 16)] = i
        for name, i in controls:
            if name in ("<s>", "<bos>"):
                self.bos_id = i
            elif name in ("</s>", "<eos>"):
                self.eos_id = i
        self.max_piece_len = max(
            (len(p) for p in self._scores), default=1)
        self._min_score = min(
            (s for s in self._scores.values()), default=0.0)
        self._unk_score = self._min_score - 10.0   # kUnkPenalty

    # -- construction ------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            pieces, spec = parse_model_proto_full(f.read())
        return cls(pieces, normalizer_spec=spec)

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    # -- encode ------------------------------------------------------------
    def _encode_word(self, word: str) -> List[int]:
        """Best-scoring segmentation (Viterbi over piece scores); unknown
        characters become byte pieces (byte_fallback models) or UNK."""
        n = len(word)
        neg = -1e30
        best = [neg] * (n + 1)
        back: List[Tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(1, n + 1):
            for j in range(max(0, i - self.max_piece_len), i):
                sub = word[j:i]
                s = self._scores.get(sub)
                if s is None:
                    if i - j > 1:
                        continue
                    s = self._unk_score          # single unknown char
                    pid = -1
                else:
                    pid = self._id_of[sub]
                v = best[j] + s
                if v > best[i]:
                    best[i] = v
                    back[i] = (j, pid)
        ids: List[int] = []
        i = n
        while i > 0:
            j, pid = back[i]
            if pid >= 0:
                ids.append(pid)
            elif self._byte_of:
                ids.extend(self._byte_of.get(b, self.unk_id)
                           for b in reversed(word[j:i].encode("utf-8")))
            else:
                ids.append(self.unk_id)
            i = j
        return ids[::-1]

    def normalize(self, text: str) -> str:
        """NormalizerSpec charsmap normalisation (identity when the
        model carries no precompiled_charsmap — e.g. the in-repo
        trainer's exports or identity-normalisation models)."""
        return self._charsmap.normalize(text) if self._charsmap else text

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for w in self.normalize(text).split():
            out.extend(self._encode_word(_WORD_MARK + w))
        return out

    # -- decode ------------------------------------------------------------
    def decode(self, ids: Sequence[int]) -> str:
        chunks: List[str] = []
        byte_buf = bytearray()
        for i in ids:
            i = int(i)
            if not 0 <= i < len(self.pieces):
                continue
            p = self.pieces[i]
            if p.type == BYTE:
                byte_buf.append(int(p.piece[1:-1], 16))
                continue
            if byte_buf:
                chunks.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()
            if p.type in (NORMAL, USER_DEFINED):
                chunks.append(p.piece)
            elif p.type == UNKNOWN:
                chunks.append(" ⁇ ")        # sentencepiece unk_surface
        if byte_buf:
            chunks.append(byte_buf.decode("utf-8", errors="replace"))
        return "".join(chunks).replace(_WORD_MARK, " ").strip()


# ------------------------------------------------------------ serializer --


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def serialize_model_proto(
    pieces: Sequence[Tuple[str, float, int]],
    precompiled_charsmap: bytes = b"",
) -> bytes:
    """Inverse of parse_model_proto (round-trip tests; also lets the
    in-repo subword trainer EXPORT a wheel-compatible .model file).
    A non-empty ``precompiled_charsmap`` is written as NormalizerSpec
    (field 3) with the recipe-default flags."""
    out = bytearray()
    for piece, score, ptype in pieces:
        body = bytearray()
        raw = piece.encode("utf-8")
        body += _varint((1 << 3) | 2) + _varint(len(raw)) + raw
        body += _varint((2 << 3) | 5) + struct.pack("<f", score)
        body += _varint((3 << 3) | 0) + _varint(ptype)
        out += _varint((1 << 3) | 2) + _varint(len(body)) + bytes(body)
    if precompiled_charsmap:
        spec = bytearray()
        name = b"nmt_nfkc"
        spec += _varint((1 << 3) | 2) + _varint(len(name)) + name
        spec += (_varint((2 << 3) | 2)
                 + _varint(len(precompiled_charsmap)) + precompiled_charsmap)
        for field in (3, 4, 5):            # recipe-default true flags
            spec += _varint((field << 3) | 0) + _varint(1)
        out += _varint((3 << 3) | 2) + _varint(len(spec)) + bytes(spec)
    return bytes(out)


def build_precompiled_charsmap(rules: Dict[str, str]) -> bytes:
    """Compile {source: replacement} rules into the sentencepiece
    precompiled_charsmap blob format (darts-clone double-array trie +
    \\0-separated replacement pool) — the exact structure
    :class:`Charsmap` reads. Used to synthesise non-identity
    normalisation tables in tests and to export in-repo-trained models
    with explicit rule tables."""
    if any(not k for k in rules):
        raise ValueError("empty charsmap key")
    pool = bytearray()
    offsets: Dict[str, int] = {}
    for k in sorted(rules):
        offsets[k] = len(pool)
        pool += rules[k].encode("utf-8") + b"\0"

    VALUE = object()                       # terminal marker in the trie
    root: Dict[object, object] = {}
    for k in rules:
        node = root
        for b in k.encode("utf-8"):
            node = node.setdefault(b, {})  # type: ignore[assignment]
        node[VALUE] = offsets[k]

    units: List[int] = [0] * 64
    taken: List[bool] = [False] * 64
    taken[0] = True

    def _grow(n: int) -> None:
        while n >= len(units):
            units.extend([0] * len(units))
            taken.extend([False] * len(taken))

    # BFS: pick each node's child base so every child slot (label byte,
    # plus slot base^0 for a value) is free; XOR layout means
    # child_pos = base ^ label and the stored offset = node_pos ^ base.
    from collections import deque

    # label-as-check double arrays need every node's base to be UNIQUE:
    # two nodes sharing a base would accept each other's transitions
    # whenever the labels coincide (darts-clone's builder enforces the
    # same invariant via its is_used offset flags)
    bases_used = set()
    queue = deque([(0, root)])
    while queue:
        pos, node = queue.popleft()
        labels = sorted(b for b in node if b is not VALUE)
        has_value = VALUE in node
        slots = ([0] if has_value else []) + labels
        base = 1
        while True:
            _grow(base + 256)
            if base not in bases_used and all(
                    not taken[base ^ c] for c in slots):
                break
            base += 1
        bases_used.add(base)
        for c in slots:
            taken[base ^ c] = True
        offset = pos ^ base
        if offset >= (1 << 21):
            raise ValueError("charsmap trie too large for direct offsets")
        units[pos] |= (offset << 10) | ((1 if has_value else 0) << 8)
        if has_value:
            units[base] = 0x80000000 | int(node[VALUE])  # type: ignore
        for c in labels:
            units[base ^ c] = c            # offset/has_leaf filled later
            queue.append((base ^ c, node[c]))

    # trim to the last used slot
    n_units = max(i for i, t in enumerate(taken) if t) + 1
    trie = struct.pack(f"<{n_units}I", *units[:n_units])
    return struct.pack("<I", len(trie)) + trie + bytes(pool)
