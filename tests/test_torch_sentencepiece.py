"""The port's SentencePiece `.model` reader (`data/sentencepiece_model.py`)
against the JAX package's on the same model bytes: the cases of
`tests/test_sentencepiece_model.py` (round trip, file-order ids and
specials, Viterbi, the unknown character, byte fallback, unknown proto
fields, the precompiled charsmap, the normalizer spec, a trained unigram
table), each held to identical pieces, ids and text; the serializer and the
charsmap builder to identical bytes; and a run directory holding
`tokenizer.model` read by the runners."""

import os
import random
import struct

import numpy as np
import pytest

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.data import sentencepiece_model as jspm
from summarymixing_tpu.data.subword import train_subword
from summarymixing_tpu_torch.config import load_recipe
from summarymixing_tpu_torch.data import sentencepiece_model as tspm
from summarymixing_tpu_torch.data.tokenizer import SentencePieceTokenizer, load_tokenizer
from summarymixing_tpu_torch.recipes import common, evaluate

FLAGSHIP = os.path.join(os.path.dirname(__file__), "..", "recipes", "LibriSpeech",
                        "branchformer_summarymixing.yaml")

NORMAL, UNKNOWN, CONTROL, BYTE = jspm.NORMAL, jspm.UNKNOWN, jspm.CONTROL, jspm.BYTE


def _std(extra=()):
    return [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)] + list(extra)


def _trained_table():
    rng = np.random.default_rng(0)
    words = ["ba", "do", "ki", "lu", "me", "ta", "bado", "kilu", "meta"]
    texts = [" ".join(rng.choice(words, size=rng.integers(2, 6))) for _ in range(120)]
    tok = train_subword(texts, 40, "unigram")
    return jspm.serialize_model_proto(_std([(p, lp, NORMAL) for p, lp in tok.pieces.items()])), \
        texts[:30]


def _case(name):
    """(model bytes, texts to encode)."""
    if name == "round_trip":
        return jspm.serialize_model_proto(_std([("▁ab", -1.5, NORMAL), ("▁a", -2.0, NORMAL),
                                                ("b", -2.5, NORMAL), ("<0x41>", -10.0, BYTE)])), \
            ["ab", "a b ab"]
    if name == "specials":
        return jspm.serialize_model_proto(_std([("▁x", -1.0, NORMAL)])), ["x", "x x"]
    if name == "viterbi":
        return jspm.serialize_model_proto(_std([("▁ab", -9.0, NORMAL), ("▁a", -2.0, NORMAL),
                                                ("b", -2.5, NORMAL)])), ["ab", "ab a"]
    if name == "unknown_char":
        return jspm.serialize_model_proto(_std([("▁a", -1.0, NORMAL)])), ["aq", "q"]
    if name == "byte_fallback":
        byte_pieces = [(f"<0x{b:02X}>", -20.0, BYTE) for b in range(256)]
        return jspm.serialize_model_proto(_std([("▁a", -1.0, NORMAL)] + byte_pieces)), \
            ["aé", "é a", "a"]
    if name == "unknown_fields":
        data = jspm.serialize_model_proto(_std([("▁hi", -1.0, NORMAL)]))
        blob = b"\x08\x01"
        data += b"\x12" + bytes([len(blob)]) + blob
        data += bytes([7 << 3 | 5]) + struct.pack("<f", 1.0) + bytes([8 << 3 | 0, 42])
        return data, ["hi", "hi hi"]
    if name == "normalizer_spec":
        blob = jspm.build_precompiled_charsmap({"ﬁ": "fi", "Ａ": "a"})
        return jspm.serialize_model_proto(
            _std([("▁fin", -1.0, NORMAL), ("▁a", -1.5, NORMAL), ("b", -2.0, NORMAL)]),
            precompiled_charsmap=blob), ["ﬁn", "fin", "Ａb", "ab fin"]
    return _trained_table()


CASES = ["round_trip", "specials", "viterbi", "unknown_char", "byte_fallback",
         "unknown_fields", "normalizer_spec", "trained_unigram"]


@pytest.mark.parametrize("name", CASES)
def test_reader_matches_jax_on_the_same_bytes(name, tmp_path):
    data, texts = _case(name)
    assert tspm.parse_model_proto(data) == jspm.parse_model_proto(data)
    assert tspm.parse_model_proto_full(data) == jspm.parse_model_proto_full(data)
    path = tmp_path / "m.model"
    path.write_bytes(data)
    mine, theirs = tspm.SentencePieceModel.load(str(path)), jspm.SentencePieceModel.load(str(path))
    assert (mine.vocab_size, mine.unk_id, mine.bos_id, mine.eos_id) == \
        (theirs.vocab_size, theirs.unk_id, theirs.bos_id, theirs.eos_id)
    for text in texts:
        ids = mine.encode(text)
        assert ids == theirs.encode(text), text
        assert mine.decode(ids) == theirs.decode(ids), text
        assert mine.normalize(text) == theirs.normalize(text), text


def test_serializer_and_charsmap_builder_give_the_jax_bytes():
    pieces = _std([("▁fin", -1.0, NORMAL), ("<0x41>", -10.0, BYTE)])
    rng = random.Random(7)
    rules = {"".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 3))): "X"
             for _ in range(60)}
    rules.update({"ﬁ": "fi", "Ａ": "A", " ": " "})
    blob = tspm.build_precompiled_charsmap(rules)
    assert blob == jspm.build_precompiled_charsmap(rules)
    assert tspm.serialize_model_proto(pieces, precompiled_charsmap=blob) == \
        jspm.serialize_model_proto(pieces, precompiled_charsmap=blob)
    mine, theirs = tspm.Charsmap(blob), jspm.Charsmap(blob)
    for _ in range(40):
        s = "".join(rng.choice("abcdefghxyz ﬁＡ ") for _ in range(rng.randint(0, 20)))
        assert mine.normalize(s) == theirs.normalize(s), s


def test_run_directory_with_tokenizer_model_is_read(tmp_path):
    """`tokenizer.model` in a run directory: `resolve_tokenizer` (the
    evaluate, transcribe, serve and export runners) and
    `build_or_load_tokenizer` (train) read it, with the file's ids."""
    data = jspm.serialize_model_proto(_std([("▁ba", -1.0, NORMAL), ("▁do", -1.2, NORMAL)]))
    (tmp_path / "tokenizer.model").write_bytes(data)
    cfg = load_recipe(FLAGSHIP)
    for tok in (evaluate.resolve_tokenizer(cfg, evaluate.run_dir_of(str(tmp_path / "save"))),
                common.build_or_load_tokenizer(cfg, str(tmp_path), []),
                load_tokenizer("sentencepiece", model_path=str(tmp_path / "tokenizer.model"))):
        assert isinstance(tok, SentencePieceTokenizer) and tok.vocab_size == 5
        assert tok.encode("ba do") == [3, 4] and tok.decode([3, 4]) == "ba do"
