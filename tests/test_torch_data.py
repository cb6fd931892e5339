"""The port's data pipeline and recipe reader against the JAX package and
PyYAML on the CPU: `config/yaml_lite.py` against `yaml.safe_load` on every
recipe and on the scalar forms whose typing differs between readers; the
manifest reader, WAV loading, bucket construction, the bucketed batch
order at a seed, token padding, the character tokenizer, the subword
trainer and the train logger against their JAX counterparts on a --hard
synthetic corpus written into a temporary directory. Everything here is
exact: the port's copies must give the same values, orders and ids."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.data import batching as jbatching
from summarymixing_tpu.data import dataio as jdataio
from summarymixing_tpu.data import subword as jsubword
from summarymixing_tpu.data import tokenizer as jtokenizer
from summarymixing_tpu.training import logger as jlogger
from summarymixing_tpu_torch.config import yaml_lite
from summarymixing_tpu_torch.data import batching, dataio, subword, tokenizer
from summarymixing_tpu_torch.training import checkpoint as tckpt
from summarymixing_tpu_torch.training import logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "recipes/*/*.yaml")))


def make_corpus(root, n=40, lm_text=0):
    """`recipes/make_synthetic_corpus.py --hard` into `root` (a subprocess:
    the script is not a module of either package)."""
    cmd = [sys.executable, os.path.join(REPO, "recipes", "make_synthetic_corpus.py"), str(root),
           "--hard", "--n", str(n), "--seed", "0", "--lm-text", str(lm_text)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    return {split: os.path.join(str(root), f"manifest_{split}.csv")
            for split in ("train", "dev", "test")}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def test_recipes_are_the_nine_the_repository_ships():
    assert len(RECIPES) == 9


@pytest.mark.parametrize("recipe", RECIPES)
def test_yaml_reader_equals_safe_load_on_recipe(recipe):
    with open(os.path.join(REPO, recipe)) as f:
        text = f.read()
    assert yaml_lite.load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("value", [
    "1.0e-9", "1e-9", "5.0e3", "-1.5e+3", "3.", ".5", "+.5", "0", "-0", "+7", "true", "No",
    "ON", "off", "~", "null", "", "abc def", "a#b", "gelu", "[8, 8]", "[0.9, 0.98]", "[]",
    "[95, 100, 105]", "'it''s'", '"x: y"', ".inf", "-.inf", "SummaryMixing-fast",
])
def test_yaml_reader_types_scalars_as_safe_load(value):
    """PyYAML's YAML 1.1 typing, quirks included: a float needs a dot, and
    an exponent needs its sign (`1e-9` and `5.0e3` stay strings)."""
    assert yaml_lite.parse_value(value) == yaml.safe_load(f"k: {value}")["k"]


@pytest.mark.parametrize("text", [
    "a: 017", "a: 0x1f", "a: 1_000", "a: 1:30", "a: 2001-12-14", "a: &x 1", "a: *x",
    "a: !!str 1", "a: |", "a: {b: 1}", "a:\n  - 1", "a: [1,\n 2]", "---\na: 1",
    "a:\n\tb: 1", "a: 1\na: 2", "a: 1\n  b: 2", "on: 1", "a: b: c", "a: [[1]]",
])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    """Syntax outside the subset, and plain scalars PyYAML types otherwise
    than this reader would (octal, hexadecimal, underscores, sexagesimal,
    timestamps, boolean keys), raise instead of being guessed."""
    with pytest.raises(yaml_lite.YamlLiteError):
        yaml_lite.load(text)


def test_manifest_and_wav_loading_match_jax(corpus):
    for split in ("train", "dev", "test"):
        mine, theirs = dataio.read_manifest_csv(corpus[split]), jdataio.read_manifest_csv(corpus[split])
        assert [vars(u) for u in mine] == [vars(u) for u in theirs]
    for u in dataio.read_manifest_csv(corpus["dev"]):
        got = dataio.load_wav(u.wav_path, 16000)
        np.testing.assert_array_equal(got, jdataio.load_wav(u.wav_path, 16000))
        assert got.dtype == np.float32 and abs(len(got) / 16000 - u.duration) < 1e-3
    with open(u.wav_path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(dataio.load_audio_bytes(data, 16000),
                                  jdataio.load_audio_bytes(data, 16000))
    # a WAV body behind the FLAC magic is malformed FLAC: the same
    # ValueError in both packages
    errors = []
    for load in (dataio.load_audio_bytes, jdataio.load_audio_bytes):
        with pytest.raises(ValueError) as exc:
            load(b"fLaC" + data[4:])
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_manifest_json_matches_jax(tmp_path):
    path = tmp_path / "m.json"
    path.write_text(json.dumps({"u1": {"wav": "a.wav", "duration": 1.5, "wrd": "hi there",
                                       "spk_id": "s"}, "u2": {"wav": "b.wav", "text": "x"}}))
    assert ([vars(u) for u in dataio.read_manifest_json(str(path))]
            == [vars(u) for u in jdataio.read_manifest_json(str(path))])


@pytest.mark.parametrize("quantize", [False, True])
def test_buckets_and_batch_order_match_jax(corpus, quantize):
    """Bucket bounds and sizes from the training manifest's lengths, then
    the batcher's (bucket, indices) sequence over two epochs with shuffling
    at a seed, and once without (evaluation: tails filled by repetition)."""
    lengths = [int(u.duration * 16000) for u in dataio.read_manifest_csv(corpus["train"])]
    kw = dict(max_batch_length=8.0 * 16000, num_buckets=4, min_len=min(lengths),
              max_len=max(lengths), max_batch_size=6, quantize=quantize)
    buckets = batching.make_buckets(**kw)
    assert [vars(b) for b in buckets] == [vars(b) for b in jbatching.make_buckets(**kw)]
    for shuffle in (True, False):
        mine = batching.DynamicBucketBatcher(lengths, buckets, shuffle=shuffle, seed=5,
                                             drop_last=shuffle)
        theirs = jbatching.DynamicBucketBatcher(lengths, jbatching.make_buckets(**kw),
                                                shuffle=shuffle, seed=5, drop_last=shuffle)
        assert mine.num_batches() == theirs.num_batches() > 0
        for _ in range(2):
            got = [(s.max_len, list(i)) for s, i in mine]
            assert got == [(s.max_len, list(i)) for s, i in theirs]
    assert batching.quantize_len(123457) == jbatching.quantize_len(123457)


def test_pad_batch_matches_jax(rng):
    arrays = [rng.integers(3, 40, n).astype(np.int32) for n in (5, 1, 9, 3)]
    for max_len in (9, 6):
        for got, want in zip(batching.pad_batch(arrays, max_len),
                             jbatching.pad_batch(arrays, max_len)):
            np.testing.assert_array_equal(got, want)


def test_prefetch_keeps_order_and_forwards_errors():
    assert list(batching.prefetch(iter(range(7)))) == list(range(7))

    def broken():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError):
        list(batching.prefetch(broken()))


def test_char_tokenizer_matches_jax(corpus):
    texts = [u.text for u in dataio.read_manifest_csv(corpus["train"])]
    mine, theirs = tokenizer.CharTokenizer.build(texts), jtokenizer.CharTokenizer.build(texts)
    assert mine.vocab == theirs.vocab and mine.vocab_size == theirs.vocab_size
    for t in texts + ["unseen QZ chars"]:
        assert mine.encode(t) == theirs.encode(t)
        assert mine.decode(mine.encode(t)) == theirs.decode(theirs.encode(t))
    assert tokenizer.load_tokenizer("char", vocab=mine.vocab).vocab == mine.vocab
    # a SentencePiece model is read since it was ported (test_torch_sentencepiece.py);
    # one that is not there raises
    with pytest.raises(FileNotFoundError):
        tokenizer.load_tokenizer("sentencepiece", model_path="no/such/tokenizer.model")


@pytest.mark.parametrize("token_type,vocab", [("unigram", 5000), ("bpe", 60)])
def test_subword_trainer_ids_match_jax(corpus, tmp_path, token_type, vocab):
    """The flagship's unigram at 5000 (the transcripts hold fewer pieces,
    so it stops below) and a small BPE: the same pieces, scores and ids,
    and the same ids after a save and load."""
    texts = [u.text for u in dataio.read_manifest_csv(corpus["train"])]
    mine = subword.train_subword(texts, vocab, token_type)
    theirs = jsubword.train_subword(texts, vocab, token_type)
    assert mine.pieces == theirs.pieces and mine.vocab_size <= vocab
    mine.save(str(tmp_path / "tok.json"))
    loaded = subword.SubwordTokenizer.load(str(tmp_path / "tok.json"))
    for t in texts:
        assert mine.encode(t) == theirs.encode(t) == loaded.encode(t)
        assert mine.decode(mine.encode(t)) == theirs.decode(theirs.encode(t)) == t


def test_train_logger_writes_what_jax_writes(tmp_path):
    stats = ({"epoch": 3, "steps": 33, "epoch_s": 1.5}, {"loss": 1.23456789},
             {"loss": 0.5, "WER": 12.345}, None)
    for mod, name in ((logger, "torch"), (jlogger, "jax")):
        mod.FileTrainLogger(str(tmp_path / name / "train_log.txt")).log_stats(*stats)
    assert ((tmp_path / "torch" / "train_log.txt").read_text()
            == (tmp_path / "jax" / "train_log.txt").read_text())
    mine = json.loads((tmp_path / "torch" / "train_log.jsonl").read_text())
    theirs = json.loads((tmp_path / "jax" / "train_log.jsonl").read_text())
    mine.pop("ts"), theirs.pop("ts")
    assert mine == theirs
    assert list(logger.EpochCounter(5, start=3)) == list(jlogger.EpochCounter(5, start=3)) == [4, 5]


def test_checkpoint_interval_gates_saves(tmp_path):
    """`should_save` is True without an interval; with one, only once that
    many minutes have passed since the last save (or since the manager was
    made)."""
    assert tckpt.CheckpointManager(str(tmp_path / "a")).should_save()
    mgr = tckpt.CheckpointManager(str(tmp_path / "b"), interval_minutes=1.0)
    assert not mgr.should_save()
    mgr._last_save -= 61.0
    assert mgr.should_save()
    mgr.save(1, {"step": 1})
    assert not mgr.should_save() and mgr.all_steps() == [1]
