"""The port's corpus preparation (`summarymixing_tpu_torch/recipes/prepare_data.py`)
against the JAX package's `recipes/prepare_data.py` on the fake corpus
trees of `tests/test_prepare_data.py` (LibriSpeech with FLAC, AISHELL-1,
CommonVoice and VoxPopuli): byte-identical CSVs, the same failures, the
same header-only durations and text normalisation, and the command line."""

import os

import numpy as np
import pytest

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from test_prepare_data import _write_flac, _write_wav  # puts the repository on sys.path

from recipes import prepare_data as jprep  # noqa: E402
from summarymixing_tpu_torch.recipes import prepare_data as tprep  # noqa: E402


def _librispeech(root, rng):
    for split, spk, chap, utts in [("train-clean-100", "19", "198", ["0000", "0001"]),
                                   ("train-clean-100", "26", "495", ["0000"]),
                                   ("dev-clean", "84", "121123", ["0000"])]:
        d = os.path.join(root, split, spk, chap)
        lines = []
        for u in utts:
            utt_id = f"{spk}-{chap}-{u}"
            _write_flac(os.path.join(d, utt_id + ".flac"), rng, n=1600 * (1 + int(u)))
            lines.append(f"{utt_id} HELLO WORLD {u}")
        with open(os.path.join(d, f"{spk}-{chap}.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return lambda prep, out: prep.prepare_librispeech(root, out, ["train-clean-100"],
                                                      ["dev-clean"])


def _aishell(root, rng):
    os.makedirs(os.path.join(root, "transcript"))
    with open(os.path.join(root, "transcript", "aishell_transcript_v0.8.txt"), "w",
              encoding="utf-8") as f:
        f.write("BAC009S0002W0122 你 好 世 界\nBAC009S0002W0123 语 音 识 别\n")
    for split, utt in [("train", "BAC009S0002W0122"), ("dev", "BAC009S0002W0123"),
                       ("test", "BAC009S0002W0124")]:
        _write_wav(os.path.join(root, "wav", split, "S0002", utt + ".wav"), rng)
    return lambda prep, out: prep.prepare_aishell(root, out)


def _commonvoice(root, rng):
    os.makedirs(os.path.join(root, "clips"))
    for split, stem, sent in [("train", "cv1", "Bonjour, le monde!"), ("dev", "cv2", "Ça va?"),
                              ("test", "cv3", "Très bien.")]:
        _write_wav(os.path.join(root, "clips", stem + ".wav"), rng)
        with open(os.path.join(root, f"{split}.tsv"), "w", encoding="utf-8") as f:
            f.write(f"client_id\tpath\tsentence\nspk_{stem}_0123456789ab\t{stem}.mp3\t{sent}\n")
    return lambda prep, out: prep.prepare_commonvoice(root, out)


def _voxpopuli(root, rng):
    lang = os.path.join(root, "transcribed_data", "en")
    utt = "20180101-0900-PLENARY-1-abc"
    _write_flac(os.path.join(lang, "2018", utt + ".flac"), rng)
    for split in ("train", "dev", "test"):
        with open(os.path.join(lang, f"asr_{split}.tsv"), "w", encoding="utf-8") as f:
            f.write(f"id\traw_text\tnormalized_text\tspeaker_id\n{utt}\tHello there\t"
                    "hello there\tspk9\n")
    return lambda prep, out: prep.prepare_voxpopuli(root, out, "en")


TREES = {"librispeech": _librispeech, "aishell": _aishell, "commonvoice": _commonvoice,
         "voxpopuli": _voxpopuli}


@pytest.mark.parametrize("dataset", sorted(TREES))
def test_manifests_equal_the_jax_runner(dataset, tmp_path):
    prepare = TREES[dataset](str(tmp_path / dataset), np.random.default_rng(7))
    prepare(jprep, str(tmp_path / "jax"))
    prepare(tprep, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_failures_durations_and_normalisation_match_the_jax_runner(tmp_path):
    rng = np.random.default_rng(7)
    root = str(tmp_path / "LS")
    d = os.path.join(root, "test-clean", "1", "2")
    _write_flac(os.path.join(d, "1-2-0000.flac"), rng)
    with open(os.path.join(d, "1-2.trans.txt"), "w") as f:
        f.write("1-2-9999 SOME OTHER UTT\n")
    for prep in (jprep, tprep):
        with pytest.raises(ValueError, match="no transcript"):
            prep.prepare_librispeech(root, str(tmp_path / "out"), [], ["test-clean"])
    cv = str(tmp_path / "cv")
    os.makedirs(os.path.join(cv, "clips"))
    for split in ("train", "dev", "test"):
        with open(os.path.join(cv, f"{split}.tsv"), "w") as f:
            f.write("client_id\tpath\tsentence\nc\tmissing.mp3\thello\n")
    for prep in (jprep, tprep):
        with pytest.raises(FileNotFoundError, match="no converted"):
            prep.prepare_commonvoice(cv, str(tmp_path / "out"))
    wav, flac = str(tmp_path / "a.wav"), str(tmp_path / "a.flac")
    _write_wav(wav, rng, n=8000)
    _write_flac(flac, rng, n=4000)
    for path in (wav, flac):
        assert tprep.audio_duration(path) == jprep.audio_duration(path)
    for text, strip in (("It's  fine, really!", True), ("a—b", False), ("Ça va?", True)):
        assert tprep.normalize_commonvoice_text(text, strip) == \
            jprep.normalize_commonvoice_text(text, strip)


def test_command_line_writes_the_manifests(tmp_path):
    prepare = _aishell(str(tmp_path / "aishell"), np.random.default_rng(7))
    prepare(jprep, str(tmp_path / "jax"))
    tprep.main(["aishell", "--root", str(tmp_path / "aishell"), "--out", str(tmp_path / "port")])
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
