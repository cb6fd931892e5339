"""Corpus preparation: raw dataset trees -> manifest CSVs — the port's copy
of the JAX package's `recipes/prepare_data.py` (no JAX; FLAC durations
from the port's `data/flac.py::read_streaminfo`).

It scans a corpus tree and writes CSVs with the columns the data pipeline
reads (`ID, duration, wav, spk_id, wrd`: `data/dataio.py`), as
SpeechBrain's per-dataset `*_prepare.py` scripts do for the reference
recipes.

Datasets:
  librispeech   <root>/<split>/<spk>/<chap>/*.flac + *.trans.txt
                (durations from STREAMINFO: the scan never decodes audio)
  aishell       <root>/wav/{train,dev,test}/**/<id>.wav +
                <root>/transcript/aishell_transcript_v0.8.txt
  commonvoice   <root>/{train,dev,test}.tsv + <root>/clips/
  voxpopuli     <root>/transcribed_data/<lang>/asr_{split}.tsv

CommonVoice and VoxPopuli distribute mp3/ogg, which the port does not
decode: convert their audio to 16 kHz WAV or FLAC next to the originals
(same stem); the scan resolves the converted file and fails with a count
if any are missing.

Usage:
  python -m summarymixing_tpu_torch.recipes.prepare_data librispeech --root /data/LibriSpeech \\
      --out data/manifests --train-splits train-clean-100 train-clean-360 \\
      --eval-splits dev-clean test-clean test-other
"""

from __future__ import annotations

import argparse
import csv
import os
import unicodedata
import wave
from typing import Dict, Iterable, List, Optional, Tuple

from summarymixing_tpu_torch.data.flac import read_streaminfo

CSV_FIELDS = ["ID", "duration", "wav", "spk_id", "wrd"]
AUDIO_EXTS = (".flac", ".wav")


def audio_duration(path: str) -> float:
    """Header-only duration read (no audio decode)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        return read_streaminfo(path).duration
    with wave.open(path, "rb") as w:
        return w.getnframes() / w.getframerate()


def write_manifest(path: str, rows: Iterable[Dict[str, object]]) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = 0
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        writer.writeheader()
        for row in rows:
            writer.writerow(row)
            n += 1
    return n


def _resolve_audio(base_no_ext: str) -> Optional[str]:
    for ext in AUDIO_EXTS:
        cand = base_no_ext + ext
        if os.path.exists(cand):
            return cand
    return None


# ---------------------------------------------------------------------------
# LibriSpeech


def scan_librispeech_split(root: str, split: str) -> List[Dict[str, object]]:
    """One split directory -> manifest rows (sorted by utterance ID)."""
    split_dir = os.path.join(root, split)
    if not os.path.isdir(split_dir):
        raise FileNotFoundError(f"missing LibriSpeech split dir: {split_dir}")
    rows = []
    for dirpath, _dirnames, filenames in sorted(os.walk(split_dir)):
        trans = [f for f in filenames if f.endswith(".trans.txt")]
        if not trans:
            continue
        text: Dict[str, str] = {}
        for t in trans:
            with open(os.path.join(dirpath, t)) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    utt_id, _, words = line.partition(" ")
                    text[utt_id] = words.strip()
        for fname in sorted(filenames):
            stem, ext = os.path.splitext(fname)
            if ext.lower() not in AUDIO_EXTS:
                continue
            if stem not in text:
                raise ValueError(
                    f"{dirpath}/{fname}: no transcript line in {trans}")
            path = os.path.join(dirpath, fname)
            spk = stem.split("-")[0]
            rows.append(dict(ID=stem, duration=round(audio_duration(path), 4),
                             wav=path, spk_id=spk, wrd=text[stem]))
    if not rows:
        raise ValueError(f"no utterances found under {split_dir}")
    return rows


def prepare_librispeech(root: str, out_dir: str,
                        train_splits: List[str],
                        eval_splits: List[str]) -> None:
    if train_splits:
        rows: List[Dict[str, object]] = []
        for split in train_splits:
            rows.extend(scan_librispeech_split(root, split))
        n = write_manifest(os.path.join(out_dir, "train.csv"), rows)
        print(f"train.csv: {n} utterances from {train_splits}")
    for split in eval_splits:
        rows = scan_librispeech_split(root, split)
        n = write_manifest(os.path.join(out_dir, f"{split}.csv"), rows)
        print(f"{split}.csv: {n} utterances")


# ---------------------------------------------------------------------------
# AISHELL-1


def prepare_aishell(root: str, out_dir: str) -> None:
    trans_path = os.path.join(root, "transcript",
                              "aishell_transcript_v0.8.txt")
    if not os.path.exists(trans_path):
        raise FileNotFoundError(trans_path)
    text: Dict[str, str] = {}
    with open(trans_path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            utt_id, _, words = line.partition(" ")
            text[utt_id] = " ".join(words.split())
    skipped = 0
    for split in ("train", "dev", "test"):
        split_dir = os.path.join(root, "wav", split)
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(split_dir)
        rows = []
        for dirpath, _d, filenames in sorted(os.walk(split_dir)):
            for fname in sorted(filenames):
                stem, ext = os.path.splitext(fname)
                if ext.lower() not in AUDIO_EXTS:
                    continue
                if stem not in text:
                    skipped += 1  # corpus ships some untranscribed wavs
                    continue
                path = os.path.join(dirpath, fname)
                spk = os.path.basename(dirpath)
                rows.append(dict(
                    ID=stem, duration=round(audio_duration(path), 4),
                    wav=path, spk_id=spk, wrd=text[stem]))
        n = write_manifest(os.path.join(out_dir, f"{split}.csv"), rows)
        print(f"{split}.csv: {n} utterances")
    if skipped:
        print(f"skipped {skipped} wavs without transcript "
              "(expected for AISHELL-1)")


# ---------------------------------------------------------------------------
# CommonVoice


def normalize_commonvoice_text(text: str, strip_punct: bool = True) -> str:
    text = unicodedata.normalize("NFC", text)
    if strip_punct:
        text = "".join(
            c for c in text
            if not unicodedata.category(c).startswith("P") or c == "'")
    return " ".join(text.upper().split())


def prepare_commonvoice(root: str, out_dir: str,
                        strip_punct: bool = True) -> None:
    for split in ("train", "dev", "test"):
        tsv = os.path.join(root, f"{split}.tsv")
        if not os.path.exists(tsv):
            raise FileNotFoundError(tsv)
        rows, missing = [], 0
        with open(tsv, encoding="utf-8") as f:
            reader = csv.DictReader(f, delimiter="\t")
            for rec in reader:
                rel = rec.get("path", "")
                stem = os.path.splitext(os.path.basename(rel))[0]
                audio = _resolve_audio(os.path.join(root, "clips", stem))
                if audio is None:
                    missing += 1
                    continue
                wrd = normalize_commonvoice_text(
                    rec.get("sentence", ""), strip_punct)
                if not wrd:
                    continue
                rows.append(dict(
                    ID=stem, duration=round(audio_duration(audio), 4),
                    wav=audio, spk_id=rec.get("client_id", "")[:16],
                    wrd=wrd))
        if missing:
            raise FileNotFoundError(
                f"{split}: {missing} clips have no converted wav/flac next "
                f"to the mp3 (convert to 16 kHz first; see module docstring)")
        n = write_manifest(os.path.join(out_dir, f"{split}.csv"), rows)
        print(f"{split}.csv: {n} utterances")


# ---------------------------------------------------------------------------
# VoxPopuli


def prepare_voxpopuli(root: str, out_dir: str, lang: str = "en") -> None:
    lang_dir = os.path.join(root, "transcribed_data", lang)
    if not os.path.isdir(lang_dir):
        raise FileNotFoundError(lang_dir)
    for split in ("train", "dev", "test"):
        tsv = os.path.join(lang_dir, f"asr_{split}.tsv")
        if not os.path.exists(tsv):
            raise FileNotFoundError(tsv)
        rows, missing = [], 0
        with open(tsv, encoding="utf-8") as f:
            reader = csv.DictReader(f, delimiter="\t")
            for rec in reader:
                utt_id = rec.get("id") or rec.get("id_", "")
                # audio lives under <lang>/<year>/<id>.ogg; converted
                # wav/flac expected at the same stem
                year = utt_id[:4]
                audio = _resolve_audio(os.path.join(lang_dir, year, utt_id))
                if audio is None:
                    missing += 1
                    continue
                wrd = (rec.get("normalized_text")
                       or rec.get("raw_text", "")).strip().upper()
                if not wrd:
                    continue
                rows.append(dict(
                    ID=utt_id, duration=round(audio_duration(audio), 4),
                    wav=audio, spk_id=rec.get("speaker_id", ""), wrd=wrd))
        if missing:
            raise FileNotFoundError(
                f"{split}: {missing} segments have no converted wav/flac "
                f"(convert the oggs to 16 kHz first; see module docstring)")
        n = write_manifest(os.path.join(out_dir, f"{split}.csv"), rows)
        print(f"{split}.csv: {n} utterances")


# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="dataset", required=True)

    p = sub.add_parser("librispeech")
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--train-splits", nargs="*", default=[
        "train-clean-100", "train-clean-360", "train-other-500"])
    p.add_argument("--eval-splits", nargs="*", default=[
        "dev-clean", "dev-other", "test-clean", "test-other"])

    p = sub.add_parser("aishell")
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)

    p = sub.add_parser("commonvoice")
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--keep-punct", action="store_true")

    p = sub.add_parser("voxpopuli")
    p.add_argument("--root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--lang", default="en")

    args = parser.parse_args(argv)
    if args.dataset == "librispeech":
        prepare_librispeech(args.root, args.out, args.train_splits,
                            args.eval_splits)
    elif args.dataset == "aishell":
        prepare_aishell(args.root, args.out)
    elif args.dataset == "commonvoice":
        prepare_commonvoice(args.root, args.out,
                            strip_punct=not args.keep_punct)
    elif args.dataset == "voxpopuli":
        prepare_voxpopuli(args.root, args.out, args.lang)


if __name__ == "__main__":
    main()
