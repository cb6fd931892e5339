"""Dataset IO — the port's copy of `summarymixing_tpu/data/dataio.py`:
SpeechBrain-style CSV/JSON manifests (columns ID, duration, wav, spk_id,
wrd) and audio loading on the host (16-bit and 32-bit PCM WAV through the
standard library, other WAV through scipy). FLAC input raises: the JAX
package's pure-Python FLAC codec (`data/flac.py`) is still to port
(ROADMAP.md, queue 1 item 9)."""

from __future__ import annotations

import csv
import json
import struct
import wave
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

# exception types the stdlib wave / struct decoders leak for truncated or
# corrupt input; callers are promised plain ValueError
_DECODE_ERRORS = (EOFError, IndexError, KeyError, struct.error)
_FLAC_TODO = "FLAC decoding (data/flac.py) is not ported; see ROADMAP.md queue 1 item 9"


@dataclass
class Utterance:
    utt_id: str
    wav_path: str
    duration: float
    text: str
    speaker: str = ""


def read_manifest_csv(path: str) -> List[Utterance]:
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out.append(Utterance(
                utt_id=row.get("ID") or row.get("id", ""),
                wav_path=row.get("wav", ""),
                duration=float(row.get("duration", 0.0) or 0.0),
                text=row.get("wrd") or row.get("words", "") or row.get("text", ""),
                speaker=row.get("spk_id", ""),
            ))
    return out


def read_manifest_json(path: str) -> List[Utterance]:
    with open(path) as f:
        data = json.load(f)
    out = []
    for utt_id, entry in data.items():
        out.append(Utterance(
            utt_id=utt_id,
            wav_path=entry.get("wav", ""),
            duration=float(entry.get("duration", 0.0)),
            text=entry.get("wrd") or entry.get("words", "") or entry.get("text", ""),
            speaker=entry.get("spk_id", ""),
        ))
    return out


def load_audio_bytes(data: bytes,
                     expected_rate: Optional[int] = None) -> np.ndarray:
    """In-memory WAV (16-bit PCM) bytes -> float32 [-1, 1] mono.

    The bytes-level twin of `load_wav` (for a serving path, which receives
    audio over HTTP). Raises ValueError for any malformed or unsupported
    input — including wave.Error, so callers can map every client-input
    problem to one exception type; NotImplementedError for FLAC."""
    import io

    if data[:4] == b"fLaC":
        raise NotImplementedError(_FLAC_TODO)
    if data[:4] == b"RIFF":
        try:
            with wave.open(io.BytesIO(data), "rb") as w:
                rate = w.getframerate()
                width = w.getsampwidth()
                ch = w.getnchannels()
                raw = w.readframes(w.getnframes())
        except (wave.Error,) + _DECODE_ERRORS as e:
            raise ValueError(f"malformed WAV: {e}") from e
        if width != 2:
            raise ValueError("only 16-bit PCM WAV is accepted")
        audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        if ch > 1:
            audio = audio.reshape(-1, ch)
    else:
        raise ValueError("bytes must be WAV (RIFF) or FLAC (fLaC)")
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if expected_rate is not None and rate != expected_rate:
        raise ValueError(f"sample rate {rate} != expected {expected_rate}")
    return audio


def load_wav(path: str, expected_rate: Optional[int] = None) -> np.ndarray:
    """Load a WAV file to float32 [-1, 1] mono. Routing is by content
    sniffing, not extension: FLAC raises NotImplementedError."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        raise NotImplementedError(f"{path}: {_FLAC_TODO}")
    try:
        with wave.open(path, "rb") as w:
            rate = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            channels = w.getnchannels()
            raw = w.readframes(n)
        if width == 2:
            audio = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            audio = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported sample width {width}")
        if channels > 1:
            audio = audio.reshape(-1, channels)
    except (wave.Error, ValueError) + _DECODE_ERRORS:
        # stdlib wave handles 16/32-bit PCM; scipy covers the rest
        # (24-bit reads as int32, 8-bit as uint8, IEEE float as float)
        from scipy.io import wavfile

        try:
            rate, audio = wavfile.read(path)
        except Exception as e:
            raise ValueError(f"{path}: undecodable WAV: {e}") from e
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        elif audio.dtype == np.int32:
            audio = audio.astype(np.float32) / 2147483648.0
        elif audio.dtype == np.uint8:
            # 8-bit WAV is unsigned with a +128 DC offset
            audio = (audio.astype(np.float32) - 128.0) / 128.0
        else:
            audio = audio.astype(np.float32)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    if expected_rate is not None and rate != expected_rate:
        raise ValueError(f"{path}: sample rate {rate} != expected {expected_rate}")
    return audio
