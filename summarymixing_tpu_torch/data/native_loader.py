"""The threaded C++ WAV/FLAC batch loader `native/dataloader.cpp`, bound
with ctypes — the port of `summarymixing_tpu/data/native_loader.py`.

`g++` builds the tracked source at first use into
`build/native/dataloader-<digest>.so` at the repository root (a directory
that `.gitignore` lists; the digest covers the source and the flags, so an
edited source is rebuilt), compiling to a private name and renaming it
into place, so that concurrent processes never load a half-written
library. Nothing is written into `native/`, and an untracked
`native/libdataloader.so` is never loaded. A failed build raises: the
loader does not quietly take the Python path.

`load_wav_batch(paths, max_len)` decodes 16-bit PCM WAV (mono or
interleaved channels, averaged) and FLAC into a zero-padded float32
`[B, max_len]` matrix and the `[B]` int32 lengths, one thread per file up
to 16. Rows the C++ side rejects (24- and 32-bit WAV, malformed files) are
decoded again, alone, by the port's Python decoder (`dataio.load_wav`),
which decodes what it can and raises a precise error for the rest; each
such row is counted in `load_wav_batch.python_retries`, and the first is
reported on stdout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SRC = REPO / "native" / "dataloader.cpp"
BUILD_DIR = REPO / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LIBS: Dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    h = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"dataloader-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless this digest is built already; returns the
    library's path. Raises RuntimeError when the compiler fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the native loader's build ({CXX} {SRC}) failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"the native loader's build ({CXX} {SRC}) failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    so = build()
    if so not in _LIBS:
        lib = ctypes.CDLL(str(so))
        lib.load_wav_batch.restype = ctypes.c_int
        lib.load_wav_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ]
        _LIBS[so] = lib
    return _LIBS[so]


def native_available() -> bool:
    """Whether the native loader builds and loads here (the JAX package's
    probe); `load_wav_batch` itself raises when it does not."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def load_wav_batch(paths: Sequence[str], max_len: int,
                   expected_rate: int = 16000) -> Tuple[np.ndarray, np.ndarray]:
    """Decode `paths` into `(out [B, max_len] float32, zero-padded; lengths
    [B] int32)`, each file cut at `max_len` samples, on as many threads as
    the loader chooses. `expected_rate` <= 0 skips the sample-rate check."""
    from summarymixing_tpu_torch.data.dataio import load_wav

    lib = load_library()
    n = len(paths)
    out = np.zeros((n, max_len), np.float32)   # the ABI writes only each row's prefix
    lengths = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.load_wav_batch(c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            max_len, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                            expected_rate, 0)
    if rc == 0:
        return out, lengths
    # the rejected rows have length 0 and the others are complete: decode
    # only those again, so a batch with one 24-bit file is not all Python
    for i, path in enumerate(paths):
        if lengths[i] == 0:
            if load_wav_batch.python_retries == 0:
                print(f"NOTE: the native loader rejected {path!r} (an unsupported format or a "
                      "malformed file); such rows are decoded by the Python decoder",
                      flush=True)
            load_wav_batch.python_retries += 1
            audio = load_wav(path, expected_rate if expected_rate > 0 else None)[:max_len]
            out[i, :len(audio)] = audio
            lengths[i] = len(audio)
    return out, lengths


load_wav_batch.python_retries = 0
