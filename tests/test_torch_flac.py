"""The port's FLAC codec (`summarymixing_tpu_torch/data/flac.py`) and FLAC
input (`data/dataio.py`) against the JAX package's, on the CPU.

Every forced code path of `tests/test_flac.py` (subframe types, LPC
orders, stereo modes, partition orders, residual codings, wasted bits,
bit depths), on short signals since both codecs are bit-serial Python:
the two encoders write the same bytes, a stream written by the JAX
encoder decodes bit-equal in the port and one written by the port decodes
bit-equal in the JAX package. Then files and in-memory bodies through
`load_wav` and `load_audio_bytes`, a FLAC body against its WAV twin, and
the checks (CRC-16, MD5, a stream that is not FLAC)."""

import io
import wave

import numpy as np
import pytest

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.data import dataio as jdataio
from summarymixing_tpu.data import flac as jflac
from summarymixing_tpu_torch.data import dataio
from summarymixing_tpu_torch.data import flac

# (name, length, channels, bits, encoder keywords): tests/test_flac.py's forced paths
PATHS = [
    ("default", 700, 1, 16, {}),
    *[(f"subframe_{f}", 600, 1, 16, {"force_subframe": f})
      for f in ("verbatim", "fixed0", "fixed1", "fixed2", "fixed3", "fixed4", "lpc")],
    *[(f"lpc_order_{o}", 500, 1, 16, {"force_subframe": "lpc", "lpc_order": o})
      for o in (1, 8, 32)],
    *[(f"stereo_{m}", 500, 2, 16, {"stereo_mode": m})
      for m in ("independent", "left_side", "right_side", "mid_side")],
    ("partitions_4", 512, 1, 16, {"partition_order": 4}),
    ("rice2", 500, 1, 16, {"rice2": True}),
    ("escape", 500, 1, 16, {"force_escape": True}),
    ("variable_blocking", 500, 1, 16, {"variable_blocking": True}),
    ("bits_8", 400, 1, 8, {"bits_per_sample": 8}),
    ("bits_24", 400, 1, 24, {"bits_per_sample": 24}),
]


def _audio(seed, n, nch=1, bps=16):
    """Correlated noise plus a tone over the full integer range (so the
    predictors engage), as tests/test_flac.py draws it."""
    rng = np.random.default_rng(seed)
    lim = 1 << (bps - 1)
    x = rng.standard_normal((n, nch))
    for _ in range(3):
        x[1:] = 0.7 * x[1:] + 0.3 * x[:-1]
    x = x / np.abs(x).max() * 0.5 + 0.3 * np.sin(0.05 * np.arange(n)[:, None])
    out = np.clip((x * (lim - 1)).round(), -lim, lim - 1).astype(np.int64)
    if nch == 2:
        out[:, 1] = (0.8 * out[:, 0] + 0.2 * out[:, 1]).astype(np.int64)
    return out[:, 0] if nch == 1 else out


@pytest.mark.parametrize("name,n,nch,bps,kw", PATHS, ids=[p[0] for p in PATHS])
def test_streams_cross_decode_bit_equal(name, n, nch, bps, kw):
    x = _audio(len(name), n, nch, bps)
    if name == "default":
        x = x & ~0b111   # shared trailing zero bits: the wasted-bits path
    ours = flac.encode_flac(x, 16000, blocksize=256, **kw)
    theirs = jflac.encode_flac(x, 16000, blocksize=256, **kw)
    assert ours == theirs
    for data, decode in ((theirs, flac.decode_flac), (ours, jflac.decode_flac)):
        y, rate, got_bps = decode(data)
        assert (rate, got_bps) == (16000, bps)
        np.testing.assert_array_equal(y, x)


def _wav_bytes(x16: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(x16.astype(np.int16).tobytes())
    return buf.getvalue()


def test_flac_files_and_bodies_decode_as_in_jax(tmp_path):
    """A file written by the JAX encoder through both `load_wav`s, and its
    bytes through both `load_audio_bytes`: equal to each other and to the
    WAV twin's samples, bit for bit."""
    x = _audio(3, 16000 + 37)
    path = str(tmp_path / "a.flac")
    jflac.encode_flac_file(path, x, 16000)
    assert flac.read_streaminfo(path).total_samples == len(x)
    got = dataio.load_wav(path, 16000)
    np.testing.assert_array_equal(got, jdataio.load_wav(path, 16000))
    with open(path, "rb") as f:
        body = f.read()
    np.testing.assert_array_equal(dataio.load_audio_bytes(body, 16000), got)
    np.testing.assert_array_equal(dataio.load_audio_bytes(_wav_bytes(x), 16000), got)
    assert got.dtype == np.float32
    with pytest.raises(ValueError, match="sample rate"):
        dataio.load_audio_bytes(body, 8000)
    with pytest.raises(ValueError, match="sample rate"):
        dataio.load_wav(path, 8000)


def test_corrupt_streams_are_refused():
    x = _audio(5, 512)
    data = bytearray(flac.encode_flac(x, 16000, blocksize=512))
    bad_crc = bytes(data[:-1]) + bytes([data[-1] ^ 0x40])
    with pytest.raises(ValueError, match="CRC-16"):
        flac.decode_flac(bad_crc)
    data[26] ^= 1   # a bit of the STREAMINFO MD5
    with pytest.raises(ValueError, match="MD5"):
        flac.decode_flac(bytes(data))
    flac.decode_flac(bytes(data), verify_md5=False)
    with pytest.raises(ValueError, match="fLaC"):
        flac.decode_flac(b"RIFF....WAVE" + b"\x00" * 64)
    with pytest.raises(ValueError, match="STREAMINFO says 512"):
        dataio.load_audio_bytes(bytes(data[:40]), 16000)   # a body cut after its header
