"""Pure-Python/numpy FLAC codec (decoder and encoder) — the port's copy of
`summarymixing_tpu/data/flac.py`, unchanged in what it computes.

LibriSpeech ships 16-bit FLAC, and the serving runner accepts FLAC
bodies, so the port decodes it without any audio package. Decode covers
what the official `flac` encoder emits:
- all subframe types: CONSTANT, VERBATIM, FIXED (orders 0-4),
  LPC (orders 1-32)
- both Rice residual methods (4- and 5-bit parameters) including
  escape partitions (raw n-bit residuals)
- wasted-bits shifting
- all four channel assignments (independent, left/side, right/side,
  mid/side)
- fixed and variable blocking strategies, last-frame short blocks
- 8/12/16/20/24-bit sample depths
- CRC-8 (frame header), CRC-16 (frame) and STREAMINFO MD5 verification

The encoder writes FLAC (and gives the tests streams with forced code
paths); it optimises lightly (fixed predictors by residual-energy search,
per-partition Rice parameter search). Both ends are bit-serial Python:
seconds for a 30 s utterance. The serving path's FLAC bodies and the
train runner's batches take the threaded native decoder instead
(`native/dataloader.cpp` through `data/native_loader.py`); this codec
stays the reference it is held to, and decodes what that one rejects.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "StreamInfo",
    "read_streaminfo",
    "decode_flac",
    "decode_flac_file",
    "encode_flac",
    "encode_flac_file",
]

_SYNC = 0x3FFE  # 14-bit frame sync code

# Fixed predictors are LPC with these coefficient rows and shift 0
# (newest-first), per the format spec's closed forms.
_FIXED_COEFS = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]]


def _make_crc_table(poly: int, width: int) -> List[int]:
    table = []
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        table.append(crc & mask)
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8_TABLE[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC16_TABLE[((crc >> 8) ^ b) & 0xFF] ^ ((crc << 8) & 0xFFFF)
    return crc


# ---------------------------------------------------------------------------
# bit IO


class _BitReader:
    """MSB-first bit reader over a bytes-like, starting at a byte offset."""

    __slots__ = ("data", "byte", "acc", "n")

    def __init__(self, data: bytes, byte: int = 0):
        self.data = data
        self.byte = byte
        self.acc = 0  # holds `n` not-yet-consumed bits (LSB-justified)
        self.n = 0

    def read(self, k: int) -> int:
        while self.n < k:
            self.acc = (self.acc << 8) | self.data[self.byte]
            self.byte += 1
            self.n += 8
        self.n -= k
        v = self.acc >> self.n
        self.acc &= (1 << self.n) - 1
        return v

    def read_signed(self, k: int) -> int:
        v = self.read(k)
        return v - (1 << k) if v >> (k - 1) else v

    def unary(self) -> int:
        """Count 0 bits up to (and consuming) the terminating 1 bit."""
        q = 0
        while True:
            if self.n == 0:
                self.acc = self.data[self.byte]
                self.byte += 1
                self.n = 8
            if self.acc == 0:
                q += self.n
                self.n = 0
                continue
            top = self.acc.bit_length()
            q += self.n - top
            self.n = top - 1
            self.acc &= (1 << self.n) - 1
            return q

    def align(self) -> None:
        if self.n % 8:
            self.read(self.n % 8)

    def byte_pos(self) -> int:
        """Current position in bytes; only meaningful when byte-aligned."""
        return self.byte - self.n // 8


class _BitWriter:
    __slots__ = ("buf", "acc", "n")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, v: int, k: int) -> None:
        self.acc = (self.acc << k) | (v & ((1 << k) - 1))
        self.n += k
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)
            self.acc &= (1 << self.n) - 1

    def write_unary(self, q: int) -> None:
        self.write(1, q + 1)  # q zeros then a 1

    def align(self) -> None:
        if self.n:
            self.write(0, 8 - self.n)

    def getvalue(self) -> bytes:
        assert self.n == 0, "unaligned bit writer"
        return bytes(self.buf)


def _read_utf8_number(br: _BitReader) -> int:
    """FLAC's UTF-8-style coded frame/sample number (up to 36 bits)."""
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    leading = 0
    mask = 0x80
    while b0 & mask:
        leading += 1
        mask >>= 1
    if leading < 2 or leading > 7:
        raise ValueError("invalid UTF-8-coded number prefix")
    v = b0 & (0xFF >> (leading + 1))
    for _ in range(leading - 1):
        b = br.read(8)
        if b & 0xC0 != 0x80:
            raise ValueError("invalid UTF-8-coded number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


def _write_utf8_number(bw: _BitWriter, v: int) -> None:
    if v < 0x80:
        bw.write(v, 8)
        return
    # choose the smallest length whose payload capacity fits v
    for nbytes, bits in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31), (7, 36)):
        if v < (1 << bits):
            break
    else:
        raise ValueError("number too large for UTF-8 coding")
    payload_bits = bits - 6 * (nbytes - 1)
    prefix = (0xFF << (8 - nbytes)) & 0xFF if nbytes < 8 else 0xFE
    bw.write(prefix >> (8 - nbytes), nbytes)  # nbytes ones
    bw.write(0, 1)
    bw.write(v >> (6 * (nbytes - 1)), payload_bits)
    for i in range(nbytes - 2, -1, -1):
        bw.write(0b10, 2)
        bw.write((v >> (6 * i)) & 0x3F, 6)


# ---------------------------------------------------------------------------
# stream metadata


@dataclass
class StreamInfo:
    min_blocksize: int
    max_blocksize: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int  # 0 = unknown
    md5: bytes

    @property
    def duration(self) -> float:
        return self.total_samples / self.sample_rate if self.sample_rate else 0.0


def _parse_metadata(data: bytes) -> Tuple[StreamInfo, int]:
    """Parse the fLaC marker + metadata blocks; return (StreamInfo,
    offset of the first audio frame)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream (missing fLaC marker)")
    pos = 4
    info: Optional[StreamInfo] = None
    while True:
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:
            br = _BitReader(body)
            min_bs = br.read(16)
            max_bs = br.read(16)
            br.read(24)  # min frame size
            br.read(24)  # max frame size
            rate = br.read(20)
            ch = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
            md5 = body[18:34]
            info = StreamInfo(min_bs, max_bs, rate, ch, bps, total, md5)
        elif btype == 127:
            raise ValueError("invalid metadata block type 127")
        pos += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("missing STREAMINFO block")
    return info, pos


def read_streaminfo(path: str) -> StreamInfo:
    """Fast metadata scan (duration etc.) without decoding audio."""
    with open(path, "rb") as f:
        head = f.read(65536)
        try:
            return _parse_metadata(head)[0]
        except IndexError:
            # metadata larger than the probe window (oversized tags)
            return _parse_metadata(head + f.read())[0]


# ---------------------------------------------------------------------------
# decoding


def _decode_residual(br: _BitReader, blocksize: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError(f"reserved residual method {method}")
    plen = 4 + method
    escape = (1 << plen) - 1
    porder = br.read(4)
    nparts = 1 << porder
    if blocksize % nparts:
        raise ValueError("partition order does not divide block size")
    out: List[int] = []
    part_len = blocksize >> porder
    for p in range(nparts):
        count = part_len - (order if p == 0 else 0)
        if count < 0:
            raise ValueError("invalid partition/predictor geometry")
        param = br.read(plen)
        if param == escape:
            nbits = br.read(5)
            if nbits:
                out.extend(br.read_signed(nbits) for _ in range(count))
            else:
                out.extend([0] * count)
        else:
            for _ in range(count):
                q = br.unary()
                r = br.read(param) if param else 0
                u = (q << param) | r
                out.append((u >> 1) ^ -(u & 1))
    return out


def _predict(warm: Sequence[int], coefs: Sequence[int], shift: int,
             resid: Sequence[int], blocksize: int) -> List[int]:
    """Restore samples from warmup + residual through the (quantised)
    linear predictor x[i] = ((sum_j c[j]*x[i-1-j]) >> shift) + e."""
    order = len(warm)
    x = list(warm) + [0] * (blocksize - order)
    for i in range(order, blocksize):
        acc = 0
        for j, c in enumerate(coefs):
            acc += c * x[i - 1 - j]
        x[i] = (acc >> shift) + resid[i - order]
    return x


def _decode_subframe(br: _BitReader, blocksize: int, bps: int) -> List[int]:
    if br.read(1):
        raise ValueError("subframe padding bit set")
    ftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.unary()
    bps -= wasted
    if ftype == 0:  # CONSTANT
        out = [br.read_signed(bps)] * blocksize
    elif ftype == 1:  # VERBATIM
        out = [br.read_signed(bps) for _ in range(blocksize)]
    elif 8 <= ftype <= 12:  # FIXED
        order = ftype - 8
        warm = [br.read_signed(bps) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        out = _predict(warm, _FIXED_COEFS[order], 0, resid, blocksize)
    elif ftype >= 32:  # LPC
        order = (ftype & 31) + 1
        warm = [br.read_signed(bps) for _ in range(order)]
        prec = br.read(4)
        if prec == 15:
            raise ValueError("invalid LPC precision code")
        prec += 1
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        resid = _decode_residual(br, blocksize, order)
        out = _predict(warm, coefs, shift, resid, blocksize)
    else:
        raise ValueError(f"reserved subframe type {ftype}")
    if wasted:
        out = [v << wasted for v in out]
    return out


_BPS_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def _decode_frame(data: bytes, pos: int, si: StreamInfo):
    """Decode one frame; return (channel-major samples [ch][blocksize],
    next byte offset)."""
    br = _BitReader(data, pos)
    if br.read(14) != _SYNC:
        raise ValueError(f"bad frame sync at byte {pos}")
    if br.read(1):
        raise ValueError("reserved bit set in frame header")
    br.read(1)  # blocking strategy (number semantics only)
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise ValueError("reserved bit set in frame header")
    _read_utf8_number(br)
    if bs_code == 0:
        raise ValueError("reserved block size code")
    elif bs_code == 1:
        blocksize = 192
    elif bs_code <= 5:
        blocksize = 576 << (bs_code - 2)
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = 256 << (bs_code - 8)
    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    elif sr_code == 15:
        raise ValueError("invalid sample rate code")
    if ss_code == 0:
        bps = si.bits_per_sample
    elif ss_code in _BPS_CODES:
        bps = _BPS_CODES[ss_code]
    else:
        raise ValueError(f"reserved sample size code {ss_code}")

    crc8 = _crc8(data[pos:br.byte_pos()])
    if br.read(8) != crc8:
        raise ValueError(f"frame header CRC-8 mismatch at byte {pos}")

    if ch_code < 8:
        nch = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bps) for _ in range(nch)]
    elif ch_code <= 10:
        # stereo decorrelation: the side channel carries one extra bit
        side_ch = 0 if ch_code == 9 else 1
        chans = [
            _decode_subframe(br, blocksize, bps + (1 if c == side_ch else 0))
            for c in range(2)
        ]
        if ch_code == 8:  # left/side: R = L - S
            left, side = chans
            chans = [left, [l - s for l, s in zip(left, side)]]
        elif ch_code == 9:  # right/side: L = S + R
            side, right = chans
            chans = [[s + r for s, r in zip(side, right)], right]
        else:  # mid/side
            mid, side = chans
            left, right = [], []
            for m, s in zip(mid, side):
                m2 = (m << 1) | (s & 1)
                left.append((m2 + s) >> 1)
                right.append((m2 - s) >> 1)
            chans = [left, right]
    else:
        raise ValueError(f"reserved channel assignment {ch_code}")

    br.align()
    end = br.byte_pos()
    crc16 = _crc16(data[pos:end])
    if br.read(16) != crc16:
        raise ValueError(f"frame CRC-16 mismatch at byte {pos}")
    return chans, br.byte_pos()


def decode_flac(data: bytes, verify_md5: bool = True
                ) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream.

    Returns (samples int32 [n] mono / [n, channels], sample_rate,
    bits_per_sample). Verifies frame CRCs always and the STREAMINFO MD5
    when present (unless verify_md5=False)."""
    si, pos = _parse_metadata(data)
    per_ch: List[List[int]] = [[] for _ in range(si.channels)]
    while pos < len(data):
        chans, pos = _decode_frame(data, pos, si)
        if len(chans) != si.channels:
            raise ValueError("frame channel count differs from STREAMINFO")
        for c, s in zip(per_ch, chans):
            c.extend(s)
    out = np.array(per_ch, np.int32).T  # [n, ch]
    if si.total_samples and out.shape[0] != si.total_samples:
        raise ValueError(
            f"decoded {out.shape[0]} samples, STREAMINFO says {si.total_samples}")
    if verify_md5 and si.md5 != b"\x00" * 16:
        if _pcm_md5(out, si.bits_per_sample) != si.md5:
            raise ValueError("decoded PCM MD5 mismatch")
    if si.channels == 1:
        out = out[:, 0]
    return out, si.sample_rate, si.bits_per_sample


def decode_flac_file(path: str, verify_md5: bool = True
                     ) -> Tuple[np.ndarray, int, int]:
    with open(path, "rb") as f:
        return decode_flac(f.read(), verify_md5=verify_md5)


def _pcm_md5(samples: np.ndarray, bps: int) -> bytes:
    """MD5 of the interleaved little-endian PCM, as STREAMINFO defines."""
    x = samples if samples.ndim == 2 else samples[:, None]
    nbytes = (bps + 7) // 8
    le = x.astype("<i4").tobytes()
    # keep the low `nbytes` of each 4-byte little-endian word
    arr = np.frombuffer(le, np.uint8).reshape(-1, 4)[:, :nbytes]
    return hashlib.md5(arr.tobytes()).digest()


# ---------------------------------------------------------------------------
# encoding


def _rice_cost(resid: Sequence[int], k: int) -> int:
    total = 0
    for v in resid:
        u = 2 * v if v >= 0 else -2 * v - 1
        total += (u >> k) + 1 + k
    return total


def _best_rice_param(resid: Sequence[int], max_param: int) -> int:
    if not len(resid):
        return 0
    mean = sum(2 * v if v >= 0 else -2 * v - 1 for v in resid) / max(len(resid), 1)
    k = max(0, int(mean).bit_length() - 1)
    k = min(k, max_param)
    # local search around the estimate
    best_k, best_c = k, _rice_cost(resid, k)
    for kk in (k - 1, k + 1):
        if 0 <= kk <= max_param:
            c = _rice_cost(resid, kk)
            if c < best_c:
                best_k, best_c = kk, c
    return best_k


def _write_residual(bw: _BitWriter, resid: Sequence[int], blocksize: int,
                    order: int, partition_order: int, rice2: bool,
                    force_escape: bool) -> None:
    method = 1 if rice2 else 0
    plen = 4 + method
    escape = (1 << plen) - 1
    bw.write(method, 2)
    bw.write(partition_order, 4)
    nparts = 1 << partition_order
    assert blocksize % nparts == 0
    part_len = blocksize >> partition_order
    idx = 0
    for p in range(nparts):
        count = part_len - (order if p == 0 else 0)
        part = resid[idx:idx + count]
        idx += count
        if force_escape:
            nbits = max((int(v).bit_length() + 1 for v in part), default=1)
            nbits = min(nbits, 31)
            bw.write(escape, plen)
            bw.write(nbits, 5)
            for v in part:
                bw.write(v, nbits)
        else:
            k = _best_rice_param(part, escape - 1)
            bw.write(k, plen)
            for v in part:
                u = 2 * v if v >= 0 else -2 * v - 1
                bw.write_unary(u >> k)
                if k:
                    bw.write(u & ((1 << k) - 1), k)


def _fixed_residual(x: Sequence[int], order: int) -> List[int]:
    coefs = _FIXED_COEFS[order]
    return [
        x[i] - sum(c * x[i - 1 - j] for j, c in enumerate(coefs))
        for i in range(order, len(x))
    ]


def _write_subframe(bw: _BitWriter, x: Sequence[int], bps: int,
                    force: Optional[str], lpc_order: int,
                    partition_order: int, rice2: bool, force_escape: bool,
                    wasted_ok: bool) -> None:
    x = [int(v) for v in x]
    blocksize = len(x)

    wasted = 0
    if wasted_ok and any(x):
        # count shared trailing zero bits across all samples
        acc = 0
        for v in x:
            acc |= v
        wasted = (acc & -acc).bit_length() - 1
        if wasted:
            x = [v >> wasted for v in x]
    eff_bps = bps - wasted

    def header(ftype: int) -> None:
        bw.write(0, 1)
        bw.write(ftype, 6)
        if wasted:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    constant = all(v == x[0] for v in x)
    if force == "constant" or (force is None and constant):
        if not constant:
            raise ValueError("constant subframe forced on non-constant block")
        header(0)
        bw.write(x[0], eff_bps)
        return
    if force == "verbatim":
        header(1)
        for v in x:
            bw.write(v, eff_bps)
        return
    if force == "lpc":
        order = min(lpc_order, blocksize - 1)
        if order < 1:
            raise ValueError("LPC needs at least 2 samples")
        coefs, shift, prec = _fit_qlp(x, order)
        resid = [
            x[i] - (sum(c * x[i - 1 - j] for j, c in enumerate(coefs)) >> shift)
            for i in range(order, blocksize)
        ]
        header(32 + order - 1)
        for v in x[:order]:
            bw.write(v, eff_bps)
        bw.write(prec - 1, 4)
        bw.write(shift, 5)
        for c in coefs:
            bw.write(c, prec)
        porder = partition_order if blocksize % (1 << partition_order) == 0 \
            and (blocksize >> partition_order) > order else 0
        _write_residual(bw, resid, blocksize, order, porder, rice2,
                        force_escape)
        return

    # FIXED: pick the order with the least residual magnitude
    if force is not None and force.startswith("fixed"):
        orders = [int(force[5:])]
    else:
        orders = [o for o in range(5) if o < blocksize]
    best = None
    for o in orders:
        resid = _fixed_residual(x, o)
        cost = sum(abs(v) for v in resid)
        if best is None or cost < best[0]:
            best = (cost, o, resid)
    _, order, resid = best
    header(8 + order)
    for v in x[:order]:
        bw.write(v, eff_bps)
    porder = partition_order if blocksize % (1 << partition_order) == 0 \
        and (blocksize >> partition_order) > order else 0
    _write_residual(bw, resid, blocksize, order, porder, rice2, force_escape)


def _fit_qlp(x: Sequence[int], order: int,
             precision: int = 14) -> Tuple[List[int], int, int]:
    """Quantised LPC fit: Levinson-Durbin on the autocorrelation, then
    coefficient quantisation. Correctness never depends on fit quality —
    the residual is computed with the *quantised* predictor, so decode is
    lossless for any coefficients."""
    xf = np.asarray(x, np.float64)
    n = len(xf)
    auto = [float(np.dot(xf[:n - lag], xf[lag:])) for lag in range(order + 1)]
    if auto[0] == 0.0:
        lp = np.zeros(order)
    else:
        err = auto[0]
        lp = np.zeros(order)
        for i in range(order):
            acc = auto[i + 1] - float(np.dot(lp[:i], auto[i:0:-1][:i]))
            k = acc / err if err else 0.0
            lp[:i], lp[i] = lp[:i] - k * lp[:i][::-1], k
            err *= max(1.0 - k * k, 1e-9)
    cmax = float(np.max(np.abs(lp))) or 1.0
    shift = max(0, min(15, precision - 1 - int(np.ceil(np.log2(cmax + 1e-9)))))
    qmax = (1 << (precision - 1)) - 1
    coefs = [int(np.clip(round(c * (1 << shift)), -qmax - 1, qmax)) for c in lp]
    return coefs, shift, precision


_BS_CODE = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
            1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}


def encode_flac(
    samples: np.ndarray,
    sample_rate: int,
    bits_per_sample: int = 16,
    blocksize: int = 4096,
    stereo_mode: str = "independent",
    force_subframe: Optional[str] = None,
    lpc_order: int = 8,
    partition_order: int = 0,
    rice2: bool = False,
    force_escape: bool = False,
    wasted_ok: bool = True,
    variable_blocking: bool = False,
) -> bytes:
    """Encode PCM to a FLAC stream.

    samples: int array [n] (mono) or [n, channels]; values must fit in
    `bits_per_sample` signed bits. `force_subframe` in {None, "constant",
    "verbatim", "fixed0".."fixed4", "lpc"} pins the subframe type (used
    by the decoder tests to exercise every code path)."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    n, nch = x.shape
    if nch > 8:
        raise ValueError("FLAC supports at most 8 channels")
    lim = 1 << (bits_per_sample - 1)
    if x.min() < -lim or x.max() >= lim:
        raise ValueError(f"samples exceed {bits_per_sample}-bit range")
    if stereo_mode != "independent" and nch != 2:
        raise ValueError("stereo decorrelation requires 2 channels")
    if not 16 <= blocksize <= 65535:
        # STREAMINFO's min/max blocksize are 16-bit fields: 65536 would
        # silently truncate to an (invalid) declared blocksize of 0 that
        # spec-conforming external decoders reject
        raise ValueError(f"blocksize {blocksize} outside FLAC's [16, 65535]")

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.write(blocksize, 16)
    si.write(blocksize, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(nch - 1, 3)
    si.write(bits_per_sample - 1, 5)
    si.write(n, 36)
    body = si.getvalue() + _pcm_md5(x, bits_per_sample)
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits_per_sample]
    frame_idx = 0
    for start in range(0, n, blocksize):
        blk = x[start:start + blocksize]
        bs = blk.shape[0]
        bw = _BitWriter()
        bw.write(_SYNC, 14)
        bw.write(0, 1)
        bw.write(1 if variable_blocking else 0, 1)
        bs_code = _BS_CODE.get(bs, 7)
        bw.write(bs_code, 4)
        bw.write(0, 4)  # sample rate: from STREAMINFO
        if stereo_mode == "independent":
            ch_code = nch - 1
        else:
            ch_code = {"left_side": 8, "right_side": 9, "mid_side": 10}[
                stereo_mode]
        bw.write(ch_code, 4)
        bw.write(ss_code, 3)
        bw.write(0, 1)
        _write_utf8_number(bw, start if variable_blocking else frame_idx)
        if bs_code == 7:
            bw.write(bs - 1, 16)
        # the header is byte-aligned here by construction; CRC-8 covers it
        bw.write(_crc8(bytes(bw.buf)), 8)

        sub = dict(force=force_subframe, lpc_order=lpc_order,
                   partition_order=partition_order, rice2=rice2,
                   force_escape=force_escape, wasted_ok=wasted_ok)
        if stereo_mode == "independent":
            for c in range(nch):
                _write_subframe(bw, blk[:, c], bits_per_sample, **sub)
        else:
            left = [int(v) for v in blk[:, 0]]
            right = [int(v) for v in blk[:, 1]]
            side = [a - b for a, b in zip(left, right)]
            if stereo_mode == "left_side":
                _write_subframe(bw, left, bits_per_sample, **sub)
                _write_subframe(bw, side, bits_per_sample + 1, **sub)
            elif stereo_mode == "right_side":
                _write_subframe(bw, side, bits_per_sample + 1, **sub)
                _write_subframe(bw, right, bits_per_sample, **sub)
            else:
                mid = [(a + b) >> 1 for a, b in zip(left, right)]
                _write_subframe(bw, mid, bits_per_sample, **sub)
                _write_subframe(bw, side, bits_per_sample + 1, **sub)
        bw.align()
        bw.write(_crc16(bytes(bw.buf)), 16)
        out += bw.getvalue()
        frame_idx += 1
    return bytes(out)


def encode_flac_file(path: str, samples: np.ndarray, sample_rate: int,
                     **kwargs) -> None:
    data = encode_flac(samples, sample_rate, **kwargs)
    with open(path, "wb") as f:
        f.write(data)
