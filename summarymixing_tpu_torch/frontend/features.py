"""Speech features — the port of `Fbank`, `NormStats` and
`InputNormalization` from `summarymixing_tpu/frontend/features.py`.

Fbank: centered framing with zero padding, ONE float32 matmul of the frames
against the hamming-windowed DFT basis, power spectrum, HTK-mel filterbank,
10·log10 with an 80 dB cap below each utterance's peak. The pieces
(`stft_magnitude`, `log_mel`, `clamp_top_db`) are public for the chunked
frontend of `streaming.py`, which clamps against a running peak. The basis and the
filterbank are built in numpy float64 and rounded to float32 exactly as
the JAX package builds them. The JAX Fbank's other options (f_min, f_max,
top_db, power) keep their defaults here, the values the recipes use.
"""

from __future__ import annotations

import math

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

TOP_DB = 80.0   # dynamic range kept below each utterance's peak


def _dft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(n_fft // 2 + 1)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = -2.0 * np.pi * k * n / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _windowed_basis(n_fft: int, win_length: int) -> np.ndarray:
    """`[win_length, 2·(n_fft//2+1)]`: hamming window times [cos | sin]."""
    cos_b, sin_b = _dft_basis(n_fft)
    w = (0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
         ).astype(np.float32)
    basis = (np.concatenate([cos_b[:, :win_length], sin_b[:, :win_length]], axis=0)
             * w[None, :])
    return np.ascontiguousarray(basis.T.astype(np.float32))


def hamming_window(length: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The periodic Hamming window (`torch.hamming_window(periodic=True)`)."""
    n = torch.arange(length, dtype=torch.float32)
    return (0.54 - 0.46 * torch.cos(2.0 * math.pi * n / length)).to(dtype)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int, center: bool = True
                 ) -> torch.Tensor:
    """x `[B, N]` -> frames `[B, T, frame_length]`; T = 1 + N//hop when
    centred (frame_length//2 zeros on both sides, as torch's STFT pads)."""
    if center:
        pad = frame_length // 2
        x = F.pad(x, (pad, pad))
    return x.unfold(1, frame_length, hop)


def _power_spectrum(wav: torch.Tensor, basis: torch.Tensor, n_fft: int, win_length: int,
                    hop: int) -> torch.Tensor:
    """|STFT|² `[B, 1 + N//hop, n_fft//2 + 1]` of the centred windows, one
    product with the windowed DFT basis."""
    n = wav.shape[1]
    t_out = 1 + n // hop
    half = win_length // 2
    right = max(0, (t_out - 1) * hop + win_length - n - half)
    frames = F.pad(wav.to(torch.float32), (half, right)).unfold(1, win_length, hop)[:, :t_out]
    y = torch.matmul(frames, basis)
    f = n_fft // 2 + 1
    return y[..., :f] ** 2 + y[..., f:] ** 2


def stft_magnitude(x: torch.Tensor, n_fft: int = 512, win_length: int = 512, hop: int = 160,
                   power: float = 1.0) -> torch.Tensor:
    """x `[B, N]` audio -> `[B, T, n_fft//2 + 1]`: the power spectrum
    |X|² (power 1.0, the reference Fbank's), or |X|^(2·power)."""
    if win_length > n_fft:
        raise ValueError("win_length > n_fft")
    basis = torch.as_tensor(_windowed_basis(n_fft, win_length), device=x.device)
    spec = _power_spectrum(x, basis, n_fft, win_length, hop)
    return spec if power == 1.0 else torch.pow(spec, power)


def _hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int = 80, n_fft: int = 512, sample_rate: int = 16000) -> np.ndarray:
    """Triangular HTK-mel filterbank matrix `[n_fft//2+1, n_mels]` over
    0 Hz to the Nyquist frequency."""
    mel_pts = np.linspace(_hz_to_mel(0.0), _hz_to_mel(sample_rate / 2), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bins = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    fb = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
    for m in range(n_mels):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bins - left) / max(center - left, 1e-10)
        down = (right - bins) / max(right - center, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


class Fbank(nn.Module):
    """Log-mel filterbank features: wav `[B, N]` -> `[B, 1 + N//hop, n_mels]`.
    The basis and filterbank are buffers on the device the module is built
    on (or moved to)."""

    def __init__(self, sample_rate: int = 16000, n_fft: int = 512,
                 win_length_ms: float = 32.0, hop_length_ms: float = 10.0, n_mels: int = 80):
        super().__init__()
        self.sample_rate, self.n_fft, self.n_mels = sample_rate, n_fft, n_mels
        self.win_length = int(round(sample_rate * win_length_ms / 1000.0))
        self.hop_length = int(round(sample_rate * hop_length_ms / 1000.0))
        if self.win_length > n_fft:
            raise ValueError("win_length > n_fft")
        self.register_buffer("basis", torch.as_tensor(_windowed_basis(n_fft, self.win_length)),
                             persistent=False)
        self.register_buffer("mel_fb", torch.as_tensor(
            mel_filterbank(n_mels, n_fft, sample_rate)), persistent=False)

    def frame_lengths(self, sample_lengths: torch.Tensor) -> torch.Tensor:
        return 1 + sample_lengths // self.hop_length

    def stft_magnitude(self, wav: torch.Tensor) -> torch.Tensor:
        """wav `[B, N]` -> power spectrum `[B, 1 + N//hop, n_fft//2 + 1]`."""
        return _power_spectrum(wav, self.basis, self.n_fft, self.win_length, self.hop_length)

    def log_mel(self, spec: torch.Tensor) -> torch.Tensor:
        """Power spectrum `[B, T, n_fft//2 + 1]` -> 10·log10 of the mel
        energies `[B, T, n_mels]`, before the top-dB clamp."""
        mel = torch.matmul(spec, self.mel_fb)
        return 10.0 * torch.log10(mel.clamp_min(1e-10))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        db = self.log_mel(self.stft_magnitude(wav))
        return clamp_top_db(db, db.amax(dim=(1, 2)))


def clamp_top_db(db: torch.Tensor, db_max: torch.Tensor) -> torch.Tensor:
    """Floor log-mel `db` `[B, T, n_mels]` at `TOP_DB` below each row's
    reference `db_max` `[B]`: the utterance's peak offline, the running
    peak of a stream (`streaming.py`)."""
    return torch.maximum(db, (db_max - TOP_DB)[:, None, None])


class NormStats:
    """Running global mean/variance as a dict of tensors (count, mean, m2),
    merged over the valid frames of each batch (Chan's parallel Welford)."""

    @staticmethod
    def init(dim: int, device=None) -> dict:
        return {"count": torch.zeros((), dtype=torch.float32, device=device),
                "mean": torch.zeros(dim, dtype=torch.float32, device=device),
                "m2": torch.zeros(dim, dtype=torch.float32, device=device)}

    @staticmethod
    def update(stats: dict, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
               reduce=None) -> dict:
        """x `[B, T, F]`; pad_mask `[B, T]`, 1 = valid. `reduce`, given, sums
        tensors over the data-parallel processes (`GradientSync.sum_`): the
        batch's count, sum and squared deviations are then the whole global
        batch's, as one process would see them."""
        if pad_mask is None:
            pad_mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
        w = pad_mask[..., None].to(torch.float32)
        n_b = w.sum()
        s_b = (x * w).sum(dim=(0, 1))
        if reduce is not None:
            n_b, s_b = reduce(n_b, s_b)
        mean_b = s_b / n_b.clamp_min(1.0)
        m2_b = (((x - mean_b) ** 2) * w).sum(dim=(0, 1))
        if reduce is not None:
            (m2_b,) = reduce(m2_b)
        n_a, mean_a, m2_a = stats["count"], stats["mean"], stats["m2"]
        n = n_a + n_b
        delta = mean_b - mean_a
        mean = mean_a + delta * n_b / n.clamp_min(1.0)
        m2 = m2_a + m2_b + delta * delta * n_a * n_b / n.clamp_min(1.0)
        return {"count": n, "mean": mean, "m2": m2}

    @staticmethod
    def mean_std(stats: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = stats["mean"]
        var = stats["m2"] / (stats["count"] - 1.0).clamp_min(1.0)
        std = torch.sqrt(var.clamp_min(1e-10))
        # fresh stats (count 0): neutral normalization
        seen = stats["count"] > 0
        return (torch.where(seen, mean, torch.zeros_like(mean)),
                torch.where(seen, std, torch.ones_like(std)))


class InputNormalization:
    """Global mean/variance normalization. With `update=True` the
    statistics first take in the batch's valid frames, while the trainer's
    0-based `epoch` + 1 is below `update_until_epoch` (the reference counts
    epochs from 1); after that they are frozen."""

    def __init__(self, update_until_epoch: int = 4, std_norm: bool = True):
        self.update_until_epoch = update_until_epoch
        self.std_norm = std_norm

    def __call__(self, x: torch.Tensor, stats: dict, pad_mask: Optional[torch.Tensor] = None,
                 epoch: Optional[int] = None, update: bool = False,
                 reduce=None) -> Tuple[torch.Tensor, dict]:
        if update and (epoch is None or epoch + 1 < self.update_until_epoch):
            stats = NormStats.update(stats, x, pad_mask, reduce)
        mean, std = NormStats.mean_std(stats)
        out = x - mean
        return (out / std if self.std_norm else out), stats
