"""Data augmentation — the port of `summarymixing_tpu/frontend/augment.py`:
SpecAugment (time and frequency drops, time warp, the Augmenter's
N-of-3 selection) and speed perturbation.

Each augmentation is split into a random draw (`*_draw`, from a
`torch.Generator`) and a deterministic transform of the input and those
draws, so that a test can feed the JAX package's draws to the port's
transform. The draws are the raw numbers the JAX functions draw: integer
lengths and offsets, and uniforms that the transform scales.
`spectrogram_drop` and `time_warp` (draw, then transform) and the
`Augmenter` combinator keep the JAX signatures with a generator where
JAX takes a key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch


def _valid_frames(x: torch.Tensor, pad_mask: Optional[torch.Tensor], size: int,
                  use_mask: bool) -> torch.Tensor:
    if use_mask and pad_mask is not None:
        return pad_mask.sum(dim=1).to(torch.int32)
    return torch.full((x.shape[0],), size, dtype=torch.int32, device=x.device)


def spectrogram_drop_draw(generator: Optional[torch.Generator], batch: int, drop_count: int,
                          drop_length_low: int, drop_length_high: int,
                          device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Span lengths `[B, count]` in [low, high] and start uniforms `[B, count]`."""
    lengths = torch.randint(drop_length_low, drop_length_high + 1, (batch, drop_count),
                            generator=generator, device=device, dtype=torch.int32)
    starts_u = torch.rand(batch, drop_count, generator=generator, device=device)
    return lengths, starts_u


def spectrogram_drop_apply(x: torch.Tensor, lengths: torch.Tensor, starts_u: torch.Tensor,
                           pad_mask: Optional[torch.Tensor] = None, axis: int = 1,
                           replace: str = "mean") -> torch.Tensor:
    """Drop the drawn spans along time (axis 1) or frequency (axis 2) of x
    `[B, T, F]`, replacing them with the utterance mean or zeros; padded
    frames keep their values."""
    f = x.shape[2]
    size = x.shape[axis]
    valid = _valid_frames(x, pad_mask, size, axis == 1)
    starts = (starts_u * torch.clamp(valid[:, None] - lengths, min=1).to(torch.float32)
              ).to(torch.int32)
    pos = torch.arange(size, device=x.device)[None, None, :]
    in_span = (pos >= starts[..., None]) & (pos < (starts + lengths)[..., None])
    drop = in_span.any(dim=1)
    drop3 = drop[:, :, None] if axis == 1 else drop[:, None, :]
    if replace == "mean":
        if pad_mask is None:
            fill = x.mean(dim=(1, 2), keepdim=True)
        else:
            w = pad_mask[..., None]
            fill = (x * w).sum(dim=(1, 2), keepdim=True) / torch.clamp(
                w.sum(dim=(1, 2), keepdim=True) * f, min=1.0)
    else:
        fill = torch.zeros((1, 1, 1), dtype=x.dtype, device=x.device)
    out = torch.where(drop3, fill.to(x.dtype), x)
    if pad_mask is not None:
        out = torch.where(pad_mask[..., None] > 0, out, x)
    return out


def time_warp_draw(generator: Optional[torch.Generator], batch: int, warp_window: int,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centre uniforms `[B]` and shifts `[B]` in [-W, W]."""
    center_u = torch.rand(batch, generator=generator, device=device)
    shift = torch.randint(-warp_window, warp_window + 1, (batch,), generator=generator,
                          device=device, dtype=torch.int32)
    return center_u, shift


def time_warp_apply(x: torch.Tensor, center_u: torch.Tensor, shift: torch.Tensor,
                    pad_mask: Optional[torch.Tensor] = None, warp_window: int = 5) -> torch.Tensor:
    """SpecAugment time warp: the centre c in [W, L - W) moves by the drawn
    shift and the frames on both sides are linearly resampled."""
    b, t, _ = x.shape
    valid = _valid_frames(x, pad_mask, t, True)
    lo = torch.clamp(valid // 2, max=warp_window)
    c = (center_u * torch.clamp(valid - 2 * lo, min=1).to(torch.float32)).to(torch.int32) + lo
    w = torch.minimum(torch.maximum(shift, -(c - 1)), valid - 1 - c)
    c_new = c + w
    f32 = torch.float32
    pos = torch.arange(t, device=x.device)[None, :].to(f32)
    cf, cnf, vf = c.to(f32)[:, None], c_new.to(f32)[:, None], valid.to(f32)[:, None]
    left = pos * (cf / torch.clamp(cnf, min=1.0))
    right = cf + (pos - cnf) * (vf - 1 - cf) / torch.clamp(vf - 1 - cnf, min=1.0)
    src = torch.where(pos <= cnf, left, right)
    src = torch.minimum(torch.clamp(src, min=0.0), vf - 1.0)
    src = torch.where(pos < vf, src, pos)
    i0 = torch.floor(src).to(torch.long)
    i1 = torch.clamp(i0 + 1, max=t - 1)
    frac = (src - i0.to(f32))[..., None]
    g0 = torch.gather(x, 1, i0[..., None].expand(-1, -1, x.shape[2]))
    g1 = torch.gather(x, 1, i1[..., None].expand(-1, -1, x.shape[2]))
    return g0 * (1.0 - frac) + g1 * frac


def spectrogram_drop(generator: Optional[torch.Generator], x: torch.Tensor,
                     pad_mask: Optional[torch.Tensor] = None, drop_length_low: int = 15,
                     drop_length_high: int = 25, drop_count: int = 4, axis: int = 1,
                     replace: str = "mean") -> torch.Tensor:
    """Drop `drop_count` random spans along time (axis 1) or frequency
    (axis 2), replaced by the utterance mean or zeros."""
    draw = spectrogram_drop_draw(generator, x.shape[0], drop_count, drop_length_low,
                                 drop_length_high, device=x.device)
    return spectrogram_drop_apply(x, *draw, pad_mask, axis=axis, replace=replace)


def time_warp(generator: Optional[torch.Generator], x: torch.Tensor,
              pad_mask: Optional[torch.Tensor] = None, warp_window: int = 5) -> torch.Tensor:
    """SpecAugment time warp, drawn from `generator`."""
    draw = time_warp_draw(generator, x.shape[0], warp_window, device=x.device)
    return time_warp_apply(x, *draw, pad_mask, warp_window)


@dataclass(frozen=True)
class Augmenter:
    """Sequential augmentation with one gate: with probability
    `augment_prob` every augmentation `aug(generator, x, pad_mask)` is
    applied in order, else x is returned (the JAX combinator's semantics)."""

    augmentations: Sequence[Callable] = ()
    augment_prob: float = 1.0

    def __call__(self, generator: Optional[torch.Generator], x: torch.Tensor,
                 pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        apply = torch.rand((), generator=generator, device=x.device) < self.augment_prob
        out = x
        for aug in self.augmentations:
            out = aug(generator, out, pad_mask)
        return torch.where(apply, out, x)


@dataclass(frozen=True)
class SpecAugmentConfig:
    time_drop_length: Tuple[int, int] = (15, 25)
    time_drop_count: int = 4
    freq_drop_length: Tuple[int, int] = (10, 20)
    freq_drop_count: int = 4
    warp_window: int = 5
    replace: str = "mean"
    min_augmentations: int = 3
    max_augmentations: int = 3
    shuffle_augmentations: bool = False


def spec_augment(x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                 config: SpecAugmentConfig = SpecAugmentConfig(),
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """time drop -> freq drop -> time warp (the recipe's Augmenter order)
    with the Augmenter's selection: the first N of the three for N drawn in
    [min, max] (all three for the LibriSpeech recipes), or, shuffled, the
    first N of a random order."""
    b, dev = x.shape[0], x.device
    stages = (
        lambda cur: spectrogram_drop_apply(
            cur, *spectrogram_drop_draw(generator, b, config.time_drop_count,
                                        *config.time_drop_length, device=dev),
            pad_mask, axis=1, replace=config.replace),
        lambda cur: spectrogram_drop_apply(
            cur, *spectrogram_drop_draw(generator, b, config.freq_drop_count,
                                        *config.freq_drop_length, device=dev),
            pad_mask, axis=2, replace=config.replace),
        lambda cur: time_warp_apply(
            cur, *time_warp_draw(generator, b, config.warp_window, device=dev), pad_mask,
            config.warp_window),
    )
    n_lo, n_hi = min(config.min_augmentations, 3), min(config.max_augmentations, 3)
    n = n_lo
    if n_hi > n_lo:
        n = int(torch.randint(n_lo, n_hi + 1, (), generator=generator, device=dev))
    order = list(range(3))
    if config.shuffle_augmentations:
        order = torch.argsort(torch.rand(3, generator=generator, device=dev)).tolist()
    out = x
    for r in range(n):
        out = stages[order[r]](out)
    return out


def speed_perturb_draw(generator: Optional[torch.Generator], batch: int, n_speeds: int,
                       device=None) -> torch.Tensor:
    """The index of each utterance's speed, `[B]`."""
    return torch.randint(0, n_speeds, (batch,), generator=generator, device=device)


def speed_perturb_apply(wav: torch.Tensor, lengths: torch.Tensor, choice: torch.Tensor,
                        speeds: Sequence[int] = (95, 100, 105),
                        num_taps: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample each utterance at its drawn speed by Hann-windowed sinc
    interpolation into the same `[B, N]` buffer: output sample n reads input
    position n·s/100; lengths become ceil(len·100/s), at most N, and the
    samples past them are zeroed."""
    b, n = wav.shape
    f32 = torch.float32
    ratios = torch.tensor([s / 100.0 for s in speeds], dtype=f32, device=wav.device)[choice]
    pos = torch.arange(n, device=wav.device).to(f32)[None, :] * ratios[:, None]
    base = torch.floor(pos).to(torch.long)
    frac = pos - base.to(f32)
    taps = torch.arange(-num_taps // 2 + 1, num_taps // 2 + 1, device=wav.device)
    idx = torch.clamp(base[..., None] + taps[None, None, :], 0, n - 1)
    rel = taps[None, None, :].to(f32) - frac[..., None]
    cutoff = torch.clamp(1.0 / ratios, max=1.0)[:, None, None]
    sinc = cutoff * torch.sinc(cutoff * rel)
    window = 0.5 + 0.5 * torch.cos(math.pi * rel / (num_taps // 2 + 1))
    kernel = sinc * torch.where(rel.abs() <= num_taps // 2, window, torch.zeros_like(window))
    gathered = torch.gather(wav.to(f32), 1, idx.reshape(b, -1)).reshape(b, n, taps.numel())
    out = (gathered * kernel).sum(dim=-1)
    new_len = torch.clamp(torch.ceil(lengths.to(f32) / ratios).to(torch.int32), max=n)
    keep = torch.arange(n, device=wav.device)[None, :] < new_len[:, None]
    return out * keep.to(out.dtype), new_len


def speed_perturb_batch(wav: torch.Tensor, lengths: torch.Tensor,
                        speeds: Sequence[int] = (95, 100, 105), num_taps: int = 16,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-utterance random speed perturbation: `(wav [B, N], lengths [B])`."""
    choice = speed_perturb_draw(generator, wav.shape[0], len(speeds), wav.device)
    return speed_perturb_apply(wav, lengths, choice, speeds, num_taps)
