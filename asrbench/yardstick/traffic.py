"""The one traffic generator: reads a mix file (`asrbench/traffic/<mix>.json`)
and makes the run's pool of batches on the device from the seed.

A mix file gives:

- `entry`: the module under `entries/` that drives the cell;
- `utterances`: how many utterances the pool holds;
- `lengths`: `{"kind": "gamma", "mean_s", "shape", "min_s", "max_s"}` or
  `{"kind": "uniform", "min_s", "max_s"}`, drawn from `length_seed` (fixed in
  the file, so every run seed gets the same set of shapes, in another order);
- `batching`: `{"max_batch_s", "max_rows"}`: utterances sorted by length and
  cut into consecutive batches whose padded audio (rows x longest) stays
  within `max_batch_s` and whose rows stay within `max_rows`;
- `pad_quantum_s`: each batch's sample count rounded up to this;
- `tokens_per_s` (a mix of training batches): target tokens per second of
  audio, drawn uniformly from the vocabulary without the blank/pad, BOS and
  EOS ids; a mix without it makes no targets;
- `tiny`: the keys that the mix's small form replaces, for the benchmark's
  CPU tests (`asrbench/tests/tiny.py`); no run of the benchmark reads it.

The run seed draws the audio, the targets and the order in which the window
cycles through the pool. Audio is a voiced signal (a few harmonics of a
drifting pitch under a slow envelope) plus noise, zero past each length.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
SAMPLE_RATE = 16000


def load_mix(name: str, root: Path = HERE) -> Dict:
    """`<root>/traffic/<name>.json`; `root` is the benchmark's folder."""
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def utterance_lengths(mix: Dict, stream: int = 0) -> np.ndarray:
    """Seconds per utterance, from the mix's fixed `length_seed` (and `stream`,
    a process index: each process of a multi-chip cell has its own set)."""
    rng = np.random.default_rng([mix["length_seed"], stream])
    spec, n = mix["lengths"], mix["utterances"]
    if spec["kind"] == "gamma":
        x = rng.gamma(spec["shape"], spec["mean_s"] / spec["shape"], n)
    elif spec["kind"] == "uniform":
        x = rng.uniform(spec["min_s"], spec["max_s"], n)
    else:
        raise ValueError(f"unknown length kind {spec['kind']!r}")
    return np.clip(x, spec["min_s"], spec["max_s"])


def dynamic_batches(lengths: np.ndarray, max_batch_s: float, max_rows: int) -> List[List[int]]:
    """Indices sorted by length, cut so that rows x longest <= max_batch_s and
    rows <= max_rows."""
    order = np.argsort(lengths, kind="stable")
    batches, cur = [], []
    for i in order:
        if cur and ((len(cur) + 1) * lengths[i] > max_batch_s or len(cur) == max_rows):
            batches.append(cur)
            cur = []
        cur.append(int(i))
    if cur:
        batches.append(cur)
    return batches


@dataclass
class Batch:
    wav: torch.Tensor            # [B, N] float32 on the device
    wav_lens: torch.Tensor       # [B] int32 samples
    audio_s: float               # seconds of audio (unpadded)
    tokens: Optional[torch.Tensor] = None       # [B, U] int64, 0-padded
    token_lens: Optional[torch.Tensor] = None   # [B] int64


def synth_audio(n_rows: int, n: int, lens: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    dev = lens.device
    t = torch.arange(n, device=dev, dtype=torch.float32)[None] / SAMPLE_RATE
    u = torch.rand(n_rows, 6, generator=gen, device=dev)
    f0 = 90.0 + 160.0 * u[:, 0:1]
    drift = 1.0 + 0.1 * torch.sin(2 * math.pi * (0.2 + 0.5 * u[:, 1:2]) * t)
    phase = 2 * math.pi * f0 * drift * t
    voiced = sum(torch.sin(k * phase + 6.28 * u[:, k + 1:k + 2]) / k for k in range(1, 5))
    env = 0.5 * (1.0 + torch.sin(2 * math.pi * (1.5 + 2.0 * u[:, 5:6]) * t))
    noise = torch.randn(n_rows, n, generator=gen, device=dev)
    wav = 0.1 * env * voiced + 0.01 * noise
    return wav * (torch.arange(n, device=dev)[None] < lens[:, None]).float()


def make_pool(mix: Dict, seed: int, device, vocab: int = 0, stream: int = 0) -> List[Batch]:
    """The pool of batches of `mix`, made on `device` from `seed`."""
    lengths = utterance_lengths(mix, stream)
    b = mix["batching"]
    groups = dynamic_batches(lengths, b["max_batch_s"], b["max_rows"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    quantum = int(round(mix["pad_quantum_s"] * SAMPLE_RATE))
    pool = []
    for g in groups:
        samples = [int(round(lengths[i] * SAMPLE_RATE)) for i in g]
        n = -(-max(samples) // quantum) * quantum
        lens = torch.tensor(samples, dtype=torch.int32, device=device)
        batch = Batch(synth_audio(len(g), n, lens, gen), lens, sum(samples) / SAMPLE_RATE)
        if "tokens_per_s" in mix:
            tl = [max(1, int(round(lengths[i] * mix["tokens_per_s"]))) for i in g]
            toks = torch.randint(3, vocab, (len(g), max(tl)), generator=gen, device=device)
            tl_t = torch.tensor(tl, dtype=torch.int64, device=device)
            valid = torch.arange(max(tl), device=device)[None] < tl_t[:, None]
            batch.tokens, batch.token_lens = toks * valid, tl_t
        pool.append(batch)
    return pool


def cycle_order(n: int, seed: int, cycles: int) -> List[int]:
    """The window's order over the pool: a fresh permutation per cycle."""
    rng = np.random.default_rng([seed, 7])
    return [int(i) for _ in range(cycles) for i in rng.permutation(n)]
