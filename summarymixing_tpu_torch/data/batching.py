"""Length-bucketed batching with padded shapes per bucket — the port's
copy of `summarymixing_tpu/data/batching.py`, the replacement for the
reference's DynamicBatchSampler (branchformer yaml:75-95: duration
bucketing, max_batch_length 500 s, num_buckets 200, max_batch_ex 128).

Each bucket has a fixed (batch_size, max_len), and batch size scales
inversely with length to keep the audio per batch near the reference's
duration budget. The JAX package needs the fixed shapes so that XLA
compiles once per bucket; the port keeps them so that both packages draw
the same batches from the same seed, and so that the card sees few
shapes (the library kernels pick their algorithms per shape). The
runners pass the process count as `batch_multiple`
(`recipes/common.py::build_buckets`), 1 in one process."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class BucketSpec:
    max_len: int       # padded length (samples or frames)
    batch_size: int    # fixed examples per batch


def quantize_len(n: int, grid_ratio: float = 1.1, base: int = 4000) -> int:
    """Round a length UP to a corpus-independent geometric grid
    (base * grid_ratio^k). Bucket boundaries derived from a manifest's own
    min/max lengths shift whenever the manifest changes (a subset, a new
    split, next week's crawl) — and every shifted boundary is a fresh
    train-step shape, i.e. a fresh 90 s – 12 min XLA compile. Snapping
    boundaries to this fixed grid makes bucket shapes a function of the
    grid alone, so any two manifests drawn from the same corpus family
    reuse each other's compiled programs (persistent compile cache)."""
    if n <= base:
        return base
    import math

    k = math.ceil(math.log(n / base) / math.log(grid_ratio))
    # float log can land one notch high when n sits exactly on a grid
    # point (grid points are the CEIL of base*ratio^k, so compare ceils)
    while k > 0 and math.ceil(base * grid_ratio ** (k - 1)) >= n:
        k -= 1
    return int(math.ceil(base * grid_ratio**k))


def make_buckets(
    max_batch_length: float,
    num_buckets: int,
    min_len: int,
    max_len: int,
    max_batch_size: int = 128,
    batch_multiple: int = 1,
    growth: str = "exp",
    quantize: bool = False,
) -> List[BucketSpec]:
    """Build bucket boundaries. max_batch_length is the per-batch length
    budget in the same unit as len (the reference's seconds-of-audio budget);
    batch_size = clamp(budget / bucket_len, 1, max_batch_size), rounded down
    to a multiple of `batch_multiple` (e.g. the data-parallel mesh size).
    quantize=True snaps every boundary (and min/max) to the fixed
    geometric grid of `quantize_len`, trading ≤10% extra padding for
    manifest-independent compile shapes."""
    specs = []
    if quantize:
        min_len = quantize_len(min_len)
        max_len = max(quantize_len(max_len), min_len)
    if growth == "exp":
        ratio = (max_len / min_len) ** (1.0 / num_buckets)
        bounds = [int(round(min_len * ratio ** i)) for i in range(1, num_buckets + 1)]
    else:
        step = (max_len - min_len) / num_buckets
        bounds = [int(round(min_len + step * i)) for i in range(1, num_buckets + 1)]
    if quantize:
        bounds = [quantize_len(b) for b in bounds]
    seen = set()
    for b in bounds:
        b = max(b, min_len)
        if b in seen:
            continue
        seen.add(b)
        bs = int(max_batch_length // b)
        bs = max(1, min(bs, max_batch_size))
        if batch_multiple > 1:
            rounded = (bs // batch_multiple) * batch_multiple
            if rounded == 0:
                # the mesh divisibility floor exceeds the length budget:
                # the bump is unavoidable (batches must split over the
                # devices) but must not be silent — the longest bucket's
                # batch is then up to batch_multiple/bs times the
                # configured memory budget
                print(f"WARNING: bucket max_len={b} needs batch "
                      f"{batch_multiple} (device multiple) but the "
                      f"max_batch_length budget only allows {bs}; this "
                      f"bucket exceeds the budget "
                      f"{batch_multiple * b / max_batch_length:.1f}x")
                rounded = batch_multiple
            bs = rounded
        specs.append(BucketSpec(max_len=b, batch_size=bs))
    return specs


def pad_batch(
    arrays: Sequence[np.ndarray], max_len: int, pad_value: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length 1-D/2-D arrays into [B, max_len, ...] + lengths."""
    b = len(arrays)
    lengths = np.array([min(len(a), max_len) for a in arrays], np.int32)
    trailing = arrays[0].shape[1:]
    out = np.full((b, max_len) + trailing, pad_value, arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : lengths[i]] = a[:max_len]
    return out, lengths


class DynamicBucketBatcher:
    """Groups (index, length) pairs into fixed-shape batches.

    Yields (bucket_spec, indices) where len(indices) == spec.batch_size
    (short final groups are dropped in training, padded by repetition in
    eval). Shuffles within buckets per epoch with a seeded RNG."""

    def __init__(
        self,
        lengths: Sequence[int],
        buckets: List[BucketSpec],
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.lengths = np.asarray(lengths)
        self.buckets = sorted(buckets, key=lambda s: s.max_len)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        bounds = np.array([s.max_len for s in self.buckets])
        self.assignment = np.searchsorted(bounds, self.lengths, side="left")
        self.assignment = np.minimum(self.assignment, len(self.buckets) - 1)
        self._epoch = 0

    def __iter__(self) -> Iterator[Tuple[BucketSpec, np.ndarray]]:
        # fresh shuffle each epoch (each __iter__ call advances the stream,
        # like the reference's shuffle_ex re-batching)
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += int(self.shuffle)
        batches = []
        for bi, spec in enumerate(self.buckets):
            idx = np.where(self.assignment == bi)[0]
            if len(idx) == 0:
                continue
            if self.shuffle:
                rng.shuffle(idx)
            bs = spec.batch_size
            n_full = len(idx) // bs
            for k in range(n_full):
                batches.append((spec, idx[k * bs : (k + 1) * bs]))
            rem = idx[n_full * bs :]
            if len(rem) and not self.drop_last:
                # pad the tail batch to the fixed size by repetition
                # (idx is non-empty here: empty buckets continue above)
                fill = rng.choice(idx, bs - len(rem))
                batches.append((spec, np.concatenate([rem, fill])))
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        yield from batches

    def num_batches(self) -> int:
        n = 0
        for bi, spec in enumerate(self.buckets):
            cnt = int((self.assignment == bi).sum())
            full, rem = divmod(cnt, spec.batch_size)
            n += full + (0 if self.drop_last or rem == 0 else 1)
        return n


def prefetch(iterator: Iterable, size: int = 2) -> Iterator:
    """Run `iterator` in a background thread, keeping up to `size` items
    ready — overlaps host-side batch assembly (wav decode, padding,
    tokenisation) with device compute, the role of the reference's
    num_workers DataLoader (branchformer yaml:98-101). Exceptions are
    re-raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not _put(item):
                    return      # consumer gone — drop batches, free memory
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            _put(("__prefetch_error__", e))
        finally:
            _put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] == "__prefetch_error__":
                raise item[1]
            yield item
    finally:
        # consumer exited (break / exception / close): release the producer,
        # which would otherwise block in q.put forever pinning device-array
        # batches for the rest of the process
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
