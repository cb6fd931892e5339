"""Sequence parallelism: the encoder's TIME axis sharded over processes —
the port of `summarymixing_tpu/parallel/sequence.py` on `torch.distributed`.

The SummaryMixing architecture makes this nearly free: the cell's only
global time coupling is the masked mean over T, so with `[B, T, D]`
activations split over a "seq" axis the per-layer traffic is one
`[B, summary_out_dim]` sum and a `[B]` count all-reduced, plus halos of
(K-1)//2 frames for the depthwise convolutions (the cgMLP's K=31: 15
frames each side), O(B·D) per layer whatever T is. Where GSPMD inserts
those collectives itself, here they are explicit: while an encode runs
under `TimeShard.active()`, the modules that couple frames ask
`current()` (`ops/time_shard.py`, per thread) for the shard and

- the masked time means (`ops/summary_mixing.py::masked_time_mean`, the
  plain path of every mode that pools by the mean) sum their numerator
  and count over the shards (`TimeShard.sum_`);
- the full-mode cell on the card runs the kernel's split route
  (`ops/fused_summary.py`: `sm_partial`, the all-reduce, `sm_finish`);
- the cgMLP branch (kernel or plain) and the Conformer's convolution
  module run on their input extended by (K-1)//2 frames from each
  neighbour (`TimeShard.halo`), with the pad mask of those frames, and
  keep their own frames: every operation before the depthwise conv acts
  on one frame at a time, so the result is exact;
- the pad mask and the sine positions come from the global T' and the
  shard's first frame (`models/asr.py`).

Rank r of the seq axis holds feature frames `[r·T/n, (r+1)·T/n)` and
encoder frames `[r·L, (r+1)·L)`, L = ceil(T'/n), T' = ceil(T/4): T' need
not divide by n, so the last shard may run past T' (frames no utterance
reaches, as GSPMD pads internally) and its output is cut to T'. The CNN
frontend runs on a window of features from the neighbours, with
`input_frame_offset` and the global frame count reproducing the whole
stack's zero padding at both ends (`ops/convolution.py`). A layer never
gathers the whole activation: only sums, counts, halos and the final
`[B, T']` ids and marks of the greedy decode cross processes.

Everything that REDUCES over T must be length-masked for the result to be
shard-invariant; the package's multiplicative masks already are. Taken:
the Branchformer and the Conformer with the SummaryMixing cell in full,
lite or fast mode, or the Branchformer's `cnnonly`, offline (not causal,
no Dynamic Chunk Training). Attention mixers and expdecay's `[T, T]`
weights couple every pair of frames and are refused.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from summarymixing_tpu_torch.ops import time_shard
from summarymixing_tpu_torch.parallel import comm
from summarymixing_tpu_torch.parallel.mesh import build_mesh, check_mesh

# the shard of the encode running on this thread, or None outside one
current = time_shard.current


class TimeShard:
    """This process's piece of a time-sharded encode: position `index` of
    `count` on the seq axis (`group`), encoder frames `[start, start +
    local)` of `frames`. The pad mask of the whole `[B, frames]` is set by
    the encoder (`set_pad`) before its layers run."""

    def __init__(self, group, index: int, count: int, frames: int):
        self.group, self.index, self.count, self.frames = group, index, count, frames
        self.local = -(-frames // count)
        self.start = index * self.local
        self.pad: Optional[torch.Tensor] = None

    def active(self):
        """Make this shard current on this thread while the block runs."""
        return time_shard.use(self)

    # -- the pad mask ----------------------------------------------------------
    def window(self, full: torch.Tensor, lo: int = 0, hi: int = 0) -> torch.Tensor:
        """Global frames `[start - lo, start + local + hi)` of `full`
        `[B, frames, ...]`, zeros outside `[0, frames)`."""
        b0, b1 = self.start - lo, self.start + self.local + hi
        lead, tail = max(0, -b0), max(0, b1 - full.shape[1])
        part = full[:, max(b0, 0):min(b1, full.shape[1])]
        if lead or tail:
            shape = list(part.shape)
            part = torch.cat([part.new_zeros([shape[0], lead] + shape[2:]), part,
                              part.new_zeros([shape[0], tail] + shape[2:])], dim=1)
        return part

    def set_pad(self, pad: torch.Tensor) -> torch.Tensor:
        """Keep the whole `[B, frames]` pad mask; return this shard's frames of it."""
        if pad.shape[1] != self.frames:
            raise ValueError(f"pad mask of {pad.shape[1]} frames for a shard of {self.frames}")
        self.pad = pad
        return self.window(pad)

    def pad_window(self, lo: int, hi: int) -> torch.Tensor:
        if self.pad is None:
            raise RuntimeError("the shard's pad mask is set by the encoder before its layers")
        return self.window(self.pad, lo, hi)

    # -- collectives -------------------------------------------------------------
    def sum_(self, *tensors: torch.Tensor):
        """Each tensor summed over the shards (one collective, float32)."""
        if self.count == 1:
            return tensors
        out = comm.sum_tensors(tensors, self.group)
        return tuple(o.to(t.dtype) for o, t in zip(out, tensors))

    def halo(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """`x` `[B, S, ...]` (every shard S frames, consecutive in rank
        order) extended by the `lo` frames before it and the `hi` after it
        from the neighbouring shards; zeros past either end. One
        all-gather of each shard's edges."""
        s = x.shape[1]
        if lo > s or hi > s:
            raise ValueError(f"a halo of {lo} + {hi} frames needs shards of at least that many "
                             f"frames, not {s}: use fewer shards")
        if self.count == 1:
            edges = None
        else:
            send = torch.cat([x[:, :hi], x[:, s - lo:]], dim=1)[None]
            edges = comm.all_gather_rows(send, self.group)
        shape = list(x.shape)
        left = (edges[self.index - 1][:, hi:] if edges is not None and self.index > 0
                else x.new_zeros([shape[0], lo] + shape[2:]))
        right = (edges[self.index + 1][:, :hi] if edges is not None and self.index < self.count - 1
                 else x.new_zeros([shape[0], hi] + shape[2:]))
        return torch.cat([left, x, right], dim=1)

    def gather_time(self, x: torch.Tensor) -> torch.Tensor:
        """`[B, local, ...]` from every shard -> `[B, frames, ...]` in time order."""
        if self.count == 1:
            return x[:, :self.frames]
        parts = comm.all_gather_rows(x.contiguous()[None], self.group)
        return torch.cat(list(parts), dim=1)[:, :self.frames]


def make_seq_mesh(n_data: Optional[int] = None, n_seq: int = 1, n_model: int = 1,
                  devices: Optional[Sequence] = None, device=None):
    """A `("data", "seq", "model")` `DeviceMesh` over every process (one
    device each; `devices`, when given, only counts them). A mesh that
    leaves a device out raises `ValueError`. Processes that differ only
    on the model axis hold the same rows and the same time shard."""
    import torch.distributed as dist

    n_dev = len(devices) if devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if n_data is None:
        n_data = n_dev // (n_seq * n_model)
    check_mesh((n_data, n_seq, n_model), n_dev, f"{n_data}x{n_seq}x{n_model}")
    return build_mesh((n_data, n_seq, n_model), ("data", "seq", "model"), device)


def _check_time_divisible(feats: torch.Tensor, n_seq: int) -> None:
    """Each seq shard holds an equal slice of the features' time axis, and
    zero-padding the features here would NOT be equivalent: extra frames
    shift which conv taps fall on real data at the sequence boundary,
    changing the last valid subsampled frame. Padding to the bucket shape
    belongs upstream (pad the waveform: `recipes/evaluate.py`)."""
    if feats.shape[1] % n_seq:
        raise ValueError(
            f"time axis {feats.shape[1]} is not divisible by the seq mesh "
            f"axis ({n_seq}); pad/bucket features to a multiple upstream "
            "(per-call padding would perturb the boundary frame through "
            "the frontend conv taps)"
        )


def _seq_axis(mesh):
    """(group, index, count) of this process on the mesh's seq axis."""
    dim = mesh.mesh_dim_names.index("seq")
    count = mesh.size(dim)
    if count == 1:
        return None, 0, 1
    return mesh.get_group("seq"), mesh.get_local_rank("seq"), count


def check_shardable(model) -> None:
    """Refuse a recognizer whose encoder couples frames other than by the
    masked mean and the depthwise convolutions (the cell itself refuses
    expdecay and a `sum_mask` on a shard)."""
    asr = model.asr
    if asr.encoder_module not in ("branchformer", "conformer"):
        raise NotImplementedError(f"the time-sharded encode takes the Branchformer and the "
                                  f"Conformer, not {asr.encoder_module!r}")
    if asr.attention_type not in ("SummaryMixing", "cnnonly"):
        raise NotImplementedError(f"the time-sharded encode takes the SummaryMixing cell (or "
                                  f"cnnonly), not {asr.attention_type!r}: attention couples "
                                  "every pair of frames")
    if asr.causal:
        raise NotImplementedError("the time-sharded encode is offline: not causal")


def sharded_frontend(model, feats: torch.Tensor, shard: TimeShard, total: int) -> torch.Tensor:
    """The CNN frontend's output frames `[start, start + local)` from this
    process's features `[B, total/n, F]`: a window of features reaching
    the frontend's receptive field past both ends (from the neighbours,
    zeros past the stream), run with its global offset and frame count,
    then cut to the shard's frames."""
    strides = model.frontend_strides
    r = 1
    reach = 0
    for i, s in enumerate(strides):
        reach += getattr(model.cnn, f"conv_{i}").padding[0] * r
        r *= s
    ext = -(-reach // r) * r          # a multiple of the total stride
    per = total // shard.count
    lo_of = [q * per - (q * shard.local * r - ext) for q in range(shard.count)]
    hi_of = [(q + 1) * shard.local * r + ext - (q + 1) * per for q in range(shard.count)]
    lo, hi = max(max(lo_of), 0), max(max(hi_of), 0)
    wide = shard.halo(feats, lo, hi)
    first = lo - lo_of[shard.index]
    window = wide[:, first:first + shard.local * r + 2 * ext]
    out = model.frontend(window, shard.start * r - ext, input_frame_count=total)
    return out[:, ext // r:ext // r + shard.local]


def _encode(model, feats: torch.Tensor, feat_lengths: torch.Tensor, shard_of):
    """Shared body: (shard, local encoder output `[B, local, D]`,
    enc_lengths) from the whole features, of which this process takes its
    slice."""
    group, index, count = shard_of
    _check_time_divisible(feats, count)
    total = feats.shape[1]
    per = total // count
    frames = int(model.subsampled_length(torch.tensor([total]))[0])
    shard = TimeShard(group, index, count, frames)
    out_len = model.subsampled_length(feat_lengths)
    with shard.active():
        x = sharded_frontend(model, feats[:, index * per:(index + 1) * per], shard, total)
        wav_len_rel = out_len.to(torch.float32) / frames
        enc = model.asr.encode(x, wav_len_rel)
    return shard, enc, out_len


def sequence_parallel_encode(model, mesh):
    """`model.encode` with the time axis sharded over the mesh's "seq" axis.

    Returns fn(feats [B, T, n_mels], feat_lengths [B]) -> (enc_out
    [B, T'_r, d], enc_lengths [B]): every process of the seq axis calls it
    with the same features and keeps only its slice of them (rank r:
    frames [r·T/n, (r+1)·T/n)); enc_out holds its encoder frames
    [r·L, r·L + T'_r), T'_r = L but the last shard's cut to T'. T must be
    a multiple of the axis size (`_check_time_divisible`)."""
    check_shardable(model)
    axis = _seq_axis(mesh)

    @torch.no_grad()
    def call(feats, feat_lengths):
        shard, enc, out_len = _encode(model, feats, feat_lengths, axis)
        return enc[:, :max(0, min(shard.local, shard.frames - shard.start))], out_len

    return call


def sequence_parallel_ctc_decode(model, mesh, blank_id: int = 0):
    """Greedy-CTC decode (encode, CTC head, greedy marks) with the whole
    graph time-sharded: the per-frame argmax and the collapse marks (a
    one-frame shifted compare: one halo frame from the left) run on the
    shards, and only the `[B, T']` ids and marks are gathered.

    Returns fn(feats [B, T, n_mels], feat_lengths [B]) -> (ids [B, T'],
    keep [B, T'], enc_lengths [B]) on every process of the seq axis — the
    `decoding.ctc` greedy contract; `decoding.ctc.collapse_ctc` gives the
    token lists."""
    check_shardable(model)
    axis = _seq_axis(mesh)

    @torch.no_grad()
    def call(feats, feat_lengths):
        shard, enc, out_len = _encode(model, feats, feat_lengths, axis)
        ids = model.ctc_head(enc).argmax(dim=-1)
        prev = shard.halo(ids, 1, 0)[:, :shard.local]
        pos = shard.start + torch.arange(shard.local, device=ids.device)
        if shard.index == 0:
            prev[:, 0] = -1
        valid = pos[None, :] < out_len[:, None]
        keep = (ids != blank_id) & (ids != prev) & valid
        return shard.gather_time(ids), shard.gather_time(keep), out_len

    return call
