"""Online serving: a dynamic batcher for transcription requests and a
session server for live streams — the port of `summarymixing_tpu/serving.py`.

`DynamicBatchingServer`: requests queue up; a worker thread forms a batch
when `batch_size` requests wait or the oldest has waited `max_wait_ms`,
pads the audio up to the smallest of a few bucket lengths (so the card
sees a bounded set of shapes, and the hand-written kernels run at those
shapes), fills the empty rows by repeating row 0, and calls
`infer(wav [B, N], lens [B]) -> list[str]`. Callers block on their request
and get its text, or the batch's error as `RequestError`.

`StreamingSessionServer`: live streams share the S rows of one chunked
streaming step (`streaming.make_streaming_infer_fns`). Each tick packs at
most one pending chunk per slot, feeds zero chunks to idle slots, steps
all S rows once, and keeps the idle rows' carry as it was (a per-row
select over the carry, `streaming._select`); a slot given to a new stream
is reset to a fresh `init_fn` row before its first chunk.

Both run the model on their worker thread. Autograd's mode and the
current CUDA device are per thread, so the worker enters
`torch.inference_mode()` and, given a CUDA `device`, makes it current; the
callers' threads (an HTTP server's handlers) only enqueue work.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from summarymixing_tpu_torch.streaming import _select, carry_tensors

__all__ = ["ServingConfig", "DynamicBatchingServer", "RequestError", "StreamingSessionServer"]


class RequestError(RuntimeError):
    """Raised to the caller when its batch failed in inference."""


@dataclass
class ServingConfig:
    batch_size: int = 8            # requests per device batch
    max_wait_ms: float = 20.0      # the oldest request waits at most this
    sample_rate: int = 16000
    pad_quantum_s: float = 0.5     # audio above the last edge is padded to this grid
    max_audio_s: float = 120.0     # per-request cap
    # bucket edges in seconds: a batch is padded up to the smallest that fits
    bucket_edges_s: Sequence[float] = (5.0, 10.0, 20.0, 40.0, 120.0)


@dataclass
class _Pending:
    audio: np.ndarray
    t_enqueue: float
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[str] = None
    error: Optional[BaseException] = None


@contextlib.contextmanager
def _worker_context(device: Optional[torch.device]):
    """What a model thread needs: inference mode, and the CUDA device current."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.inference_mode())
        if device is not None and torch.device(device).type == "cuda":
            stack.enter_context(torch.cuda.device(device))
        yield


class DynamicBatchingServer:
    """Threaded dynamic batcher over a batch transcription callable. Given a
    CUDA `device`, the worker makes it current before calling `infer`."""

    def __init__(self, infer: Callable[[np.ndarray, np.ndarray], List[str]],
                 config: Optional[ServingConfig] = None, device=None):
        self.infer = infer
        self.cfg = config or ServingConfig()
        self.device = device
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._lock = threading.Lock()
        # stats over the most recent window, not the process lifetime
        self._latencies_ms: deque = deque(maxlen=10000)
        self._batch_sizes: deque = deque(maxlen=10000)
        self._served = 0
        self._errors = 0
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True, name="serving-batcher")
        self._worker.start()

    # -- caller side --------------------------------------------------------

    def submit(self, audio: np.ndarray, timeout: Optional[float] = None) -> str:
        """Blocking transcription of one float32 [-1, 1] mono utterance."""
        if self._closed:
            raise RuntimeError("server is closed")
        audio = np.asarray(audio, np.float32).reshape(-1)
        if audio.shape[0] == 0:
            raise ValueError("empty audio")
        if audio.shape[0] > int(self.cfg.max_audio_s * self.cfg.sample_rate):
            raise ValueError(f"audio longer than max_audio_s={self.cfg.max_audio_s}")
        req = _Pending(audio=audio, t_enqueue=time.monotonic())
        # the closed check and the put share close()'s lock: a request put
        # after close() drained the queue would never be answered
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("transcription timed out")
        if req.error is not None:
            raise RequestError(str(req.error)) from req.error
        return req.result  # type: ignore[return-value]

    # -- worker side --------------------------------------------------------

    def _collect(self) -> List[_Pending]:
        """Block for the first request, then gather until the batch is full
        or the first request's deadline passes. Past the deadline (the
        worker was busy) everything already queued is still taken, so a
        backlog drains in full batches."""
        try:
            first = self._queue.get(timeout=0.2)
        except queue.Empty:
            return []
        batch = [first]
        deadline = first.t_enqueue + self.cfg.max_wait_ms / 1000.0
        while len(batch) < self.cfg.batch_size:
            remaining = deadline - time.monotonic()
            try:
                batch.append(self._queue.get(timeout=remaining) if remaining > 0
                             else self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def bucket_len(self, n_samples: int) -> int:
        """The padded length of a batch whose longest request has `n_samples`."""
        for edge_s in self.cfg.bucket_edges_s:
            edge = int(edge_s * self.cfg.sample_rate)
            if n_samples <= edge:
                return edge
        quantum = int(self.cfg.pad_quantum_s * self.cfg.sample_rate)
        return -(-n_samples // quantum) * quantum

    def form_batch(self, audios: Sequence[np.ndarray]):
        """`(wav [batch_size, N], lens [batch_size])` as the worker gives them
        to `infer`: N the bucket length, rows past the requests repeat row 0."""
        n = self.bucket_len(max(len(a) for a in audios))
        wav = np.zeros((self.cfg.batch_size, n), np.float32)
        lens = np.zeros((self.cfg.batch_size,), np.int32)
        for i in range(self.cfg.batch_size):
            a = audios[i] if i < len(audios) else audios[0]
            wav[i, :len(a)] = a
            lens[i] = len(a)
        return wav, lens

    def _run(self) -> None:
        with _worker_context(self.device):
            while not self._closed:
                batch = self._collect()
                if batch:
                    self._serve(batch)

    def _serve(self, batch: List[_Pending]) -> None:
        # the whole tick is guarded, batch assembly included: an exception
        # outside it would end the worker and strand the callers
        try:
            texts = self.infer(*self.form_batch([r.audio for r in batch]))
            now = time.monotonic()
            with self._lock:
                self._batch_sizes.append(len(batch))
                for i, r in enumerate(batch):
                    r.result = texts[i]
                    self._latencies_ms.append((now - r.t_enqueue) * 1000.0)
                    self._served += 1
        except Exception as e:  # every caller of the batch gets the error
            with self._lock:
                self._errors += len(batch)
            for r in batch:
                r.error = e
        finally:
            for r in batch:
                r.event.set()

    # -- ops ----------------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies_ms)
            bs = self._batch_sizes
            return {
                "served": self._served,
                "errors": self._errors,
                "p50_ms": round(lat[len(lat) // 2], 2) if lat else None,
                "p95_ms": round(lat[int(len(lat) * 0.95)], 2) if lat else None,
                "mean_batch": round(float(np.mean(bs)), 2) if bs else None,
            }

    def close(self) -> None:
        with self._lock:   # pairs with submit()'s check-and-put
            self._closed = True
        self._worker.join(timeout=10.0)
        while True:   # fail the stragglers
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            r.error = RuntimeError("server closed")
            r.event.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@dataclass
class _Session:
    slot: int
    gen: int                             # the slot's generation when it was opened
    residual: np.ndarray                 # buffered audio shorter than a chunk
    lock: threading.Lock = field(default_factory=threading.Lock)
    tokens: List[int] = field(default_factory=list)
    closed: bool = False
    last_active: float = field(default_factory=time.monotonic)
    inflight: int = 0                    # chunk jobs queued or awaited


@dataclass
class _ChunkJob:
    slot: int
    gen: int                             # dropped if the slot was given to another stream
    chunk: np.ndarray                    # [chunk_samples] float32
    n_valid: int
    event: threading.Event = field(default_factory=threading.Event)
    tokens: Optional[List[int]] = None
    error: Optional[BaseException] = None


class StreamingSessionServer:
    """Multiplex live audio streams onto `slots` rows of one streaming step.

    `init_fn(batch) -> carry` and `step_fn(carry, wav [S, chunk], n_valid [S])
    -> (carry, tokens [S, U], n_new [S])` are those of
    `streaming.make_streaming_infer_fns`; every piece of the carry is per
    row, so streams at different positions share it. Sessions buffer
    sub-chunk audio on the host; `feed` blocks until the chunks it
    completes are decoded and returns their tokens (one chunk behind the
    audio); `close` flushes the residual and the pipeline lag and frees
    the slot."""

    def __init__(self, init_fn, step_fn, chunk_samples: int, slots: int = 8,
                 max_wait_ms: float = 10.0, idle_timeout_s: float = 300.0):
        self.chunk_samples = int(chunk_samples)
        self.slots = slots
        self.max_wait_ms = max_wait_ms
        self.idle_timeout_s = idle_timeout_s
        self._step_fn = step_fn
        with torch.inference_mode():
            self._template = init_fn(slots)
        self._carry = self._template
        self.device = carry_tensors(self._template)[0].device

        self._sessions: Dict[str, _Session] = {}
        # transcripts of closed or evicted streams stay answerable (bounded)
        self._finished: "OrderedDict[str, List[int]]" = OrderedDict()
        self._finished_cap = 256
        self._free = list(range(slots))
        self._gens = [0] * slots   # bumped on every reallocation: stale jobs are dropped
        self._lock = threading.Lock()
        self._queue: "queue.Queue[_ChunkJob]" = queue.Queue()
        # slots awaiting a fresh carry row, applied by the worker between
        # collect and step (a caller-side reset could race the step in flight)
        self._pending_resets: set = set()
        self._ticks = 0
        self._ready_counts: deque = deque(maxlen=10000)
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True, name="streaming-sessions")
        self._worker.start()

    # -- the per-row step ---------------------------------------------------

    def masked_step(self, carry, wav: torch.Tensor, n_valid: torch.Tensor,
                    ready: torch.Tensor):
        """One step of every row; the rows not `ready` keep their carry and
        emit nothing."""
        new_carry, toks, n_new = self._step_fn(carry, wav, n_valid)
        return (_select(ready, new_carry, carry), torch.where(ready[:, None], toks, 0),
                torch.where(ready, n_new, 0))

    def reset_rows(self, carry, mask: torch.Tensor):
        """`carry` with the rows of `mask` set to a fresh `init_fn` row."""
        return _select(mask, self._template, carry)

    # -- caller side ----------------------------------------------------------

    def _evict_idle_locked(self) -> None:
        """Free the sessions idle past `idle_timeout_s` (clients that vanished
        mid-stream). A session waiting on work in flight is not idle. The
        caller holds the lock; the generation bump drops queued jobs."""
        now = time.monotonic()
        for sid, s in list(self._sessions.items()):
            if s.inflight == 0 and now - s.last_active > self.idle_timeout_s:
                s.closed = True
                del self._sessions[sid]
                self._record_finished_locked(sid, s)
                self._gens[s.slot] += 1
                self._free.append(s.slot)

    def _record_finished_locked(self, sid: str, sess: _Session) -> None:
        self._finished[sid] = list(sess.tokens)
        while len(self._finished) > self._finished_cap:
            self._finished.popitem(last=False)

    def open(self) -> str:
        """Allocate a slot for a new stream; returns the session id."""
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if not self._free:
                self._evict_idle_locked()
            if not self._free:
                raise RuntimeError(f"all {self.slots} stream slots busy")
            slot = self._free.pop()
            self._gens[slot] += 1
            sid = uuid.uuid4().hex[:12]
            self._sessions[sid] = _Session(slot=slot, gen=self._gens[slot],
                                           residual=np.zeros((0,), np.float32))
            self._pending_resets.add(slot)
        return sid

    def _session(self, sid: str) -> _Session:
        with self._lock:
            s = self._sessions.get(sid)
        if s is None or s.closed:
            raise KeyError(f"unknown or closed session {sid!r}")
        return s

    def _submit_chunks(self, sess: _Session, chunks: List[_ChunkJob],
                       timeout: float) -> List[int]:
        out: List[int] = []
        # in flight before queueing: the evictor never sees queued work as idle
        sess.inflight = len(chunks)
        try:
            for job in chunks:
                self._queue.put(job)
            for job in chunks:
                if not job.event.wait(timeout):
                    raise TimeoutError("streaming step timed out")
                if job.error is not None:
                    raise RequestError(str(job.error)) from job.error
                # recorded per completed job: if a later chunk fails, the
                # carry has consumed the earlier ones and their tokens stay
                out.extend(job.tokens)
                sess.tokens.extend(job.tokens)
                sess.last_active = time.monotonic()
                sess.inflight -= 1
        finally:
            sess.inflight = 0
        return out

    def feed(self, sid: str, audio: np.ndarray, timeout: float = 120.0) -> List[int]:
        """Append audio to the stream; returns the tokens decoded by the
        chunks this audio completed (output lags input by one chunk)."""
        sess = self._session(sid)
        audio = np.asarray(audio, np.float32).reshape(-1)
        cs = self.chunk_samples
        with sess.lock:
            if sess.closed:   # a concurrent close() may have freed the slot
                raise KeyError(f"session {sid!r} closed concurrently")
            sess.last_active = time.monotonic()
            buf = np.concatenate([sess.residual, audio])
            jobs = []
            while len(buf) >= cs:
                jobs.append(_ChunkJob(slot=sess.slot, gen=sess.gen, chunk=buf[:cs], n_valid=cs))
                buf = buf[cs:]
            sess.residual = buf
            return self._submit_chunks(sess, jobs, timeout)

    def close(self, sid: str, timeout: float = 120.0) -> List[int]:
        """Flush the stream (its residual, then two zero chunks: the pipeline
        lag, and the encoder frame past a stream of whole chunks, as
        `streaming.run_stream` does), free the slot, return the tokens the
        flush decoded."""
        sess = self._session(sid)
        cs = self.chunk_samples
        try:
            with sess.lock:
                if sess.closed:
                    raise KeyError(f"session {sid!r} closed concurrently")
                # closed inside the flush's critical section: a feed() waiting
                # on the lock sees it when it wakes
                sess.closed = True
                jobs = []
                if len(sess.residual):
                    chunk = np.zeros((cs,), np.float32)
                    chunk[:len(sess.residual)] = sess.residual
                    jobs.append(_ChunkJob(slot=sess.slot, gen=sess.gen, chunk=chunk,
                                          n_valid=len(sess.residual)))
                    sess.residual = np.zeros((0,), np.float32)
                for _ in range(2):
                    jobs.append(_ChunkJob(slot=sess.slot, gen=sess.gen,
                                          chunk=np.zeros((cs,), np.float32), n_valid=0))
                return self._submit_chunks(sess, jobs, timeout)
        finally:
            # the slot is freed even if the flush failed: the generation bump
            # drops queued jobs and the next open() resets the row
            with self._lock:
                if self._sessions.pop(sid, None) is not None:
                    self._record_finished_locked(sid, sess)
                    self._gens[sess.slot] += 1
                    self._free.append(sess.slot)

    def tokens(self, sid: str) -> List[int]:
        """Every token decoded for a stream so far: live, closed or evicted."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None and sid in self._finished:
                return list(self._finished[sid])
        if s is None or s.closed:
            raise KeyError(f"unknown or closed session {sid!r}")
        return list(s.tokens)

    def active_ids(self) -> set:
        with self._lock:
            return set(self._sessions)

    # -- worker side ----------------------------------------------------------

    def _collect(self) -> Dict[int, _ChunkJob]:
        """At most one job per slot per tick (a stream's chunks are
        sequential); waits briefly to pack more slots into the tick."""
        try:
            first = self._queue.get(timeout=0.2)
        except queue.Empty:
            return {}
        picked = {first.slot: first}
        leftover = []
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(picked) < self.slots:
            remaining = deadline - time.monotonic()
            try:
                job = (self._queue.get(timeout=remaining) if remaining > 0
                       else self._queue.get_nowait())
            except queue.Empty:
                break
            if job.slot in picked:
                leftover.append(job)   # the same stream: next tick
            else:
                picked[job.slot] = job
        for job in leftover:
            self._queue.put(job)
        return picked

    def _run(self) -> None:
        with _worker_context(self.device):
            while not self._closed:
                picked = self._collect()
                if picked:
                    self._tick(picked)

    def _tick(self, picked: Dict[int, _ChunkJob]) -> None:
        # the whole tick is guarded: every picked job is answered
        resets, resets_applied = set(), False
        try:
            # one critical section for the stale check and the reset snapshot:
            # split, an evict-and-reopen between them could hand a dead
            # session's job the new session's reset
            with self._lock:
                stale = {slot: job for slot, job in picked.items()
                         if job.gen != self._gens[slot]}
                resets, self._pending_resets = self._pending_resets, set()
            for slot, job in stale.items():
                del picked[slot]
                job.error = RuntimeError("session closed or evicted")
                job.event.set()
            if not picked:
                with self._lock:   # keep the resets for the next tick
                    self._pending_resets |= resets
                return
            wav = np.zeros((self.slots, self.chunk_samples), np.float32)
            nv = np.zeros((self.slots,), np.int64)
            ready = np.zeros((self.slots,), bool)
            for slot, job in picked.items():
                wav[slot], nv[slot], ready[slot] = job.chunk, job.n_valid, True
            if resets:
                mask = np.zeros((self.slots,), bool)
                mask[list(resets)] = True
                self._carry = self.reset_rows(self._carry,
                                              torch.from_numpy(mask).to(self.device))
            resets_applied = True
            carry, toks, n_new = self.masked_step(
                self._carry, torch.from_numpy(wav).to(self.device),
                torch.from_numpy(nv).to(self.device), torch.from_numpy(ready).to(self.device))
            toks, n_new = toks.cpu().numpy(), n_new.cpu().numpy()
            with self._lock:
                self._carry = carry
                self._ticks += 1
                self._ready_counts.append(len(picked))
            for slot, job in picked.items():
                job.tokens = [int(t) for t in toks[slot, :n_new[slot]]]
        except Exception as e:
            for job in picked.values():
                job.error = e
            if resets and not resets_applied:
                with self._lock:   # a new session's reset must not be lost
                    self._pending_resets |= resets
        finally:
            for job in picked.values():
                job.event.set()

    def stats(self) -> dict:
        with self._lock:
            rc = self._ready_counts
            return {
                "slots": self.slots,
                "active_sessions": len(self._sessions),
                "ticks": self._ticks,
                "mean_ready_per_tick": round(float(np.mean(rc)), 2) if rc else None,
            }

    def shutdown(self) -> None:
        self._closed = True
        self._worker.join(timeout=10.0)
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            job.error = RuntimeError("server closed")
            job.event.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
