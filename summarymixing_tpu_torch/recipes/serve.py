"""HTTP transcription server over a trained run — the port of the JAX
package's `recipes/serve.py`.

    python -m summarymixing_tpu_torch.recipes.serve RECIPE.yaml --ckpt RUN_DIR/save \\
        [--avg 10] [--host 127.0.0.1] [--port 8080] [--batch-size 8] [--max-wait-ms 20] \\
        [--warmup] [--streaming --chunk-frames 16 --left-context 4] [--set KEY=VALUE] \\
        [--device cpu]

Endpoints, with the dynamic batcher of `serving.DynamicBatchingServer`
(concurrent requests share batches of `--batch-size`, padded to the bucket
edges of `serving.ServingConfig`):

  GET  /healthz      -> {"ok": true}
  GET  /stats        -> the batcher's latency and batch statistics
  POST /transcribe   -> body: WAV or FLAC bytes; reply {"text": ...}

With `--streaming` (transducer recipes), live streams instead, on the
slots of `serving.StreamingSessionServer` over `streaming.py`'s chunked
pipeline (`--batch-size` slots):

  POST /stream/start        -> {"id": ...}
  POST /stream/<id>         -> body: an audio chunk (a WAV or FLAC file, or
                               raw float32 PCM); reply {"text_delta", "text", "tokens"}
  POST /stream/<id>/end     -> flush and free the slot; the final {"text", ...}

A malformed body gets HTTP 400, an unknown session 404. The handler
threads only decode the body and enqueue work; the model runs on the
servers' worker threads.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from summarymixing_tpu_torch.config import load_recipe
from summarymixing_tpu_torch.data.dataio import load_audio_bytes
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.recipes.evaluate import resolve_tokenizer, run_dir_of
from summarymixing_tpu_torch.serving import (
    DynamicBatchingServer,
    ServingConfig,
    StreamingSessionServer,
)
from summarymixing_tpu_torch.streaming import make_streaming_infer_fns
from summarymixing_tpu_torch.transcribe import greedy_ctc_decode, transducer_greedy_transcribe
from summarymixing_tpu_torch.utils.device import resolve_device

# a ValueError covers every malformed client body (HTTP 400)
decode_audio_bytes = load_audio_bytes


def build_infer(cfg, ckpt_dir: str, avg: int, device):
    """`(infer, tokenizer)` of a trained run: infer(wav [B, N] float32, lens
    [B]) -> list of texts, greedy CTC for an attention recipe and the
    greedy search for a transducer recipe, on `device`."""
    t0 = time.time()

    def stage(msg):
        print(f"[serve +{time.time() - t0:.1f}s] {msg}", flush=True)

    stage("loading the tokenizer and the run")
    tokenizer = resolve_tokenizer(cfg, run_dir_of(ckpt_dir))
    model, fbank, td, norm_stats = common.restore_inference(cfg, ckpt_dir, avg, device)
    stage("ready")

    def infer(wav: np.ndarray, lens: np.ndarray):
        wav_t = torch.from_numpy(np.asarray(wav, np.float32)).to(device)
        lens_t = torch.from_numpy(np.asarray(lens, np.int32)).to(device)
        if td is None:
            hyps, _ = greedy_ctc_decode(model, fbank, norm_stats, wav_t, lens_t)
        else:
            hyps, _ = transducer_greedy_transcribe(model, td, fbank, norm_stats, wav_t, lens_t,
                                                   blank_id=cfg.model.blank_index)
        return [tokenizer.decode(h) for h in hyps]

    return infer, tokenizer


def build_streaming(cfg, ckpt_dir: str, avg: int, slots: int, chunk_frames: int,
                    left_context: int, max_wait_ms: float, device):
    """`(StreamingSessionServer, tokenizer, chunk_samples)` of a trained
    transducer run on `device`."""
    if cfg.transducer is None:
        raise SystemExit("--streaming requires a transducer recipe")
    tokenizer = resolve_tokenizer(cfg, run_dir_of(ckpt_dir))
    model, fbank, td, norm_stats = common.restore_inference(cfg, ckpt_dir, avg, device)
    normalizer = InputNormalization(update_until_epoch=cfg.features.normalize_update_until_epoch)
    init_fn, step_fn, info = make_streaming_infer_fns(
        model, td, fbank, normalizer, norm_stats, chunk_frames=chunk_frames,
        left_context_chunks=left_context, blank_id=cfg.model.blank_index)
    server = StreamingSessionServer(init_fn, step_fn, info["chunk_samples"], slots=slots,
                                    max_wait_ms=max_wait_ms)
    return server, tokenizer, info["chunk_samples"]


def decode_chunk_bytes(data: bytes, sample_rate: int) -> np.ndarray:
    """An audio chunk: a WAV or FLAC file, or raw little-endian float32 PCM
    (mid-stream chunks have no header)."""
    if data[:4] in (b"RIFF", b"fLaC"):
        return decode_audio_bytes(data, sample_rate)
    if len(data) % 4:
        raise ValueError("raw chunk must be float32 PCM (length divisible by 4)")
    return np.frombuffer(data, "<f4").astype(np.float32)


class _JSONHandler(BaseHTTPRequestHandler):
    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", "0")))

    def log_message(self, fmt, *a):   # no request lines
        pass


def make_streaming_handler(server: StreamingSessionServer, tokenizer, sample_rate: int):
    """HTTP session endpoints over `server`. Each session's token history is
    decoded again on every update (subword pieces do not decode by
    deltas); `text_delta` is the text new since the last reply."""
    hist = {}   # sid -> {"tokens": [...], "text": str, "lock": Lock}
    lock = threading.Lock()

    def get_hist(sid):
        with lock:
            h = hist.get(sid)
        if h is None:
            raise KeyError(f"unknown session {sid!r}")
        return h

    def update_held(h, sid, new_tokens, final=False):
        """Extend the history and decode it; the caller holds h["lock"], so
        a session's updates never interleave."""
        h["tokens"].extend(new_tokens)
        full = tokenizer.decode(h["tokens"])
        delta = full[len(h["text"]):] if full.startswith(h["text"]) else full
        h["text"] = full
        if final:
            with lock:
                hist.pop(sid, None)
        return {"text": full, "text_delta": delta, "tokens": new_tokens}

    def feed_and_update(sid, audio):
        h = get_hist(sid)
        with h["lock"]:
            return update_held(h, sid, server.feed(sid, audio))

    def end_and_update(sid):
        h = get_hist(sid)
        with h["lock"]:
            return update_held(h, sid, server.close(sid), final=True)

    def prune_hist():
        """Drop the histories of sessions the server no longer has (evicted
        clients never post again)."""
        alive = server.active_ids()
        with lock:
            for sid in [s for s in hist if s not in alive]:
                hist.pop(sid, None)

    class Handler(_JSONHandler):
        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            parts = self.path.strip("/").split("/")
            try:
                body = self._body()
                if parts == ["stream", "start"]:
                    prune_hist()
                    sid = server.open()
                    with lock:
                        hist[sid] = {"tokens": [], "text": "", "lock": threading.Lock()}
                    self._reply(200, {"id": sid})
                elif len(parts) == 2 and parts[0] == "stream":
                    self._reply(200, feed_and_update(parts[1],
                                                     decode_chunk_bytes(body, sample_rate)))
                elif len(parts) == 3 and parts[0] == "stream" and parts[2] == "end":
                    self._reply(200, end_and_update(parts[1]))
                else:
                    self._reply(404, {"error": "unknown path"})
            except KeyError as e:
                # the session is gone from the server: drop its history too
                if len(parts) >= 2 and parts[0] == "stream":
                    with lock:
                        hist.pop(parts[1], None)
                self._reply(404, {"error": str(e)})
            except (ValueError, RuntimeError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — reported to the caller
                self._reply(500, {"error": str(e)})

    return Handler


def make_handler(server: DynamicBatchingServer, sample_rate: int):
    class Handler(_JSONHandler):
        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, server.stats())
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/transcribe":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                audio = decode_audio_bytes(self._body(), sample_rate)
                self._reply(200, {"text": server.submit(audio, timeout=120.0)})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — reported to the caller
                self._reply(500, {"error": str(e)})

    return Handler


def warmup(infer, scfg: ServingConfig) -> None:
    """One full batch at each bucket edge, before the server takes traffic."""
    for edge_s in scfg.bucket_edges_s:
        n = int(edge_s * scfg.sample_rate)
        print(f"warmup: {scfg.batch_size} x {edge_s:g} s", flush=True)
        infer(np.zeros((scfg.batch_size, n), np.float32),
              np.full((scfg.batch_size,), n, np.int32))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe")
    ap.add_argument("--ckpt", required=True, help="checkpoint (save) directory")
    ap.add_argument("--avg", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--warmup", action="store_true",
                    help="run one batch per bucket edge before taking traffic")
    ap.add_argument("--streaming", action="store_true",
                    help="serve live streams (transducer recipes): /stream/start, "
                         "/stream/<id>, /stream/<id>/end")
    ap.add_argument("--chunk-frames", type=int, default=16,
                    help="encoder frames per streaming chunk (40 ms each)")
    ap.add_argument("--left-context", type=int, default=4,
                    help="left-context chunks carried across steps")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless this says otherwise (e.g. cpu)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = load_recipe(args.recipe, overrides=common.parse_overrides(args.overrides))
    sr = cfg.features.sample_rate
    device = resolve_device(args.device)
    if args.streaming:
        server, tokenizer, chunk_samples = build_streaming(
            cfg, args.ckpt, args.avg, args.batch_size, args.chunk_frames, args.left_context,
            args.max_wait_ms, device)
        if args.warmup:
            print("warmup: one streaming step", flush=True)
            sid = server.open()
            server.feed(sid, np.zeros((chunk_samples,), np.float32))
            server.close(sid)
        httpd = ThreadingHTTPServer((args.host, args.port),
                                    make_streaming_handler(server, tokenizer, sr))
        print(f"streaming on http://{args.host}:{args.port} ({args.batch_size} slots, chunk "
              f"{chunk_samples} samples = {args.chunk_frames} encoder frames)", flush=True)
        stop = server.shutdown
    else:
        infer, _ = build_infer(cfg, args.ckpt, args.avg, device)
        scfg = ServingConfig(batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
                             sample_rate=sr)
        if args.warmup:
            with torch.inference_mode():
                warmup(infer, scfg)
        server = DynamicBatchingServer(infer, scfg, device=device)
        httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server, sr))
        print(f"serving on http://{args.host}:{args.port} (batch {args.batch_size}, max wait "
              f"{args.max_wait_ms} ms)", flush=True)
        stop = server.close
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        stop()


if __name__ == "__main__":
    main()
