"""The port's serving slice on the CPU: `serving.DynamicBatchingServer`
(the JAX `tests/test_serving.py` cases on a stub `infer`),
`serving.StreamingSessionServer` on the tiny transducer recipe whose
weights come from flax (every session decodes what `streaming.run_stream`
gives its audio alone), both HTTP handlers of `recipes.serve` in process,
and the `recipes.transcribe` runner's JSONL.

Every wait has a timeout, so no test can hang: requests, joins and the
servers' own queues."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.data.flac import encode_flac
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.recipes import common, export_model, serve, transcribe
from summarymixing_tpu_torch.serving import (
    DynamicBatchingServer,
    RequestError,
    ServingConfig,
    StreamingSessionServer,
)
from summarymixing_tpu_torch.streaming import carry_tensors, make_streaming_infer_fns, run_stream
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.transcribe import batch_waveforms, greedy_ctc_decode
from test_torch_export import SYNTH, TINY, TINY_SET, norm_stats, write_run
from test_torch_transducer import CHUNK, LEFT, RECIPE as TRANSDUCER, TINY as TINY_TD
from test_torch_transducer import recipe_models  # noqa: F401 (fixture)

WAIT = 60.0   # seconds any single wait may take before the test fails


def _cfg(**kw):
    base = dict(batch_size=4, max_wait_ms=30.0, sample_rate=16000, bucket_edges_s=(1.0, 2.0, 4.0))
    base.update(kw)
    return ServingConfig(**base)


class EchoInfer:
    """Stub infer: 'len=<n>' per row; records each batch's shape and lengths."""

    def __init__(self, fail=False, delay=0.0):
        self.calls, self.fail, self.delay = [], fail, delay

    def __call__(self, wav, lens):
        self.calls.append((wav.shape, tuple(int(x) for x in lens)))
        if self.fail:
            raise RuntimeError("backend exploded")
        if self.delay:
            time.sleep(self.delay)
        return [f"len={int(n)}" for n in lens]


def _threads(fn, n):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)


def test_single_request_roundtrip():
    infer = EchoInfer()
    with DynamicBatchingServer(infer, _cfg()) as srv:
        assert srv.submit(np.ones(1600, np.float32), timeout=WAIT) == "len=1600"
        st = srv.stats()
        assert st["served"] == 1 and st["p50_ms"] is not None and st["mean_batch"] == 1.0


@pytest.mark.parametrize("max_wait_ms,delay,max_calls", [(100.0, 0.01, 3), (1.0, 0.05, 5)],
                         ids=["shared_batches", "backlog_drains_full_batches"])
def test_concurrent_requests_share_batches(max_wait_ms, delay, max_calls):
    """8 callers through batches of 4: with a long wait they share batches;
    with a 1 ms wait and a busy worker, a backlog still drains in batches
    (one request per call would be 8 calls)."""
    infer = EchoInfer(delay=delay)
    results = {}
    with DynamicBatchingServer(infer, _cfg(max_wait_ms=max_wait_ms)) as srv:
        def call(i):
            results[i] = srv.submit(np.ones(1000 + i, np.float32), timeout=WAIT)
        _threads(call, 8)
    assert results == {i: f"len={1000 + i}" for i in range(8)}
    assert len(infer.calls) <= max_calls, infer.calls
    assert any(len(set(lens)) > 1 for _, lens in infer.calls)


@pytest.mark.parametrize("n,shape", [(100, (4, 16000)), (17000, (4, 32000)),
                                     (16000 * 3, (4, 64000)), (16000 * 5 + 1, (4, 88000))])
def test_bucketed_shapes_and_repeat_padding(n, shape):
    """A lone request is padded to the smallest bucket edge that holds it
    (above the last edge, to the half-second grid), and the empty rows
    repeat row 0: `form_batch` is what `infer` sees."""
    infer = EchoInfer()
    with DynamicBatchingServer(infer, _cfg(max_wait_ms=1.0, max_audio_s=10.0)) as srv:
        assert srv.submit(np.ones(n, np.float32), timeout=WAIT) == f"len={n}"
        wav, lens = srv.form_batch([np.ones(n, np.float32)])
    assert infer.calls == [(shape, (n,) * 4)] and wav.shape == shape
    assert (wav[:, :n] == 1).all() and (wav[:, n:] == 0).all()


def test_error_propagates_and_server_survives():
    infer = EchoInfer(fail=True)
    with DynamicBatchingServer(infer, _cfg()) as srv:
        with pytest.raises(RequestError, match="backend exploded"):
            srv.submit(np.ones(100, np.float32), timeout=WAIT)
        infer.fail = False
        assert srv.submit(np.ones(100, np.float32), timeout=WAIT) == "len=100"
        assert srv.stats()["errors"] == 1


def test_submit_validation_timeout_and_close():
    infer = EchoInfer(delay=0.5)
    srv = DynamicBatchingServer(infer, _cfg(max_audio_s=1.0))
    with pytest.raises(ValueError, match="empty"):
        srv.submit(np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="max_audio_s"):
        srv.submit(np.zeros(32000, np.float32))
    with pytest.raises(TimeoutError):
        srv.submit(np.ones(100, np.float32), timeout=0.05)
    srv.close()
    assert not srv._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(np.ones(100, np.float32))


# -- the streaming session server ------------------------------------------------

@pytest.fixture(scope="module")
def stream_fns(recipe_models):  # noqa: F811
    s = recipe_models
    init_fn, step_fn, info = make_streaming_infer_fns(
        s["model"], s["td"], s["fbank"], InputNormalization(), s["stats"], chunk_frames=CHUNK,
        left_context_chunks=LEFT)
    return init_fn, step_fn, info["chunk_samples"]


def _alone(init_fn, step_fn, cs, wav):
    toks, lens = run_stream(init_fn, step_fn, torch.from_numpy(wav[None]),
                            torch.tensor([len(wav)]), cs)
    return toks[0, :int(lens[0])].tolist()


def _streams(cs, n, seed):
    rng = np.random.default_rng(seed)
    wavs = [(rng.standard_normal((2 * cs + 700 * i + 137,)) * 0.1).astype(np.float32)
            for i in range(n)]
    for w in wavs:
        w[:50] *= 30.0   # the peak first: the streamed top-dB clamp is exact
    return wavs


def test_staggered_sessions_match_run_stream_alone(stream_fns):
    """Three streams opened at different times, fed in pieces smaller and
    larger than a chunk, interleaved: each gives its `run_stream` tokens."""
    init_fn, step_fn, cs = stream_fns
    wavs = _streams(cs, 3, 7)
    refs = [_alone(init_fn, step_fn, cs, w) for w in wavs]
    with StreamingSessionServer(init_fn, step_fn, cs, slots=4, max_wait_ms=5.0) as srv:
        got, sids, pos = [[] for _ in wavs], [None] * 3, [0] * 3

        def feed_some(i, n):
            take = wavs[i][pos[i]:pos[i] + n]
            pos[i] += len(take)
            if len(take):
                got[i].extend(srv.feed(sids[i], take, timeout=WAIT))

        sids[0] = srv.open()
        feed_some(0, cs)
        sids[1] = srv.open()
        feed_some(1, cs // 2)
        feed_some(0, cs + 17)
        sids[2] = srv.open()
        feed_some(2, 2 * cs)
        for i in (1, 0, 2):
            feed_some(i, len(wavs[i]))
        for i in range(3):
            got[i].extend(srv.close(sids[i], timeout=WAIT))
        assert got == refs and all(refs)
        assert srv.stats()["ticks"] > 0 and srv.stats()["active_sessions"] == 0
        assert srv.tokens(sids[0]) == refs[0]


def test_slot_exhaustion_reuse_and_reset(stream_fns):
    """One slot: a second open is refused; after close the slot is reused,
    reset to a fresh `init_fn` row, and the new stream decodes as alone."""
    init_fn, step_fn, cs = stream_fns
    first, second = _streams(cs, 2, 11)
    with StreamingSessionServer(init_fn, step_fn, cs, slots=1) as srv:
        sid = srv.open()
        with pytest.raises(RuntimeError, match="busy"):
            srv.open()
        srv.feed(sid, first, timeout=WAIT)
        srv.close(sid, timeout=WAIT)
        fresh = carry_tensors(srv.reset_rows(srv._carry, torch.ones(1, dtype=torch.bool)))
        for got, want in zip(fresh, carry_tensors(init_fn(1))):
            assert torch.equal(got, want)
        sid2 = srv.open()
        toks = srv.feed(sid2, second, timeout=WAIT) + srv.close(sid2, timeout=WAIT)
        assert toks == _alone(init_fn, step_fn, cs, second)
        with pytest.raises(KeyError):
            srv.feed(sid, first)


def test_inflight_session_not_idle_evicted(stream_fns):
    init_fn, step_fn, cs = stream_fns
    with StreamingSessionServer(init_fn, step_fn, cs, slots=2, idle_timeout_s=0.01) as srv:
        sid = srv.open()
        sess = srv._sessions[sid]
        sess.inflight = 1           # as _submit_chunks sets it before queueing
        sess.last_active = time.monotonic() - 10.0
        with srv._lock:
            srv._evict_idle_locked()
        assert sid in srv._sessions
        sess.inflight = 0
        with srv._lock:
            srv._evict_idle_locked()
        assert sid not in srv._sessions


# -- HTTP, in process ------------------------------------------------------------

def _wav_bytes(x16: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(x16.astype(np.int16).tobytes())
    return buf.getvalue()


class _Http:
    """A handler on a `ThreadingHTTPServer` at a free port, served from a thread."""

    def __init__(self, handler):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=WAIT) as r:
            return json.load(r)

    def post(self, path, data=b""):
        req = urllib.request.Request(self.base + path, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            return json.load(r)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=WAIT)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def ctc_run(tmp_path_factory):
    """A run directory of the tiny synthetic recipe (the port's seeded draw)."""
    run = str(tmp_path_factory.mktemp("ctc_run"))
    cfg = load_recipe(SYNTH, overrides=TINY)
    model, _ = build_model(cfg, device="cpu")
    write_run(run, model, norm_stats(4))
    return cfg, run


def _speech(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (8000 * np.sin(0.03 * t + rng.uniform(0, 3)) + 2000 * rng.standard_normal(n)
            ).astype(np.int16)


def test_ctc_http_handler(ctc_run):
    """/healthz, /transcribe with a WAV body and its FLAC twin (the same
    text, equal to `infer` on the batch the server formed), /stats, and
    400 for a malformed body."""
    cfg, run = ctc_run
    infer, _ = serve.build_infer(cfg, run + "/save", 0, torch.device("cpu"))
    x = _speech(0, 12000)
    with DynamicBatchingServer(infer, ServingConfig(batch_size=2, max_wait_ms=5.0),
                               device="cpu") as srv:
        http = _Http(serve.make_handler(srv, 16000))
        try:
            assert http.get("/healthz") == {"ok": True}
            text = http.post("/transcribe", _wav_bytes(x))["text"]
            assert http.post("/transcribe", encode_flac(x.astype(np.int64), 16000))["text"] == text
            with torch.inference_mode():
                assert infer(*srv.form_batch([x / 32768.0]))[0] == text
            assert http.get("/stats")["served"] == 2
            for bad in (b"not audio", b"RIFF\x10\x00\x00\x00WAVEjunk", b"fLaC\x00\x00"):
                with pytest.raises(urllib.error.HTTPError) as exc:
                    http.post("/transcribe", bad)
                assert exc.value.code == 400
        finally:
            http.close()


class _Ids:
    """A tokenizer that writes the ids themselves (every id shows in the text)."""

    @staticmethod
    def decode(ids):
        return " ".join(str(int(i)) for i in ids)


def test_streaming_http_handler(stream_fns):
    """/stream/start, raw float32 chunks, /stream/<id>/end: the text is the
    decode of the stream's `run_stream` tokens; a closed session is 404, a
    malformed raw chunk 400."""
    init_fn, step_fn, cs = stream_fns
    tokenizer = _Ids()
    wav = _streams(cs, 1, 5)[0]
    want = tokenizer.decode(_alone(init_fn, step_fn, cs, wav))
    with StreamingSessionServer(init_fn, step_fn, cs, slots=2, max_wait_ms=5.0) as srv:
        http = _Http(serve.make_streaming_handler(srv, tokenizer, 16000))
        try:
            assert http.get("/healthz") == {"ok": True}
            sid = http.post("/stream/start")["id"]
            text = ""
            for s in range(0, len(wav), cs):
                rsp = http.post(f"/stream/{sid}", wav[s:s + cs].tobytes())
                assert rsp["text"].startswith(text) and rsp["text"] == text + rsp["text_delta"]
                text = rsp["text"]
            final = http.post(f"/stream/{sid}/end")
            assert final["text"] == want and want
            with pytest.raises(urllib.error.HTTPError) as exc:
                http.post(f"/stream/{sid}", wav[:cs].tobytes())
            assert exc.value.code == 404
            sid2 = http.post("/stream/start")["id"]
            with pytest.raises(urllib.error.HTTPError) as exc:
                http.post(f"/stream/{sid2}", b"abc")
            assert exc.value.code == 400
            http.post(f"/stream/{sid2}/end")
            assert http.get("/stats")["active_sessions"] == 0
        finally:
            http.close()


def test_transcribe_runner_jsonl(ctc_run, tmp_path):
    """WAV and FLAC files through the runner in batches of 2: its JSONL
    texts, in the order given, equal `greedy_ctc_decode` on the same
    batches through the run's tokenizer."""
    cfg, run = ctc_run
    paths, wavs = [], []
    for i, n in enumerate((9000, 16000, 5000)):
        x = _speech(10 + i, n)
        path = str(tmp_path / (f"u{i}.flac" if i == 1 else f"u{i}.wav"))
        with open(path, "wb") as f:
            f.write(encode_flac(x.astype(np.int64), 16000) if i == 1 else _wav_bytes(x))
        paths.append(path)
        wavs.append(x.astype(np.float32) / 32768.0)
    out = str(tmp_path / "out.jsonl")
    got = transcribe.main([SYNTH, *paths, "--ckpt", run + "/save", "--batch-size", "2",
                           "--output", out, "--device", "cpu"] + TINY_SET)
    lines = [json.loads(line) for line in open(out)]
    assert [line["wav"] for line in lines] == paths and got["utterances"] == 3
    model, fbank, _, stats = common.restore_inference(cfg, run + "/save", 0, "cpu")
    tokenizer = CharTokenizer(vocab=json.load(open(os.path.join(run, "tokenizer_vocab.json"))))
    want = {}
    for idx, wav, lens in batch_waveforms(wavs, 2, 8000, "cpu"):
        hyps, _ = greedy_ctc_decode(model, fbank, stats, wav, lens)
        for i, u in enumerate(idx):
            want.setdefault(u, tokenizer.decode(hyps[i]))
    assert [line["text"] for line in lines] == [want[i] for i in range(3)]
    assert got["kernels"] == common.kernel_counts(since=common.kernel_counts())


def test_streaming_export_runner_on_a_transducer_run(recipe_models, tmp_path):  # noqa: F811
    """A transducer run directory (the flax-initialised tiny recipe) through
    `export_model --streaming --check --device cpu`: the restore of both
    modules, the export and the runner's own check against `run_stream`."""
    s = recipe_models
    run = str(tmp_path / "run")
    state = torch.nn.ModuleDict({"encoder": s["model"], "transducer": s["td"]}).state_dict()
    CheckpointManager(os.path.join(run, "save")).save(1, {
        "params": state, "step": 1, "epoch": 1, "norm_stats": s["stats"]})
    with open(os.path.join(run, "tokenizer_vocab.json"), "w") as f:
        json.dump(CharTokenizer.build(["abcdefg"]).vocab, f)   # vocabulary 11
    sets = [a for k, v in TINY_TD.items() for a in ("--set", f"{k}={json.dumps(v)}")]
    # chunks of 2 frames, the least the frontend's lookahead allows: the
    # step's export unrolls 3 emit steps per frame
    out = export_model.main([TRANSDUCER, "--ckpt", run + "/save", "--output",
                             str(tmp_path / "s.smt"), "--streaming", "--chunk-frames", "2",
                             "--left-context", str(LEFT), "--check", "--device", "cpu"] + sets)
    assert out["family"] == "transducer_streaming" and out["check"]


@pytest.mark.parametrize("runner,argv", [
    (serve, ["r.yaml", "--ckpt", "c", "--avg", "2", "--host", "0.0.0.0", "--port", "1",
             "--batch-size", "2", "--max-wait-ms", "5", "--warmup", "--streaming",
             "--chunk-frames", "8", "--left-context", "2", "--set", "a=1"]),
    (transcribe, ["r.yaml", "a.wav", "b.flac", "--ckpt", "c", "--avg", "2", "--batch-size",
                  "1", "--output", "o.jsonl", "--set", "a=1"]),
    (export_model, ["r.yaml", "--ckpt", "c", "--output", "m.smt", "--avg", "2", "--fixed",
                    "2", "32000", "--streaming", "--chunk-frames", "8", "--left-context", "2",
                    "--check", "--set", "a=1"]),
], ids=["serve", "transcribe", "export_model"])
def test_runners_take_the_jax_flags_and_device(runner, argv):
    """Each runner parses the JAX runner's flags, and `--device` (default:
    the card)."""
    args = runner.parse_args(argv)
    assert args.device is None and args.avg == 2 and args.overrides == ["a=1"]
    assert runner.parse_args(argv + ["--device", "cpu"]).device == "cpu"
