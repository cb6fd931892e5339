"""The port's inference artifacts (`utils/export.py`, the
`recipes.export_model` runner) and the kernels' registered ops, on the CPU.

- The live CTC inference function against the JAX `make_ctc_infer_fn`
  under `jax.jit`, on the same converted weights (the hard synthetic
  recipe cut to 1 layer, d32) and audio from a numpy seed: encoder lengths
  equal, CTC log-probabilities within 1e-4 (float32 through one encoder
  layer, the sums in another order: the tolerance of the port's runner
  tests), and the greedy ids equal on every valid frame whose top-2
  log-probability margin exceeds 1e-3.
- The export runner (`--device cpu --check`) on a written run directory,
  then the polymorphic artifact loaded and run at two (B, N) shapes: ids,
  keep and encoder lengths bit-equal to the live port.
- The streaming artifact of the transducer recipe cut to 1 layer, d32
  (the port's seeded draw), against `streaming.run_stream` on the live
  functions, for a batch of two and a batch of one.
- What the loaders refuse: the JAX package's artifact, an artifact for
  another device, a streaming artifact as an offline one; the offline
  transducer graph without a fixed shape.
- The kernels' registered ops: `torch.library.opcheck` at the smallest
  widths the kernels take (cell: D, hidden and out 256; cgMLP: D 128,
  C 128, K 15; RelPosMHAXL: 2 heads of 64, ragged lengths with an empty
  row) in bf16, with and without a dropout keep-mask (RelPosMHAXL: with
  and without `causal`), and an export of the first two under a symbolic
  batch and a `320 · n` length, saved and loaded again."""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.frontend.features import InputNormalization as JNorm
from summarymixing_tpu.utils import export as jexport
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.ops import attention, fused_csgu, fused_summary
from summarymixing_tpu_torch.recipes import common, export_model
from summarymixing_tpu_torch.streaming import make_streaming_infer_fns, run_stream
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.utils import export
from summarymixing_tpu_torch.utils.convert import load_jax_params

REPO = os.path.join(os.path.dirname(__file__), "..")
SYNTH = os.path.join(REPO, "recipes", "Synthetic", "hard_synthetic.yaml")
TRANSDUCER = os.path.join(REPO, "recipes", "LibriSpeech",
                          "conformer_summarymixing_transducer.yaml")
# the transducer recipe cut to 1 layer, d32, vocabulary 11; chunks of 2 frames
TINY_TD = {"model.num_encoder_layers": 1, "model.d_model": 32, "model.d_ffn": 64,
           "model.csgu_kernel_size": 5, "model.local_proj_hid_dim": [16],
           "model.local_proj_out_dim": 32, "model.summary_hid_dim": [16],
           "model.output_neurons": 11, "model.frontend_channels": [8, 4],
           "model.input_size": 80, "transducer.joint_dim": 16, "transducer.dec_dim": 12,
           "training.precision": "fp32"}
CHUNK, LEFT = 2, 2
TINY = {"model.num_encoder_layers": 1, "model.num_decoder_layers": 0, "model.d_model": 32,
        "model.d_ffn": 64, "model.csgu_linear_units": 64, "model.csgu_kernel_size": 5,
        "model.local_proj_hid_dim": [32], "model.local_proj_out_dim": 32,
        "model.summary_hid_dim": [32], "model.summary_out_dim": 32,
        "model.frontend_channels": [4, 4], "model.input_size": 80}
TINY_SET = [arg for k, v in TINY.items() for arg in ("--set", f"{k}={json.dumps(v)}")]
LOGP_TOL = 1e-4
TEXTS = ["the cat sat", "a dog ran far", "birds sing"]


def norm_stats(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    count = np.float32(5e4)
    std = (3.0 + 3.0 * rng.random(80)).astype(np.float32)
    return {"count": np.asarray(count), "m2": (std ** 2 * (count - 1)).astype(np.float32),
            "mean": (-8.0 + 4.0 * rng.standard_normal(80)).astype(np.float32)}


def write_run(run_dir: str, model, stats: dict) -> CharTokenizer:
    """A port run directory: `model`'s parameters as checkpoint 1 in
    `save/`, `stats` as its normalisation statistics, a char tokenizer."""
    CheckpointManager(os.path.join(run_dir, "save")).save(1, {
        "params": model.state_dict(), "step": 1, "epoch": 1,
        "norm_stats": {k: torch.from_numpy(np.array(v)) for k, v in stats.items()}})
    tokenizer = CharTokenizer.build(TEXTS)
    with open(os.path.join(run_dir, "tokenizer_vocab.json"), "w") as f:
        json.dump(tokenizer.vocab, f)
    return tokenizer


def audio(seed: int, b: int, n: int):
    rng = np.random.default_rng(seed)
    wav = (0.1 * rng.standard_normal((b, n))).astype(np.float32)
    lens = np.full((b,), n, np.int32)
    lens[-1] = n - 3000
    return wav, lens


@pytest.fixture(scope="module")
def ctc():
    """The tiny recipe from flax init in both packages, the same weights."""
    jmodel, jfbank, _ = jax_build_model(jax_load_recipe(SYNTH, overrides=TINY))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 80)),
                                  jnp.asarray([16]), jnp.ones((1, 3), jnp.int32))
    cfg = load_recipe(SYNTH, overrides=TINY)
    model, fbank = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    stats = norm_stats()
    return dict(jmodel=jmodel, jfbank=jfbank, params=params, model=model, fbank=fbank,
                stats=stats, tstats={k: torch.from_numpy(np.array(v)) for k, v in stats.items()})


def test_ctc_infer_fn_matches_jax(ctc):
    s = ctc
    wav, lens = audio(1, 3, 320 * 60)
    jstats = {k: jnp.asarray(v) for k, v in s["stats"].items()}
    jinfer = jexport.make_ctc_infer_fn(s["jmodel"], s["jfbank"], JNorm(), s["params"]["params"],
                                       jstats)
    jids, _, jenc = jax.jit(jinfer)(jnp.asarray(wav), jnp.asarray(lens))

    @jax.jit
    def log_probs(wav, lens):
        feats, _ = JNorm()(s["jfbank"](wav), jstats)
        return s["jmodel"].apply(s["params"], feats,
                                 s["jfbank"].frame_lengths(lens))["ctc_log_probs"]

    jlogp = np.asarray(log_probs(jnp.asarray(wav), jnp.asarray(lens)))

    infer = export.make_ctc_infer_fn(s["model"], s["fbank"], InputNormalization(), s["tstats"])
    with torch.inference_mode():
        ids, keep, enc = infer(torch.from_numpy(wav), torch.from_numpy(lens))
        tfeats, _ = InputNormalization()(s["fbank"](torch.from_numpy(wav)), s["tstats"])
        logp = s["model"](tfeats, s["fbank"].frame_lengths(torch.from_numpy(lens)))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jenc))
    valid = np.arange(jlogp.shape[1])[None, :] < np.asarray(jenc)[:, None]
    diff = np.abs(logp["ctc_log_probs"].numpy() - jlogp)
    assert diff[valid].max() <= LOGP_TOL
    top2 = np.sort(jlogp, axis=-1)[..., -2:]
    clear = valid & (top2[..., 1] - top2[..., 0] > 1e-3)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ids.numpy()[clear], np.asarray(jids)[clear])
    assert keep.dtype == torch.bool and not keep.numpy()[~valid].any()


def test_export_runner_and_polymorphic_artifact(ctc, tmp_path):
    """`export_model --device cpu --check` on a run directory, then the
    artifact at two (B, N) shapes against the live port, bit for bit, and
    its text through the artifact's vocab."""
    s = ctc
    run = str(tmp_path / "run")
    tokenizer = write_run(run, s["model"], s["stats"])
    path = str(tmp_path / "model.smt")
    summary = export_model.main([SYNTH, "--ckpt", run + "/save", "--output", path,
                                 "--device", "cpu", "--check"] + TINY_SET)
    assert summary["family"] == "ctc" and summary["check"] and summary["mb"] > 0
    asr = export.ExportedASR.load(path, device="cpu")
    assert asr.meta["polymorphic"] and asr.meta["device"] == "cpu"
    assert asr.meta["vocab"] == export_model.vocab_list(tokenizer)
    infer = export.make_ctc_infer_fn(s["model"], s["fbank"], InputNormalization(), s["tstats"])
    for b, n in ((3, 320 * 37), (1, 320 * 101)):
        wav, lens = audio(b + n, b, n)
        got = asr(wav, lens)
        with torch.inference_mode():
            want = infer(torch.from_numpy(wav), torch.from_numpy(lens))
        assert got[0].shape == want[0].shape and got[0].shape[0] == b
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    wav, _ = audio(5, 2, 320 * 40 + 17)   # transcribe pads to the time multiple
    with torch.inference_mode():
        ids, keep, _ = infer(torch.from_numpy(np.pad(wav, ((0, 0), (0, 320 - 17)))),
                             torch.full((2,), wav.shape[1], dtype=torch.int32))
    want = [tokenizer.decode(row[k].tolist()) for row, k in zip(ids, keep)]
    assert asr.transcribe(wav) == want


@pytest.fixture(scope="module")
def transducer():
    """The tiny transducer recipe with the port's own seeded draw, its
    streaming functions, and two ragged waveforms with an early peak."""
    model, fbank, td = build_model(load_recipe(TRANSDUCER, overrides=TINY_TD), device="cpu")
    stats = {k: torch.from_numpy(np.array(v)) for k, v in norm_stats(2).items()}
    wav, lens = audio(7, 2, 12000)
    wav[:, :200] *= 20.0
    init_fn, step_fn, info = make_streaming_infer_fns(
        model, td, fbank, InputNormalization(), stats, chunk_frames=CHUNK,
        left_context_chunks=LEFT)
    return dict(model=model, fbank=fbank, td=td, stats=stats, wav=wav, wav_lens=lens,
                init_fn=init_fn, step_fn=step_fn, info=info)


def test_streaming_artifact_matches_run_stream(transducer, tmp_path):
    s = transducer
    init_fn, step_fn, info = s["init_fn"], s["step_fn"], s["info"]
    payloads = export.export_streaming(init_fn, step_fn, info["chunk_samples"], s["model"],
                                       s["td"], s["fbank"])
    path = str(tmp_path / "stream.smt")
    meta = {"family": "transducer_streaming", "token_type": "char", "vocab": None,
            "device": "cpu", **info}
    export.save_artifact(path, payloads, meta)
    art = export.ExportedStreamingASR.load(path, device="cpu")
    wav, lens = s["wav"], s["wav_lens"]
    toks, tl = run_stream(init_fn, step_fn, torch.from_numpy(wav), torch.from_numpy(lens),
                          info["chunk_samples"])
    want = export.decode_token_rows(meta, [toks[i, :int(tl[i])].tolist() for i in range(2)])
    assert art.transcribe(wav, lens) == want and all(want)
    # a batch of one: the exported batch is symbolic
    one = wav[1:, :lens[1]]
    toks, tl = run_stream(init_fn, step_fn, torch.from_numpy(one),
                          torch.tensor([lens[1]]), info["chunk_samples"])
    assert art.transcribe(one) == export.decode_token_rows(meta, [toks[0, :int(tl[0])].tolist()])
    with pytest.raises(ValueError, match="streaming artifact"):
        export.ExportedASR.load(path, device="cpu")


def test_loaders_refuse_other_artifacts(transducer, tmp_path):
    jax_art = tmp_path / "jax.smtexp"
    jexport.save_artifact(str(jax_art), b"\x00" * 16, {"family": "ctc"})
    with pytest.raises(ValueError, match="JAX package"):
        export.ExportedASR.load(str(jax_art), device="cpu")
    ours = tmp_path / "ours.smt"
    export.save_artifact(str(ours), b"\x00" * 16, {"family": "ctc", "device": "cuda"})
    with pytest.raises(ValueError, match="not a summarymixing_tpu export artifact"):
        jexport.ExportedASR.load(str(ours))
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        export.ExportedASR.load(str(ours), device="cpu")
    # the offline transducer artifact, polymorphic since its frame loop is a
    # scan under export (its equality with the live model:
    # tests/test_torch_tooling.py), is refused by the streaming loader
    s = transducer
    infer = export.make_transducer_infer_fn(s["model"], s["td"], s["fbank"],
                                            InputNormalization(), s["stats"])
    offline = str(tmp_path / "td.smt")
    export.save_artifact(offline, export.export_ctc_infer(infer),
                         {"family": "transducer", "device": "cpu", "polymorphic": True})
    with pytest.raises(ValueError, match="not a streaming artifact"):
        export.ExportedStreamingASR.load(offline, device="cpu")


def _cell_args(keep: bool):
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.bfloat16, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    b, t, d = 2, 7, 256
    pad = torch.ones(b, t, 1)
    pad[1, 4:] = 0.0
    merge = r(d, 2 * d)
    weights = [r(d, d), r(d), r(d, d), r(d), r(d, d), r(d), r(d, d), r(d),
               merge[:, :d].contiguous(), merge[:, d:].contiguous(), r(d)]
    mask = torch.rand(b, t, 2 * d, generator=g) < 0.9 if keep else None
    return (r(b, t, d, scale=1.0), pad, weights, "gelu", mask, 0.9 if keep else 1.0)


def _branch_args(keep: bool):
    g = torch.Generator().manual_seed(1)

    def r(*shape, dtype=torch.float32, scale=0.05):
        return (torch.randn(*shape, generator=g) * scale).to(dtype)

    b, t, d, c, k = 2, 9, 128, 128, 15
    mask = torch.ones(b, t)
    mask[0, 6:] = 0.0
    weights = [r(2 * c, d, dtype=torch.bfloat16), r(2 * c), 1.0 + r(c), r(c), r(k, c), r(c),
               r(d, c, dtype=torch.bfloat16), r(d)]
    keep_mask = torch.rand(b, t, c, generator=g) < 0.9 if keep else None
    return (r(b, t, d, dtype=torch.bfloat16, scale=1.0), mask, weights, 1e-5, keep_mask,
            0.9 if keep else 1.0)


def _relpos_args(causal: bool):
    """RelPosMHAXL's op at hd 64: a prefix mask, valid keys at the end (a
    streaming left buffer not yet full) and an empty row."""
    g = torch.Generator().manual_seed(2)
    b, t, h, hd = 3, 7, 2, 64
    q, k, v = (torch.randn(b, t, h, hd, generator=g).to(torch.bfloat16) for _ in range(3))
    p = torch.randn(1, 2 * t - 1, h, hd, generator=g).to(torch.bfloat16)
    u, vb = (0.3 * torch.randn(h, hd, generator=g) for _ in range(2))
    pad = torch.tensor([[1.0] * 7, [0.0] * 3 + [1.0] * 4, [0.0] * 7])
    return (q, k, v, p, u, vb, pad, causal)


@pytest.mark.parametrize("keep", [False, True], ids=["no_keep", "keep"])
@pytest.mark.parametrize("op", ["summary_mixing", "convolution_branch", "relpos_attention",
                                "convolution_branch_train"])
def test_registered_ops_pass_opcheck(op, keep):
    """Each op on the CPU against `torch.library.opcheck` and its plain
    version; for RelPosMHAXL's op `keep` stands for `causal`. The cgMLP's
    training op gives the inference op's output and, beside it, the bf16
    `h`, the gate rows' (mean, rstd) and the bf16 `g` its backward reads."""
    if op == "relpos_attention":
        fn, args = attention.relpos_attention_op, _relpos_args(keep)
    elif op == "summary_mixing":
        fn, args = fused_summary.summary_mixing_op, _cell_args(keep)
    else:
        fn = getattr(fused_csgu, f"{op}_op")
        args = _branch_args(keep)
    assert fn._qualname == f"summarymixing_torch::{op}"
    torch.library.opcheck(fn, args)
    if op == "relpos_attention":
        q, k, v, p, u, vb, pad, causal = args
        want = attention.relpos_attention_reference(q, k, v, p, u, vb, None, pad, causal)
    else:
        want = (fused_summary.summary_mixing_reference if op == "summary_mixing"
                else fused_csgu.convolution_branch_reference)(*args[:2], tuple(args[2]),
                                                              *args[3:])
    if op == "convolution_branch_train":
        out, h, stats, g = fn(*args)
        b, t, d = args[0].shape
        c2 = args[2][0].shape[0]
        assert torch.equal(out, want)
        assert (h.shape, h.dtype, stats.shape, stats.dtype, g.shape, g.dtype) == (
            (b, t, c2), torch.bfloat16, (b * t, 2), torch.float32, (b, t, c2 // 2), torch.bfloat16)
        gate = h[..., c2 // 2:].float().reshape(b * t, -1)
        torch.testing.assert_close(stats[:, 0], gate.mean(-1))
    else:
        assert torch.equal(fn(*args), want)


def test_ops_export_with_symbolic_batch_and_length():
    """A graph of both ops under `Dim("b")` and `320 · Dim("n")` (here the
    time axis), saved and loaded: the same outputs at other shapes."""
    x, pad, cw, act, _, _ = _cell_args(False)
    _, _, bw, eps, _, _ = _branch_args(False)
    proj = torch.nn.Linear(256, 128).to(torch.bfloat16)

    class Both(torch.nn.Module):
        def forward(self, x, pad):
            y = fused_summary.summary_mixing_op(x, pad, cw, act, None, 1.0)
            return fused_csgu.convolution_branch_op(proj(y).contiguous(), pad[..., 0].contiguous(),
                                                    bw, eps, None, 1.0)

    n = torch.export.Dim("n", min=2, max=64)
    bd = torch.export.Dim("b", min=1, max=64)
    x, pad = torch.randn(2, 640, 256).to(torch.bfloat16), torch.ones(2, 640, 1)
    with torch.no_grad():
        ep = torch.export.export(Both(), (x, pad),
                                 dynamic_shapes=({0: bd, 1: 320 * n}, {0: bd, 1: 320 * n}))
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    loaded = torch.export.load(io.BytesIO(buf.getvalue())).module()
    for b, t in ((3, 640), (1, 960)):
        xi = torch.randn(b, t, 256).to(torch.bfloat16)
        padi = torch.ones(b, t, 1)
        padi[0, t // 2:] = 0.0
        with torch.no_grad():
            assert torch.equal(loaded(xi, padi), Both()(xi, padi))


def test_kernel_counts_untouched_on_the_cpu():
    """The CPU route never counts a launch or a plain call."""
    assert common.kernel_counts() == {"summary_mixing": {"launches": 0, "plain_calls": 0},
                                      "csgu": {"launches": 0, "plain_calls": 0, "int8_calls": 0},
                                      "relpos_attention": {"launches": 0, "plain_calls": 0}}
