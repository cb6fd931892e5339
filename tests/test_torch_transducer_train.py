"""The port's transducer training against the JAX package on the CPU,
float32: the RNN-T loss and its gradient (whole and chunked joint, ragged
lengths, a single frame, every reduction), the warm-up + exponential-decay
schedule, gradient accumulation against `optax.MultiSteps` under
`apply_safe_update`, one `TransducerTrainer` step against the JAX trainer's,
the evaluate runner's greedy transducer decode against the JAX eval step,
and the initialisation each leaf is drawn with against flax's.

The trainer step runs the LibriSpeech transducer recipe cut to 2 layers of
d64 (nhead 4, d_ffn 128, kernel 5), vocabulary 11, joint 16, predictor 12,
at dropout 0, without SpecAugment, with the DCT sampler pinned to chunks of
4 frames and 2 chunks of left context, on 2 ragged utterances of about
1.2 s; the JAX weights move across with `load_jax_params`."""

import copy
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.decoding.transducer_search import transducer_greedy_decode as jax_greedy
from summarymixing_tpu.frontend.features import NormStats as JNormStats
from summarymixing_tpu.losses.transducer import transducer_loss as jax_loss
from summarymixing_tpu.losses.transducer import transducer_loss_chunked as jax_loss_chunked
from summarymixing_tpu.models.lm import RNNLM as JRNNLM
from summarymixing_tpu.parallel.mesh import make_mesh
from summarymixing_tpu.training import optim as joptim
from summarymixing_tpu.training.transducer_trainer import (
    DynChunkTrainSamplerConfig as JDct,
)
from summarymixing_tpu.training.transducer_trainer import TransducerTrainer as JTrainer
from summarymixing_tpu.training.transducer_trainer import (
    TransducerTrainerConfig as JTrainerConfig,
)
from summarymixing_tpu_torch.config import (
    build_lm,
    build_model,
    build_transducer_trainer,
    load_recipe,
)
from summarymixing_tpu_torch.config.schema import LMConfig
from summarymixing_tpu_torch.data.dataio import read_manifest_csv
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer
from summarymixing_tpu_torch.losses.transducer import transducer_loss, transducer_loss_chunked
from summarymixing_tpu_torch.models.transducer import LSTMCell, TransducerJoint
from summarymixing_tpu_torch.recipes import common, evaluate
from summarymixing_tpu_torch.training import optim
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.training.optim import MultiSteps
from summarymixing_tpu_torch.training.transducer_trainer import (
    DynChunkTrainSamplerConfig,
    sample_dynchunk,
)
from summarymixing_tpu_torch.utils.convert import load_jax_params
from test_torch_data import REPO, make_corpus

RECIPE = os.path.join(REPO, "recipes", "LibriSpeech", "conformer_summarymixing_transducer.yaml")
SYNTH_T = os.path.join(REPO, "recipes", "Synthetic", "hard_synthetic_transducer.yaml")
TINY = {
    "model.num_encoder_layers": 2, "model.d_model": 64, "model.d_ffn": 128,
    "model.csgu_kernel_size": 5, "model.local_proj_hid_dim": [32],
    "model.local_proj_out_dim": 64, "model.summary_hid_dim": [32], "model.output_neurons": 11,
    "model.frontend_channels": [8, 4], "model.input_size": 80, "model.transformer_dropout": 0.0,
    "transducer.joint_dim": 16, "transducer.dec_dim": 12, "transducer.dec_emb_dropout": 0.0,
    "transducer.dec_dropout": 0.0, "transducer.chunkwise_prob": 1.0,
    "transducer.chunk_size_min": 4, "transducer.chunk_size_max": 4,
    "transducer.limited_left_context_prob": 1.0, "transducer.left_context_chunks_min": 2,
    "transducer.left_context_chunks_max": 2, "training.precision": "fp32",
    "training.number_of_ctc_epochs": 1, "augment.fea_augment": False,
    "augment.speed_perturb": False,
}
LOSS_TOL = 1e-5       # the loss and d/dlogits: float32 on both sides
STEP_LOSS_TOL = 1e-5  # relative, a whole train step's loss
GRAD_TOL = 1e-4       # per tensor ||g_port - g_jax|| / ||g_jax||
PARAM_TOL = 1e-6      # accumulation: parameters after every micro step


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the RNN-T loss ------------------------------------------------------------

def _lattice(rng, b=3, t=9, u=5, v=7):
    logits = (2.0 * rng.standard_normal((b, t, u + 1, v))).astype(np.float32)
    targets = rng.integers(1, v, (b, u)).astype(np.int32)
    # ragged: a full row, a shorter one, and one frame with no target
    return logits, targets, np.asarray([t, 6, 1], np.int32), np.asarray([u, 2, 0], np.int32)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean", "batchmean"])
def test_transducer_loss_and_gradient_match_jax(rng, reduction):
    logits, targets, ilens, tlens = _lattice(rng)

    def jloss(x):
        return jax_loss(x, jnp.asarray(targets), jnp.asarray(ilens), jnp.asarray(tlens),
                        reduction=reduction)

    want = jloss(jnp.asarray(logits))
    jgrad = jax.grad(lambda x: jnp.sum(jloss(x) * jnp.arange(1.0, 1.0 + jloss(x).size)))(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    got = transducer_loss(x, _t(targets), _t(ilens), _t(tlens), reduction=reduction)
    (got.reshape(-1) * torch.arange(1.0, 1.0 + got.numel())).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=LOSS_TOL, rtol=LOSS_TOL)
    assert np.isfinite(x.grad.numpy()).all()


def test_transducer_loss_single_frame_and_docstring_value(rng):
    """T = 1 (the JAX loss returns before its scan) and the docstrings'
    uniform joint: 10.46 in each package."""
    logits, targets, _, _ = _lattice(rng, b=2, t=1, u=3)
    ilens, tlens = np.asarray([1, 1], np.int32), np.asarray([0, 2], np.int32)
    x = _t(logits).requires_grad_(True)
    got = transducer_loss(x, _t(targets), _t(ilens), _t(tlens), reduction="none")
    got.sum().backward()
    f = lambda a: jax_loss(a, jnp.asarray(targets), jnp.asarray(ilens),  # noqa: E731
                           jnp.asarray(tlens), reduction="none")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(f(jnp.asarray(logits))),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(
        lambda a: jnp.sum(f(a)))(jnp.asarray(logits))), atol=LOSS_TOL, rtol=LOSS_TOL)
    uniform = transducer_loss(torch.zeros(1, 6, 4, 5), torch.tensor([[1, 2, 3]]),
                              torch.tensor([6]), torch.tensor([3]))
    want = jax_loss(jnp.zeros((1, 6, 4, 5)), jnp.asarray([[1, 2, 3]]), jnp.asarray([6]),
                    jnp.asarray([3]))
    assert round(float(uniform), 2) == round(float(want), 2) == 10.46


def test_chunked_loss_matches_jax_and_the_whole_joint(rng):
    """`transducer_loss_chunked` (chunks of 4 over 10 frames: the last one
    padded) against the JAX chunked loss and the port's whole-joint loss:
    the value and the gradients of the projections and the joint's weight."""
    b, t, u, j, v = 2, 10, 4, 6, 7
    enc = rng.standard_normal((b, t, j)).astype(np.float32)
    dec = rng.standard_normal((b, u + 1, j)).astype(np.float32)
    w = (0.5 * rng.standard_normal((j, v))).astype(np.float32)
    targets = rng.integers(1, v, (b, u)).astype(np.int32)
    ilens, tlens = np.asarray([10, 7], np.int32), np.asarray([4, 3], np.int32)
    joint = TransducerJoint(j, v, activation="gelu")
    with torch.no_grad():
        joint.transducer_lin.weight.copy_(_t(w.T))

    def jjoint(wk, e, d):
        return jax.nn.gelu(e[:, :, None] + d[:, None]) @ wk

    def jtotal(e, d, wk):
        return jax_loss_chunked(e, d, lambda a, c: jjoint(wk, a, c), jnp.asarray(targets),
                                jnp.asarray(ilens), jnp.asarray(tlens), chunk_size=4)

    want, jgrads = jax.value_and_grad(jtotal, argnums=(0, 1, 2))(
        jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(w))
    results = []
    for chunked in (True, False):
        e, d = _t(enc).requires_grad_(True), _t(dec).requires_grad_(True)
        joint.zero_grad()
        if chunked:
            loss = transducer_loss_chunked(e, d, joint, _t(targets), _t(ilens), _t(tlens),
                                           chunk_size=4)
        else:
            loss = transducer_loss(joint(e, d), _t(targets), _t(ilens), _t(tlens))
        loss.backward()
        results.append(loss.detach())
        for got, jg in zip((e.grad, d.grad, joint.transducer_lin.weight.grad.T), jgrads):
            np.testing.assert_allclose(got.numpy(), np.asarray(jg), atol=LOSS_TOL, rtol=1e-4)
    np.testing.assert_allclose([float(r) for r in results], [float(want)] * 2, rtol=LOSS_TOL)


# -- the optimizer -------------------------------------------------------------

def test_warm_and_exp_decay_schedule_matches_jax():
    want = joptim.warm_and_exp_decay_schedule(8e-4, 100, 1000, 0.05)
    got = optim.warm_and_exp_decay_schedule(8e-4, 100, 1000, 0.05)
    for step in (0, 1, 50, 99, 100, 550, 1000, 5000):
        np.testing.assert_allclose(float(got(step)), float(want(step)), rtol=1e-6, atol=0.0)
    assert float(got(1000)) == pytest.approx(8e-4 * 0.05, rel=1e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_accumulation_matches_optax_multisteps(rng, k):
    """`MultiSteps(AdamW)` under `apply_safe_update` against
    `make_adamw(accum_steps=k)` under the JAX `apply_safe_update` over 3k + 1
    micro steps with the warm + decay schedule: clipping (some micro
    gradients are large), one non-finite loss and one non-finite gradient
    (the accumulator and its counter keep their values); the parameters
    within 1e-6 after every micro step, and bit for bit unchanged between
    updates."""
    shapes = {"a": (3, 4), "b": (5,)}
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    sched = dict(lr=1e-2, warmup_steps=2, total_steps=10, decay_factor=0.1)
    tx = joptim.make_adamw(joptim.warm_and_exp_decay_schedule(**sched), weight_decay=0.01,
                           eps=1e-8, accum_steps=k)
    jstate = {"params": {n: jnp.asarray(v) for n, v in params.items()}, "step": 0, "epoch": 0,
              "norm_stats": {"x": jnp.zeros(())}}
    jstate["opt_state"] = tx.init(jstate["params"])
    opt = optim.make_optimizer(optim.warm_and_exp_decay_schedule(**sched), 0.01, eps=1e-8,
                               accum_steps=k)
    assert isinstance(opt, MultiSteps) and opt.every_k == k
    tparams = [_t(params[n]) for n in shapes]
    state = opt.init(tparams)
    bad_loss, bad_grad = k - 1, 2 * k
    updates = 0
    for i in range(3 * k + 1):
        grads = {n: (rng.standard_normal(s) * (10.0 if i % 3 == 0 else 1.0)).astype(np.float32)
                 for n, s in shapes.items()}
        if i == bad_grad:
            grads["b"][1] = np.inf
        loss = np.float32(np.nan if i == bad_loss else 1.0)
        jstate, jnorm, jfinite = joptim.apply_safe_update(
            tx, jstate, {n: jnp.asarray(g) for n, g in grads.items()}, {"loss": loss},
            jstate["norm_stats"], None)
        before = [p.clone() for p in tparams]
        state, norm, finite = optim.apply_safe_update(
            opt, tparams, [_t(grads[n]) for n in shapes], state, torch.tensor(loss))
        assert finite == bool(jfinite) == (i not in (bad_loss, bad_grad))
        if finite:
            np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for p, n in zip(tparams, shapes):
            np.testing.assert_allclose(p.numpy(), np.asarray(jstate["params"][n]),
                                       atol=PARAM_TOL, rtol=PARAM_TOL)
        fired = finite and state["mini_step"] == 0
        changed = any(not torch.equal(p, q) for p, q in zip(tparams, before))
        # the warm-up's first rate is 0: the first update leaves them as they were
        assert changed == (fired and updates > 0)
        updates += fired
    assert updates == state["gradient_step"] == 2


# -- one train step against the JAX trainer ------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The cut recipe in each package with the flax weights in the port,
    two ragged utterances and their token ids."""
    rng = np.random.default_rng(21)
    jcfg = jax_load_recipe(RECIPE, overrides=TINY)
    jmodel, jfbank, jtd = jax_build_model(jcfg)
    cfg = load_recipe(RECIPE, overrides=TINY)
    model, fbank, td = build_model(cfg, device="cpu")
    n = 19200
    wav = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    batch = {"wav": wav, "wav_lens": np.asarray([n, n - 4800], np.int32),
             "tokens": rng.integers(1, 11, (2, 6)).astype(np.int32),
             "token_lens": np.asarray([6, 4], np.int32)}
    feats = jfbank(jnp.asarray(wav[:1]))
    eparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), feats, jnp.asarray([120]))
    enc_out = jnp.zeros((1, 5, 64))
    tparams = jax.jit(lambda k: jtd.init(k, enc_out, jnp.zeros((1, 3), jnp.int32),
                                         method=jtd.init_all))(jax.random.PRNGKey(1))
    params = {"encoder": eparams["params"], "transducer": tparams["params"]}
    trainer = build_transducer_trainer(cfg, model, fbank, td)
    state = trainer.init_state(cfg.seed)
    load_jax_params(trainer.model, params)
    jtrainer = JTrainer(jmodel, jtd, joptim.make_adamw(1e-3), jfbank, JTrainerConfig(
        ctc_weight=0.3, number_of_ctc_epochs=1, augment=None, dct=JDct(1.0, 4, 4, 1.0, 2, 2),
        xavier_init_overwrite=False), mesh=make_mesh(devices=jax.devices()[:1]))
    jgrad = jax.jit(jax.value_and_grad(jtrainer._forward_loss, has_aux=True), static_argnums=(4,))
    return dict(cfg=cfg, trainer=trainer, state=state, jgrad=jgrad, params=params, batch=batch)


@pytest.mark.parametrize("epoch", [0, 1], ids=["ctc_aux", "ctc_gated_off"])
def test_transducer_train_step_matches_jax(tiny, epoch):
    """One training forward and backward (RNN-T + 0.3 CTC while epoch <
    number_of_ctc_epochs = 1) under the same DCT chunking: the loss within
    STEP_LOSS_TOL, every parameter's gradient within GRAD_TOL relative L2,
    and the normalisation statistics updated alike."""
    trainer, state, batch = tiny["trainer"], tiny["state"], tiny["batch"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jlosses, jstats, _)), jgrads = tiny["jgrad"](
        tiny["params"], JNormStats.init(80), jbatch, jax.random.PRNGKey(0), False,
        jnp.asarray(epoch), 0)
    for p in trainer.params:
        p.grad = None
    loss, (losses, stats, _) = trainer._forward_loss(
        state["norm_stats"], {k: _t(v) for k, v in batch.items()}, True, epoch,
        state["generator"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=STEP_LOSS_TOL)
    np.testing.assert_allclose(float(losses["ctc"].detach()), float(jlosses["ctc"]),
                               rtol=STEP_LOSS_TOL,
                               atol=STEP_LOSS_TOL)
    assert (float(losses["ctc"].detach()) == 0.0) == (epoch == 1)
    np.testing.assert_allclose(stats["mean"].numpy(), np.asarray(jstats["mean"]), rtol=1e-5,
                               atol=1e-6)
    want = load_jax_params(copy.deepcopy(trainer.model), jgrads)
    for (name, p), (_, g) in zip(trainer.model.named_parameters(), want.named_parameters()):
        got = torch.zeros_like(p) if p.grad is None else p.grad
        err = float(torch.linalg.vector_norm(got - g).detach())
        assert err <= GRAD_TOL * float(torch.linalg.vector_norm(g).detach()) + 1e-9, name


def test_dct_sampler_draws_the_recipe_ranges():
    """Chunks in [8, 32] about 60% of the time, a limited left context in
    [2, 32] chunks only when chunking, else the whole utterance
    (`max_frames`)."""
    gen = torch.Generator().manual_seed(0)
    cfg = DynChunkTrainSamplerConfig()
    draws = [sample_dynchunk(gen, 100, cfg) for _ in range(400)]
    chunked = [d for d in draws if d.chunk_size != 100]
    assert 0.5 < len(chunked) / len(draws) < 0.7
    assert all(8 <= d.chunk_size <= 32 for d in chunked)
    assert {d.chunk_size for d in chunked} == set(range(8, 33))
    assert all(d.left_context_size == 100 for d in draws if d.chunk_size == 100)
    limited = [d for d in chunked if d.left_context_size != 100]
    assert 0.65 < len(limited) / len(chunked) < 0.85
    assert all(2 <= d.left_context_size <= 32 for d in limited)


def test_build_transducer_trainer_maps_the_recipe():
    """The LibriSpeech transducer recipe: accumulation 4 around AdamW with
    the warm-up + exponential decay to 0.05 at 210,000 steps, CTC 0.3 for
    60 epochs, the DCT sampler and SpecAugment of the recipe."""
    cfg = load_recipe(RECIPE)
    with torch.device("meta"):
        model, fbank, td = build_model(cfg, device="meta")
    trainer = build_transducer_trainer(cfg, model, fbank, td)
    c = trainer.config
    assert isinstance(trainer.optimizer, MultiSteps) and trainer.optimizer.every_k == 4
    inner = trainer.optimizer.inner
    assert (inner.eps, inner.weight_decay, inner.max_grad_norm) == (1e-8, 0.01, 5.0)
    assert float(inner.schedule(210000)) == pytest.approx(0.0008 * 0.05, rel=1e-6)
    assert float(inner.schedule(12500)) == pytest.approx(0.0004, rel=1e-6)
    assert (c.ctc_weight, c.number_of_ctc_epochs, c.ce_weight, c.joint_chunk) == (0.3, 60, 0.0, 0)
    assert c.dct == DynChunkTrainSamplerConfig(0.6, 8, 32, 0.75, 2, 32)
    assert c.speed_perturb and c.augment.freq_drop_count == 2


# -- the evaluate runner against the JAX eval step -----------------------------

def test_evaluate_runner_transducer_greedy_matches_jax(tmp_path):
    """`hard_synthetic_transducer.yaml` built in flax from a seed, saved as
    a port checkpoint, decoded greedily by the port's evaluate runner on
    the CPU: the same hypotheses as the JAX `TransducerTrainer.eval_step`
    and greedy decode on the same batches."""
    paths = make_corpus(tmp_path / "corpus", n=40)
    one_bucket = ["training.num_buckets=1"]
    cfg = load_recipe(SYNTH_T, overrides=common.parse_overrides(one_bucket))
    jmodel, jfbank, jtd = jax_build_model(jax_load_recipe(SYNTH_T))
    eparams = jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((1, 16, 80)),
                                   jnp.asarray([16]))
    tparams = jax.jit(lambda k: jtd.init(k, jnp.zeros((1, 4, 128)), jnp.zeros((1, 3), jnp.int32),
                                         method=jtd.init_all))(jax.random.PRNGKey(3))
    params = {"encoder": eparams["params"], "transducer": tparams["params"]}
    model, fbank, td = build_model(cfg, device="cpu")
    net = build_transducer_trainer(cfg, model, fbank, td, train=False).model
    load_jax_params(net, params)
    rng = np.random.default_rng(4)
    count = np.float32(5e4)
    stats = {"count": np.asarray(count),
             "m2": ((3.0 + 3.0 * rng.random(80)) ** 2 * (count - 1)).astype(np.float32),
             "mean": (-8.0 + 4.0 * rng.standard_normal(80)).astype(np.float32)}
    run = tmp_path / "run"
    CheckpointManager(str(run / "save")).save(1, {
        "params": net.state_dict(), "step": 1, "epoch": 1,
        "norm_stats": {k: _t(v) for k, v in stats.items()}})
    texts = [u.text for u in read_manifest_csv(paths["train"])]
    tok = CharTokenizer.build(texts)
    (run / "tokenizer_vocab.json").write_text(json.dumps(tok.vocab))
    got = evaluate.main([SYNTH_T, "--test-manifest", paths["test"], "--ckpt", str(run / "save"),
                         "--device", "cpu", "--set", one_bucket[0]])
    assert got["decode"] == "transducer_greedy"

    jtr = JTrainer(jmodel, jtd, joptim.make_adamw(1e-4), jfbank, JTrainerConfig(
        ctc_weight=0.3, augment=None, dct=None), mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = {"params": params, "epoch": jnp.asarray(1),
              "norm_stats": {k: jnp.asarray(v) for k, v in stats.items()}}
    bound = jtd.bind(tparams)
    test_set = read_manifest_csv(paths["test"])
    want = {}
    for batch, idx in common.batches(test_set, tok, cfg, False, 0, "cpu"):
        _, (enc, enc_lens) = jtr.eval_step(jstate, {k: jnp.asarray(v.numpy())
                                                    for k, v in batch.items()})
        toks, lens = jax_greedy(bound.encode_proj(enc), enc_lens, bound.predictor_init,
                                bound.predictor_step, bound.joint_step)
        toks, lens = np.asarray(toks), np.asarray(lens)
        for i, u in enumerate(idx):
            want.setdefault(test_set[u].utt_id, tok.decode(toks[i, :lens[i]]).split())
    assert got["hyps"] == want and any(want.values())


# -- initialisation ------------------------------------------------------------

def _std_tol(n: int) -> float:
    """5% for a leaf of 4,096 values or more; smaller leaves (the
    ParallelLinear biases, 512 values) by their sampling spread."""
    return 0.05 if n >= 4096 else 4.0 / math.sqrt(n)


def test_fresh_parameters_are_drawn_as_flax_draws_them():
    """The transducer recipe at its d512 widths (2 of its 12 layers), its
    transducer and an RNNLM of 2 × 512: every leaf's std within `_std_tol`
    of the flax leaf's (constant leaves equal), and every LSTM gate's H×H
    recurrent block orthogonal to 1e-5."""
    cfg = load_recipe(RECIPE, overrides={"model.num_encoder_layers": 2})
    jmodel, _, jtd = jax_build_model(jax_load_recipe(RECIPE,
                                                     overrides={"model.num_encoder_layers": 2}))
    model, _, td = build_model(cfg, device="cpu")
    eparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 80)),
                                   jnp.asarray([16]))
    tparams = jax.jit(lambda k: jtd.init(k, jnp.zeros((1, 4, 512)), jnp.zeros((1, 3), jnp.int32),
                                         method=jtd.init_all))(jax.random.PRNGKey(1))
    lm_cfg = LMConfig(model_type="rnn", rnn_neurons=512)
    lm = build_lm(lm_cfg, 1000, device="cpu", seed=5)
    jlm = JRNNLM(vocab=1000, rnn_neurons=512)
    lparams = jax.jit(lambda k: jlm.init(k, jnp.zeros((1, 3), jnp.int32)))(jax.random.PRNGKey(2))
    checked = 0
    for port, tree in ((model, eparams), (td, tparams), (lm, lparams)):
        flax_side = load_jax_params(copy.deepcopy(port), tree)
        for (name, p), (_, f) in zip(port.named_parameters(), flax_side.named_parameters()):
            want, got = float(f.detach().std()), float(p.detach().std())
            if want == 0.0:
                assert torch.equal(p, f), name
            else:
                assert abs(got / want - 1.0) <= _std_tol(p.numel()), (name, got, want)
                checked += 1
        for cell in (m for m in port.modules() if isinstance(m, LSTMCell)):
            h = cell.hidden_size
            for g in range(4):
                w = cell.weight_hh[g * h:(g + 1) * h].detach()
                assert float((w @ w.T - torch.eye(h)).abs().max()) <= 1e-5
    assert checked > 30
