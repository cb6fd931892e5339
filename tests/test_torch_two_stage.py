"""The other recipes' training set-up in the port, against the JAX package
where it has a counterpart:

- `make_two_stage_adam_sgd` against the optax transform over 6 optimizer
  steps across the switch, with clipping, with and without accumulation:
  parameters within 1e-6, the SGD momentum zero before the switch;
- `concat_original` and `augment_warmup_steps` against the JAX trainer's
  losses, with the augmentation made the same deterministic transform on
  both sides;
- `TrainStopper` on SIGTERM and on its budget;
- the `train` runner's `--max-hours` stop and its resume past the
  two-stage switch, on a d64 Summary Decoder recipe, and `evaluate --beam`
  on its checkpoints;
- remat's gradients against none, with and without dropout keep-masks
  drawn from the trainer's generator;
- every recipe the repository ships builds its model and trainer through
  `config/loader.py` at reduced widths.
"""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.frontend.augment import SpecAugmentConfig as JSpecAugmentConfig
from summarymixing_tpu.frontend.features import Fbank as JFbank
from summarymixing_tpu.frontend.features import NormStats as JNormStats
from summarymixing_tpu.parallel.mesh import make_mesh
from summarymixing_tpu.training import optim as joptim
from summarymixing_tpu.training import trainer as jtrainer_module
from summarymixing_tpu.training.trainer import ASRTrainer as JTrainer
from summarymixing_tpu.training.trainer import TrainerConfig as JTrainerConfig
from summarymixing_tpu_torch.config import (
    build_model,
    build_trainer,
    build_transducer_trainer,
    load_recipe,
)
from summarymixing_tpu_torch.frontend.augment import SpecAugmentConfig
from summarymixing_tpu_torch.frontend.features import Fbank, NormStats
from summarymixing_tpu_torch.models.asr import TransformerASR
from summarymixing_tpu_torch.ops.layers import set_dropout_generator
from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing
from summarymixing_tpu_torch.recipes import common, evaluate, train
from summarymixing_tpu_torch.training import optim
from summarymixing_tpu_torch.training import trainer as ttrainer_module
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.training.preempt import TrainStopper
from summarymixing_tpu_torch.training.trainer import ASRTrainer, TrainerConfig
from summarymixing_tpu_torch.utils.init import init_parameters
from test_torch_data import RECIPES, REPO, make_corpus
from test_torch_summary_decoder import _models

SD_SYNTH = os.path.join(REPO, "recipes/Synthetic/hard_synthetic_summarydecoder.yaml")


# -- the two-stage optimizer ----------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_two_stage_matches_optax_across_the_switch(rng, accum):
    """Three tensors, 6 optimizer steps (`accum` micro-batches each) with
    the switch after 3, gradients scaled so that some steps clip at norm
    5: the parameters after every micro step within 1e-6 of optax's
    `make_two_stage_adam_sgd`; the SGD momentum exactly zero before the
    switch and non-zero after it; the reported stage "adam" for 3 steps,
    then "sgd"."""
    shapes = [(4, 3), (3,), (2, 5)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(sgd_lr=0.05, switch_step=3, weight_decay=0.01, betas=(0.9, 0.98), eps=1e-8,
              max_grad_norm=5.0, sgd_momentum=0.99, sgd_nesterov=True, accum_steps=accum)
    tx = joptim.make_two_stage_adam_sgd(joptim.noam_schedule(1e-2, 2), **kw)
    port = optim.make_two_stage_adam_sgd(optim.noam_schedule(1e-2, 2), **kw)
    jparams = {str(i): jnp.asarray(p) for i, p in enumerate(p0)}
    jstate = tx.init(jparams)
    params = [torch.from_numpy(p.copy()) for p in p0]
    state = port.init(params)
    stages = []
    for i in range(6 * accum):
        scale = 4.0 if i % 3 else 0.3
        grads = [scale * rng.standard_normal(s).astype(np.float32) for s in shapes]
        if i % accum == 0:
            stages.append(optim.optimizer_stage(port, state))
        updates, jstate = tx.update({str(k): jnp.asarray(g) for k, g in enumerate(grads)},
                                    jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        state = port.step(params, [torch.from_numpy(g) for g in grads], state)
        for k, p in enumerate(params):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[str(k)]), atol=1e-6,
                                       rtol=0, err_msg=f"micro step {i}, tensor {k}")
        inner = state["inner"] if accum > 1 else state
        trace_zero = all(not t.any() for t in inner["trace"])
        assert trace_zero == (inner["count"] <= 3), (i, inner["count"])
    assert stages == ["adam"] * 3 + ["sgd"] * 3


# -- concat_original and augment_warmup_steps against the JAX trainer ------------

def _drop_frames_jax(key, x, pad_mask=None, config=None):
    return x.at[:, 3:9].set(0.0)


def _drop_frames_torch(x, pad_mask=None, config=None, generator=None):
    x = x.clone()
    x[:, 3:9] = 0.0
    return x


def _batch(rng):
    secs = (0.5, 0.3, 0.42)
    wav = np.zeros((3, 8000), np.float32)
    for i, s in enumerate(secs):
        wav[i, :int(16000 * s)] = 0.3 * rng.standard_normal(int(16000 * s))
    return {"wav": wav, "wav_lens": np.array([int(16000 * s) for s in secs], np.int32),
            "tokens": rng.integers(3, 30, (3, 5)).astype(np.int32),
            "token_lens": np.array([5, 2, 4], np.int32)}


@pytest.mark.parametrize("case,concat,warmup,steps", [
    ("concat_original", True, 0, (0,)),
    ("augment_warmup_steps", False, 5, (4, 5)),
])
def test_augment_settings_match_the_jax_trainer(rng, monkeypatch, case, concat, warmup, steps):
    """The tiny recognizer with the Summary Decoder, fp32, dropout 0, the
    augmentation replaced on both sides by zeroing frames 3-8: the
    training-mode losses (CTC, attention, total) within 1e-5 relative of
    the JAX trainer's `_forward_loss` at each step; `concat_original` runs
    the model on the doubled batch; before the warm-up step the loss is the
    unaugmented one, from it on the augmented one."""
    monkeypatch.setattr(jtrainer_module, "spec_augment", _drop_frames_jax)
    monkeypatch.setattr(ttrainer_module, "spec_augment", _drop_frames_torch)
    jmodel, tmodel, params = _models("SummaryMixing")
    batch = _batch(rng)
    jtrainer = JTrainer(jmodel, joptim.make_adamw(joptim.noam_schedule(1e-3, 4)),
                        JFbank(win_length_ms=32.0),
                        JTrainerConfig(ctc_weight=0.3, label_smoothing=0.0,
                                       augment=JSpecAugmentConfig(), concat_original=concat,
                                       augment_warmup_steps=warmup,
                                       xavier_init_overwrite=False),
                        mesh=make_mesh(devices=jax.devices()[:1]))
    trainer = ASRTrainer(tmodel, optim.AdamW(optim.noam_schedule(1e-3, 4)),
                         Fbank(win_length_ms=32.0),
                         TrainerConfig(ctc_weight=0.3, label_smoothing=0.0,
                                       augment=SpecAugmentConfig(), concat_original=concat,
                                       augment_warmup_steps=warmup,
                                       xavier_init_overwrite=False))
    loss_fn = jax.jit(jtrainer._forward_loss, static_argnums=(4,))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    totals = []
    for step in steps:
        _, (jlosses, _, jout) = loss_fn(params["params"], JNormStats.init(80), jbatch,
                                        jax.random.PRNGKey(0), False, 0, step)
        with torch.no_grad():
            _, (losses, _, out) = trainer._forward_loss(NormStats.init(80), tbatch, True, 0,
                                                        torch.Generator(), step)
        assert out["ctc_log_probs"].shape[0] == (6 if concat else 3)
        assert jout["ctc_log_probs"].shape[0] == out["ctc_log_probs"].shape[0]
        for key in ("loss", "ctc", "att"):
            np.testing.assert_allclose(float(losses[key]), float(jlosses[key]), rtol=1e-5,
                                       err_msg=f"{key} at step {step}")
        totals.append(float(losses["loss"]))
    if len(totals) == 2:
        assert totals[0] != totals[1]


# -- TrainStopper ------------------------------------------------------------

@pytest.mark.parametrize("cause", ["SIGTERM", "WALLCLOCK"])
def test_train_stopper_stops_on_a_signal_and_on_its_budget(cause):
    """A SIGTERM to the process, or a spent budget, makes `should_stop`
    true and names the cause; without either it stays false; the handler
    that was installed before comes back on exit."""
    before = signal.getsignal(signal.SIGTERM)
    with TrainStopper(max_hours=0.0 if cause == "WALLCLOCK" else None) as stopper:
        assert signal.getsignal(signal.SIGTERM) is not before
        if cause == "SIGTERM":
            assert not stopper.should_stop()
            os.kill(os.getpid(), signal.SIGTERM)
        assert stopper.should_stop() and stopper.signame == cause
        assert stopper.should_stop()
    assert signal.getsignal(signal.SIGTERM) is before


# -- the train runner: --max-hours, two_stage, concat_original -----------------

D64 = ["--set", "model.d_model=64", "--set", "model.num_encoder_layers=2",
       "--set", "model.num_decoder_layers=2", "--set", "model.d_ffn=128",
       "--set", "model.csgu_linear_units=128", "--set", "model.local_proj_hid_dim=[64]",
       "--set", "model.local_proj_out_dim=64", "--set", "model.summary_hid_dim=[64]",
       "--set", "model.summary_out_dim=64", "--set", "training.max_batch_length=8.0",
       "--set", "training.scheduler=two_stage", "--set", "training.stage_one_epochs=1",
       "--set", "augment.concat_original=true", "--set", "decoding.test_beam_size=2",
       "--num-buckets", "2", "--device", "cpu"]


def test_train_max_hours_stops_and_resumes_past_the_switch(tmp_path):
    """The Summary Decoder recipe at d64 with the two-stage optimizer
    (switch after one epoch of the estimated steps) and `concat_original`:
    `--max-hours 0` checkpoints after one step and stops; the same command
    without it resumes at that step and passes the switch ("adam" until
    the estimated epoch's steps, then "sgd"), with the beam test stage;
    a third call resumes past the switch in SGD with the momentum it
    saved; `evaluate --beam` decodes on the checkpoints."""
    corpus = make_corpus(tmp_path / "corpus", n=40)
    run = str(tmp_path / "run")
    base = [SD_SYNTH, "--train-manifest", corpus["train"], "--valid-manifest", corpus["dev"],
            "--output", run] + D64
    cfg = load_recipe(SD_SYNTH, overrides=common.parse_overrides(["training.max_batch_length=8.0"]))
    cfg.training.num_buckets = 2
    from summarymixing_tpu_torch.data.dataio import read_manifest_csv

    switch = common.estimate_steps_per_epoch(read_manifest_csv(corpus["train"]), cfg)
    assert switch >= 2

    first = train.main(base + ["--max-hours", "0"])
    assert first["stopped"] == "WALLCLOCK" and first["steps"] == 1
    assert first["opt_stages"] == ["adam"]
    assert CheckpointManager(os.path.join(run, "save")).all_steps() == [1]

    second = train.main(base + ["--test-manifest", corpus["test"], "--steps", str(switch + 2)])
    assert second["steps"] == switch + 2 and "stopped" not in second
    assert second["opt_stages"] == ["adam"] * (switch - 1) + ["sgd"] * 2
    assert second["test"]["num_sentences"] == 4
    log = [json.loads(line) for line in open(os.path.join(run, "train_log.jsonl"))]
    assert log[0]["meta"]["opt_stage"] == "sgd"

    third = train.main(base + ["--max-hours", "0"])
    assert third["stopped"] == "WALLCLOCK" and third["steps"] == switch + 3
    assert third["opt_stages"] == ["sgd"]
    saved = CheckpointManager(os.path.join(run, "save")).restore(("opt_state",), partial=True,
                                                                 device="cpu")
    assert saved["opt_state"]["count"] == switch + 3
    assert any(t.any() for t in saved["opt_state"]["trace"])

    out = evaluate.main([SD_SYNTH, "--test-manifest", corpus["test"], "--ckpt",
                         os.path.join(run, "save"), "--avg", "2", "--beam"] + D64[:-4]
                        + ["--device", "cpu"])
    assert out["decode"] == "beam" and out["utterances"] == 4 and np.isfinite(out["WER"])


# -- remat -------------------------------------------------------------------

@pytest.mark.parametrize("encoder", ["branchformer", "conformer"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_gradients_equal_those_without(encoder, dropout):
    """Two encoder layers with and without `remat`, the same weights; with
    dropout the keep-masks come from one generator per model, seeded
    alike. The encoder output, every gradient and the generator's state
    after the backward are the same, bit for bit: the recompute draws the
    forward's keep-masks and leaves the generator where it was."""
    kw = dict(tgt_vocab=12, input_size=24, d_model=32, nhead=1, num_encoder_layers=2,
              num_decoder_layers=0, d_ffn=64, encoder_module=encoder, csgu_linear_units=64,
              kernel_size=5, dropout_rate=dropout, local_proj_hid_dim=(32,),
              local_proj_out_dim=32, summary_hid_dim=(32,), summary_out_dim=32,
              mode="SummaryMixing" if encoder == "branchformer" else "SummaryMixing-fast")
    plain = TransformerASR(**kw)
    init_parameters(plain, torch.Generator().manual_seed(1))
    remat = TransformerASR(**kw, remat=True)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 10, 24)).astype(np.float32))
    results = []
    for model in (plain, remat):
        gen = torch.Generator().manual_seed(5)
        set_dropout_generator(model, gen)
        out = model.train().encode(x, torch.tensor([1.0, 0.7]))
        (out ** 2).sum().backward()
        results.append((out.detach(), [p.grad for p in model.parameters()], gen.get_state()))
    (out_a, grads_a, gen_a), (out_b, grads_b, gen_b) = results
    assert torch.equal(out_a, out_b) and torch.equal(gen_a, gen_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))
    if dropout:
        no_dropout = TransformerASR(**dict(kw, dropout_rate=0.0))
        no_dropout.load_state_dict(plain.state_dict())
        assert not torch.equal(no_dropout.train().encode(x, torch.tensor([1.0, 0.7])), out_a)


# -- every recipe builds -------------------------------------------------------

SMALL = {"model.d_model": 64, "model.num_encoder_layers": 1, "model.d_ffn": 64,
         "model.csgu_linear_units": 64, "model.local_proj_hid_dim": [64],
         "model.local_proj_out_dim": 64, "model.summary_hid_dim": [64],
         "model.summary_out_dim": 64, "model.output_neurons": 20, "transducer.dec_dim": 32,
         "transducer.joint_dim": 32, "lm.d_model": 32}


@pytest.mark.parametrize("recipe", RECIPES)
def test_every_recipe_builds_its_model_and_trainer(recipe):
    """Each recipe at d64 with one encoder layer (and `model.remat` on):
    `build_model` and `build_trainer` or `build_transducer_trainer` raise
    nothing, and carry what the recipe sets: the two-stage optimizer (under
    `MultiSteps` when it accumulates), `concat_original`,
    `augment_warmup_steps`, the Summary Decoder's cells and remat."""
    over = dict(SMALL, **{"model.remat": True})
    raw = load_recipe(os.path.join(REPO, recipe))
    if raw.model.num_decoder_layers:
        over["model.num_decoder_layers"] = 1
    if raw.transducer is None:
        over.pop("transducer.dec_dim"), over.pop("transducer.joint_dim")
    cfg = load_recipe(os.path.join(REPO, recipe), overrides=over)
    if cfg.transducer is not None:
        model, fbank, td = build_model(cfg, device="cpu")
        trainer = build_transducer_trainer(cfg, model, fbank, td, steps_per_epoch=10)
        assert trainer.config.augment_warmup_steps == raw.augment.augment_warmup_steps
    else:
        model, fbank = build_model(cfg, device="cpu")
        trainer = build_trainer(cfg, model, fbank, steps_per_epoch=10)
        assert trainer.config.concat_original == raw.augment.concat_original
        assert trainer.config.augment_warmup_steps == raw.augment.augment_warmup_steps
    assert model.asr.encoder.remat
    opt = trainer.optimizer
    inner = opt.inner if isinstance(opt, optim.MultiSteps) else opt
    assert isinstance(opt, optim.MultiSteps) == (raw.training.grad_accumulation_factor > 1)
    if raw.training.scheduler == "two_stage":
        accum = raw.training.grad_accumulation_factor
        assert isinstance(inner, optim.TwoStageAdamSGD)
        assert inner.switch_step == raw.training.stage_one_epochs * max(10 // accum, 1)
        assert inner.sgd_lr == raw.training.lr_sgd
    else:
        assert isinstance(inner, optim.AdamW)
    if raw.model.decoder_attention_type == "SummaryMixing":
        cells = [layer.self_attn for layer in model.asr.decoder.layers()]
        assert cells and all(isinstance(c, SummaryMixing) for c in cells)
