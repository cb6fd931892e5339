"""The port's recipe runners (`summarymixing_tpu_torch/recipes/`) on the CPU:
the slice as a whole against the JAX package, the three runners end to end
with a resumed training run, what they refuse, and the kernels'
configuration predicates with `build_trainer`'s refusals.

The slice against JAX: the hard synthetic recipe's model built in flax
from a seed, carried across with `load_jax_params` and saved as a port
checkpoint, evaluated greedily by the port's `evaluate` runner
(`--device cpu`); the JAX `ASRTrainer.eval_step` on the same batches must
give the same hypotheses, and the CTC log-probabilities of the two models
on those batches must agree within 1e-4 (float32 through 4 encoder
layers, the sums in another order)."""

import dataclasses
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
from summarymixing_tpu.parallel.mesh import make_mesh
from summarymixing_tpu.training import optim as joptim
from summarymixing_tpu.training.trainer import ASRTrainer as JTrainer
from summarymixing_tpu.training.trainer import TrainerConfig as JTrainerConfig
from summarymixing_tpu_torch.config import (
    build_model,
    build_trainer,
    build_transducer_trainer,
    load_recipe,
)
from summarymixing_tpu_torch.data.dataio import read_manifest_csv
from summarymixing_tpu_torch.data.tokenizer import CharTokenizer
from summarymixing_tpu_torch.ops import convolution, fused_csgu, fused_summary, summary_mixing
from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing
from summarymixing_tpu_torch.recipes import common, evaluate, train, train_lm, wer_protocol
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.training.optim import TwoStageAdamSGD
from summarymixing_tpu_torch.training.trainer import ASRTrainer, TrainerConfig
from summarymixing_tpu_torch.utils.convert import load_jax_params
from test_torch_data import REPO, make_corpus

SYNTH = os.path.join(REPO, "recipes/Synthetic/hard_synthetic.yaml")
FLAGSHIP = os.path.join(REPO, "recipes/LibriSpeech/branchformer_summarymixing.yaml")
# the corpus's 32 training utterances of 2-3 s hold no full batch at the
# recipe's 60 s budget: 8 s batches in 2 buckets
SMALL_BATCHES = ["--num-buckets", "2", "--set", "training.max_batch_length=8.0"]
SYNTH_TRANSDUCER = os.path.join(REPO, "recipes/Synthetic/hard_synthetic_transducer.yaml")
LOGP_TOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    paths = make_corpus(root, n=40, lm_text=100)
    paths["lm_text"] = os.path.join(str(root), "lm_text.txt")
    return paths


# -- the kernels' configuration predicates ---------------------------------

def _cell(**kw):
    cfg = dict(d=512, local_dims=(512, 512), summary_dims=(512, 512), n=512, activation="gelu",
               dtype=torch.bfloat16)
    return dict(cfg, **kw)


def _branch(**kw):
    return dict(dict(d=512, units=3072, kernel_size=31, activation="gelu",
                     dtype=torch.bfloat16), **kw)


@pytest.mark.parametrize("case,cell,branch", [
    ("flagship", _cell(), _branch()),
    ("flagship_training_keep_mask", _cell(keep=True), _branch()),
    ("erf_gelu_cell", _cell(activation="gelu_exact"), _branch(kernel_size=15)),
])
def test_kernels_take_the_flagship_configuration(case, cell, branch):
    assert fused_summary.takes(**cell) and fused_csgu.takes(**branch)


@pytest.mark.parametrize("case,config", [
    ("cell_d128", _cell(d=128, local_dims=(128, 128), summary_dims=(128, 128), n=128)),
    ("cell_float32", _cell(dtype=torch.float32)),
    ("cell_sum_mask", _cell(sum_mask=True)),
    ("cell_nhead_4", _cell(nhead=4)),
    ("cell_two_hidden_layers", _cell(local_dims=(512, 512, 512))),
    ("cell_fast_mode", _cell(mode="SummaryMixing-fast")),
    ("cell_relu", _cell(activation="relu")),
    ("cell_width_768_summary_with_keep", _cell(summary_dims=(512, 768), keep=True)),
    ("branch_d128_float32", _branch(d=128, units=256, kernel_size=15, dtype=torch.float32)),
    ("branch_float32", _branch(dtype=torch.float32)),
    ("branch_conv_width_7", _branch(kernel_size=7)),
    ("branch_units_192", _branch(units=192)),
    ("branch_gate_activation", _branch(gate_activation="gelu")),
    ("branch_linear_after_conv", _branch(use_linear_after_conv=True)),
    ("branch_erf_gelu", _branch(activation="gelu_exact")),
])
def test_kernels_refuse_configurations_they_do_not_take(case, config):
    """The predicate the modules consult on the card before any launch: a
    configuration it refuses runs the plain path there, counted."""
    mod = fused_summary if case.startswith("cell") else fused_csgu
    assert not mod.takes(**config)
    error, message = mod.refusal(**config)
    assert error in (NotImplementedError, ValueError) and message


def test_synthetic_recipe_is_not_what_the_kernels_take():
    """The hard synthetic recipe (d128, fp32) builds modules whose
    configuration both predicates refuse; the flagship's take both."""
    for recipe, taken in ((SYNTH, False), (FLAGSHIP, True)):
        cfg = load_recipe(recipe)
        model, _ = build_model(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, num_encoder_layers=1,
                                           num_decoder_layers=0)), device="meta")
        layer = model.asr.encoder.layer_0
        dtype = torch.bfloat16 if cfg.training.precision == "bf16" else torch.float32
        x = torch.empty(2, 5, cfg.model.d_model, dtype=dtype, device="meta")
        branch = layer.convolution_branch
        assert fused_summary.takes(**layer.mixer._kernel_config(x, None)) is taken
        assert fused_csgu.takes(
            d=cfg.model.d_model, units=branch.pre_channel_proj.out_features,
            kernel_size=branch.csgu.conv_kernel.shape[0], activation=branch.activation,
            dtype=dtype) is taken


def test_cell_route_is_the_same_in_training_and_the_launch_checks_the_keep_mask():
    """The cell decides its route from its configuration alone, not from
    whether a dropout keep-mask comes with the call: a cell whose summary
    is 768 wide takes the kernel in evaluation and in training alike, and
    in training the launch's check raises for the keep-mask instead of
    the call giving way to the plain path."""
    cell = SummaryMixing(512, local_proj_hid_dim=(512,), local_proj_out_dim=512,
                         summary_hid_dim=(512,), summary_out_dim=768, activation="gelu",
                         dropout_rate=0.1)
    x = torch.zeros(2, 5, 512, dtype=torch.bfloat16)
    for training in (False, True):
        assert fused_summary.takes(**cell.train(training)._kernel_config(x, None))
    weights = fused_summary.kernel_weights(fused_summary.params_to_weights(cell))
    pad = torch.ones(2, 5, 1)
    keep = torch.ones(2, 5, 512 + 768, dtype=torch.bool)
    fused_summary._check(x, pad, weights, "gelu")
    with pytest.raises(ValueError, match="keep-mask"):
        fused_summary._check(x, pad, weights, "gelu", keep)


@pytest.mark.parametrize("setting", ["augment.concat_original=true",
                                     "augment.augment_warmup_steps=5000"])
def test_build_trainer_refuses_unported_augment_settings(setting):
    """Both settings were refused until they were ported: `build_trainer`
    now hands them to the trainer."""
    cfg = load_recipe(SYNTH, overrides=common.parse_overrides([setting]))
    model, fbank = build_model(cfg, device="cpu")
    config = build_trainer(cfg, model, fbank).config
    assert (config.concat_original, config.augment_warmup_steps) == (
        cfg.augment.concat_original, cfg.augment.augment_warmup_steps)
    assert config != build_trainer(load_recipe(SYNTH), model, fbank).config


# -- the slice against JAX ---------------------------------------------------

def _write_run(run_dir, cfg, texts, seed=0):
    """A port run directory holding the flax-initialised hard synthetic
    model as a checkpoint, seeded normalisation statistics and the char
    tokenizer of `texts`; returns (flax model, flax params, port model,
    norm stats as numpy, flax Fbank, port Fbank)."""
    jmodel, jfbank, _ = jax_build_model(jax_load_recipe(SYNTH))
    feats = jnp.zeros((1, 16, cfg.features.n_mels), jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), feats, jnp.asarray([16]),
                                  jnp.ones((1, 3), jnp.int32))
    tmodel, tfbank = build_model(cfg, device="cpu")
    load_jax_params(tmodel, params)
    rng = np.random.default_rng(seed)
    count = np.float32(5e4)
    std = (3.0 + 3.0 * rng.random(cfg.features.n_mels)).astype(np.float32)
    stats = {"count": np.asarray(count), "m2": (std ** 2 * (count - 1)).astype(np.float32),
             "mean": (-8.0 + 4.0 * rng.standard_normal(cfg.features.n_mels)).astype(np.float32)}
    CheckpointManager(os.path.join(run_dir, "save")).save(1, {
        "params": tmodel.state_dict(), "step": 1, "epoch": 1,
        "norm_stats": {k: torch.from_numpy(np.array(v)) for k, v in stats.items()}})
    with open(os.path.join(run_dir, "tokenizer_vocab.json"), "w") as f:
        json.dump(CharTokenizer.build(texts).vocab, f)
    return jmodel, params, tmodel, stats, jfbank, tfbank


def test_evaluate_runner_matches_jax_eval_step(corpus, tmp_path):
    cfg = load_recipe(SYNTH)
    texts = [u.text for u in read_manifest_csv(corpus["train"])]
    run = str(tmp_path / "run")
    os.makedirs(run)
    jmodel, params, tmodel, stats, jfbank, tfbank = _write_run(run, cfg, texts)
    # one bucket: the JAX side compiles one batch shape
    one_bucket = ["--set", "training.num_buckets=1"]
    cfg = load_recipe(SYNTH, overrides=common.parse_overrides(one_bucket[1:]))
    got = evaluate.main([SYNTH, "--test-manifest", corpus["test"], "--ckpt", run + "/save",
                         "--device", "cpu", "--output", str(tmp_path / "eval")] + one_bucket)
    test_set = read_manifest_csv(corpus["test"])
    assert got["utterances"] == len(test_set) == len(got["hyps"])
    assert (tmp_path / "eval" / "wer_details.txt").exists()
    assert json.loads((tmp_path / "eval" / "eval.json").read_text())["WER"] == got["WER"]

    jtrainer = JTrainer(jmodel, joptim.make_adamw(1e-4), jfbank,
                        JTrainerConfig(ctc_weight=cfg.training.ctc_weight, augment=None),
                        mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = {"params": params["params"], "epoch": jnp.zeros((), jnp.int32),
              "norm_stats": {k: jnp.asarray(v) for k, v in stats.items()}}
    forward = jax.jit(jtrainer._forward_loss, static_argnums=(4,))
    tok = CharTokenizer(vocab=json.load(open(os.path.join(run, "tokenizer_vocab.json"))))
    ttrainer = ASRTrainer(tmodel, None, tfbank, TrainerConfig(
        ctc_weight=cfg.training.ctc_weight, augment=None))
    tstats = {k: torch.from_numpy(np.array(v)) for k, v in stats.items()}
    seen, n_batches = {}, 0
    for batch, idx in common.batches(test_set, tok, cfg, False, 0, "cpu"):
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        _, jhyps = jtrainer.eval_step(jstate, jbatch)
        for i, u in enumerate(idx):
            seen.setdefault(test_set[u].utt_id, tok.decode(jhyps[i]).split())
        _, (_, _, jout) = forward(jstate["params"], jstate["norm_stats"], jbatch,
                                  jax.random.PRNGKey(0), True, 0)
        with torch.no_grad():
            _, (_, _, tout) = ttrainer._forward_loss(tstats, batch, False, 1)
        enc_len = np.asarray(jout["enc_lengths"])
        np.testing.assert_array_equal(tout["enc_lengths"].numpy(), enc_len)
        diff = np.abs(tout["ctc_log_probs"].numpy() - np.asarray(jout["ctc_log_probs"]))
        valid = np.arange(diff.shape[1])[None, :] < enc_len[:, None]
        assert diff[valid].max() <= LOGP_TOL
        n_batches += 1
    assert n_batches == 1 and any(seen.values())
    assert seen == got["hyps"]


# -- the runners end to end ---------------------------------------------------

def test_runners_end_to_end_with_resume(corpus, tmp_path):
    """train (2 steps, the test stage at beam 2), a second train call that
    resumes at the next epoch, train_lm (2 steps), and evaluate greedy,
    beam 2 and beam 2 + LM on averaged checkpoints: the files each writes
    and the summaries."""
    run, lm_run = str(tmp_path / "run"), str(tmp_path / "lm")
    beam2 = ["--set", "decoding.test_beam_size=2"]
    first = train.main([SYNTH, "--train-manifest", corpus["train"], "--valid-manifest",
                        corpus["dev"], "--test-manifest", corpus["test"], "--output", run,
                        "--steps", "2", "--device", "cpu"] + SMALL_BATCHES + beam2)
    assert first["steps"] == 2 and first["epochs"] == 1 and len(first["step_s"]) == 2
    assert np.isfinite(first["valid"]["loss"]) and first["test"]["num_sentences"] == 4
    assert sorted(os.listdir(run)) == ["save", "tokenizer_vocab.json", "train_log.jsonl",
                                       "train_log.txt"]
    assert sorted(os.listdir(os.path.join(run, "save", "2"))) == [
        "epoch.pt", "norm_stats.pt", "opt_state.pt", "params.pt", "rng.pt", "step.pt"]
    second = train.main([SYNTH, "--train-manifest", corpus["train"], "--valid-manifest",
                         corpus["dev"], "--output", run, "--steps", "4", "--device",
                         "cpu"] + SMALL_BATCHES)
    assert second["steps"] == 4 and second["epochs"] == 2 and len(second["step_s"]) == 2
    log = [json.loads(line) for line in open(os.path.join(run, "train_log.jsonl"))]
    assert [r["meta"].get("epoch", r["meta"].get("stage")) for r in log] == [1, "test", 2]
    # the kernels' counters rise only on the card
    zero = {"summary_mixing": {"launches": 0, "plain_calls": 0},
            "csgu": {"launches": 0, "plain_calls": 0, "int8_calls": 0},
            "relpos_attention": {"launches": 0, "plain_calls": 0}}
    assert first["kernels"] == second["kernels"] == log[0]["meta"]["kernels"] == zero
    assert CheckpointManager(os.path.join(run, "save")).all_steps() == [2, 4]

    lm = train_lm.main([SYNTH, "--text", corpus["lm_text"], "--tokenizer-dir", run,
                        "--output", lm_run, "--steps", "2", "--device", "cpu"])
    assert lm["steps"] == 2 and np.isfinite(lm["loss"])
    assert json.load(open(os.path.join(lm_run, "lm_config.json")))["d_model"] == 64
    assert os.listdir(os.path.join(lm_run, "save")) == ["2"]

    n_test = len(read_manifest_csv(corpus["test"]))
    for extra, decode in (([], "greedy_ctc"), (["--beam"], "beam"),
                          (["--beam", "--lm-ckpt", lm_run], "beam+lm")):
        out = str(tmp_path / ("eval_" + decode))
        summary = evaluate.main([SYNTH, "--test-manifest", corpus["test"], "--ckpt",
                                 run + "/save/", "--avg", "2", "--device", "cpu",
                                 "--output", out] + beam2 + extra)
        assert summary["decode"] == decode and summary["utterances"] == n_test
        assert np.isfinite(summary["WER"]) and summary["audio_s"] > 0
        assert sorted(os.listdir(out)) == ["eval.json", "wer_details.txt"]
        assert ("lm_weight" in summary) == (decode == "beam+lm")
        assert summary["kernels"] == zero


@pytest.mark.parametrize("runner,recipe,args", [
    ("train", "transducer", ["--profile-steps", "2"]),
    ("train", "synth", ["--profile-steps", "2"]),
    ("evaluate", "synth", ["--set", "model.mode=SummaryMixing-lite"]),
    ("evaluate", "synth", ["--set", "model.causal=true"]),
])
def test_runners_take_what_was_refused(corpus, tmp_path, runner, recipe, args):
    """These were refused until they were ported. `--profile` traces steps
    4-5 of a 5-step run: the trace and the table land in the directory and
    the summary names the trace. A lite or a causal run trains (2 steps)
    and the evaluate runner decodes it greedily to its end."""
    recipe = {"synth": SYNTH, "transducer": SYNTH_TRANSDUCER}[recipe]
    run = str(tmp_path / "run")
    train_args = [recipe, "--train-manifest", corpus["train"], "--valid-manifest", corpus["dev"],
                  "--output", run, "--device", "cpu"] + SMALL_BATCHES
    if runner == "train":
        prof = str(tmp_path / "prof")
        res = train.main(train_args + ["--steps", "5", "--profile", prof] + args)
        assert res["steps"] == 5 and res["profile"] == os.path.join(prof, "trace.json")
        assert sorted(os.listdir(prof)) == ["key_averages.txt", "trace.json"]
        assert json.load(open(res["profile"]))["traceEvents"]
        return
    train.main(train_args + ["--steps", "2"] + args)
    summary = evaluate.main([recipe, "--test-manifest", corpus["test"], "--ckpt",
                             os.path.join(run, "save"), "--device", "cpu"] + args)
    assert summary["utterances"] == 4 and np.isfinite(summary["WER"])
    assert summary["decode"] == "greedy_ctc"


@pytest.mark.parametrize("runner,recipe,args,match", [
    ("evaluate", "transducer", ["--seq-parallel", "2"], "greedy CTC decode only"),
    ("evaluate", "synth", ["--seq-parallel", "2"], "1 devices not divisible by --seq-parallel 2"),
], ids=["evaluate-transducer-args0-seq-parallel", "evaluate-synth-args1-seq-parallel"])
def test_runners_refuse_what_is_not_ported(corpus, tmp_path, runner, recipe, args, match):
    """What the JAX runner refuses, with its messages: `--seq-parallel`
    for a transducer recipe, and over more processes than there are (one
    process here). The sharded decode itself runs in
    `tests/test_torch_sequence_parallel.py` and the multi-process runner
    in `tests/test_torch_launch.py`."""
    recipe = {"synth": SYNTH, "transducer": SYNTH_TRANSDUCER}[recipe]
    common_args = {"train": ["--train-manifest", corpus["train"], "--valid-manifest",
                             corpus["dev"], "--output", str(tmp_path / "run")] + SMALL_BATCHES,
                   "evaluate": ["--test-manifest", corpus["test"], "--ckpt",
                                str(tmp_path / "run" / "save")]}
    main = {"train": train.main, "evaluate": evaluate.main}[runner]
    with pytest.raises(SystemExit, match=match):
        main([recipe] + common_args[runner] + args + ["--device", "cpu"])


@pytest.mark.parametrize("recipe,setting", [
    ("recipes/VoxPopuli/conformer_summarymixing_transducer.yaml", None),
    ("recipes/Synthetic/hard_synthetic_transducer.yaml", "training.scheduler=two_stage"),
    ("recipes/Synthetic/hard_synthetic_transducer.yaml", "augment.concat_original=true"),
])
def test_build_transducer_trainer_refuses_what_is_not_ported(recipe, setting):
    """These three were refused until they were ported; each now builds, as
    the JAX runner builds it: VoxPopuli's `augment_warmup_steps: 5000`
    reaches the trainer, `two_stage` gives the two-stage optimizer, and
    `concat_original`,
    which the JAX runner hands only to the CTC/attention trainer, is not
    read."""
    cfg = load_recipe(os.path.join(REPO, recipe),
                      overrides=common.parse_overrides([setting] if setting else []))
    model, fbank, td = build_model(cfg, device="meta")
    trainer = build_transducer_trainer(cfg, model, fbank, td)
    assert trainer.config.augment_warmup_steps == cfg.augment.augment_warmup_steps
    inner = getattr(trainer.optimizer, "inner", trainer.optimizer)
    assert isinstance(inner, TwoStageAdamSGD) == (setting == "training.scheduler=two_stage")
    assert not hasattr(trainer.config, "concat_original")


def test_evaluate_runner_reports_plain_calls(corpus, tmp_path, monkeypatch):
    """The summary's `kernels` counts the calls of the card's route. With
    that route taken on the CPU (`uses_kernel` patched), the synthetic
    recipe (d128, float32), which neither kernel takes, runs every cell
    and cgMLP branch on the plain path: one plain call per encoder layer
    and batch in each wrapper, no launch, and the same hypotheses."""
    cfg = load_recipe(SYNTH)
    run = str(tmp_path / "run")
    model, _ = build_model(cfg, device="cpu")
    n_mels = cfg.features.n_mels
    CheckpointManager(os.path.join(run, "save")).save(1, {
        "params": model.state_dict(), "step": 1, "epoch": 1,
        "norm_stats": {"count": torch.tensor(5e4), "m2": torch.full((n_mels,), 5e5),
                       "mean": torch.full((n_mels,), -8.0)}})
    test_set = read_manifest_csv(corpus["test"])
    tok = CharTokenizer.build([u.text for u in read_manifest_csv(corpus["train"])])
    with open(os.path.join(run, "tokenizer_vocab.json"), "w") as f:
        json.dump(tok.vocab, f)
    argv = [SYNTH, "--test-manifest", corpus["test"], "--ckpt", run + "/save", "--device",
            "cpu"]
    plain = evaluate.main(argv)
    monkeypatch.setattr(summary_mixing, "uses_kernel", lambda x: True)
    monkeypatch.setattr(convolution, "uses_kernel", lambda x: True)
    # the counters are the process's: put them back after the test, so a
    # later test in this worker reads what its own calls counted
    for wrapper in (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch):
        monkeypatch.setattr(wrapper, "plain_calls", wrapper.plain_calls)
    routed = evaluate.main(argv)
    n = cfg.model.num_encoder_layers * sum(
        1 for _ in common.batches(test_set, tok, cfg, False, 0, "cpu"))
    assert n > 0 and routed["kernels"] == {
        "summary_mixing": {"launches": 0, "plain_calls": n},
        "csgu": {"launches": 0, "plain_calls": n, "int8_calls": 0},
        "relpos_attention": {"launches": 0, "plain_calls": 0}}
    assert routed["hyps"] == plain["hyps"]


@pytest.mark.parametrize("runner,flag", [
    ("wer_protocol", "--epochs"), ("wer_protocol", "--ckpt-interval-minutes")])
def test_runners_have_no_flag_that_nothing_reads(runner, flag, tmp_path):
    """The protocol's epochs and checkpoint interval are constants."""
    argv = {"wer_protocol": [str(tmp_path)]}[runner]
    main = {"wer_protocol": wer_protocol.main}[runner]
    with pytest.raises(SystemExit):
        main(argv + [flag, "1", "--device", "cpu"])


def test_subword_recipe_refuses_a_sentencepiece_model(corpus, tmp_path):
    """A SentencePiece `.model` in the run directory was refused until its
    reader was ported; now both the train and the evaluate runners read
    it instead of training another tokenizer over it, and one that does
    not parse stops them."""
    from summarymixing_tpu_torch.data.sentencepiece_model import serialize_model_proto

    cfg = load_recipe(FLAGSHIP)
    (tmp_path / "tokenizer.model").write_bytes(serialize_model_proto(
        [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("\u2581hi", -1.0, 1)]))
    for tok in (common.build_or_load_tokenizer(cfg, str(tmp_path),
                                               read_manifest_csv(corpus["train"])),
                evaluate.resolve_tokenizer(cfg, str(tmp_path))):
        assert tok.vocab_size == 4 and tok.encode("hi") == [3]
    assert not (tmp_path / "tokenizer.json").exists()
    (tmp_path / "tokenizer.model").write_bytes(b"\n")   # a length with no bytes after it
    with pytest.raises(IndexError):
        common.build_or_load_tokenizer(cfg, str(tmp_path), read_manifest_csv(corpus["train"]))
    with pytest.raises(IndexError):
        evaluate.resolve_tokenizer(cfg, str(tmp_path))


def test_flagship_tokenizer_is_trained_and_persisted(corpus, tmp_path):
    """The flagship recipe (`sentencepiece`, `unigram`, 5000) without a
    `.model` trains the subword model on the transcripts, writes it, and
    reads it back on the next call and from evaluation."""
    cfg = load_recipe(FLAGSHIP)
    train_set = read_manifest_csv(corpus["train"])
    tok = common.build_or_load_tokenizer(cfg, str(tmp_path), train_set)
    assert 3 < tok.vocab_size <= cfg.model.output_neurons
    again = common.build_or_load_tokenizer(cfg, str(tmp_path), [])
    assert again.pieces == tok.pieces
    assert evaluate.resolve_tokenizer(cfg, evaluate.run_dir_of(str(tmp_path / "save/"))).pieces \
        == tok.pieces


def test_parse_overrides_reads_values_as_recipes_do():
    got = common.parse_overrides(["training.lr_adam=0.0005", "augment.speeds=[95, 100]",
                                  "training.adam_eps=1.0e-9", "augment.fea_augment=false",
                                  "name=run1", "training.max_batch_length_val=~"])
    assert got == {"training.lr_adam": 0.0005, "augment.speeds": [95, 100],
                   "training.adam_eps": 1e-9, "augment.fea_augment": False, "name": "run1",
                   "training.max_batch_length_val": None}
    with pytest.raises(SystemExit):
        common.parse_overrides(["training.lr_adam"])


def test_batches_hold_the_manifest(corpus):
    """Evaluation batches cover every utterance with its waveform and
    tokens; training batches drop each bucket's short tail."""
    cfg = load_recipe(SYNTH)
    test_set = read_manifest_csv(corpus["test"])
    tok = CharTokenizer.build([u.text for u in test_set])
    seen = set()
    for batch, idx in common.batches(test_set, tok, cfg, False, 0, "cpu"):
        assert batch["wav"].dtype == torch.float32 and batch["tokens"].dtype == torch.int32
        assert batch["tokens"].shape[1] % cfg.training.eval_token_multiple == 0
        for row, u in enumerate(idx):
            n = int(batch["token_lens"][row])
            assert batch["tokens"][row, :n].tolist() == tok.encode(test_set[u].text)
            assert abs(int(batch["wav_lens"][row]) / 16000 - test_set[u].duration) < 1e-3
            seen.add(int(u))
    assert seen == set(range(len(test_set)))
