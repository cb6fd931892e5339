"""The transducer branches of the port's runners on the CPU:
`recipes/Synthetic/hard_synthetic_transducer.yaml` (d128, 4 layers) trained
for a few steps on a 40-utterance synthetic corpus, resumed, and evaluated
greedy, with the beam (and an RNNLM trained by `train_lm --model-type
rnn`), chunked streaming and the raw-audio pipeline; the streaming flags'
way into the summary. The slice against the JAX package is
`tests/test_torch_transducer_train.py`; the runners' refusals are in
`tests/test_torch_recipes.py`."""

import json
import os

import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu_torch.data.dataio import read_manifest_csv
from summarymixing_tpu_torch.recipes import evaluate, train, train_lm
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from test_torch_data import REPO, make_corpus

SYNTH_TRANSDUCER = os.path.join(REPO, "recipes/Synthetic/hard_synthetic_transducer.yaml")
# the corpus's 32 training utterances of 2-3 s hold no full batch at the
# recipe's 60 s budget: 8 s batches in 2 buckets
SMALL_BATCHES = ["--num-buckets", "2", "--set", "training.max_batch_length=8.0"]
SMALL_EVAL = ["--set", "training.num_buckets=2", "--set", "training.max_batch_length=8.0"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    paths = make_corpus(root, n=40, lm_text=100)
    paths["lm_text"] = os.path.join(str(root), "lm_text.txt")
    return paths


@pytest.fixture(scope="module")
def trained_run(corpus, tmp_path_factory):
    """The recipe trained for 2 steps."""
    run = str(tmp_path_factory.mktemp("trained") / "run")
    train.main([SYNTH_TRANSDUCER, "--train-manifest", corpus["train"], "--valid-manifest",
                corpus["dev"], "--output", run, "--steps", "2", "--device", "cpu"]
               + SMALL_BATCHES)
    return run


@pytest.mark.parametrize("flag,decode,timing", [
    ("--streaming", "transducer_streaming_greedy", "chunk_latency_ms_p90"),
    ("--streaming-full", "transducer_streaming_full_pipeline", "chunk_ms_mean")])
def test_chunk_size_and_left_context_reach_the_streaming_summary(corpus, trained_run, flag,
                                                                 decode, timing):
    """`--chunk-size` and `--left-context` set the streaming decode: the
    summary reports them (the defaults are 16 and 4) beside the chunk
    timing, over every test utterance."""
    argv = [SYNTH_TRANSDUCER, "--test-manifest", corpus["test"], "--ckpt", trained_run + "/save",
            "--device", "cpu", flag] + SMALL_EVAL
    out = evaluate.main(argv + ["--chunk-size", "8", "--left-context", "3"])
    default = evaluate.main(argv)
    assert out["decode"] == default["decode"] == decode and timing in out
    assert (out["chunk_frames"], out["left_context_chunks"]) == (8, 3)
    assert (default["chunk_frames"], default["left_context_chunks"]) == (16, 4)
    assert out["utterances"] == default["utterances"] == len(read_manifest_csv(corpus["test"]))


def test_transducer_runners_train_resume_and_evaluate(corpus, tmp_path):
    """The transducer recipe through the runners: train (2 steps with a
    mid-epoch validation at step 2 and the beam test stage), a resumed call
    to 4 steps, the RNNLM (2 steps at small
    widths), and evaluate greedy, beam, beam + RNNLM, streaming and the
    raw-audio pipeline on the 2 averaged checkpoints."""
    run, lm_run = str(tmp_path / "run"), str(tmp_path / "lm")
    beam2 = ["--set", "decoding.beam_size=2"]
    first = train.main([SYNTH_TRANSDUCER, "--train-manifest", corpus["train"],
                        "--valid-manifest", corpus["dev"], "--test-manifest", corpus["test"],
                        "--output", run, "--steps", "2", "--device", "cpu",
                        "--set", "training.valid_every_steps=2"] + SMALL_BATCHES + beam2)
    assert first["steps"] == 2 and first["epochs"] == 1
    assert np.isfinite(first["valid"]["loss"]) and first["test"]["num_sentences"] == 4
    assert sorted(os.listdir(os.path.join(run, "save", "2"))) == [
        "epoch.pt", "norm_stats.pt", "opt_state.pt", "params.pt", "rng.pt", "step.pt"]
    params = torch.load(os.path.join(run, "save", "2", "params.pt"), weights_only=True)
    assert {k.split(".")[0] for k in params} == {"encoder", "transducer"}
    second = train.main([SYNTH_TRANSDUCER, "--train-manifest", corpus["train"],
                         "--valid-manifest", corpus["dev"], "--output", run, "--steps", "4",
                         "--device", "cpu"] + SMALL_BATCHES)
    assert second["steps"] == 4 and second["epochs"] == 2 and len(second["step_s"]) == 2
    log = [json.loads(line) for line in open(os.path.join(run, "train_log.jsonl"))]
    assert [r["meta"].get("valid_step", r["meta"].get("epoch", r["meta"].get("stage")))
            for r in log] == [2, 1, "test", 2]
    assert np.isfinite(log[0]["valid"]["WER"])
    assert CheckpointManager(os.path.join(run, "save")).all_steps() == [2, 4]

    small_lm = ["--set", "lm.embedding_dim=16", "--set", "lm.rnn_neurons=32",
                "--set", "lm.dnn_neurons=24"]
    lm = train_lm.main([SYNTH_TRANSDUCER, "--text", corpus["lm_text"], "--tokenizer-dir", run,
                        "--output", lm_run, "--steps", "2", "--model-type", "rnn",
                        "--device", "cpu"] + small_lm)
    assert lm["steps"] == 2 and np.isfinite(lm["loss"])
    lm_cfg = json.load(open(os.path.join(lm_run, "lm_config.json")))
    assert (lm_cfg["model_type"], lm_cfg["rnn_neurons"]) == ("rnn", 32)

    n_test = len(read_manifest_csv(corpus["test"]))
    zero = {"summary_mixing": {"launches": 0, "plain_calls": 0},
            "csgu": {"launches": 0, "plain_calls": 0, "int8_calls": 0},
            "relpos_attention": {"launches": 0, "plain_calls": 0}}
    for extra, decode in (([], "transducer_greedy"), (["--beam"], "transducer_beam"),
                          (["--beam", "--lm-ckpt", lm_run], "transducer_beam+lm"),
                          (["--streaming", "--chunk-size", "8"], "transducer_streaming_greedy"),
                          (["--streaming-full", "--chunk-size", "8"],
                           "transducer_streaming_full_pipeline")):
        out = str(tmp_path / ("eval_" + decode))
        summary = evaluate.main([SYNTH_TRANSDUCER, "--test-manifest", corpus["test"], "--ckpt",
                                 run + "/save/", "--avg", "2", "--device", "cpu",
                                 "--output", out] + SMALL_EVAL + beam2 + extra)
        assert summary["decode"] == decode and summary["utterances"] == n_test
        assert np.isfinite(summary["WER"]) and summary["rtf"] > 0
        assert sorted(os.listdir(out)) == ["eval.json", "wer_details.txt"]
        assert ("lm_weight" in summary) == (decode == "transducer_beam+lm")
        assert summary["kernels"] == zero
