"""The port's multi-process launch (`summarymixing_tpu_torch/parallel/launch.py`):
the single-process semantics of `tests/test_multihost.py`, then real
2-process gloo runs of the port's train runner on the CPU (one process
per rank, `SMT_COORDINATOR` / `SMT_NUM_PROCESSES` / `SMT_PROCESS_ID`)
against one process on the same batches, at dropout 0 without
augmentation (the processes draw their own random bits): a CTC recipe,
and a transducer recipe that accumulates 2 micro-batches per optimizer
step; the CTC run's `evaluate --seq-parallel 2` over both processes
against one; then the stop step the processes agree on when one alone
gets SIGTERM, and the resumed rerun.

The recipes' buckets hold 8 utterances (`max_batch_ex` 8 binds before the
100 s budget in every bucket), a multiple of 2, so the single process
draws the same batches as the two together.
"""

import json
import os
import signal
import socket
import subprocess
import sys

import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu_torch.parallel import launch
from summarymixing_tpu_torch.recipes import evaluate, train
from summarymixing_tpu_torch.training import logger as logger_mod
from summarymixing_tpu_torch.training import optim
from summarymixing_tpu_torch.training import preempt
from test_torch_data import REPO, make_corpus

RANK_TOL = 1e-6     # the processes' validation losses: one all-reduced value each
SINGLE_TOL = 1e-4   # relative, against one process: sums in another order

CTC_RECIPE = """
name: tiny_dist
seed: 1
tokenizer_type: char
model:
  attention_type: SummaryMixing
  mode: SummaryMixing
  encoder_module: branchformer
  d_model: 32
  nhead: 1
  num_encoder_layers: 1
  num_decoder_layers: 0
  d_ffn: 32
  transformer_dropout: 0.0
  csgu_linear_units: 32
  csgu_kernel_size: 5
  local_proj_hid_dim: [16]
  local_proj_out_dim: 32
  summary_hid_dim: [16]
  summary_out_dim: 16
  input_size: 80
  output_neurons: 40
  frontend_channels: [4, 4]
training:
  number_of_epochs: {epochs}
  precision: fp32
  ctc_weight: 1.0
  lr_adam: 0.001
  n_warmup_steps: 10
  max_batch_length: 100.0
  num_buckets: 2
  max_batch_ex: 8
  ckpt_interval_minutes: 999
augment:
  speed_perturb: false
  fea_augment: false
"""

TRANSDUCER_RECIPE = """
name: tiny_dist_transducer
seed: 1
tokenizer_type: char
model:
  attention_type: SummaryMixing
  mode: SummaryMixing-fast
  encoder_module: conformer
  d_model: 32
  nhead: 1
  num_encoder_layers: 1
  num_decoder_layers: 0
  d_ffn: 32
  transformer_dropout: 0.0
  csgu_kernel_size: 5
  local_proj_hid_dim: [16]
  local_proj_out_dim: 32
  summary_hid_dim: [16]
  summary_out_dim: 32
  input_size: 80
  output_neurons: 40
  frontend_channels: [4, 4]
  bos_index: 0
  eos_index: 0
transducer:
  joint_dim: 32
  dec_dim: 24
  dec_emb_dropout: 0.0
  dec_dropout: 0.0
  chunk_size_min: 2
  chunk_size_max: 8
  left_context_chunks_min: 1
  left_context_chunks_max: 4
training:
  number_of_epochs: 1
  precision: fp32
  ctc_weight: 0.3
  lr_adam: 0.002
  scheduler: warm_exp_decay
  n_warmup_steps: 2
  grad_accumulation_factor: 2
  max_batch_length: 100.0
  num_buckets: 2
  max_batch_ex: 8
  ckpt_interval_minutes: 999
augment:
  speed_perturb: false
  fea_augment: false
"""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), n=40)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(recipe, corpus, out, steps, n=2, env=None):
    """The train runner as `n` processes of one launch."""
    return _launch(["train", str(recipe), "--train-manifest", corpus["train"],
                    "--valid-manifest", corpus["dev"], "--output", str(out),
                    "--steps", str(steps)], n, env)


def _launch(args, n=2, env=None):
    """`python -m summarymixing_tpu_torch.recipes.<args>` as `n` processes of one launch."""
    port = _free_port()
    procs = []
    for rank in range(n):
        # one intra-op thread each: the processes share the worker's cores
        e = dict(os.environ, SMT_COORDINATOR=f"127.0.0.1:{port}", SMT_NUM_PROCESSES=str(n),
                 SMT_PROCESS_ID=str(rank), OMP_NUM_THREADS="1", **(env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"summarymixing_tpu_torch.recipes.{args[0]}", *args[1:],
             "--device", "cpu"],
            cwd=REPO, env=e, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs):
    outs = [p.communicate(timeout=150)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    return outs


def _valid_loss(path):
    with open(path) as f:
        return [json.loads(line)["valid"]["loss"] for line in f if '"valid"' in line][-1]


# -- one process -----------------------------------------------------------------

def test_initialize_noop_without_env(monkeypatch):
    for var in launch.LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    assert launch.initialize() is False
    assert launch.process_count() == 1 and launch.process_index() == 0
    assert launch.is_coordinator() and launch.backend() is None


def test_local_rows_single_process():
    assert launch.local_rows(8) == slice(0, 8)
    assert launch.local_rows(3) == slice(0, 3)
    assert launch.local_rows(8, 2, 1) == slice(4, 8)
    with pytest.raises(ValueError, match="not divisible by process count 2"):
        launch.local_rows(7, 2, 0)


def test_fetch_global_single_process():
    x = torch.arange(6).reshape(2, 3)
    assert (launch.fetch_global(x) == x.numpy()).all()


def test_allreduce_counts_single_process():
    assert launch.allreduce_counts(3.0, 4.5) == (3.0, 4.5)
    assert launch.any_process(True) and not launch.any_process(False)
    assert launch.gather_objects({"a": 1}) == [{"a": 1}]


def test_logger_writes_one_file_per_process(tmp_path, monkeypatch):
    monkeypatch.setattr(launch, "process_index", lambda: 1)
    log = logger_mod.FileTrainLogger(str(tmp_path / "train_log.txt"))
    log.log_stats({"epoch": 1}, {"loss": 1.0})
    assert sorted(os.listdir(tmp_path)) == ["train_log.p1.jsonl", "train_log.p1.txt"]


class _CountingSync:
    """A `GradientSync` of one process that counts its collectives."""

    def __init__(self, ok=True):
        self.ok, self.means, self.flags = ok, 0, 0

    def mean_list_(self, tensors):
        self.means += 1
        return tensors

    def loss_and_flag(self, loss, local_ok):
        self.flags += 1
        return loss, torch.tensor(self.ok) & local_ok


def test_accumulation_reduces_once_per_optimizer_step():
    """With `MultiSteps` (k = 2) the accumulator is reduced once per
    optimizer step and each micro step reduces only its loss and flag;
    the update equals the one without a reduction (the stub's mean of
    one process); a flag raised on any process skips the micro step on
    all."""
    g = torch.Generator().manual_seed(0)
    p0 = [torch.randn(3, 2, generator=g), torch.randn(4, generator=g)]
    grads = [[torch.randn(p.shape, generator=g) for p in p0] for _ in range(4)]
    runs = []
    for sync in (None, _CountingSync()):
        params = [p.clone() for p in p0]
        opt = optim.make_optimizer(lambda step: torch.tensor(1e-2), accum_steps=2)
        state = opt.init(params)
        for gr in grads:
            state, _, finite, _ = optim.synced_update(opt, params, [x.clone() for x in gr],
                                                      state, torch.tensor(1.0), sync)
            assert finite
        runs.append((params, sync))
    for a, b in zip(runs[0][0], runs[1][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (runs[1][1].means, runs[1][1].flags) == (2, 4)
    params = [p.clone() for p in p0]
    opt = optim.make_optimizer(lambda step: torch.tensor(1e-2), accum_steps=2)
    state = opt.init(params)
    state, _, finite, _ = optim.synced_update(opt, params, grads[0], state, torch.tensor(1.0),
                                              _CountingSync(ok=False))
    assert not finite and state["mini_step"] == 0


def test_stop_is_agreed_on_the_cadence(monkeypatch):
    """Several processes: no stop between multiples of `sync_every`, even
    after a local signal; a stop a peer asked for is recorded as PEER."""
    monkeypatch.setattr(launch, "process_count", lambda: 2)
    monkeypatch.setattr(launch, "any_process", lambda flag: True)
    stopper = preempt.TrainStopper(sync_every=10)
    assert not stopper.should_stop(5)
    assert stopper.should_stop(10) and stopper.signame == "PEER"
    local = preempt.TrainStopper(sync_every=10)
    local.requested, local.signame = True, "SIGTERM"
    assert not local.should_stop(7) and local.should_stop(20) and local.signame == "SIGTERM"



def test_checkpoint_interval_is_agreed_on_the_cadence(tmp_path, monkeypatch):
    """Several processes: `should_save` runs its host collective on every
    `sync_every`-th call only, and is false between those calls even when
    the interval has passed; at a sync call it takes the processes' OR."""
    from summarymixing_tpu_torch.training import checkpoint

    asked = []
    monkeypatch.setattr(launch, "process_count", lambda: 2)
    monkeypatch.setattr(launch, "any_process", lambda flag: asked.append(flag) or True)
    mgr = checkpoint.CheckpointManager(str(tmp_path), interval_minutes=1.0)
    assert [mgr.should_save() for _ in range(mgr.sync_every - 1)] == [False] * 19
    assert mgr.should_save() and asked == [False]
    mgr._last_save -= 61.0
    assert not any(mgr.should_save() for _ in range(mgr.sync_every - 1))
    assert mgr.should_save() and asked == [False, True]


# -- two processes ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ctc", "transducer_accumulating"])
def test_two_process_training_matches_single(corpus, tmp_path, kind):
    recipe = tmp_path / "tiny.yaml"
    recipe.write_text(CTC_RECIPE.format(epochs=1) if kind == "ctc" else TRANSDUCER_RECIPE)
    args = [str(recipe), "--train-manifest", corpus["train"], "--valid-manifest", corpus["dev"],
            "--steps", "4", "--device", "cpu"]
    procs = _start(recipe, corpus, tmp_path / "dist", steps=4)
    single = train.main(args + ["--output", str(tmp_path / "single")])
    outs = _finish(procs)
    assert all("[dist] process" in o and "backend gloo" in o for o in outs)
    dist = tmp_path / "dist"
    # one writer: the canonical log and the checkpoints from process 0, its
    # own log from process 1
    assert (dist / "train_log.txt").exists() and (dist / "train_log.p1.txt").exists()
    assert (dist / "save").is_dir() and not (dist / "train_log.p0.txt").exists()
    l0, l1 = _valid_loss(dist / "train_log.jsonl"), _valid_loss(dist / "train_log.p1.jsonl")
    assert abs(l0 - l1) < RANK_TOL, (l0, l1)
    ls = single["valid"]["loss"]
    assert abs(l0 - ls) / abs(ls) < SINGLE_TOL, (l0, ls)
    if kind == "ctc":
        # the trained run's greedy evaluation with the time axis over both
        # processes, against one process (the waveform padded to an even
        # frame count on the sharded side only)
        test = ["evaluate", str(recipe), "--test-manifest", corpus["test"], "--ckpt",
                str(dist / "save")]
        procs = _launch(test + ["--seq-parallel", "2", "--output", str(tmp_path / "sp")])
        ref = evaluate.main(test[1:] + ["--device", "cpu", "--output", str(tmp_path / "one")])
        out = _finish(procs)[0]
        summary = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
        assert summary["decode"] == "greedy_ctc_seq_parallel" and summary["seq_parallel"] == 2
        assert (summary["WER"], summary["utterances"]) == (ref["WER"], ref["utterances"])
        # every utterance's hypothesis, aligned against its reference, as one process gives it
        assert ((tmp_path / "sp" / "wer_details.txt").read_text()
                == (tmp_path / "one" / "wer_details.txt").read_text())


def test_sigterm_to_one_process_stops_both_at_one_step(corpus, tmp_path):
    recipe = tmp_path / "tiny.yaml"
    recipe.write_text(CTC_RECIPE.format(epochs=50))
    out = tmp_path / "run"
    procs = _start(recipe, corpus, out, steps=60, env={"SMT_HEARTBEAT_STEPS": "1"})
    seen = []
    for line in procs[1].stdout:
        seen.append(line)
        if line.startswith("[hb] step 2 "):
            procs[1].send_signal(signal.SIGTERM)
            break
    outs = _finish(procs)
    outs[1] = "".join(seen) + outs[1]
    steps = []
    for o, reason in zip(outs, ("PEER", "SIGTERM")):
        saved = [line for line in o.splitlines() if line.startswith("[preempt] checkpoint saved")]
        assert len(saved) == 1 and f"({reason})" in saved[0], o[-2000:]
        steps.append(int(saved[0].split("at step ")[1].split()[0]))
    assert steps[0] == steps[1] and steps[0] % 10 == 0 and steps[0] < 60, steps
    assert max(int(s) for s in os.listdir(out / "save") if s.isdigit()) == steps[0]
    outs = _finish(_start(recipe, corpus, out, steps=steps[0] + 2))
    assert all(f"[restore] resumed from step {steps[0]}," in o for o in outs)
