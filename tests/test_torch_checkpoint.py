"""The port's checkpointing and metrics against the JAX package on the CPU:
checkpoint averaging over the same arrays (JAX through orbax, the port
through `torch.save`), the manager's keep-last-N and partial restore,
restoring an averaged evaluation state and a fusion LM from run
directories, and `edit_distance`/`ErrorRateStats`/`AccuracyStats` on the
same sequences. Averages and error counts must be equal: both packages
sum float64 values in one order and cast once, and count with integers."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.training import checkpoint as jckpt
from summarymixing_tpu.training import metrics as jmetrics
from summarymixing_tpu_torch.config import LMConfig, RecipeConfig, build_lm
from summarymixing_tpu_torch.evaluate import restore_eval_state, restore_lm
from summarymixing_tpu_torch.training import checkpoint as tckpt
from summarymixing_tpu_torch.training import metrics as tmetrics


def _param_sets(rng, n=4):
    return [{"w": rng.standard_normal((5, 3)).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32),
             "n": np.array(i, np.int64)} for i in range(n)]


def test_average_checkpoints_matches_jax(rng, tmp_path):
    """Four checkpoints, the last three averaged: the port's float64 mean,
    cast back to each leaf's dtype (the integer leaf too), equals the JAX
    package's on the same arrays; the other state comes from the latest
    checkpoint."""
    sets = _param_sets(rng)
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), max_to_keep=10)
    tmgr = tckpt.CheckpointManager(str(tmp_path / "torch"), max_to_keep=10)
    for step, p in enumerate(sets):
        stats = np.full(2, float(step), np.float32)
        jmgr.save(step, {"params": p, "norm_stats": stats}, force=True)
        tmgr.save(step, {"params": {k: torch.from_numpy(v) for k, v in p.items()},
                         "norm_stats": torch.from_numpy(stats), "opt_state": [torch.ones(1)]})
    jmgr.wait_until_finished()
    want = jckpt.average_checkpoints(jmgr, {"params": None, "norm_stats": None}, num=3)
    got = tckpt.average_checkpoints(tmgr, {"params": None, "norm_stats": None}, num=3,
                                    device="cpu")
    assert set(got) == {"params", "norm_stats"}
    for k in ("w", "b", "n"):
        assert got["params"][k].dtype == torch.from_numpy(sets[0][k]).dtype, k
        np.testing.assert_array_equal(got["params"][k].numpy(), np.asarray(want["params"][k]))
    direct = (sets[1]["w"].astype(np.float64) + sets[2]["w"] + sets[3]["w"]) / 3
    np.testing.assert_array_equal(got["params"]["w"].numpy(), direct.astype(np.float32))
    np.testing.assert_array_equal(got["norm_stats"].numpy(), np.asarray(want["norm_stats"]))


def test_checkpoint_manager_keeps_the_last_n_and_restores_partially(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore(device="cpu") is None
    for step in (3, 7, 10):
        mgr.save(step, {"params": {"w": torch.full((2,), float(step))}, "step": step})
    assert mgr.all_steps() == [7, 10] and mgr.latest_step() == 10
    assert sorted(os.listdir(tmp_path)) == ["10", "7"]
    assert mgr.restore({"step": None}, partial=True, device="cpu") == {"step": 10}
    assert torch.equal(mgr.restore(step=7, device="cpu")["params"]["w"], torch.full((2,), 7.0))
    with pytest.raises(KeyError):
        mgr.restore({"step": None}, device="cpu")
    with pytest.raises(ValueError):
        tckpt.average_checkpoints(tckpt.CheckpointManager(str(tmp_path / "empty")),
                                  {"params": None})


def test_evaluation_restore_reads_no_optimizer_state(tmp_path):
    """Each key is its own file: `restore(partial=True)`,
    `average_checkpoints` and `restore_eval_state` read the parameters and
    statistics of a checkpoint whose optimizer state cannot be read."""
    mgr = tckpt.CheckpointManager(str(tmp_path))
    for step in range(3):
        mgr.save(step, {"params": {"w": torch.full((2,), float(step))},
                        "norm_stats": torch.tensor(float(step)), "step": step,
                        "opt_state": {"mu": torch.zeros(2)}})
        assert sorted(os.listdir(tmp_path / str(step))) == [
            "norm_stats.pt", "opt_state.pt", "params.pt", "step.pt"]
        with open(tmp_path / str(step) / "opt_state.pt", "wb") as f:
            f.write(b"not a checkpoint")
    got = mgr.restore({"params": None, "step": None}, partial=True, device="cpu")
    assert got["step"] == 2 and torch.equal(got["params"]["w"], torch.full((2,), 2.0))
    avg = tckpt.average_checkpoints(mgr, {"norm_stats": None, "step": None}, num=3, device="cpu")
    assert avg["step"] == 2 and float(avg["norm_stats"]) == 2.0
    assert torch.equal(avg["params"]["w"], torch.full((2,), 1.0))
    with pytest.raises(pickle.UnpicklingError):
        mgr.restore(device="cpu")


def test_restore_eval_state_and_restore_lm_read_run_directories(tmp_path):
    """`restore_eval_state` loads the mean of the last checkpoints into a
    model and returns the latest statistics and counters; `restore_lm`
    builds the LM that `lm_config.json` describes, not the recipe's."""
    model = torch.nn.Linear(3, 2)
    mgr = tckpt.CheckpointManager(str(tmp_path / "asr"))
    weights = []
    for step in range(3):
        w = {k: torch.randn_like(v) for k, v in model.state_dict().items()}
        weights.append(w)
        mgr.save(step, {"params": w, "norm_stats": {"count": torch.tensor(float(step))},
                        "step": step, "epoch": 0, "opt_state": {"mu": [torch.zeros(1)]}})
    state = restore_eval_state(model, str(tmp_path / "asr"), avg=2, device="cpu")
    assert state["step"] == 2 and float(state["norm_stats"]["count"]) == 2.0
    want = (weights[1]["weight"].double() + weights[2]["weight"].double()) / 2
    assert torch.equal(model.weight.detach(), want.float())

    lm_cfg = LMConfig(d_model=16, nhead=2, num_layers=1, d_ffn=32)
    lm = build_lm(lm_cfg, 12, device="cpu", seed=1)
    run = tmp_path / "lm_run"
    tckpt.CheckpointManager(str(run / "save")).save(5, {"params": lm.state_dict()})
    with open(run / "lm_config.json", "w") as f:
        json.dump(dict(vars(lm_cfg), unknown_key=1), f)
    cfg = RecipeConfig(lm=LMConfig())        # the recipe's block is the full-width default
    cfg.model.output_neurons = 12
    got_cfg, got = restore_lm(cfg, str(run), device="cpu")
    assert got_cfg == lm_cfg
    for (name, a), b in zip(got.named_parameters(), lm.parameters()):
        assert torch.equal(a, b), name
    assert restore_lm(cfg, str(tmp_path / "no_lm"), device="cpu") is None


@pytest.mark.parametrize("split_tokens", [False, True])
def test_error_rate_stats_match_jax(rng, tmp_path, split_tokens):
    """Random token sequences with insertions, deletions and
    substitutions: the summaries and the per-utterance report agree."""
    refs, hyps = [], []
    for _ in range(6):
        ref = [str(t) for t in rng.integers(0, 6, rng.integers(0, 8))]
        hyp = [t for t in ref if rng.random() > 0.2]
        hyp = [str(rng.integers(0, 6)) if rng.random() < 0.2 else t for t in hyp]
        hyp += [str(t) for t in rng.integers(0, 6, rng.integers(0, 2))]
        refs.append(ref)
        hyps.append(hyp)
    stats = []
    for mod in (jmetrics, tmetrics):
        s = mod.ErrorRateStats(split_tokens=split_tokens, keep_details=True)
        s.append(refs, hyps, ids=list(range(6)))
        path = tmp_path / f"{mod.__name__}.txt"
        s.write_stats(str(path))
        stats.append((s.summarize(), path.read_text()))
    assert stats[0] == stats[1]
    for r, h in zip(refs, hyps):
        assert tmetrics.edit_distance(r, h, True) == jmetrics.edit_distance(r, h, True)


def test_accuracy_stats_match_jax(rng):
    lp = rng.standard_normal((3, 5, 7))
    targets = rng.integers(0, 7, (3, 5))
    lens = np.array([5, 2, 4])
    acc = []
    for mod in (jmetrics, tmetrics):
        a = mod.AccuracyStats()
        a.append(lp, targets, lens)
        a.append(lp, targets)
        acc.append((a.correct, a.total, a.summarize()))
    assert acc[0] == acc[1]
