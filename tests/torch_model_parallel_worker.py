"""One process of the port's model-sharding and pipeline checks, started
by `tests/test_torch_sharding.py` and `tests/test_torch_pipeline.py` with
`SMT_COORDINATOR`, `SMT_NUM_PROCESSES` and `SMT_PROCESS_ID` set; it
imports the port only, never JAX, so that the JAX side runs in the
pytest process alone.

    python tests/torch_model_parallel_worker.py shard CONFIG.json OUT_DIR
    python tests/torch_model_parallel_worker.py pipe CONFIG.json OUT_DIR

`shard`: from the same initial weights (`state`) and global batch
(`batch`), `steps` training steps of `ASRTrainer` under each run of
CONFIG's `runs` (`single`: a 1x1 mesh on process 0; `tp`: a 1x2 mesh on
processes 0 and 1; `fsdp`, `composite`: every process; a run ending in
`_acc`: `acc_steps` steps of `MultiSteps(AdamW, 2)` clipping at
`acc_clip`, on the same mesh), each process
saving its losses, the share of parameter and moment elements it keeps,
its placements, to `OUT_DIR/<run>.rank<r>.pt`, and the run's checkpoint
through `CheckpointManager` (process 0 writes) to `OUT_DIR/ckpt_<run>`;
each process's whole parameters after the steps to
`<run>.params.rank<r>.pt`; and with four
processes the coordinates of a 2x2 `make_mesh` and a 1x2x2
`make_seq_mesh`, and the 2x2 mesh's rows of a batch of 4
(`meshes.rank<r>.pt`).

`pipe`: for each case (`n_data`, `n_pipe`, `n_micro`, rows `b`), the
pipelined encode of `x[:b]` with `pad[:b]` (each process holding only its
stage's stacked layers) beside the sequential encode of the same
microbatches in the same process; the gradient of
`sum(out²)` where asked; dropout runs where asked; and the refusals;
saved to `OUT_DIR/<case>.rank<r>.pt` and `refusals.rank<r>.json`.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from summarymixing_tpu_torch.frontend.features import Fbank  # noqa: E402
from summarymixing_tpu_torch.models.asr import TransformerASR  # noqa: E402
from summarymixing_tpu_torch.models.branchformer import BranchformerEncoder  # noqa: E402
from summarymixing_tpu_torch.models.speech_recognizer import SpeechRecognizer  # noqa: E402
from summarymixing_tpu_torch.parallel import launch, pipeline, sequence  # noqa: E402
from summarymixing_tpu_torch.parallel import mesh as meshes  # noqa: E402
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager  # noqa: E402
from summarymixing_tpu_torch.training.optim import AdamW, MultiSteps, noam_schedule  # noqa: E402
from summarymixing_tpu_torch.training.trainer import ASRTrainer, TrainerConfig  # noqa: E402


def _rules(run: str, mesh, cfg):
    run = run.removesuffix("_acc")
    if run == "tp":
        return meshes.tensor_parallel_param_sharding(mesh, min_dim=cfg["tp_min_dim"])
    if run == "fsdp":
        return meshes.fsdp_param_sharding(mesh, min_size=cfg["fsdp_min_size"])
    if run == "composite":
        return meshes.composite_param_sharding(mesh, tp_min_dim=cfg["tp_min_dim"],
                                               fsdp_min_size=cfg["fsdp_min_size"])
    return None


def run_shard(cfg_path: str, out_dir: str) -> None:
    launch.initialize(device="cpu")
    rank = launch.process_index()
    with open(cfg_path) as f:
        cfg = json.load(f)
    state0 = torch.load(cfg["state"], weights_only=True)
    batch = torch.load(cfg["batch"], weights_only=True)
    # every process builds every mesh (their groups are collective), then
    # runs the ones it belongs to
    grids = {"single": ((1, 1), [0]), "tp": ((1, 2), [0, 1]),
             "fsdp": ((launch.process_count(), 1), None), "composite": ((2, 2), None)}
    saved = {}
    for run in cfg["runs"]:
        (n_data, n_model), devices = grids[run.removesuffix("_acc")]
        mesh = meshes.make_mesh(n_data, n_model, devices=devices or list(
            range(launch.process_count())))
        if mesh.get_coordinate() is None:
            continue
        model = SpeechRecognizer(TransformerASR(**cfg["asr"]), cfg["vocab"],
                                 frontend_channels=cfg["frontend_channels"])
        model.load_state_dict(state0)
        opt = AdamW(noam_schedule(1e-3, 10), weight_decay=0.01)
        steps = cfg["steps"]
        if run.endswith("_acc"):
            # accumulation over 2 micro-batches, every inner step clipped
            opt = MultiSteps(AdamW(noam_schedule(1e-3, 10), weight_decay=0.01,
                                   max_grad_norm=cfg["acc_clip"]), 2)
            steps = cfg["acc_steps"]
        trainer = ASRTrainer(model, opt, Fbank(n_mels=cfg["n_mels"]),
                             TrainerConfig(augment=None, xavier_init_overwrite=False),
                             mesh=mesh, param_sharding_fn=_rules(run, mesh, cfg))
        state = trainer.init_state(seed=3407)
        local = meshes.shard_batch(batch, mesh)
        losses = []
        for _ in range(steps):
            state, metrics = trainer.train_step(state, local)
            losses.append(metrics["loss"].item())
        out = {"losses": losses}
        if trainer.shards is not None:
            opt_state = state["opt_state"]
            moments = opt_state.get("inner", opt_state)["mu"]
            kept = sum(m.to_local().numel() for m in moments)
            out.update(param_share=trainer.shards.held_share(),
                       moment_share=kept / sum(p.numel() for p in trainer.params),
                       params={n: [repr(p) for p in d.placements]
                               for n, d in state["params"].items()},
                       moments={n: [repr(p) for p in m.placements]
                                for n, m in zip(trainer.shards.names, moments)},
                       acc={n: [repr(p) for p in m.placements]
                            for n, m in zip(trainer.shards.names, opt_state.get("acc", []))},
                       whole_between_steps=sum(p.untyped_storage().nbytes()
                                               for p in trainer.params))
        view = trainer.checkpoint_view(state)
        with trainer.shards.whole() if trainer.shards is not None else contextlib.nullcontext():
            params = {k: v.clone() for k, v in model.state_dict().items()}
            out["eval_loss"] = trainer.eval_step(state, local)[0]["loss"].item()
        saved[run] = {"params": params, "opt_state": view["opt_state"]}
        torch.save(params, os.path.join(out_dir, f"{run}.params.rank{rank}.pt"))
        torch.save(out, os.path.join(out_dir, f"{run}.rank{rank}.pt"))
    if launch.process_count() == 4:
        grid = meshes.make_mesh(2, 2)
        seq = sequence.make_seq_mesh(n_data=1, n_seq=2, n_model=2)
        torch.save({"mesh": tuple(grid.get_coordinate()), "seq_mesh": tuple(seq.get_coordinate()),
                    "rows": meshes.shard_batch({"x": torch.arange(4)}, grid)["x"].tolist()},
                   os.path.join(out_dir, f"meshes.rank{rank}.pt"))
    # every process takes part in a save (process 0 writes, the rest wait)
    for run in cfg["checkpoint"]:
        CheckpointManager(os.path.join(out_dir, f"ckpt_{run}")).save(cfg["steps"],
                                                                     saved.get(run, {}))


def run_pipe(cfg_path: str, out_dir: str) -> None:
    launch.initialize(device="cpu")
    rank = launch.process_index()
    with open(cfg_path) as f:
        cfg = json.load(f)
    x_all = torch.load(cfg["x"], weights_only=True)
    pad_all = torch.load(cfg["pad"], weights_only=True)
    refusals = {}
    for case in cfg["cases"]:
        enc = BranchformerEncoder(**case.get("encoder", cfg["encoder"]))
        state = case.get("state", cfg["state"])
        if state:   # a refusal needs no weights
            enc.load_state_dict(torch.load(state, weights_only=True))
        mesh = pipeline.make_pipeline_mesh(case["n_data"], case["n_pipe"])
        x, pad = x_all[:case["b"]], pad_all[:case["b"]]
        if case.get("refuse"):
            try:
                fn = pipeline.pipeline_branchformer_encode(enc, mesh, case["n_micro"])
                fn(pipeline.stacked_params(enc, stage_of=mesh), x, None, pad)
                refusals[case["name"]] = ""
            except ValueError as e:
                refusals[case["name"]] = str(e)
            continue
        fn = pipeline.pipeline_branchformer_encode(enc, mesh, case["n_micro"])
        out = {}
        with torch.no_grad():
            out["out"] = fn(pipeline.stacked_params(enc, stage_of=mesh), x, None, pad)
            # the sequential encode of the same microbatches, in this process
            enc.eval()
            out["seq"] = torch.cat([enc(xm, None, pm) for xm, pm in zip(
                x.chunk(case["n_micro"]), pad.chunk(case["n_micro"]))])
        if case.get("dropout"):
            stage = pipeline.stacked_params(enc, stage_of=mesh)
            with torch.no_grad():
                out["train"] = fn(stage, x, None, pad, seed=42)
                out["train2"] = fn(stage, x, None, pad, seed=42)
                out["train7"] = fn(stage, x, None, pad, seed=7)
        if case.get("grad"):
            params = pipeline.stacked_params(enc, stage_of=mesh)
            leaves = {k: v.detach().requires_grad_() for k, v in params["layers"].items()}
            norm = {k: v.detach().requires_grad_() for k, v in params["norm"].items()}
            xg = x.clone().requires_grad_()
            y = fn({"layers": leaves, "norm": norm}, xg, None, pad, seed=case.get("seed"))
            (y.float() ** 2).sum().backward()
            out["grads"] = {k: v.grad for k, v in leaves.items()}
            out["norm_grads"] = {k: v.grad for k, v in norm.items()}
            out["x_grad"] = xg.grad
        torch.save(out, os.path.join(out_dir, f"{case['name']}.rank{rank}.pt"))
    with open(os.path.join(out_dir, f"refusals.rank{rank}.json"), "w") as f:
        json.dump(refusals, f)


if __name__ == "__main__":
    checks = {"shard": run_shard, "pipe": run_pipe}
    if sys.argv[1] not in checks:
        raise SystemExit(f"unknown check {sys.argv[1]!r}")
    checks[sys.argv[1]](sys.argv[2], sys.argv[3])
