"""Train and evaluate a recipe on the card — the port of the JAX package's
`recipes/train.py`: a CTC + attention recipe, or a transducer recipe
(a `transducer:` section, the JAX `run_transducer`).

    python -m summarymixing_tpu_torch.recipes.train recipes/Synthetic/hard_synthetic.yaml \\
        --train-manifest train.csv --valid-manifest dev.csv [--test-manifest test.csv] \\
        [--output results/run1] [--steps N] [--num-buckets N] [--lm-ckpt LM_RUN_DIR] \\
        [--max-hours H] [--profile DIR [--profile-steps N]] \\
        [--set training.lr_adam=0.0005] [--device cpu]

The tokenizer is resolved and written to the run directory; training
resumes from the run's latest checkpoint at the epoch after the last one
it completed (a checkpoint taken inside an epoch, at a stop, reruns that
epoch with the step count, optimizer state and generator it saved). On
SIGTERM or SIGINT, or once `--max-hours` of wall clock are spent, the run
saves a checkpoint at the end of the step and exits; the same command
resumes it (`training/preempt.py`). The two-stage optimizer switches to
SGD after `stage_one_epochs` epochs of the estimated steps per epoch,
and each epoch's log line names the stage it ended in. Each epoch:
bucketed, shuffled batches through `ASRTrainer.train_step`, or for a transducer recipe
`TransducerTrainer.train_step` (RNN-T loss, Dynamic Chunk Training, the
CTC aux for `number_of_ctc_epochs`; each call is one micro step of
`grad_accumulation_factor`), with speed perturbation, SpecAugment and
dropout as the recipe sets them; a heartbeat line every
`SMT_HEARTBEAT_STEPS` steps (10), checkpoints every
`ckpt_interval_minutes`, and at the epoch's end a checkpoint (always after
epoch 1 and the last), greedy validation (CTC, or the transducer's greedy
search, with the validation loss) and, for a decoder model every
`valid_search_interval` epochs, joint CTC/attention beam validation at
`valid_beam_size`; a transducer recipe with `training.valid_every_steps`
also checkpoints and validates greedily every that many steps.
`train_log.txt` and `train_log.jsonl` record each epoch, with each
kernel's launches and plain calls (cells or branches on the card whose
configuration it does not take, such as a float32 recipe's) in it. With
a test manifest, the test stage decodes at `test_beam_size` and
`test_temperature` (with the Transformer LM of `--lm-ckpt` fused at
`lm_weight`), greedily for a CTC model without a decoder, and for a
transducer with the batched beam search at `beam_size`, `state_beam` and
`expand_beam` (with the RNNLM of `--lm-ckpt` fused at `lm_weight`).

`--profile DIR` traces `--profile-steps` train steps (5) after the first 3
of the call with `torch.profiler`, the card synchronised at both edges
(`training/profiling.py::StepProfiler`): a Chrome trace
`DIR/trace.json` and the operators' and kernels' table by device time,
printed and in `DIR/key_averages.txt`; a window the epoch cuts short ends
with the epoch. The summary's `profile` names the trace.

Several processes (data parallelism, `parallel/launch.py`): start one per
device with `SMT_COORDINATOR=host:port SMT_NUM_PROCESSES=N
SMT_PROCESS_ID=i`; each prints a `[dist]` line with its backend (NCCL
when each process has a card of its own, gloo otherwise). Every process
iterates the same batches (bucket sizes a multiple of N) and loads its
own rows; the trainers average the gradients (`parallel/comm.py`);
validation gathers the hypotheses and sums the losses over the
processes; only process 0 writes checkpoints, the tokenizer and
`train_log.txt` (process p writes `train_log.p<p>.txt`); a stop is agreed
every 10 steps (`training/preempt.py`), and every process restores. The
summary's `dist` holds the process count, index and backend."""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from summarymixing_tpu_torch.config import (
    build_model,
    build_trainer,
    build_transducer_trainer,
    load_recipe,
)
from summarymixing_tpu_torch.data.batching import prefetch
from summarymixing_tpu_torch.data.dataio import read_manifest_csv
from summarymixing_tpu_torch.parallel import launch
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.training.logger import EpochCounter, FileTrainLogger
from summarymixing_tpu_torch.training.optim import optimizer_stage
from summarymixing_tpu_torch.training.preempt import TrainStopper
from summarymixing_tpu_torch.training.profiling import StepProfiler
from summarymixing_tpu_torch.training.trainer import process_seed
from summarymixing_tpu_torch.utils.device import resolve_device

# what a checkpoint holds (`checkpoint_state`)
_STATE_KEYS = ("params", "opt_state", "norm_stats", "step", "epoch", "rng")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("recipe")
    ap.add_argument("--train-manifest", required=True)
    ap.add_argument("--valid-manifest", required=True)
    ap.add_argument("--test-manifest")
    ap.add_argument("--output", default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="stop after N optimizer steps in all (smoke runs)")
    ap.add_argument("--num-buckets", type=int, default=None,
                    help="override training.num_buckets")
    ap.add_argument("--lm-ckpt", default=None,
                    help="LM run directory (recipes.train_lm) fused in beam validation and "
                         "the test stage at decoding.lm_weight")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    dest="overrides", help="override a recipe value by dotted path")
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless this says otherwise (e.g. cpu)")
    ap.add_argument("--max-hours", type=float, default=None,
                    help="wall-clock budget: checkpoint and exit once it is spent")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of a few train steps to DIR")
    ap.add_argument("--profile-steps", type=int, default=5,
                    help="train steps --profile traces, after the first 3")
    return ap.parse_args(argv)


def rng_state(state: Dict):
    """The generators' state for a checkpoint: the step generator's; in a
    multi-process run every process's (`ranks`, in process order) and the
    shared stream's (`shared`)."""
    local = state["generator"].get_state()
    if launch.process_count() == 1:
        return local
    shared = state.get("shared_generator") or state["generator"]
    return {"ranks": torch.stack(launch.gather_objects(local)), "shared": shared.get_state()}


def restore_rng(state: Dict, rng, seed: int) -> None:
    """Set the generators from a checkpoint's `rng_state`. A checkpoint of
    another process count gives each process a fresh stream of its own
    from (seed, index, step)."""
    n, p = launch.process_count(), launch.process_index()
    ranks = rng["ranks"] if isinstance(rng, dict) else rng[None]
    if ranks.shape[0] == n:
        state["generator"].set_state(ranks[p].cpu().clone())   # a row of its own storage
    else:
        print(f"[restore] checkpoint of {ranks.shape[0]} processes restored by {n}: fresh "
              "per-process streams", flush=True)
        state["generator"].manual_seed(process_seed(seed + state["step"], p))
    shared = state.get("shared_generator")
    if shared is not None and shared is not state["generator"]:
        shared.set_state((rng["shared"] if isinstance(rng, dict) else rng).cpu().clone())


def checkpoint_state(model, state: Dict) -> Dict:
    """What a checkpoint holds: the parameters, the optimizer state, the
    normalisation statistics, the step and epoch counters and the state of
    the generators that speed perturbation, SpecAugment, the DCT sampler
    and dropout draw from (`rng_state`; a collective in a multi-process
    run)."""
    return {"params": model.state_dict(), "opt_state": state["opt_state"],
            "norm_stats": state["norm_stats"], "step": state["step"], "epoch": state["epoch"],
            "rng": rng_state(state)}


def init_or_restore(trainer, ckpt: CheckpointManager, cfg) -> Dict:
    """A fresh train state from `cfg.seed`, or the latest checkpoint's, so
    that a resumed run continues at the epoch after the one it saved, with
    that epoch's labels and shuffling seed."""
    state = trainer.init_state(cfg.seed)
    if ckpt.latest_step() is None:
        return state
    saved = ckpt.restore(_STATE_KEYS, device=trainer.device)
    trainer.model.load_state_dict(saved["params"])
    state.update(opt_state=saved["opt_state"], norm_stats=saved["norm_stats"],
                 step=int(saved["step"]), epoch=int(saved["epoch"]))
    restore_rng(state, saved["rng"], cfg.seed)
    print(f"[restore] resumed from step {state['step']}, epoch {state['epoch']}", flush=True)
    return state


def epoch_loss_stats(train_losses: List[torch.Tensor]) -> Dict:
    """Mean training loss of the epoch over the steps whose update was not
    skipped as non-finite, and the count of skipped ones."""
    arr = np.asarray([float(x) for x in train_losses], np.float64)
    finite = arr[np.isfinite(arr)]
    stats = {"loss": float(finite.mean()) if finite.size else 0.0}
    if arr.size - finite.size:
        stats["nonfinite_skipped"] = int(arr.size - finite.size)
    return stats


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Run the recipe; returns a summary: `steps` (train_step calls: micro
    steps under gradient accumulation), `stopped` (the stop's reason,
    such as "SIGTERM" or "WALLCLOCK", when the run checkpointed and
    stopped early; the summary then holds only `steps`, `epochs`,
    `step_s`, `opt_stages` and `kernels`), `opt_stages` (the two-stage
    optimizer's stage before each step this call ran, else empty),
    `epochs` (the last one run), `dist` (`common.start_processes`),
    `step_s` (the host time of each step this call ran, each ending in the
    step's one device synchronisation), `valid` (the last epoch's
    validation stats), `test` (the test stage's error-rate summary, or
    None), `profile` (the `--profile` trace's path, or None) and `kernels` (`common.kernel_counts` over this call; each
    epoch's line of the train log has its own)."""
    args = parse_args(argv)
    cfg = load_recipe(args.recipe, overrides=common.parse_overrides(args.overrides))
    if args.num_buckets:
        cfg.training.num_buckets = args.num_buckets
    dist_info = common.start_processes(args.device)
    device = resolve_device(args.device)
    out_dir = args.output or os.path.join(cfg.output_folder, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    train_set = read_manifest_csv(args.train_manifest)
    valid_set = read_manifest_csv(args.valid_manifest)
    tokenizer = common.build_or_load_tokenizer(cfg, out_dir, train_set)
    launch.barrier()

    transducer = cfg.transducer is not None
    steps_per_epoch = common.estimate_steps_per_epoch(train_set, cfg)
    if transducer:
        model, fbank, td = build_model(cfg, device=device)
        trainer = build_transducer_trainer(cfg, model, fbank, td, steps_per_epoch=steps_per_epoch)
    else:
        model, fbank = build_model(cfg, device=device)
        trainer = build_trainer(cfg, model, fbank, steps_per_epoch=steps_per_epoch)
    if steps_per_epoch == 0:
        raise SystemExit("no training batches produced: the corpus is smaller than one bucket "
                         "batch (drop_last). Lower training.max_batch_length or num_buckets.")
    logger = FileTrainLogger(os.path.join(out_dir, "train_log.txt"))
    ckpt = CheckpointManager(os.path.join(out_dir, "save"),
                             max_to_keep=cfg.training.avg_checkpoints,
                             interval_minutes=cfg.training.ckpt_interval_minutes)
    state = init_or_restore(trainer, ckpt, cfg)
    step = state["step"]
    lm = (common.load_rnnlm if transducer else common.load_fusion_lm)(cfg, args.lm_ckpt, device)
    hb_every = int(os.environ.get("SMT_HEARTBEAT_STEPS", "10"))
    # mid-epoch validation points (the JAX transducer runner's)
    valid_every = cfg.training.valid_every_steps if transducer else 0
    step_s: List[float] = []
    opt_stages: List[str] = []
    valid_stats: Dict = {}
    epoch = state["epoch"]
    counts0 = common.kernel_counts()
    profiler = StepProfiler(args.profile, args.profile_steps)
    # the stop handlers hold for the training loop only; the previous
    # ones come back after it
    with TrainStopper(max_hours=args.max_hours) as stopper:
        for epoch in EpochCounter(cfg.training.number_of_epochs, start=state["epoch"]):
            t0 = hb_t = time.time()
            epoch_counts = common.kernel_counts()
            train_losses = []
            for batch, _ in prefetch(common.batches(train_set, tokenizer, cfg, True,
                                                    cfg.seed + epoch, device)):
                stage = optimizer_stage(trainer.optimizer, state["opt_state"])
                if stage is not None:
                    opt_stages.append(stage)
                ts = time.perf_counter()
                state, metrics = trainer.train_step(state, batch)
                step_s.append(time.perf_counter() - ts)
                step += 1
                profiler.step()
                train_losses.append(metrics["loss"])
                if valid_every and step % valid_every == 0:
                    ckpt.save(step, checkpoint_state(trainer.model, state))
                    tv = time.time()
                    stats = common.error_rate_stats(cfg)
                    vloss = common.transducer_greedy_score(stats, trainer, state, valid_set,
                                                           tokenizer, cfg, device)
                    logger.log_stats({"valid_step": step, "epoch": epoch,
                                      "valid_s": round(time.time() - tv, 1)},
                                     valid_stats={"loss": vloss,
                                                  cfg.error_rate.upper(): stats.summarize()["WER"]})
                    hb_t = time.time()
                if hb_every and step % hb_every == 0:
                    now = time.time()
                    print(f"[hb] step {step} mean_step_s {(now - hb_t) / hb_every:.3f} "
                          f"loss {float(metrics['loss']):.3f}", flush=True)
                    hb_t = now
                if ckpt.should_save():
                    ckpt.save(step, checkpoint_state(trainer.model, state))
                if stopper.should_stop(step):
                    profiler.close()
                    ckpt.save(step, checkpoint_state(trainer.model, state))
                    print(f"[preempt] checkpoint saved at step {step} ({stopper.signame}); "
                          "resume with the same command", flush=True)
                    return {"steps": step, "epochs": epoch, "step_s": step_s,
                            "stopped": stopper.signame, "opt_stages": opt_stages,
                            "kernels": common.kernel_counts(since=counts0), "dist": dist_info}
                if args.steps and step >= args.steps:
                    break
            profiler.close()
            # the epoch-end checkpoint comes before validation, so a failure
            # there costs the epoch's validation numbers, not its training;
            # validation runs at the epoch it follows (it gates the CTC aux)
            valid_state, state = state, trainer.next_epoch(state)
            last_epoch = epoch >= cfg.training.number_of_epochs or bool(args.steps
                                                                          and step >= args.steps)
            if last_epoch or epoch == 1 or ckpt.should_save():
                ckpt.save(step, checkpoint_state(trainer.model, state))
            stats = common.error_rate_stats(cfg)
            score = common.transducer_greedy_score if transducer else common.greedy_score
            vloss = score(stats, trainer, valid_state, valid_set, tokenizer, cfg, device)
            valid_stats = {"loss": vloss, cfg.error_rate.upper(): stats.summarize()["WER"]}
            if (model.asr.num_decoder_layers > 0 and cfg.decoding.valid_search_interval > 0
                    and epoch % cfg.decoding.valid_search_interval == 0):
                beam_stats = common.error_rate_stats(cfg)
                common.beam_score(beam_stats, cfg, model, fbank, state["norm_stats"], valid_set,
                                  tokenizer, device, lm)
                valid_stats[f"beam_{cfg.error_rate.upper()}"] = beam_stats.summarize()["WER"]
            epoch_stats = {"epoch": epoch, "steps": step, "epoch_s": round(time.time() - t0, 1),
                           "kernels": common.kernel_counts(since=epoch_counts)}
            stage = optimizer_stage(trainer.optimizer, state["opt_state"])
            if stage is not None:
                epoch_stats["opt_stage"] = stage
            logger.log_stats(epoch_stats, epoch_loss_stats(train_losses), valid_stats)
            print(f"epoch {epoch}: steps {step}, valid {valid_stats}", flush=True)
            if args.steps and step >= args.steps:
                break
    print("training done:", step, "steps", flush=True)

    test = None
    if args.test_manifest:
        test_set = read_manifest_csv(args.test_manifest)
        stats = common.error_rate_stats(cfg)
        if transducer:
            common.transducer_beam_score(stats, trainer, state, test_set, tokenizer, cfg, device,
                                         lm)
        elif model.asr.num_decoder_layers > 0 and cfg.decoding.test_beam_size > 0:
            common.beam_score(stats, cfg, model, fbank, state["norm_stats"], test_set,
                              tokenizer, device, lm, beam_size=cfg.decoding.test_beam_size,
                              temperature=cfg.decoding.test_temperature)
        else:
            common.greedy_score(stats, trainer, state, test_set, tokenizer, cfg, device)
        test = stats.summarize()
        logger.log_stats({"stage": "test"}, test_stats={cfg.error_rate.upper(): test["WER"]})
        print("test", cfg.error_rate.upper(), test["WER"], flush=True)
    return {"steps": step, "epochs": epoch, "step_s": step_s, "valid": valid_stats,
            "test": test, "tokenizer_size": tokenizer.vocab_size, "opt_stages": opt_stages,
            "profile": profiler.path, "kernels": common.kernel_counts(since=counts0),
            "dist": dist_info}


if __name__ == "__main__":
    main()
