"""Train and evaluate a CTC + attention recipe on the card — the port of
the JAX package's `recipes/train.py` (its non-transducer branch).

    python -m summarymixing_tpu_torch.recipes.train recipes/Synthetic/hard_synthetic.yaml \\
        --train-manifest train.csv --valid-manifest dev.csv [--test-manifest test.csv] \\
        [--output results/run1] [--steps N] [--num-buckets N] [--lm-ckpt LM_RUN_DIR] \\
        [--set training.lr_adam=0.0005] [--device cpu]

The tokenizer is resolved and written to the run directory; training
resumes from the run's latest checkpoint at the epoch after the one it
saved. Each epoch: bucketed, shuffled batches through
`ASRTrainer.train_step` (speed perturbation, SpecAugment and dropout as
the recipe sets them), a heartbeat line every `SMT_HEARTBEAT_STEPS` steps
(10), checkpoints every `ckpt_interval_minutes`, and at the epoch's end a
checkpoint (always after epoch 1 and the last), greedy-CTC validation and,
every `valid_search_interval` epochs, joint CTC/attention beam validation
at `valid_beam_size`. `train_log.txt` and `train_log.jsonl` record each
epoch, with each kernel's launches and plain calls (cells or branches on
the card whose configuration it does not take, such as a float32 recipe's)
in it. With a test manifest, the test stage decodes at `test_beam_size`
and `test_temperature` (with the LM of `--lm-ckpt` fused at `lm_weight`),
or greedily for a model without a decoder.

Not ported, and refused: `--profile`, `--max-hours`, a multi-process
launch, and recipes with a `transducer:` section (ROADMAP.md)."""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from summarymixing_tpu_torch.config import build_model, build_trainer, load_recipe
from summarymixing_tpu_torch.data.batching import prefetch
from summarymixing_tpu_torch.data.dataio import read_manifest_csv
from summarymixing_tpu_torch.recipes import common
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.training.logger import EpochCounter, FileTrainLogger
from summarymixing_tpu_torch.utils.device import resolve_device

# environment variables of the JAX package's multi-process launch
_LAUNCH_ENV = ("SMT_COORDINATOR", "SMT_NUM_PROCESSES", "SMT_PROCESS_ID")
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
    ap.add_argument("--max-hours", type=float, default=None, help="not ported")
    ap.add_argument("--profile", default=None, metavar="DIR", help="not ported")
    return ap.parse_args(argv)


def refuse_unported(args: argparse.Namespace) -> None:
    if args.max_hours is not None:
        raise NotImplementedError("--max-hours (training/preempt.py TrainStopper) is not "
                                  "ported; see ROADMAP.md queue 1 item 5")
    if args.profile is not None:
        raise NotImplementedError("--profile (a profiler trace of train steps) is not ported; "
                                  "see ROADMAP.md queue 1 item 9")
    if any(os.environ.get(k) for k in _LAUNCH_ENV):
        raise NotImplementedError("the multi-process launch is not ported; see ROADMAP.md "
                                  "queue 1 item 10")


def checkpoint_state(model, state: Dict) -> Dict:
    """What a checkpoint holds: the parameters, the optimizer state, the
    normalisation statistics, the step and epoch counters and the state of
    the generator that speed perturbation, SpecAugment and dropout draw
    from."""
    return {"params": model.state_dict(), "opt_state": state["opt_state"],
            "norm_stats": state["norm_stats"], "step": state["step"], "epoch": state["epoch"],
            "rng": state["generator"].get_state()}


def init_or_restore(trainer, ckpt: CheckpointManager, cfg) -> Dict:
    """A fresh train state from `cfg.seed`, or the latest checkpoint's, so
    that a resumed run continues at the epoch after the one it saved, with
    that epoch's labels and shuffling seed."""
    state = trainer.init_state(cfg.seed)
    if ckpt.latest_step() is None:
        return state
    saved = ckpt.restore(_STATE_KEYS, device=trainer.device)
    trainer.model.load_state_dict(saved["params"])
    state["generator"].set_state(saved["rng"].cpu())
    state.update(opt_state=saved["opt_state"], norm_stats=saved["norm_stats"],
                 step=int(saved["step"]), epoch=int(saved["epoch"]))
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
    """Run the recipe; returns a summary: `steps`, `epochs` (the last one
    run), `step_s` (the host time of each step this call ran, each ending in
    the step's one device synchronisation), `valid` (the last epoch's
    validation stats), `test` (the test stage's error-rate summary, or
    None) and `kernels` (`common.kernel_counts` over this call; each
    epoch's line of the train log has its own)."""
    args = parse_args(argv)
    refuse_unported(args)
    cfg = load_recipe(args.recipe, overrides=common.parse_overrides(args.overrides))
    if cfg.transducer is not None:
        raise NotImplementedError("transducer recipes (RNN-T loss, Dynamic Chunk Training) "
                                  "are not ported; see ROADMAP.md queue 1 item 4")
    if args.num_buckets:
        cfg.training.num_buckets = args.num_buckets
    device = resolve_device(args.device)
    out_dir = args.output or os.path.join(cfg.output_folder, cfg.name)
    os.makedirs(out_dir, exist_ok=True)
    train_set = read_manifest_csv(args.train_manifest)
    valid_set = read_manifest_csv(args.valid_manifest)
    tokenizer = common.build_or_load_tokenizer(cfg, out_dir, train_set)

    model, fbank = build_model(cfg, device=device)
    trainer = build_trainer(cfg, model, fbank)
    if common.estimate_steps_per_epoch(train_set, cfg) == 0:
        raise SystemExit("no training batches produced: the corpus is smaller than one bucket "
                         "batch (drop_last). Lower training.max_batch_length or num_buckets.")
    logger = FileTrainLogger(os.path.join(out_dir, "train_log.txt"))
    ckpt = CheckpointManager(os.path.join(out_dir, "save"),
                             max_to_keep=cfg.training.avg_checkpoints,
                             interval_minutes=cfg.training.ckpt_interval_minutes)
    state = init_or_restore(trainer, ckpt, cfg)
    step = state["step"]
    lm = common.load_fusion_lm(cfg, args.lm_ckpt, device)
    hb_every = int(os.environ.get("SMT_HEARTBEAT_STEPS", "10"))
    step_s: List[float] = []
    valid_stats: Dict = {}
    epoch = state["epoch"]
    counts0 = common.kernel_counts()
    for epoch in EpochCounter(cfg.training.number_of_epochs, start=state["epoch"]):
        t0 = hb_t = time.time()
        epoch_counts = common.kernel_counts()
        train_losses = []
        for batch, _ in prefetch(common.batches(train_set, tokenizer, cfg, True,
                                                cfg.seed + epoch, device)):
            ts = time.perf_counter()
            state, metrics = trainer.train_step(state, batch)
            step_s.append(time.perf_counter() - ts)
            step += 1
            train_losses.append(metrics["loss"])
            if hb_every and step % hb_every == 0:
                now = time.time()
                print(f"[hb] step {step} mean_step_s {(now - hb_t) / hb_every:.3f} "
                      f"loss {float(metrics['loss']):.3f}", flush=True)
                hb_t = now
            if ckpt.should_save():
                ckpt.save(step, checkpoint_state(model, state))
            if args.steps and step >= args.steps:
                break
        # the epoch-end checkpoint comes before validation, so a failure
        # there costs the epoch's validation numbers, not its training
        state = trainer.next_epoch(state)
        last_epoch = epoch >= cfg.training.number_of_epochs or bool(args.steps
                                                                      and step >= args.steps)
        if last_epoch or epoch == 1 or ckpt.should_save():
            ckpt.save(step, checkpoint_state(model, state))
        stats = common.error_rate_stats(cfg)
        vloss = common.greedy_score(stats, trainer, state, valid_set, tokenizer, cfg, device)
        valid_stats = {"loss": vloss, cfg.error_rate.upper(): stats.summarize()["WER"]}
        if (model.asr.num_decoder_layers > 0 and cfg.decoding.valid_search_interval > 0
                and epoch % cfg.decoding.valid_search_interval == 0):
            beam_stats = common.error_rate_stats(cfg)
            common.beam_score(beam_stats, cfg, model, fbank, state["norm_stats"], valid_set,
                              tokenizer, device, lm)
            valid_stats[f"beam_{cfg.error_rate.upper()}"] = beam_stats.summarize()["WER"]
        logger.log_stats({"epoch": epoch, "steps": step, "epoch_s": round(time.time() - t0, 1),
                          "kernels": common.kernel_counts(since=epoch_counts)},
                         epoch_loss_stats(train_losses), valid_stats)
        print(f"epoch {epoch}: steps {step}, valid {valid_stats}", flush=True)
        if args.steps and step >= args.steps:
            break
    print("training done:", step, "steps", flush=True)

    test = None
    if args.test_manifest:
        test_set = read_manifest_csv(args.test_manifest)
        stats = common.error_rate_stats(cfg)
        if model.asr.num_decoder_layers > 0 and cfg.decoding.test_beam_size > 0:
            common.beam_score(stats, cfg, model, fbank, state["norm_stats"], test_set,
                              tokenizer, device, lm, beam_size=cfg.decoding.test_beam_size,
                              temperature=cfg.decoding.test_temperature)
        else:
            common.greedy_score(stats, trainer, state, test_set, tokenizer, cfg, device)
        test = stats.summarize()
        logger.log_stats({"stage": "test"}, test_stats={cfg.error_rate.upper(): test["WER"]})
        print("test", cfg.error_rate.upper(), test["WER"], flush=True)
    return {"steps": step, "epochs": epoch, "step_s": step_s, "valid": valid_stats,
            "test": test, "tokenizer_size": tokenizer.vocab_size,
            "kernels": common.kernel_counts(since=counts0)}


if __name__ == "__main__":
    main()
