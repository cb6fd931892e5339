"""Training steps (`ASRTrainer.train_step`) for the window, in every process
of the cell: set-up builds one trainer, drives it through its first three
steps on the window's own feed (the steps `correct` checks against the
reference's, `compare.train_numbers`), warms up every other batch shape, and
hands the same trainer to the window. In a cell of several processes each
has its own stream of batches and draws, and every process stops at the same
step.

Its control is the reference with float8 products in the system's place
(`control`); its faults: a step that returns its state unchanged, half of
each batch left out, the exchange between the processes left out."""

from __future__ import annotations

import dataclasses
import gc
import json
import time
from typing import Dict

import numpy as np
import torch

from asrbench.harness import build_system, load_reference, no_tf32, seeds
from asrbench.reference import compare
from asrbench.yardstick import counts, traffic
from asrbench.yardstick.weights import make_weights

TRACE_UNITS = 3
CONTROL = "fp8"


def _fault_unchanged():
    from summarymixing_tpu_torch.training import optim
    saved = optim.AdamW.step
    optim.AdamW.step = lambda self, params, grads, state, norm=None: state
    return lambda: setattr(optim.AdamW, "step", saved)


def _fault_half_batch():
    from summarymixing_tpu_torch.training.trainer import ASRTrainer
    saved = ASRTrainer.train_step

    def half(self, state, batch):
        n = max(1, batch["wav"].shape[0] // 2)
        return saved(self, state, {k: v[:n] for k, v in batch.items()})

    ASRTrainer.train_step = half
    return lambda: setattr(ASRTrainer, "train_step", saved)


def _fault_no_exchange():
    from summarymixing_tpu_torch.parallel import comm
    saved = comm.GradientSync.mean_
    comm.GradientSync.mean_ = lambda self, grads, loss: (grads, loss)
    return lambda: setattr(comm.GradientSync, "mean_", saved)


FAULTS = {"unchanged": _fault_unchanged, "half_batch": _fault_half_batch,
          "no_exchange": _fault_no_exchange}
FAULT_NUMBERS = {"unchanged": "update_gap", "half_batch": "grad_gap", "no_exchange": "grad_gap"}
MULTI_PROCESS_FAULTS = ("no_exchange",)


def feed(b) -> Dict:
    """A pool batch as `train_step` and the reference take it."""
    return {"wav": b.wav, "wav_lens": b.wav_lens, "tokens": b.tokens, "token_lens": b.token_lens}


def process_seed(seed: int, index: int) -> int:
    """The seed of process `index`'s own training stream in a data-parallel
    run: SeedSequence([seed, index]), one 64-bit word shifted right by one."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


def train_pools(spec: Dict, run_seeds: Dict[str, int], seed: int, nproc: int, device,
                first=None):
    """Every process's pool (its own stream) and window order; `first`:
    process 0's `(pool, order)`, already made."""
    m = spec["config"]["model"]
    pools = [traffic.make_pool(spec["mix"], run_seeds["data"] + r, device,
                               vocab=m["output_neurons"], stream=r)
             for r in range(1 if first else 0, nproc)]
    orders = [traffic.cycle_order(len(p), seed, 3) for p in pools]
    if first:
        pools, orders = [first[0]] + pools, [first[1]] + orders
    return pools, orders


def reference_steps(spec: Dict, run_seeds: Dict[str, int], pools, orders, device,
                    prec=None) -> Dict:
    """The reference's first three steps over every process's batches and
    draws, from the seed's weights and the cell's `start_step`, in the
    precision `prec` (the reference's own float32 when None): each step's
    loss, the first gradient's norm per leaf and the three steps' change per
    leaf, in the reference's leaf order."""
    cfg = spec["config"]
    ref = load_reference(cfg)
    shapes = ref.param_shapes(cfg)
    names = [n for n, _ in shapes]
    w = make_weights(shapes, run_seeds["weights"], device)
    gens = []
    for r in range(len(pools)):
        g = torch.Generator(device=device)
        g.manual_seed(run_seeds["draws"] if len(pools) == 1 else
                      process_seed(run_seeds["draws"], r))
        gens.append(g)
    with no_tf32():
        tr = ref.Trainer(w, cfg, prec or ref.Precision(), count=spec["start_step"])
        out = {"losses": []}
        for k in range(3):
            loss, grads = tr.step([feed(p[o[k]]) for p, o in zip(pools, orders)], gens)
            out["losses"].append(loss)
            if k == 0:
                out["grad_norms"] = compare.leaf_norms([grads[n] for n in names])
        out["update_norms"] = compare.leaf_norms([tr.w[n] - w[n] for n in names])
    return out


def control(spec: Dict, seed: int, device) -> Dict[str, float]:
    """The float8 reference in the system's place over the cell's first three
    steps (every process's batches and draws of a multi-chip cell), judged by
    the float32 reference."""
    s = seeds(seed)
    pools, orders = train_pools(spec, s, seed, spec["workload"]["chips"], device)
    low = reference_steps(spec, s, pools, orders, device,
                          load_reference(spec["config"]).Precision("fp8"))
    return compare.train_numbers(low, reference_steps(spec, s, pools, orders, device))


def trainer(recipe, model, fbank):
    """The system's trainer of `model` as the recipe builds it, keeping the
    seed's weights (no xavier overwrite)."""
    from summarymixing_tpu_torch.config.loader import build_trainer

    tr = build_trainer(recipe, model, fbank)
    tr.config = dataclasses.replace(tr.config, xavier_init_overwrite=False)
    return tr


def run(cell, system, readers) -> Dict:
    from summarymixing_tpu_torch.recipes.common import kernel_counts

    model = system.model
    m, f = cell.cfg["model"], cell.cfg["features"]
    pool = traffic.make_pool(cell.mix, cell.seeds["data"] + cell.rank, cell.device,
                             vocab=m["output_neurons"], stream=cell.rank)
    order = traffic.cycle_order(len(pool), cell.seed, 10000)
    tr = trainer(system.recipe, model, system.fbank)
    state = tr.init_state(seed=cell.seeds["draws"])
    start = cell.spec["start_step"]
    if start:
        # the state of a run past its first `start` steps: the schedule
        # and the bias correction read the optimizer's count
        count = state["opt_state"]["count"]
        state = dict(state, step=start,
                     opt_state=dict(state["opt_state"], count=torch.full_like(count, start)))
    b1 = cell.cfg["training"]["adam_betas"][0]
    theta0 = [p.detach().clone() for p in tr.params]
    prog = {"losses": []}
    for k in range(3):
        state, met = tr.train_step(state, feed(pool[order[k]]))
        prog["losses"].append(float(met["loss"]))
        if k == 0:
            prog["grad_norms"] = [n / (1.0 - b1) for n in
                                  compare.leaf_norms(state["opt_state"]["mu"])]
    prog["update_norms"] = compare.leaf_norms([p - p0 for p, p0 in zip(tr.params, theta0)])
    del theta0
    # one step on each shape not met yet, the largest first; every process
    # takes as many steps as the one with most (each step is a collective)
    seen, warm = {tuple(pool[order[k]].wav.shape) for k in range(3)}, []
    for b in sorted(pool, key=lambda b: -b.wav.numel()):
        if tuple(b.wav.shape) not in seen:
            seen.add(tuple(b.wav.shape))
            warm.append(b)
    n_warm = max(cell.launch.gather_objects(len(warm))) if cell.nproc > 1 else len(warm)
    for j in range(n_warm):
        state, _ = tr.train_step(state, feed((warm or pool)[j % len(warm or pool)]))
    cell.sync()
    counts_before = kernel_counts()
    setup_s = time.perf_counter() - cell.t0
    audio, done, skipped, flops = 0.0, 0, 0, 0.0
    gc.collect()
    gc.disable()
    start = time.perf_counter()
    while True:
        b = pool[order[3 + done]]
        state, met = tr.train_step(state, feed(b))
        done += 1
        skipped += met["nonfinite_skipped"]
        stop = time.perf_counter() - start >= cell.seconds
        if cell.nproc > 1:
            stop = cell.launch.any_process(stop)
        if stop:
            break
    cell.sync()
    window_s = time.perf_counter() - start
    gc.enable()
    for j in range(done):
        b = pool[order[3 + j]]
        flops += counts.train_batch_flops(m, f, b.wav_lens.tolist(), b.token_lens.tolist())
        audio += b.audio_s
    audio, flops, skipped = cell.launch.allreduce_counts(audio, flops, float(skipped))
    kc = kernel_counts(counts_before)
    cell.notes.append(f"route: {json.dumps(kc)} over {done} steps per process")
    peak = cell.peak_bytes()
    if cell.nproc > 1:
        peak = max(cell.launch.gather_objects(peak))
    per_layer, trace = {}, None
    if readers:
        per_layer, trace = cell._traced(
            model, readers, window_s, flops, done * cell.nproc,
            lambda j: tr.train_step(state, feed(pool[order[3 + done + j]])))
    del tr, state, model
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = None
    if cell.rank == 0:
        numbers = check(cell, pool, order, prog)
    if cell.nproc > 1:
        cell.launch.barrier()
    metrics = {"train_audio_s_per_s": (audio / window_s, "audio-s/s"),
               "setup_s": (setup_s, "s")}
    return cell._result(metrics, per_layer, numbers, done * cell.nproc, int(skipped), peak,
                        trace)


def check(cell, pool, order, prog) -> Dict[str, float]:
    """The system's first three steps (`prog`) against the reference's over
    every process's batches and draws."""
    pools, orders = train_pools(cell.spec, cell.seeds, cell.seed, cell.nproc, cell.device,
                                first=(pool, order))
    out = reference_steps(cell.spec, cell.seeds, pools, orders, cell.device)
    # the system's leaves in its own order -> the reference's
    names = [n for n, _ in cell.ref.param_shapes(cell.cfg)]
    pos = {n: i for i, n in enumerate(named_order(cell.cfg))}
    prog = dict(prog, grad_norms=[prog["grad_norms"][pos[n]] for n in names],
                update_norms=[prog["update_norms"][pos[n]] for n in names])
    return compare.train_numbers(prog, out)


def named_order(cfg: Dict):
    """The names of the system's trained leaves, in its own order."""
    return [n for n, p in build_system(cfg, "meta").named_parameters().items()
            if p.requires_grad]
