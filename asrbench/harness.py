"""One run of one cell: set-up, the measured window, the traced stretch, the
comparison with the reference, and the result line.

Everything a cell needs is found by name: its entry in `BENCHMARK.json`
(configuration, traffic mix, chips), `configs/<config>.json` (the recipe and
its overrides, and the configuration's sizes, which the reference reads),
`traffic/<mix>.json` (read by `yardstick/traffic.py`), `limits/<cell>.json`
(`limits`: the limit of each number that decides `correct`; `start_step`, for
a training cell: the optimizer steps its state counts as taken before the
three checked steps, 0 when absent) and, for each per-layer
metric that `BENCHMARK.json` gives the cell, `metrics/<metric>.py` (a
`read(ctx)` that returns the value or None, and the module classes whose
forwards it needs timed, `MODULES`). An end-to-end metric named
`<quantity>.<suffix>` is the cell's own copy of `<quantity>`, with a bound of
its own.

The system under test is `summarymixing_tpu_torch`: the harness builds its
model from the recipe, loads the seed's weights into it, and drives its
entry points `transcribe.greedy_ctc_decode` and `ASRTrainer.train_step`.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from asrbench.reference import asr as ref
from asrbench.reference import compare
from asrbench.yardstick import counts, traffic
from asrbench.yardstick.weights import make_norm_stats, make_weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "summarymixing_tpu")
TRACE_BATCHES = {"decode": 8, "train": 3}


def load_benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_config(name: str) -> Dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"asrbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(bench: Dict, name: str) -> Dict:
    """The cell's entry, configuration, mix, limits and metrics by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [])
                 or ("workloads" not in m and any(x["name"] == m["moves"] for x in e2e))]
    check = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return {"workload": w, "config": load_config(w["config"]),
            "mix": traffic.load_mix(w["traffic"]), "limits": check["limits"],
            "start_step": check.get("start_step", 0), "end_to_end": e2e,
            "per_layer": per_layer}


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


# -- the system under test ---------------------------------------------------------

def recipe_dict(cfg: Dict) -> Dict:
    """The sections of the configuration file that the recipe must match."""
    return {k: cfg[k] for k in ("features", "augment", "model", "training") if k in cfg}


def build_system(cfg: Dict, device, extra_overrides: Optional[Dict] = None):
    """The system's recognizer and Fbank from the configuration's recipe, on
    `device`, with parameters left empty; checks that the recipe as loaded
    has every number the configuration file states."""
    from summarymixing_tpu_torch.config.loader import build_model, load_recipe
    from summarymixing_tpu_torch.frontend.features import Fbank

    recipe = load_recipe(str(ROOT / cfg["recipe"]), cfg.get("overrides", {}))
    for section, values in recipe_dict(cfg).items():
        got = dataclasses.asdict(getattr(recipe, section))
        for k, v in values.items():
            have = list(got[k]) if isinstance(got[k], tuple) else got[k]
            if have != v:
                raise SystemExit(f"configuration {cfg['name']}: {section}.{k} is {v!r} in the "
                                 f"file but {have!r} in the recipe as loaded")
    if extra_overrides:
        recipe = load_recipe(str(ROOT / cfg["recipe"]), dict(cfg.get("overrides", {}),
                                                             **extra_overrides))
    model, _ = build_model(recipe, device="meta")
    model = model.to_empty(device=device)
    f = recipe.features
    fbank = Fbank(sample_rate=f.sample_rate, n_fft=f.n_fft, win_length_ms=float(f.win_length),
                  hop_length_ms=float(f.hop_length), n_mels=f.n_mels).to(device)
    return recipe, model, fbank


@torch.no_grad()
def load_weights(model, weights: Dict[str, torch.Tensor]) -> None:
    named = dict(model.named_parameters())
    if set(named) != set(weights) or any(named[n].shape != weights[n].shape for n in named):
        raise SystemExit("the system's parameters do not have the reference's names and shapes: "
                         f"{sorted(set(named) ^ set(weights))[:6]}")
    names = sorted(named)
    torch._foreach_copy_([named[n] for n in names], [weights[n] for n in names])


def seeds(seed: int) -> Dict[str, int]:
    """The run's seeds for its weights, data, statistics and training draws."""
    ss = np.random.SeedSequence([seed, 20261018]).generate_state(4, np.uint64)
    return dict(zip(("weights", "data", "stats", "train"), (int(x >> 1) for x in ss)))


def feed(b) -> Dict:
    """A pool batch as `train_step` and the reference take it."""
    return {"wav": b.wav, "wav_lens": b.wav_lens, "tokens": b.tokens, "token_lens": b.token_lens}


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
                    prec: ref.Precision = ref.Precision()) -> Dict:
    """The reference's first three steps over every process's batches and
    draws, from the seed's weights and the cell's `start_step`: each step's
    loss, the first gradient's norm per leaf and the three steps' change per
    leaf, in the reference's leaf order."""
    cfg = spec["config"]
    shapes = ref.param_shapes(cfg["model"])
    names = [n for n, _ in shapes]
    w = make_weights(shapes, run_seeds["weights"], device)
    gens = []
    for r in range(len(pools)):
        g = torch.Generator(device=device)
        g.manual_seed(run_seeds["train"] if len(pools) == 1 else
                      process_seed(run_seeds["train"], r))
        gens.append(g)
    with no_tf32():
        tr = ref.Trainer(w, cfg, prec, count=spec["start_step"])
        out = {"losses": []}
        for k in range(3):
            loss, grads = tr.step([feed(p[o[k]]) for p, o in zip(pools, orders)], gens)
            out["losses"].append(loss)
            if k == 0:
                out["grad_norms"] = compare.leaf_norms([grads[n] for n in names])
        out["update_norms"] = compare.leaf_norms([tr.w[n] - w[n] for n in names])
    return out


class ModuleTimer:
    """Forward hooks that open an `asrbench::<Class>` profiler range around
    each forward of the named classes, and note each call's shapes."""

    def __init__(self, model, classes):
        self.calls = {c: [] for c in classes}
        self.handles = []
        for mod in model.modules():
            cls = type(mod).__name__
            if cls in self.calls:
                self.handles.append(mod.register_forward_pre_hook(self._pre, with_kwargs=True))
                self.handles.append(mod.register_forward_hook(self._post))

    def _pre(self, mod, args, kwargs):
        cls = type(mod).__name__
        x = args[0]
        # the pad mask is kept and summed after the stretch: no host sync here
        self.calls[cls].append((x.shape[0], x.shape[1], kwargs.get("pad_mask")))
        rf = torch.profiler.record_function(f"asrbench::{cls}")
        rf.__enter__()
        mod.__dict__["_asrbench_range"] = rf

    def _post(self, mod, args, out):
        mod.__dict__.pop("_asrbench_range").__exit__(None, None, None)

    def close(self):
        """Remove the hooks; each call's pad mask becomes its valid frame count."""
        for h in self.handles:
            h.remove()
        sums = {}
        for cls, calls in self.calls.items():
            self.calls[cls] = [(b, t, b * t if pad is None else
                                sums.setdefault(id(pad), int(pad.sum())))
                               for b, t, pad in calls]


# -- one run -------------------------------------------------------------------------

class CellRun:
    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device,
                 t0: float, spec: Optional[Dict] = None, overrides: Optional[Dict] = None):
        self.name, self.seed, self.seconds, self.trace = name, seed, seconds, trace
        self.device = torch.device(device)
        self.t0 = t0
        self.spec = spec or cell_spec(load_benchmark(), name)
        self.cfg, self.mix = self.spec["config"], self.spec["mix"]
        self.overrides = overrides
        self.seeds = seeds(seed)
        self.notes: List[str] = []
        from summarymixing_tpu_torch.parallel import launch
        self.launch = launch
        self.rank, self.nproc = launch.process_index(), launch.process_count()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self) -> Dict:
        readers = {m["name"]: load_reader(m["name"]) for m in self.spec["per_layer"]} \
            if self.trace else {}
        entry = self.mix["entry"]
        shapes = ref.param_shapes(self.cfg["model"])
        self.recipe, model, fbank = build_system(self.cfg, self.device, self.overrides)
        load_weights(model, make_weights(shapes, self.seeds["weights"], self.device))
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        return (self._decode if entry == "decode" else self._train)(model, fbank, readers)

    # -- decode ---------------------------------------------------------------
    def _decode(self, model, fbank, readers) -> Dict:
        from summarymixing_tpu_torch.recipes.common import kernel_counts
        from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

        m, f = self.cfg["model"], self.cfg["features"]
        stats = make_norm_stats(f["n_mels"], self.seeds["stats"], self.device)
        pool = traffic.make_pool(self.mix, self.seeds["data"], self.device)
        for b in sorted(pool, key=lambda b: -b.wav.numel()):
            greedy_ctc_decode(model, fbank, stats, b.wav, b.wav_lens)
        self.sync()
        counts_before = kernel_counts()
        rng = np.random.default_rng([self.seed, 11])
        longest = max(range(len(pool)), key=lambda i: pool[i].wav.numel())
        sample = {longest} | set(rng.choice(len(pool), self.mix["check_batches"] - 1,
                                            replace=False).tolist())
        order = traffic.cycle_order(len(pool), self.seed, 10000)
        setup_s = time.perf_counter() - self.t0
        kept, lat, audio, flops, done = {}, [], 0.0, 0.0, 0
        gc.collect()
        gc.disable()
        start = time.perf_counter()
        while True:
            i = order[done]
            b = pool[i]
            t1 = time.perf_counter()
            hyps, res = greedy_ctc_decode(model, fbank, stats, b.wav, b.wav_lens)
            t2 = time.perf_counter()
            lat.append(t2 - t1)
            audio += b.audio_s
            done += 1
            if i in sample and i not in kept:
                kept[i] = {"hyps": hyps, "lp": res["ctc_log_probs"], "lens": res["enc_lengths"]}
            if t2 - start >= self.seconds:
                break
        window_s = t2 - start
        gc.enable()
        for i in order[:done]:
            flops += counts.decode_batch_flops(m, f, pool[i].wav_lens.tolist())
        kc = kernel_counts(counts_before)
        self.notes.append(f"route: {json.dumps(kc)} over {done} batches")
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        per_layer, trace = {}, None
        if readers:
            per_layer, trace = self._traced(model, readers, window_s, flops, done, lambda j: (
                greedy_ctc_decode(model, fbank, stats, pool[order[j]].wav,
                                  pool[order[j]].wav_lens)))
        del model
        gc.collect()
        numbers = self._check_decode(pool, kept, stats)
        metrics = {"decode_audio_s_per_s": (audio / window_s, "audio-s/s"),
                   "decode_p95_ms": (1000.0 * statistics.quantiles(lat, n=20)[-1]
                                     if len(lat) >= 2 else 1000.0 * lat[0], "ms"),
                   "setup_s": (setup_s, "s")}
        return self._result(metrics, per_layer, numbers, done, 0, peak, trace)

    def _check_decode(self, pool, kept, stats) -> Dict[str, float]:
        w = make_weights(ref.param_shapes(self.cfg["model"]), self.seeds["weights"], self.device)
        rstats = make_norm_stats(self.cfg["features"]["n_mels"], self.seeds["stats"], self.device)
        rows = []
        block = self.mix.get("check_rows", 16)
        with no_tf32():
            for i, k in sorted(kept.items()):
                b = pool[i]
                lps, lens = [], []
                for s in range(0, b.wav.shape[0], block):
                    lp, ln = ref.ctc_log_probs(w, self.cfg, rstats, b.wav[s:s + block],
                                               b.wav_lens[s:s + block])
                    lps.append(lp)
                    lens.append(ln)
                rows.append(dict(k, ref_lp=torch.cat(lps), ref_lens=torch.cat(lens)))
        if not rows:
            raise RuntimeError("no sampled batch completed in the window: nothing to compare")
        return compare.decode_numbers(rows)

    # -- train ----------------------------------------------------------------
    def _trainer(self, model, fbank):
        from summarymixing_tpu_torch.config.loader import build_trainer

        trainer = build_trainer(self.recipe, model, fbank)
        trainer.config = dataclasses.replace(trainer.config, xavier_init_overwrite=False)
        return trainer

    def _train(self, model, fbank, readers) -> Dict:
        from summarymixing_tpu_torch.recipes.common import kernel_counts

        m, f = self.cfg["model"], self.cfg["features"]
        pool = traffic.make_pool(self.mix, self.seeds["data"] + self.rank, self.device,
                                 vocab=m["output_neurons"], stream=self.rank)
        order = traffic.cycle_order(len(pool), self.seed, 10000)
        trainer = self._trainer(model, fbank)
        state = trainer.init_state(seed=self.seeds["train"])
        start = self.spec["start_step"]
        if start:
            # the state of a run past its first `start` steps: the schedule
            # and the bias correction read the optimizer's count
            count = state["opt_state"]["count"]
            state = dict(state, step=start,
                         opt_state=dict(state["opt_state"], count=torch.full_like(count, start)))
        b1 = self.cfg["training"]["adam_betas"][0]
        theta0 = [p.detach().clone() for p in trainer.params]
        prog = {"losses": []}
        for k in range(3):
            state, met = trainer.train_step(state, feed(pool[order[k]]))
            prog["losses"].append(float(met["loss"]))
            if k == 0:
                prog["grad_norms"] = [n / (1.0 - b1) for n in
                                      compare.leaf_norms(state["opt_state"]["mu"])]
        prog["update_norms"] = compare.leaf_norms(
            [p - p0 for p, p0 in zip(trainer.params, theta0)])
        del theta0
        # one step on each shape not met yet, the largest first; every process
        # takes as many steps as the one with most (each step is a collective)
        seen, warm = {tuple(pool[order[k]].wav.shape) for k in range(3)}, []
        for b in sorted(pool, key=lambda b: -b.wav.numel()):
            if tuple(b.wav.shape) not in seen:
                seen.add(tuple(b.wav.shape))
                warm.append(b)
        n_warm = max(self.launch.gather_objects(len(warm))) if self.nproc > 1 else len(warm)
        for j in range(n_warm):
            state, _ = trainer.train_step(state, feed((warm or pool)[j % len(warm or pool)]))
        self.sync()
        counts_before = kernel_counts()
        setup_s = time.perf_counter() - self.t0
        audio, done, skipped, flops = 0.0, 0, 0, 0.0
        gc.collect()
        gc.disable()
        start = time.perf_counter()
        while True:
            b = pool[order[3 + done]]
            state, met = trainer.train_step(state, feed(b))
            done += 1
            skipped += met["nonfinite_skipped"]
            stop = time.perf_counter() - start >= self.seconds
            if self.nproc > 1:
                stop = self.launch.any_process(stop)
            if stop:
                break
        self.sync()
        window_s = time.perf_counter() - start
        gc.enable()
        for j in range(done):
            b = pool[order[3 + j]]
            flops += counts.train_batch_flops(m, f, b.wav_lens.tolist(), b.token_lens.tolist())
            audio += b.audio_s
        audio, flops, skipped = self.launch.allreduce_counts(audio, flops, float(skipped))
        kc = kernel_counts(counts_before)
        self.notes.append(f"route: {json.dumps(kc)} over {done} steps per process")
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        if self.nproc > 1:
            peak = max(self.launch.gather_objects(peak))
        per_layer, trace = {}, None
        if readers:
            per_layer, trace = self._traced(
                model, readers, window_s, flops, done * self.nproc,
                lambda j: trainer.train_step(state, feed(pool[order[3 + done + j]])))
        del trainer, state, model
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers = None
        if self.rank == 0:
            numbers = self._check_train(pool, order, prog)
        if self.nproc > 1:
            self.launch.barrier()
        metrics = {"train_audio_s_per_s": (audio / window_s, "audio-s/s"),
                   "setup_s": (setup_s, "s")}
        return self._result(metrics, per_layer, numbers, done * self.nproc, int(skipped), peak,
                            trace)

    def _check_train(self, pool, order, prog) -> Dict[str, float]:
        pools, orders = train_pools(self.spec, self.seeds, self.seed, self.nproc, self.device,
                                    first=(pool, order))
        out = reference_steps(self.spec, self.seeds, pools, orders, self.device)
        # the system's leaves in its own order -> the reference's
        names = [n for n, _ in ref.param_shapes(self.cfg["model"])]
        pos = {n: i for i, (n, _) in enumerate(self._named_order())}
        prog = dict(prog, grad_norms=[prog["grad_norms"][pos[n]] for n in names],
                    update_norms=[prog["update_norms"][pos[n]] for n in names])
        return compare.train_numbers(prog, out)

    def _named_order(self):
        _, model, _ = build_system(self.cfg, "meta")
        return [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    # -- traced stretch and result ----------------------------------------------
    def _traced(self, model, readers, window_s, flops, units, step_fn):
        from asrbench.yardstick.trace import summarize

        classes = sorted({c for r in readers.values() for c in getattr(r, "MODULES", ())})
        timer = ModuleTimer(model, classes)
        n = TRACE_BATCHES[self.mix["entry"]]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.sync()
        with torch.profiler.profile(activities=acts) as prof:
            start = time.perf_counter()
            for j in range(n):
                with torch.profiler.record_function("asrbench::step"):
                    step_fn(j)
            self.sync()
            stretch_s = time.perf_counter() - start
        timer.close()
        summary = summarize(prof)
        ctx = SimpleNamespace(entry=self.mix["entry"], model=self.cfg["model"], window_s=window_s,
                              flops=flops, units=units, trace=summary, stretch_s=stretch_s,
                              stretch_units=n, calls=timer.calls, counts=counts,
                              cards=self.nproc)
        values = {}
        for name, reader in readers.items():
            v = reader.read(ctx)
            if v is not None:
                values[name] = v
        return values, (summary, stretch_s)

    def _result(self, e2e, per_layer, numbers, attempted, failed, peak, trace) -> Dict:
        units = {m["name"]: m["unit"] for m in self.spec["end_to_end"] + self.spec["per_layer"]}
        if self.trace:
            metrics = {k: {"value": v, "unit": units[k]} for k, v in per_layer.items()}
        else:
            # each quantity under the cell's metric of that name, or its own
            # copy `<quantity>.<suffix>`
            metrics = {m["name"]: {"value": v, "unit": m["unit"]} for k, (v, _) in e2e.items()
                       for m in self.spec["end_to_end"]
                       if m["name"] == k or m["name"].startswith(k + ".")}
        dev = {"platform": "gpu" if self.device.type == "cuda" else self.device.type,
               "kind": (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                        else "cpu"),
               "count": self.nproc, "memory_peak_bytes": int(peak)}
        out = {"correct": None, "attempted": attempted, "failed": failed, "metrics": metrics,
               "device": dev}
        if trace is not None:
            summary, stretch_s = trace
            dev["busy_s"] = summary.busy_s
            dev["window_s"] = stretch_s
            out["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                                "idle_gaps": [list(x) for x in summary.idle_gaps]}
        if numbers is not None:
            checks = compare.judge(numbers, self.spec["limits"])
            out["correct"] = all(c["ok"] for c in checks) and failed == 0
            out["numbers"] = numbers
            out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
        return out


def process_seed(seed: int, index: int) -> int:
    """The seed of process `index`'s own training stream in a data-parallel
    run: SeedSequence([seed, index]), one 64-bit word shifted right by one."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0] >> 1)


class no_tf32:
    """float32 products in float32 (no TF32) inside the block, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
