"""One run of one cell: set-up, the measured window, the traced stretch, the
comparison with the reference, and the result line.

Everything a cell needs is found by name: its entry in `BENCHMARK.json`
(configuration, traffic mix, chips), `configs/<config>.json` (the recipe and
its overrides, the configuration's sizes, `reference`: the name of its
plain reference, `reference/<reference>.py`, and `tiny`: the dotted
overrides of its small form for the CPU tests), `traffic/<mix>.json` (read
by `yardstick/traffic.py`; its `entry` names `entries/<entry>.py`, the
module that drives the cell; its `tiny`, the keys of its small form),
`limits/<cell>.json` (`limits`: the limit of each
number that decides `correct`; `start_step`, for a training cell: the
optimizer steps its state counts as taken before the three checked steps, 0
when absent) and, for each per-layer metric that `BENCHMARK.json` gives the
cell, `metrics/<metric>.py` (a `read(ctx)` that returns the value or None,
and the module classes whose forwards it needs timed, `MODULES`). An
end-to-end metric named `<quantity>.<suffix>` is the cell's own copy of
`<quantity>`, with a bound of its own.

An entry module has `TRACE_UNITS` (the batches or steps of the traced
stretch) and `run(cell, system, readers)`, which warms up, measures, traces
through `cell._traced` when `readers` is not empty, compares with the
reference (`cell.ref`) and returns `cell._result(...)`; and, for the
benchmark's tests, its faults (`FAULTS`: name -> a function that plants the
fault and returns its undo), the number of the limits that each fault must
push over its limit (`FAULT_NUMBERS`) and the faults that only a cell of
several processes can have (`MULTI_PROCESS_FAULTS`). The reference
module has `param_shapes(cfg)`: the name and shape of every parameter of
the system that the configuration describes, from which the seed's weights
are drawn.

The system under test is `summarymixing_tpu_torch`: the harness builds what
its `build_model` builds from the recipe and loads the seed's weights into
it; the entry drives its entry points.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from asrbench.reference import compare
from asrbench.yardstick import counts, traffic
from asrbench.yardstick.weights import make_weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "summarymixing_tpu")
_LOADED: Dict[Path, ModuleType] = {}


def load_benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_config(name: str) -> Dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """`<kind>/<name>.py` under `HERE` (`entries`, `reference`, `metrics`),
    loaded from its file once per process."""
    path = HERE / kind / f"{name}.py"
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"asrbench_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def load_reader(metric: str) -> ModuleType:
    return load_module("metrics", metric)


def load_reference(cfg: Dict) -> ModuleType:
    return load_module("reference", cfg["reference"])


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
            "mix": traffic.load_mix(w["traffic"], HERE), "limits": check["limits"],
            "start_step": check.get("start_step", 0), "end_to_end": e2e,
            "per_layer": per_layer}


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


# -- the system under test ---------------------------------------------------------

def recipe_dict(cfg: Dict, recipe) -> Dict:
    """The sections of the configuration file that the recipe must match:
    every one that names a section of the recipe."""
    sections = {f.name for f in dataclasses.fields(recipe)}
    return {k: v for k, v in cfg.items() if k in sections and isinstance(v, dict)}


@dataclasses.dataclass
class System:
    """What the system's `build_model` builds from the recipe, on the run's
    device: the recognizer, its Fbank and, where the recipe has a
    `transducer` section, the `TransducerModel`."""
    recipe: object
    model: torch.nn.Module
    fbank: torch.nn.Module
    transducer: Optional[torch.nn.Module] = None

    def named_parameters(self) -> Dict[str, torch.nn.Parameter]:
        """Every parameter: the recognizer's by its own names, the others
        under their recipe section's name (`transducer.`)."""
        named = dict(self.model.named_parameters())
        if self.transducer is not None:
            named.update({f"transducer.{n}": p for n, p in self.transducer.named_parameters()})
        return named


def build_system(cfg: Dict, device, extra_overrides: Optional[Dict] = None) -> System:
    """The system from the configuration's recipe, on `device`, with
    parameters left empty; checks that the recipe as loaded has every number
    the configuration file states."""
    from summarymixing_tpu_torch.config.loader import build_model, load_recipe
    from summarymixing_tpu_torch.frontend.features import Fbank

    recipe = load_recipe(str(ROOT / cfg["recipe"]), cfg.get("overrides", {}))
    for section, values in recipe_dict(cfg, recipe).items():
        if getattr(recipe, section) is None:
            raise SystemExit(f"configuration {cfg['name']}: the file states a {section} section "
                             "that the recipe as loaded does not have")
        got = dataclasses.asdict(getattr(recipe, section))
        for k, v in values.items():
            have = list(got[k]) if isinstance(got[k], tuple) else got[k]
            if have != v:
                raise SystemExit(f"configuration {cfg['name']}: {section}.{k} is {v!r} in the "
                                 f"file but {have!r} in the recipe as loaded")
    if extra_overrides:
        recipe = load_recipe(str(ROOT / cfg["recipe"]), dict(cfg.get("overrides", {}),
                                                             **extra_overrides))
    built = build_model(recipe, device="meta")
    transducer = built[2].to_empty(device=device) if len(built) > 2 else None
    f = recipe.features
    fbank = Fbank(sample_rate=f.sample_rate, n_fft=f.n_fft, win_length_ms=float(f.win_length),
                  hop_length_ms=float(f.hop_length), n_mels=f.n_mels).to(device)
    return System(recipe, built[0].to_empty(device=device), fbank, transducer)


@torch.no_grad()
def load_weights(system: System, weights: Dict[str, torch.Tensor]) -> None:
    named = system.named_parameters()
    if set(named) != set(weights) or any(named[n].shape != weights[n].shape for n in named):
        raise SystemExit("the system's parameters do not have the reference's names and shapes: "
                         f"{sorted(set(named) ^ set(weights))[:6]}")
    names = sorted(named)
    torch._foreach_copy_([named[n] for n in names], [weights[n] for n in names])


def seeds(seed: int) -> Dict[str, int]:
    """The run's seeds for its weights, data, statistics and the draws of
    its steps (dropout, augmentation)."""
    ss = np.random.SeedSequence([seed, 20261018]).generate_state(4, np.uint64)
    return dict(zip(("weights", "data", "stats", "draws"), (int(x >> 1) for x in ss)))


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
    """One run of the cell `name`: its spec, seeds and process, its entry
    module (`entry`) and its configuration's reference (`ref`)."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device,
                 t0: float, spec: Optional[Dict] = None, overrides: Optional[Dict] = None):
        self.name, self.seed, self.seconds, self.trace = name, seed, seconds, trace
        self.device = torch.device(device)
        self.t0 = t0
        self.spec = spec or cell_spec(load_benchmark(), name)
        self.cfg, self.mix = self.spec["config"], self.spec["mix"]
        self.entry = load_module("entries", self.mix["entry"])
        self.ref = load_reference(self.cfg)
        self.overrides = overrides
        self.seeds = seeds(seed)
        self.notes: List[str] = []
        from summarymixing_tpu_torch.parallel import launch
        self.launch = launch
        self.rank, self.nproc = launch.process_index(), launch.process_count()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        """The most memory allocated on this process's card since set-up."""
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def run(self) -> Dict:
        readers = {m["name"]: load_reader(m["name"]) for m in self.spec["per_layer"]} \
            if self.trace else {}
        shapes = self.ref.param_shapes(self.cfg)
        system = build_system(self.cfg, self.device, self.overrides)
        load_weights(system, make_weights(shapes, self.seeds["weights"], self.device))
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        return self.entry.run(self, system, readers)

    # -- traced stretch and result ----------------------------------------------
    def _traced(self, model, readers, window_s, flops, units, step_fn):
        """`readers` over a profiled stretch of the entry's `TRACE_UNITS`
        calls `step_fn(j)`, each in an `asrbench::step` range. A reader's
        `ctx` holds the trace's summary (`trace`), its program spans
        (`spans`), the rise over the stretch of every kernel counter of
        `recipes.common.kernel_counts` and of the collectives' `calls` and
        `bytes` (`counters`, the latter under `collectives`), and every
        process's `span_steps` (`peers`, in process order)."""
        from summarymixing_tpu_torch.parallel import comm
        from summarymixing_tpu_torch.recipes.common import kernel_counts

        from asrbench.yardstick.trace import summarize

        classes = sorted({c for r in readers.values() for c in getattr(r, "MODULES", ())})
        timer = ModuleTimer(model, classes)
        n = self.entry.TRACE_UNITS
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.sync()
        kernels_before, collectives_before = kernel_counts(), dict(comm.COLLECTIVES)
        with torch.profiler.profile(activities=acts) as prof:
            start = time.perf_counter()
            for j in range(n):
                with torch.profiler.record_function("asrbench::step"):
                    step_fn(j)
            self.sync()
            stretch_s = time.perf_counter() - start
        counters = dict(kernel_counts(kernels_before), collectives={
            k: v - collectives_before[k] for k, v in comm.COLLECTIVES.items()})
        timer.close()
        summary = summarize(prof)
        ctx = SimpleNamespace(entry=self.mix["entry"], model=self.cfg["model"], window_s=window_s,
                              flops=flops, units=units, trace=summary, stretch_s=stretch_s,
                              stretch_units=n, calls=timer.calls, counts=counts,
                              cards=self.nproc, spans=summary, counters=counters,
                              peers=self.launch.gather_objects(summary.span_steps))
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


class no_tf32:
    """float32 products in float32 (no TF32) inside the block, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
