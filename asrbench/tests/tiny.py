"""A cell's small form for CPU tests, from its own files: each configuration
file's `tiny` (dotted overrides that shrink it, in the recipe's override
form) and each mix file's `tiny` (the keys its small form replaces). Holds
no size, configuration or entry of its own, so a cell added as new files
brings its small form with it."""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional

from asrbench import harness
from asrbench.yardstick import traffic


def tiny_config(name: str) -> Dict:
    """Configuration `name` with its `tiny` overrides applied both to the
    sections the file states and to the recipe's overrides."""
    cfg = copy.deepcopy(harness.load_config(name))
    tiny = cfg.pop("tiny")
    for key, value in tiny.items():
        section, field = key.split(".", 1)
        cfg.setdefault(section, {})[field] = copy.deepcopy(value)
    cfg["overrides"] = dict(cfg.get("overrides", {}), **tiny)
    return cfg


def tiny_mix(name: str) -> Dict:
    """Mix `name` (under the benchmark's folder, `harness.HERE`) with the
    keys of its `tiny` form in place of its own."""
    mix = traffic.load_mix(name, harness.HERE)
    return dict(mix, **mix.pop("tiny"))


def tiny_spec(cell: str, bench: Optional[Dict] = None, config: Optional[Dict] = None,
              per_layer: Iterable[str] = ()) -> Dict:
    """`harness.cell_spec` of `cell` in `bench` (`BENCHMARK.json` when None)
    with its configuration (or `config`) and mix in their small forms, and
    only the per-layer metrics named in `per_layer`."""
    spec = harness.cell_spec(bench or harness.load_benchmark(), cell)
    w = spec["workload"]
    spec = dict(spec, config=config or tiny_config(w["config"]), mix=tiny_mix(w["traffic"]))
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] in per_layer]
    return spec
