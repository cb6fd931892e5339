"""The checks that every cell of a benchmark must pass, each taking the
benchmark (`BENCHMARK.json`'s dict) and finding the cell's files by name
under `harness.HERE`: the benchmark's own tests run them on its cells, and
the layout test on a cell made of new files only under a temporary folder."""

from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Tuple

from asrbench import harness
from asrbench.tests.tiny import tiny_config, tiny_spec
from asrbench.yardstick import traffic


def entry_of(workload: Dict):
    """The entry module that drives `workload` (its mix's `entry`)."""
    mix = traffic.load_mix(workload["traffic"], harness.HERE)
    return harness.load_module("entries", mix["entry"])


def cells_load_by_name(bench: Dict) -> None:
    """Every cell's configuration, mix (each with its small form), limits,
    entry, reference and readers are found by name, and every fault of its
    entry names a number of its limits."""
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"])
        entry = harness.load_module("entries", spec["mix"]["entry"])
        assert entry.TRACE_UNITS > 0 and callable(entry.run)
        assert (harness.HERE / "entries" / f"{spec['mix']['entry']}.py").is_file()
        faults = getattr(entry, "FAULTS", {})
        assert set(getattr(entry, "FAULT_NUMBERS", {})) == set(faults)
        assert set(getattr(entry, "MULTI_PROCESS_FAULTS", ())) <= set(faults)
        assert {entry.FAULT_NUMBERS[f] for f in faults} <= set(spec["limits"])
        ref = harness.load_reference(spec["config"])
        assert ref.__file__ == str(harness.HERE / "reference" / f"{spec['config']['reference']}.py")
        assert callable(ref.param_shapes)
        assert spec["config"]["name"] == w["config"]
        assert spec["config"]["tiny"] and spec["mix"]["tiny"]
        assert spec["limits"]
        assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
        for m in spec["per_layer"]:
            assert callable(harness.load_reader(m["name"]).read)
    for c in bench["configs"]:
        cfg = json.loads((harness.HERE.parent / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def recipes_match(bench: Dict) -> None:
    """Every configuration, as its file states it and in its small form:
    the system as built has exactly the reference's parameter names and
    shapes (a transducer's under `transducer.`), and carries a transducer
    exactly where the configuration's recipe has a `transducer` section."""
    for c in bench["configs"]:
        for cfg in (harness.load_config(c["name"]), tiny_config(c["name"])):
            system = harness.build_system(cfg, "meta")
            shapes = dict(harness.load_reference(cfg).param_shapes(cfg))
            assert {n: tuple(p.shape) for n, p in system.named_parameters().items()} == shapes
            recipe = (harness.ROOT / cfg["recipe"]).read_text()
            has_section = re.search(r"^transducer:", recipe, re.MULTILINE) is not None
            assert (system.transducer is not None) == has_section, c["name"]


def fault_cases(bench: Dict) -> List[Tuple[str, str, str]]:
    """`(cell, fault, number)` for every one-chip cell and every fault of its
    entry that one process can have, with the number it must push over its
    limit."""
    out = []
    for w in bench["workloads"]:
        if w["chips"] != 1:
            continue
        entry = entry_of(w)
        multi = getattr(entry, "MULTI_PROCESS_FAULTS", ())
        out += [(w["name"], f, n) for f, n in getattr(entry, "FAULT_NUMBERS", {}).items()
                if f not in multi]
    return out


def fault_makes_correct_false(bench: Dict, cell: str, fault: str, number: str) -> Dict:
    """A tiny run of `cell` on the CPU with `fault` planted under its timed
    path reads `correct` false, with `number` over its limit."""
    spec = tiny_spec(cell, bench)
    undo = harness.load_module("entries", spec["mix"]["entry"]).FAULTS[fault]()
    try:
        res = harness.CellRun(cell, 2**31 + 9, 0.3, False, "cpu", time.perf_counter(),
                              spec).run()
    finally:
        undo()
    assert res["correct"] is False
    assert res["checks"][number]["value"] > res["checks"][number]["limit"], res["checks"]
    return res
