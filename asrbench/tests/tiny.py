"""A tiny cell for CPU tests: the flagship's layer structure at small widths
and depth, with small traffic mixes."""

from __future__ import annotations

import copy

from asrbench import harness

TINY_MODEL = {"d_model": 64, "num_encoder_layers": 2, "num_decoder_layers": 1, "d_ffn": 128,
              "csgu_linear_units": 128, "local_proj_hid_dim": [64], "local_proj_out_dim": 64,
              "summary_hid_dim": [64], "summary_out_dim": 64, "output_neurons": 50}
MIXES = {
    "decode": {"entry": "decode", "utterances": 6, "length_seed": 3,
               "lengths": {"kind": "uniform", "min_s": 0.8, "max_s": 2.5},
               "batching": {"max_batch_s": 6.0, "max_rows": 3}, "pad_quantum_s": 0.25,
               "check_batches": 2, "check_rows": 2},
    "train": {"entry": "train", "utterances": 12, "length_seed": 4,
              "lengths": {"kind": "uniform", "min_s": 0.8, "max_s": 2.5},
              "batching": {"max_batch_s": 6.0, "max_rows": 3}, "pad_quantum_s": 0.25,
              "tokens_per_s": 3.5},
}


def tiny_config(name: str = "branchformer_summarymixing", **model) -> dict:
    cfg = copy.deepcopy(harness.load_config(name))
    cfg["model"].update(TINY_MODEL, **model)
    cfg["overrides"] = dict(cfg["overrides"], **{f"model.{k}": v for k, v in cfg["model"].items()
                                                 if k in TINY_MODEL or k in model})
    return cfg


def tiny_spec(cell: str, entry: str, config: dict = None, per_layer=()) -> dict:
    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, cell)
    spec = dict(spec, config=config or tiny_config(spec["workload"]["config"]),
                mix=copy.deepcopy(MIXES[entry]))
    spec["per_layer"] = [m for m in spec["per_layer"] if m["name"] in per_layer]
    return spec

