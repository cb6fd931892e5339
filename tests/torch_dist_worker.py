"""One process of a multi-process check of the port, started by the port's
tests (`tests/test_torch_sequence_parallel.py`) with `SMT_COORDINATOR`,
`SMT_NUM_PROCESSES` and `SMT_PROCESS_ID` set; it imports the port only,
never JAX, so that the JAX side runs in the pytest process alone.

    python tests/torch_dist_worker.py seq CASES.json OUT_DIR

`seq`: for each case of CASES.json (`name`, `asr` keyword arguments of
`TransformerASR`, `vocab`, `frontend_channels`, the path of the port's
`state_dict`, of the features `[B, T, F]` and of the lengths), the
time-sharded encode and greedy CTC decode over every process
(`parallel/sequence.py`), saved to `OUT_DIR/<name>.rank<r>.pt`; then the
data mesh's rows of a batch and placements (`mesh.rank<r>.pt`) and the
refusal of a time axis that does not divide, saved as its message.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from summarymixing_tpu_torch.models.asr import TransformerASR  # noqa: E402
from summarymixing_tpu_torch.models.speech_recognizer import SpeechRecognizer  # noqa: E402
from summarymixing_tpu_torch.parallel import launch, sequence  # noqa: E402
from summarymixing_tpu_torch.parallel.mesh import (  # noqa: E402
    data_parallel_sharding,
    make_mesh,
    replicate,
    shard_batch,
)


def run_seq(cases_path: str, out_dir: str) -> None:
    launch.initialize(device="cpu")
    rank = launch.process_index()
    with open(cases_path) as f:
        cases = json.load(f)
    for case in cases:
        asr = TransformerASR(**case["asr"])
        model = SpeechRecognizer(asr, case["vocab"], frontend_channels=case["frontend_channels"])
        model.load_state_dict(torch.load(case["state"], weights_only=True))
        model.eval()
        feats = torch.load(case["feats"], weights_only=True)
        lens = torch.load(case["lens"], weights_only=True)
        mesh = sequence.make_seq_mesh(n_seq=launch.process_count())
        enc, enc_len = sequence.sequence_parallel_encode(model, mesh)(feats, lens)
        ids, keep, dec_len = sequence.sequence_parallel_ctc_decode(model, mesh)(feats, lens)
        torch.save({"enc": enc, "enc_len": enc_len, "ids": ids, "keep": keep,
                    "dec_len": dec_len}, os.path.join(out_dir, f"{case['name']}.rank{rank}.pt"))
    data = make_mesh()
    torch.save({"rows": shard_batch({"x": torch.arange(4)}, data)["x"],
                "placements": [repr(p) for p in data_parallel_sharding(data)],
                "replicated": [repr(p) for p in replicate(data)]},
               os.path.join(out_dir, f"mesh.rank{rank}.pt"))
    try:
        sequence.sequence_parallel_encode(model, mesh)(feats[:, :-1], lens)
        refusal = ""
    except ValueError as e:
        refusal = str(e)
    with open(os.path.join(out_dir, f"refusal.rank{rank}.txt"), "w") as f:
        f.write(refusal)


if __name__ == "__main__":
    if sys.argv[1] != "seq":
        raise SystemExit(f"unknown check {sys.argv[1]!r}")
    run_seq(sys.argv[2], sys.argv[3])
