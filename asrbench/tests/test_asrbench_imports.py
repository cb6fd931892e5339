"""Import hygiene: a run of the harness loads none of `jax`, `jaxlib`,
`flax`, `optax` or the JAX package `summarymixing_tpu` (top-level names
compared whole: `summarymixing_tpu_torch` is the system under test), and the
reference loads nothing of the system at all. Each check runs in a fresh
interpreter."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "summarymixing_tpu"}

HARNESS_RUN = """
import json, sys, time
from asrbench import control, harness, run
from asrbench.tests.tiny import tiny_spec
for cell, metrics in (("bf_sm.decode", ("mfu.decode", "idle_share.decode")),
                      ("bf_sm.train", ("mfu.train",))):
    spec = tiny_spec(cell, per_layer=metrics)
    harness.CellRun(cell, 1, 0.2, True, "cpu", time.perf_counter(), spec).run()
for m in harness.load_benchmark()["per_layer"]:
    harness.load_reader(m["name"])
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""

REFERENCE_RUN = """
import json, sys, torch
from asrbench.reference import asr, compare
from asrbench.tests import tiny
from asrbench.yardstick import traffic, weights
cfg = tiny.tiny_config("branchformer_summarymixing")
w = weights.make_weights(asr.param_shapes(cfg), 1, "cpu")
stats = weights.make_norm_stats(80, 2, "cpu")
pool = traffic.make_pool(tiny.tiny_mix("librispeech_train"), 3, "cpu", vocab=50)
asr.ctc_log_probs(w, cfg, stats, pool[0].wav, pool[0].wav_lens)
g = torch.Generator(); g.manual_seed(4)
b = pool[0]
asr.Trainer(w, cfg).step([{"wav": b.wav, "wav_lens": b.wav_lens, "tokens": b.tokens,
                            "token_lens": b.token_lens}], [g])
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def _top_level(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _top_level(HARNESS_RUN)
    assert "summarymixing_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_system():
    names = _top_level(REFERENCE_RUN)
    assert not names & (FORBIDDEN | {"summarymixing_tpu_torch"})
