"""The traffic generator, the lookup of every cell's files by name (its
configuration, mix, limits, entry module, reference module and readers), and
the runner's refusal without a card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from asrbench import harness
from asrbench.tests import checks
from asrbench.tests.tiny import tiny_mix
from asrbench.yardstick import traffic

ROOT = Path(__file__).resolve().parents[2]


BATCHED_MIXES = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json")
                       if "batching" in json.loads(p.read_text()))


@pytest.mark.parametrize("mix", BATCHED_MIXES)
def test_batches_respect_the_mix(mix):
    """Every mix with `batching`, and its small form."""
    for m in (traffic.load_mix(mix), tiny_mix(mix)):
        lengths = traffic.utterance_lengths(m)
        assert lengths.min() >= m["lengths"]["min_s"] and lengths.max() <= m["lengths"]["max_s"]
        batches = traffic.dynamic_batches(lengths, m["batching"]["max_batch_s"],
                                          m["batching"]["max_rows"])
        assert sorted(i for b in batches for i in b) == list(range(len(lengths)))
        for b in batches:
            assert len(b) <= m["batching"]["max_rows"]
            assert len(b) * lengths[b].max() <= m["batching"]["max_batch_s"] + 1e-9


def test_train_mix_limits_and_mean_length():
    m = traffic.load_mix("librispeech_train")
    assert m["batching"] == {"max_batch_s": 500.0, "max_rows": 128}
    assert traffic.load_mix("librispeech_offline")["batching"] == {"max_batch_s": 1600.0,
                                                                   "max_rows": 128}
    assert abs(traffic.utterance_lengths(m).mean() - 12.3) < 0.6
    dp4 = traffic.load_mix("librispeech_train_dp4")
    assert {k: v for k, v in dp4.items() if k != "why"} == {k: v for k, v in m.items() if k != "why"}


def test_pool_is_deterministic_per_seed():
    m = dict(traffic.load_mix("librispeech_train"), utterances=12)
    a = traffic.make_pool(m, 2**31 + 5, "cpu", vocab=50)
    b = traffic.make_pool(m, 2**31 + 5, "cpu", vocab=50)
    c = traffic.make_pool(m, 2**31 + 6, "cpu", vocab=50)
    assert all(torch.equal(x.wav, y.wav) and torch.equal(x.tokens, y.tokens) for x, y in zip(a, b))
    assert [x.wav.shape for x in a] == [x.wav.shape for x in c]
    assert not torch.equal(a[0].wav, c[0].wav)
    for x in a:
        assert int(x.tokens.min()) >= 0 and int(x.tokens.max()) < 50
        assert torch.all((x.tokens[:, 0] >= 3))
    assert traffic.cycle_order(5, 9, 2) == traffic.cycle_order(5, 9, 2)
    assert sorted(traffic.cycle_order(5, 9, 1)) == list(range(5))


def test_every_cell_loads_by_name():
    checks.cells_load_by_name(harness.load_benchmark())


def test_every_recipe_matches_its_configuration_file():
    checks.recipes_match(harness.load_benchmark())


def test_run_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "asrbench.run", "--workload", "bf_sm.decode",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_run_outside_a_checkout_of_the_system_exits_nonzero(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "asrbench", tmp_path / "asrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "asrbench.run", "--workload", "bf_sm.decode",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_param_count_of_the_flagship():
    from asrbench.reference import asr as ref
    cfg = harness.load_config("branchformer_summarymixing")
    total = sum(int(np.prod(s)) for _, s in ref.param_shapes(cfg))
    enc = sum(int(np.prod(s)) for n, s in ref.param_shapes(cfg)
              if not n.startswith(("asr.decoder", "asr.tgt_emb", "seq_lin")))
    assert (enc, total) == (88_954_088, 119_304_304)
