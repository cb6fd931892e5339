"""Hygiene of the PyTorch/CUDA port: it imports neither JAX nor the JAX
package, its entry points refuse to run without a card unless asked for
the CPU, and its config schema is the JAX package's."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import schema as jschema
from summarymixing_tpu_torch.config import schema as tschema
from summarymixing_tpu_torch.config import build_model
from summarymixing_tpu_torch.transcribe import batch_waveforms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import summarymixing_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "summarymixing_tpu")
             or m.startswith(("jax.", "flax.", "summarymixing_tpu.")))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tschema.RecipeConfig(model=tschema.ModelConfig(num_decoder_layers=0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(batch_waveforms([torch.zeros(10).numpy()], 1, 8))
    _, wav, _ = next(batch_waveforms([torch.zeros(10).numpy()], 1, 8, device="cpu"))
    assert wav.device.type == "cpu"


def test_config_schema_matches_jax_package():
    classes = [c for c in vars(jschema).values()
               if dataclasses.is_dataclass(c) and c.__module__ == jschema.__name__]
    assert len(classes) >= 8
    for jcls in classes:
        tcls = getattr(tschema, jcls.__name__)
        jf = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(jcls)]
        tf = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(tcls)]
        assert [f[:2] for f in tf] == [f[:2] for f in jf], jcls.__name__
        for (name, _, jfac), (_, _, tfac) in zip(jf, tf):
            if jfac is not dataclasses.MISSING:
                assert tfac().__class__.__name__ == jfac().__class__.__name__, name
