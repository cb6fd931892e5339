"""Build ahead of time what a run of the port builds at its first use — the
port of the JAX package's `recipes/warmup_cache.py`.

    python -m summarymixing_tpu_torch.recipes.warmup_cache

On the JAX side the per-machine artifact is the persistent XLA cache, one
compiled program per batch shape, and the runner trains one step per
bucket shape to fill it. On the port the per-machine artifacts are the
two builds a run otherwise makes on its first call: the CUDA kernels
(`ops/_build.build()`: `nvcc` on each `csrc/*.cu` into `build/kernels/`)
and the native batch loader (`data/native_loader.build()`: `g++` on
`native/dataloader.cpp` into `build/native/`). Both are keyed by a digest
of their sources and flags, so a later process loads them as built.

The runner takes no train step: what a step settles in PyTorch (the
caching allocator's pool, cuBLAS's choice of algorithm per shape) lives
in the process that ran it and ends with it, so a step here would leave
nothing a later run reads; a run pays for it on its own first step per
shape either way.

Prints, and returns, the seconds of each build (0 for one found built).
It needs the CUDA toolkit: without `nvcc` it raises, as a run would.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

from summarymixing_tpu_torch.data import native_loader
from summarymixing_tpu_torch.ops import _build


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    t0 = time.perf_counter()
    found = native_loader.library_path().exists()
    path = native_loader.build()
    summary = {"native_loader": {"seconds": 0.0 if found else time.perf_counter() - t0,
                                 "path": str(path)}}
    for name, r in _build.build().items():
        summary[f"kernel {name}"] = {"seconds": r["seconds"], "path": str(_build.library_path(name))}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
