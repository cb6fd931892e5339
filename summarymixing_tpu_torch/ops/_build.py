"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
alone into `build/kernels/<name>-<digest>.so` at the repository root (a
directory that `.gitignore` lists), then loaded with `ctypes`. The digest
covers the source, the shared headers and the flags, so an edited source
is rebuilt and an unchanged one is reused. Nothing is built at import:
the first wrapper call on a CUDA tensor builds what it needs, and
`build()` builds several sources at once, one `nvcc` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("summary_mixing", "csgu", "relpos_attention")
OP_NAMESPACE = "summarymixing_torch"   # the kernels' registered ops: summarymixing_torch::<name>
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH or CUDA_HOME)")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, dict]:
    """Compile every named source that is not built yet, all `nvcc`
    processes started together. Returns, per source, the seconds its
    build took (0 when it was already built) and the `-Xptxas -v` report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    for name in names:
        so = library_path(name)
        log = so.with_suffix(".log")
        if so.exists():
            report[name] = {"seconds": 0.0, "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, so, log, time.perf_counter())
    for name, (proc, tmp, so, log, t0) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        log.write_text(out)
        os.replace(tmp, so)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    return report


def cached_weights(module, flatten):
    """`flatten(module)`, the kernel's weight tuple, made again only when a
    parameter of `module` is another tensor or was updated in place. Under
    `torch.export` (whose tensors hold no data) it is made on every call,
    so the casts become part of the exported graph."""
    if torch.compiler.is_compiling():
        return flatten(module)
    key = tuple((p.data_ptr(), p._version) for p in module.parameters())
    hit = module.__dict__.get("_kernel_weights")
    if hit is None or hit[0] != key:
        hit = module.__dict__["_kernel_weights"] = (key, flatten(module))
    return hit[1]


def drop_cached_weights(module) -> None:
    """Forget `cached_weights`' entries of `module` and its children: a
    module called with parameters swapped in from outside
    (`torch.func.functional_call`) must not keep them keyed by an address
    that a later tensor may take."""
    for mod in module.modules():
        mod.__dict__.pop("_kernel_weights", None)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(so))
    return lib
