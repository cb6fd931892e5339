"""Run one cell of the benchmark once and print its result line.

    python3 -m asrbench.run --workload bf_sm.decode --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name (`asrbench/harness.py`). The run needs as many
CUDA cards as the cell's `chips` and exits with code 2 without a result when
they are not there. A cell on several chips starts one process per card
itself (over NCCL); only the first prints the result. The result is the last
line of standard output; the numbers that decide `correct`, each with its
limit, are the last lines of standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "asrbench_cache"


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reap(children, wait: bool):
    """Wait for the other processes of the cell (or end them, when this one
    failed and they may wait on it in a collective); their exit codes."""
    codes = []
    for c in children:
        if wait:
            try:
                c.wait(timeout=300)
            except subprocess.TimeoutExpired:
                pass
        if c.poll() is None:
            c.kill()
        codes.append(c.wait())
    return codes


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _print_checks(result) -> None:
    for name, c in result.get("checks", {}).items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()


def main(argv=None) -> int:
    args = _args(argv)
    _caches()
    import torch

    if not (ROOT / "summarymixing_tpu_torch").is_dir():
        print("the system under test (summarymixing_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    from asrbench import harness

    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    chips = spec["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); {n} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    children = []
    if chips > 1 and "SMT_PROCESS_ID" not in os.environ:
        env = dict(os.environ, SMT_COORDINATOR=f"127.0.0.1:{_free_port()}",
                   SMT_NUM_PROCESSES=str(chips))
        for r in range(1, chips):
            children.append(subprocess.Popen(
                [sys.executable, "-m", "asrbench.run", *sys.argv[1:]],
                env=dict(env, SMT_PROCESS_ID=str(r)), cwd=str(ROOT), stdout=sys.stderr))
        os.environ.update(env, SMT_PROCESS_ID="0")
    finished = False
    try:
        from summarymixing_tpu_torch.parallel import launch

        launch.initialize(device="cuda")
        device = torch.device("cuda", torch.cuda.current_device())
        run = harness.CellRun(args.workload, args.seed, args.seconds, bool(args.trace), device,
                              T0, spec)
        result = run.run()
        # every process leaves the group here, together: a process waiting in
        # NCCL's teardown for one that waits for it would never end
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        finished = True
    finally:
        codes = _reap(children, finished)
    if os.environ.get("SMT_PROCESS_ID", "0") != "0":
        return 0
    if any(codes):
        print(f"a process of the cell exited with {codes}", file=sys.stderr)
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 1
    for note in run.notes:
        print(note, file=sys.stderr)
    checks = result.pop("checks", {})
    numbers = result.pop("numbers", {})
    print(f"numbers {json.dumps(numbers)}", file=sys.stderr)
    result["checks"] = checks
    _print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
