"""Checkpointing and checkpoint averaging — the port of
`summarymixing_tpu/training/checkpoint.py` over `torch.save`/`torch.load`
(the JAX package writes with orbax).

A checkpoint is one dict of the train state (for example `params`, a
`state_dict`; `opt_state`; `norm_stats`; `step`; `epoch`), written one
file per key as `<directory>/<step>/<key>.pt`, in the step-numbered
layout of the JAX package's directories, so that an evaluation restore
reads the parameters and statistics and not the optimizer state. A save
goes to a temporary directory first and is renamed into place, so a
reader never sees half a checkpoint. The last `max_to_keep` steps are
kept. Loads use `weights_only=True`: a checkpoint holds tensors, numbers
and containers of them, nothing else.

    mgr = CheckpointManager("results/save", max_to_keep=10)
    mgr.save(step, {"params": model.state_dict(), "norm_stats": stats, "step": step})
    avg = average_checkpoints(mgr, {"params": None, "norm_stats": None}, num=10)
    model.load_state_dict(avg["params"])

`interval_minutes` gates saves in time, as the JAX manager's does (the
recipes' `ckpt_interval_minutes`): `should_save()` says whether that many
minutes have passed since the last save (or since the manager was made);
the caller then saves.

In a multi-process run (`parallel/launch.py`) every process calls `save`
at the same step; the coordinator alone writes, and every process waits
at a barrier until the checkpoint is in place, so a process that
restores next reads the whole of it. `should_save` then agrees across
the processes (each clock runs on its own) as the JAX manager's does:
on every `sync_every`-th call, once per step on every process, it is
true everywhere when the interval has passed on any process, and false
between those calls, so the host collective stays off the step loop.
Every process restores.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Any, Dict, List, Mapping, Optional

import torch

from summarymixing_tpu_torch.parallel import launch
from summarymixing_tpu_torch.utils.device import resolve_device

_EXT = ".pt"


class CheckpointManager:
    """Step-numbered checkpoints of a state dict in `directory`, the last
    `max_to_keep` kept, with an optional save interval in minutes."""

    def __init__(self, directory: str, max_to_keep: int = 10,
                 interval_minutes: Optional[float] = None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.interval_minutes = interval_minutes
        # the first interval counts from construction: a fresh or resumed
        # run does not save at its first step
        self._last_save = time.time()
        self._calls = 0
        self.sync_every = 20
        os.makedirs(self.directory, exist_ok=True)

    def should_save(self) -> bool:
        """True without an interval, else whether `interval_minutes` have
        passed since the last save; in a multi-process run, decided
        together on every `sync_every`-th call only (the module docstring)."""
        if self.interval_minutes is None:
            return True
        due = time.time() - self._last_save >= self.interval_minutes * 60
        if launch.process_count() == 1:
            return due
        self._calls += 1
        if self._calls % self.sync_every:
            return False
        return launch.any_process(due)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Mapping[str, Any]) -> None:
        """Write `state` as checkpoint `step` (replacing one of that step),
        then delete the oldest beyond `max_to_keep`: on the coordinator,
        the other processes waiting for it."""
        if step < 0:
            raise ValueError(f"checkpoint step must be non-negative, got {step}")
        if launch.is_coordinator():
            self._write(step, state)
        launch.barrier()
        self._last_save = time.time()

    def _write(self, step: int, state: Mapping[str, Any]) -> None:
        final = self._path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for key, value in state.items():
            torch.save(value, os.path.join(tmp, key + _EXT))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old))

    def all_steps(self) -> List[int]:
        """The steps on disk, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isdir(os.path.join(self.directory, name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Optional[Mapping[str, Any]] = None, step: Optional[int] = None,
                partial: bool = False, device=None) -> Optional[Dict[str, Any]]:
        """The latest (or the given) checkpoint's state with its tensors on
        `device` (the card unless told otherwise), or None when there is
        none. With `partial`, only the keys of `state_like` are read (for
        evaluation: the parameters and statistics, not the optimizer
        state); without it, the saved keys must be those of `state_like`
        when it is given."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._path(step)
        saved = sorted(name[:-len(_EXT)] for name in os.listdir(path) if name.endswith(_EXT))
        if state_like is not None and not partial and set(saved) != set(state_like):
            raise KeyError(f"checkpoint {step} holds {saved}, expected {sorted(state_like)}")
        keys = saved if state_like is None else list(state_like)
        where = resolve_device(device)
        return {k: torch.load(os.path.join(path, k + _EXT), map_location=where, weights_only=True)
                for k in keys}


def average_checkpoints(manager: CheckpointManager, state_like: Mapping[str, Any],
                        num: int = 10, device=None) -> Dict[str, Any]:
    """The mean of the `params` (a mapping of name to tensor) of the last
    `num` checkpoints, the recipes' `avg_checkpoints`: every tensor summed
    in float64, divided, cast to float32 and then to its own dtype, as the
    JAX package does. The rest of `state_like`'s keys come from the latest
    checkpoint, read with its parameters; the others read only `params`."""
    steps = manager.all_steps()[-num:]
    if not steps:
        raise ValueError("no checkpoints to average")
    acc = None
    for s in steps:
        keys = dict.fromkeys((list(state_like) if s == steps[-1] else []) + ["params"])
        state = manager.restore(keys, step=s, partial=True, device=device)
        if acc is None:
            acc = {k: v.to(torch.float64) for k, v in state["params"].items()}
        else:
            for k in acc:
                acc[k] += state["params"][k].to(torch.float64)
    state["params"] = {k: (acc[k] / len(steps)).to(torch.float32).to(v.dtype)
                       for k, v in state["params"].items()}
    return state
