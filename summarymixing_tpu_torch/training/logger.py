"""Train logging — the port's copy of `summarymixing_tpu/training/logger.py`:
an append-only text log plus a jsonl stream per epoch or step, as
SpeechBrain's FileTrainLogger writes them (yaml:343-344: train_log.txt
lines like "epoch: 1, lr: 1.2e-4 - train loss: 3.2 - valid loss: 2.9,
valid WER: 12.3"), and the epoch counter. In a multi-process run
(`parallel/launch.py`) process p > 0 writes `<name>.p<p><ext>` for each
file, so every file has one writer, as the JAX logger does."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

from summarymixing_tpu_torch.parallel import launch


class FileTrainLogger:
    def __init__(self, save_file: str, jsonl_file: Optional[str] = None):
        p = launch.process_index()
        if p > 0:
            root, ext = os.path.splitext(save_file)
            save_file = f"{root}.p{p}{ext}"
            if jsonl_file is not None:
                jroot, jext = os.path.splitext(jsonl_file)
                jsonl_file = f"{jroot}.p{p}{jext}"
        self.save_file = save_file
        self.jsonl_file = jsonl_file or (
            os.path.splitext(save_file)[0] + ".jsonl"
        )
        os.makedirs(os.path.dirname(os.path.abspath(save_file)), exist_ok=True)

    @staticmethod
    def _fmt(stats: Dict) -> str:
        parts = []
        for k, v in stats.items():
            if isinstance(v, float):
                parts.append(f"{k}: {v:.4g}")
            else:
                parts.append(f"{k}: {v}")
        return ", ".join(parts)

    def log_stats(
        self,
        stats_meta: Dict,
        train_stats: Optional[Dict] = None,
        valid_stats: Optional[Dict] = None,
        test_stats: Optional[Dict] = None,
    ) -> None:
        sections = [self._fmt(stats_meta)]
        for name, st in (
            ("train", train_stats), ("valid", valid_stats), ("test", test_stats)
        ):
            if st:
                sections.append(self._fmt({f"{name} {k}": v for k, v in st.items()}))
        line = " - ".join(sections)
        with open(self.save_file, "a") as f:
            f.write(line + "\n")
        record = {"ts": time.time(), "meta": stats_meta}
        for name, st in (
            ("train", train_stats), ("valid", valid_stats), ("test", test_stats)
        ):
            if st:
                record[name] = {
                    k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in st.items()
                }
        with open(self.jsonl_file, "a") as f:
            f.write(json.dumps(record) + "\n")


class EpochCounter:
    """Iterable epoch counter (speechbrain EpochCounter, yaml:294)."""

    def __init__(self, limit: int, start: int = 0):
        self.limit = limit
        self.current = start

    def __iter__(self):
        while self.current < self.limit:
            self.current += 1
            yield self.current
