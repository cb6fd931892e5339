"""Evaluation metrics: WER / CER (`ErrorRateStats`) and accuracy — the
port's own copy of `summarymixing_tpu/training/metrics.py` (host side:
decode outputs are strings or token lists; the edit distance is a plain
numpy DP). It mirrors SpeechBrain's ErrorRateStats (`split_tokens` for
CER) and AccuracyStats."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence,
                  return_ops: bool = False) -> dict:
    """Levenshtein alignment counts: {ins, del, sub, num_ref}; with
    return_ops also the alignment itself as [(op, ref_tok, hyp_tok)] in
    sentence order, op in {"=", "S", "I", "D"} (the per-utterance surface
    SpeechBrain's ErrorRateStats.write_stats prints)."""
    m, n = len(ref), len(hyp)
    dp = np.zeros((m + 1, n + 1), np.int32)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            dp[i, j] = min(dp[i - 1, j] + 1,       # deletion
                           dp[i, j - 1] + 1,       # insertion
                           dp[i - 1, j - 1] + cost)
    # backtrack for counts (and the alignment ops)
    i, j = m, n
    ins = dels = subs = 0
    ops: List = []
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (
            0 if ref[i - 1] == hyp[j - 1] else 1
        ):
            same = ref[i - 1] == hyp[j - 1]
            subs += int(not same)
            if return_ops:
                ops.append(("=" if same else "S", ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif j > 0 and dp[i, j] == dp[i, j - 1] + 1:
            ins += 1
            if return_ops:
                ops.append(("I", None, hyp[j - 1]))
            j -= 1
        else:
            dels += 1
            if return_ops:
                ops.append(("D", ref[i - 1], None))
            i -= 1
    out = {"ins": ins, "del": dels, "sub": subs, "num_ref": m}
    if return_ops:
        out["ops"] = ops[::-1]
    return out


@dataclass
class ErrorRateStats:
    """Accumulates WER (or CER with split_tokens) over utterances.

    With keep_details=True, every appended utterance's alignment is
    retained and write_stats() emits the per-utterance error report
    (ins/del/sub counts + aligned ref/hyp rows, worst-first) — the
    debugging surface of SpeechBrain's ErrorRateStats.write_stats
    (reference AISHELL yaml:18 cer_file)."""

    split_tokens: bool = False
    remove_spaces: bool = False
    keep_details: bool = False
    _counts: dict = field(default_factory=lambda: {
        "ins": 0, "del": 0, "sub": 0, "num_ref": 0, "num_sent": 0, "err_sent": 0,
    })
    _details: List[dict] = field(default_factory=list)

    def _prep(self, tokens):
        if isinstance(tokens, str):
            tokens = tokens.split()
        if self.split_tokens:
            joined = "".join(str(t) for t in tokens)
            if self.remove_spaces:
                joined = joined.replace(" ", "").replace("_", "").replace("▁", "")
            return list(joined)
        return list(tokens)

    def append(self, refs: List, hyps: List, ids: List | None = None):
        for k, (ref, hyp) in enumerate(zip(refs, hyps)):
            r, h = self._prep(ref), self._prep(hyp)
            d = edit_distance(r, h, return_ops=self.keep_details)
            for key in ("ins", "del", "sub", "num_ref"):
                self._counts[key] += d[key]
            self._counts["num_sent"] += 1
            errs = d["ins"] + d["del"] + d["sub"]
            self._counts["err_sent"] += int(errs > 0)
            if self.keep_details:
                self._details.append({
                    "id": (ids[k] if ids is not None
                           else self._counts["num_sent"] - 1),
                    "wer": 100.0 * errs / max(d["num_ref"], 1),
                    "errs": errs, "ops": d["ops"],
                    **{key: d[key] for key in ("ins", "del", "sub",
                                               "num_ref")},
                })

    def write_stats(self, path: str, id_map: dict | None = None) -> None:
        """Per-utterance error report, sorted worst-WER-first: a summary
        header, then one block per utterance with the %WER line and the
        aligned ref / op / hyp rows ('<eps>' marks gaps). Requires
        keep_details=True."""
        if not self.keep_details:
            raise ValueError("write_stats needs keep_details=True")
        s = self.summarize()
        lines = [
            "%WER {:.2f} [ {} / {}, {} ins, {} del, {} sub ]".format(
                s["WER"], s["insertions"] + s["deletions"]
                + s["substitutions"], s["num_ref_tokens"], s["insertions"],
                s["deletions"], s["substitutions"]),
            "%SER {:.2f} [ {} / {} ]".format(
                s["SER"], self._counts["err_sent"], s["num_sentences"]),
            "=" * 70,
        ]
        order = sorted(self._details, key=lambda d: (-d["wer"], str(d["id"])))
        for d in order:
            uid = id_map.get(d["id"], d["id"]) if id_map else d["id"]
            lines.append(
                "{}, %WER {:.2f} [ {} / {}, {} ins, {} del, {} sub ]".format(
                    uid, d["wer"], d["errs"], d["num_ref"], d["ins"],
                    d["del"], d["sub"]))
            ref_row, op_row, hyp_row = [], [], []
            for op, r, h in d["ops"]:
                r = "<eps>" if r is None else str(r)
                h = "<eps>" if h is None else str(h)
                w = max(len(r), len(h), 1)
                ref_row.append(r.ljust(w))
                op_row.append(op.center(w))
                hyp_row.append(h.ljust(w))
            lines.append(" ; ".join(ref_row))
            lines.append(" ; ".join(op_row))
            lines.append(" ; ".join(hyp_row))
            lines.append("-" * 70)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    def summarize(self) -> dict:
        c = self._counts
        errs = c["ins"] + c["del"] + c["sub"]
        wer = 100.0 * errs / max(c["num_ref"], 1)
        ser = 100.0 * c["err_sent"] / max(c["num_sent"], 1)
        return {
            "WER": wer, "SER": ser,
            "insertions": c["ins"], "deletions": c["del"],
            "substitutions": c["sub"], "num_ref_tokens": c["num_ref"],
            "num_sentences": c["num_sent"],
        }


@dataclass
class AccuracyStats:
    """Token-level teacher-forced accuracy (speechbrain AccuracyStats)."""

    correct: int = 0
    total: int = 0

    def append(self, log_probs: np.ndarray, targets: np.ndarray,
               lengths: np.ndarray | None = None):
        """log_probs [B, U, V]; targets [B, U]; lengths [B] absolute."""
        pred = np.asarray(log_probs).argmax(-1)
        targets = np.asarray(targets)
        if lengths is None:
            mask = np.ones_like(targets, bool)
        else:
            mask = np.arange(targets.shape[1])[None, :] < np.asarray(lengths)[:, None]
        self.correct += int(((pred == targets) & mask).sum())
        self.total += int(mask.sum())

    def summarize(self) -> float:
        return self.correct / max(self.total, 1)
