"""Greedy CTC decode in a closed loop (`transcribe.greedy_ctc_decode`): the
pool's batches one after another for the window, each timed from dispatch to
its token lists on the host; `correct` from a seeded sample of the window's
batches, the longest among them, against the reference's CTC
log-probabilities (`compare.decode_numbers`).

Its control is the system's own W8A8 path (`model.act_int8`); its fault, a
token altered where the answer is produced."""

from __future__ import annotations

import gc
import json
import statistics
import time
from typing import Dict

import numpy as np
import torch

from asrbench.harness import no_tf32
from asrbench.reference import compare
from asrbench.yardstick import counts, traffic
from asrbench.yardstick.weights import make_norm_stats, make_weights

TRACE_UNITS = 8
CONTROL = "int8"
CONTROL_OVERRIDES = {"model.act_int8": True}


def _fault_token():
    from summarymixing_tpu_torch import transcribe
    saved = transcribe.greedy_ctc_decode

    def altered(*args, **kwargs):
        hyps, out = saved(*args, **kwargs)
        hyps[0] = hyps[0][1:] if hyps[0] else [3]
        return hyps, out

    transcribe.greedy_ctc_decode = altered
    return lambda: setattr(transcribe, "greedy_ctc_decode", saved)


FAULTS = {"token": _fault_token}
FAULT_NUMBERS = {"token": "hyp_rows_wrong"}


def run(cell, system, readers) -> Dict:
    from summarymixing_tpu_torch.recipes.common import kernel_counts
    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    model, fbank = system.model, system.fbank
    m, f, mix = cell.cfg["model"], cell.cfg["features"], cell.mix
    stats = make_norm_stats(f["n_mels"], cell.seeds["stats"], cell.device)
    pool = traffic.make_pool(mix, cell.seeds["data"], cell.device)
    for b in sorted(pool, key=lambda b: -b.wav.numel()):
        greedy_ctc_decode(model, fbank, stats, b.wav, b.wav_lens)
    cell.sync()
    counts_before = kernel_counts()
    rng = np.random.default_rng([cell.seed, 11])
    longest = max(range(len(pool)), key=lambda i: pool[i].wav.numel())
    sample = {longest} | set(rng.choice(len(pool), mix["check_batches"] - 1,
                                        replace=False).tolist())
    order = traffic.cycle_order(len(pool), cell.seed, 10000)
    setup_s = time.perf_counter() - cell.t0
    kept, lat, audio, flops, done = {}, [], 0.0, 0.0, 0
    gc.collect()
    gc.disable()
    start = time.perf_counter()
    while True:
        i = order[done]
        b = pool[i]
        t1 = time.perf_counter()
        hyps, res = greedy_ctc_decode(model, fbank, stats, b.wav, b.wav_lens)
        t2 = time.perf_counter()
        lat.append(t2 - t1)
        audio += b.audio_s
        done += 1
        if i in sample and i not in kept:
            kept[i] = {"hyps": hyps, "lp": res["ctc_log_probs"], "lens": res["enc_lengths"]}
        if t2 - start >= cell.seconds:
            break
    window_s = t2 - start
    gc.enable()
    for i in order[:done]:
        flops += counts.decode_batch_flops(m, f, pool[i].wav_lens.tolist())
    kc = kernel_counts(counts_before)
    cell.notes.append(f"route: {json.dumps(kc)} over {done} batches")
    peak = cell.peak_bytes()
    per_layer, trace = {}, None
    if readers:
        per_layer, trace = cell._traced(model, readers, window_s, flops, done, lambda j: (
            greedy_ctc_decode(model, fbank, stats, pool[order[j]].wav,
                              pool[order[j]].wav_lens)))
    del model
    gc.collect()
    numbers = check(cell, pool, kept)
    metrics = {"decode_audio_s_per_s": (audio / window_s, "audio-s/s"),
               "decode_p95_ms": (1000.0 * statistics.quantiles(lat, n=20)[-1]
                                 if len(lat) >= 2 else 1000.0 * lat[0], "ms"),
               "setup_s": (setup_s, "s")}
    return cell._result(metrics, per_layer, numbers, done, 0, peak, trace)


def check(cell, pool, kept) -> Dict[str, float]:
    """The kept batches' answers against the reference's log-probabilities
    over the same waveforms, weights and statistics, in blocks of rows."""
    ref = cell.ref
    w = make_weights(ref.param_shapes(cell.cfg), cell.seeds["weights"], cell.device)
    rstats = make_norm_stats(cell.cfg["features"]["n_mels"], cell.seeds["stats"], cell.device)
    rows = []
    block = cell.mix.get("check_rows", 16)
    with no_tf32():
        for i, k in sorted(kept.items()):
            b = pool[i]
            lps, lens = [], []
            for s in range(0, b.wav.shape[0], block):
                lp, ln = ref.ctc_log_probs(w, cell.cfg, rstats, b.wav[s:s + block],
                                           b.wav_lens[s:s + block])
                lps.append(lp)
                lens.append(ln)
            rows.append(dict(k, ref_lp=torch.cat(lps), ref_lens=torch.cat(lens)))
    if not rows:
        raise RuntimeError("no sampled batch completed in the window: nothing to compare")
    return compare.decode_numbers(rows)
