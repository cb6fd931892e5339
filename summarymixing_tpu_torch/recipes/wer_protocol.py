"""The hard-synthetic WER protocols of `benchmarks/RESULTS.md`, run end to
end through the port's runners, on the card unless `--device` says
otherwise: `ctc` (the default, `:555-563`), `transducer` (`:575-597`) and
`summarydecoder` (`:602-627`).

    python -m summarymixing_tpu_torch.recipes.wer_protocol WORK_DIR \\
        [ctc | transducer | summarydecoder] [--report report.json] [--device cpu]

1. `recipes/make_synthetic_corpus.py WORK_DIR/corpus --hard --n 400
   --lm-text 20000 --seed 0` (a subprocess: 320/40/40 utterances and
   20,000 text-only sentences);
2. `recipes.train` on `recipes/Synthetic/hard_synthetic.yaml` for the
   protocol's 150 epochs (of 11 steps each) with a checkpoint every
   `CKPT_INTERVAL_MINUTES` of wall time (the recipe's 999 would keep two).
   Which checkpoints the evaluations average therefore follows the host's
   speed: two runs of the protocol may average different steps;
3. `recipes.train_lm` on the text for 5 epochs;
4. `recipes.evaluate` on dev and test: greedy, `--beam` (beam 10) and
   `--beam --lm-ckpt` at LM weight 0.2 (the protocol's dev-selected
   weight), each on the mean of the last 10 checkpoints.

`summarydecoder`: steps 1-4 on `recipes/Synthetic/hard_synthetic_summarydecoder.yaml`
(the paper's Summary Decoder in place of the MHA decoder, everything else
the same); the report carries beside its WERs the JAX package's on the
CPU from `benchmarks/RESULTS.md:616-618` (`JAX_SUMMARYDECODER_WER`).

`transducer`: the same corpus; `recipes.train` on
`recipes/Synthetic/hard_synthetic_transducer.yaml` for 150 epochs with
the same checkpoint interval; then `recipes.evaluate` on dev and test on
the mean of the last 10 checkpoints: greedy, `--beam` (beam 10),
`--streaming-full` at chunks of 8 encoder frames with 4 of left context
and at 4 with 2, and `--streaming` at 8 with 4; and in bf16 (`--set
training.precision=bf16`) `--streaming` and `--streaming-full` at 8 with
4. The report counts, per split and precision, the utterances on which
`--streaming` and `--streaming-full` give the same words.

Prints, and writes to `--report` as JSON, each stage's wall seconds, the
training step times, the checkpoints averaged, every evaluation summary,
and the card's name and power limit as `nvidia-smi` gives them.

`flagship`: the same corpus at `FLAGSHIP_UTTERANCES` (3,200/400/400: on
the 400-utterance corpus the 119M-parameter model memorised its 320
training utterances, a train loss of 0.47 against 2.5 on dev after 100
epochs, and stayed at a greedy dev WER of 56.83); `recipes.train` on
`recipes/LibriSpeech/branchformer_summarymixing.yaml` as written (18
layers, d512, bf16, both kernels, its decoder and a unigram tokenizer
trained on the corpus) for `FLAGSHIP_EPOCHS`, with `FLAGSHIP_SETTINGS`:
the corpus holds few batches of the recipe's 500 s in 200 buckets (the
batches are 60 s in 2 buckets), its 30,000 warm-up steps are longer
than the whole run (400 here), and a checkpoint every 15 s; then greedy `recipes.evaluate` on dev and test on the
mean of the last 10 checkpoints; then `beam_agreement` on dev: the
recipe's validation beam (10, temperature 1, no LM) with the kernels and
again with both swapped for their plain versions (`ops/plain.py`), row
by row: the best hypotheses, the margin between the two best final
scores of each path, and the max |delta log-prob| between the two paths'
CTC outputs over the row's frames. A row whose hypotheses differ with a
margin above that delta in either path is a disagreement a near-tie does
not explain (`beam_agreement`'s `unexplained`)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from summarymixing_tpu_torch.recipes import common, evaluate, train, train_lm
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECIPE = os.path.join(REPO, "recipes", "Synthetic", "hard_synthetic.yaml")
TRANSDUCER_RECIPE = os.path.join(REPO, "recipes", "Synthetic", "hard_synthetic_transducer.yaml")
SUMMARYDECODER_RECIPE = os.path.join(REPO, "recipes", "Synthetic",
                                     "hard_synthetic_summarydecoder.yaml")
FLAGSHIP_RECIPE = os.path.join(REPO, "recipes", "LibriSpeech", "branchformer_summarymixing.yaml")
# the flagship: 3,200 training utterances of 1.5-5 s make about 140 batches
# of 60 s per epoch; the peak learning rate after 400 steps; a checkpoint
# (1.4 GB with the Adam moments) every 15 s, so that the last AVG span
# about the last quarter of the run
FLAGSHIP_UTTERANCES, FLAGSHIP_EPOCHS = 4000, 20
FLAGSHIP_SETTINGS = ("training.num_buckets=2", "training.max_batch_length=60.0",
                     "training.n_warmup_steps=400", "training.ckpt_interval_minutes=0.25")
FLAGSHIP_OVERRIDES = [a for kv in FLAGSHIP_SETTINGS for a in ("--set", kv)]
# the JAX package's Summary Decoder dev/test WER % on the CPU, the round-3
# protocol's table (benchmarks/RESULTS.md:616-618; 40 + 40 utterances)
JAX_SUMMARYDECODER_WER = {"greedy": (1.32, 1.41), "beam": (2.64, 1.88),
                          "beam+lm": (1.32, 1.88)}
# the protocol of benchmarks/RESULTS.md:555-563
N_UTTERANCES, LM_SENTENCES, EPOCHS, LM_EPOCHS, AVG, LM_WEIGHT = 400, 20000, 150, 5, 10, 0.2
# wall-clock minutes between interval checkpoints: 6 s, so that the last
# AVG checkpoints of a run of a few minutes span its last few hundred steps
CKPT_INTERVAL_MINUTES = 0.1
# the transducer protocol's decodes: name -> evaluate flags
STREAM_8_4 = ["--chunk-size", "8", "--left-context", "4"]
TRANSDUCER_DECODES = {
    "greedy": [], "beam": ["--beam"],
    "streaming-full 8/4": ["--streaming-full"] + STREAM_8_4,
    "streaming-full 4/2": ["--streaming-full", "--chunk-size", "4", "--left-context", "2"],
    "streaming 8/4": ["--streaming"] + STREAM_8_4,
    "bf16 streaming 8/4": ["--streaming"] + STREAM_8_4 + ["--set", "training.precision=bf16"],
    "bf16 streaming-full 8/4": ["--streaming-full"] + STREAM_8_4
    + ["--set", "training.precision=bf16"],
}


def card() -> Optional[str]:
    """`name, power limit` of the first card from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except FileNotFoundError:
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("work_dir")
    ap.add_argument("protocol", nargs="?",
                    choices=("ctc", "transducer", "summarydecoder", "flagship"), default="ctc")
    ap.add_argument("--report", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    corpus = os.path.join(args.work_dir, "corpus")
    run, lm_run = os.path.join(args.work_dir, "run"), os.path.join(args.work_dir, "lm")
    report: Dict = {"card": card(), "args": vars(args), "wall_s": {}}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        report["wall_s"][name] = time.perf_counter() - t0
        print(f"[protocol] {name}: {report['wall_s'][name]:.1f} s", flush=True)
        return out

    stage("corpus", lambda: subprocess.run(
        [sys.executable, os.path.join(REPO, "recipes", "make_synthetic_corpus.py"), corpus,
         "--hard", "--n", str(FLAGSHIP_UTTERANCES if args.protocol == "flagship" else N_UTTERANCES),
         "--lm-text", str(LM_SENTENCES), "--seed", "0"],
        check=True, stdout=subprocess.DEVNULL))
    manifest = {s: os.path.join(corpus, f"manifest_{s}.csv") for s in ("train", "dev", "test")}
    recipe = {"ctc": RECIPE, "transducer": TRANSDUCER_RECIPE,
              "summarydecoder": SUMMARYDECODER_RECIPE,
              "flagship": FLAGSHIP_RECIPE}[args.protocol]
    flagship = args.protocol == "flagship"
    overrides = FLAGSHIP_OVERRIDES if flagship else []
    res = stage("train", lambda: train.main([
        recipe, "--train-manifest", manifest["train"], "--valid-manifest", manifest["dev"],
        "--output", run, "--set",
        f"training.number_of_epochs={FLAGSHIP_EPOCHS if flagship else EPOCHS}",
        "--set", f"training.ckpt_interval_minutes={CKPT_INTERVAL_MINUTES}"]
        + overrides + device))
    ms = np.asarray(res["step_s"][1:]) * 1e3
    report["train"] = {"steps": res["steps"], "epochs": res["epochs"], "valid": res["valid"],
                       "step_ms_median": float(np.median(ms)), "step_ms_mean": float(ms.mean()),
                       "checkpoints_kept": CheckpointManager(
                           os.path.join(run, "save")).all_steps()}
    if args.protocol == "transducer":
        return finish(report, args, transducer_evaluations(report, stage, manifest, run, device))
    if flagship:
        report["eval"] = {}
        for split in ("dev", "test"):
            out = stage(f"evaluate greedy {split}", lambda: evaluate.main([
                recipe, "--test-manifest", manifest[split], "--ckpt", os.path.join(run, "save"),
                "--avg", str(AVG)] + overrides + device))
            out.pop("hyps")
            report["eval"][f"greedy {split}"] = out
        report["beam_agreement"] = stage("beam agreement dev", lambda: beam_agreement(
            recipe, FLAGSHIP_SETTINGS, run, manifest["dev"], args.device))
        return finish(report, args, ("greedy",))
    lm = stage("train_lm", lambda: train_lm.main([
        recipe, "--text", os.path.join(corpus, "lm_text.txt"), "--tokenizer-dir", run,
        "--output", lm_run, "--epochs", str(LM_EPOCHS)] + device))
    report["train_lm"] = {"steps": lm["steps"], "loss": lm["loss"],
                          "step_ms_median": float(np.median(np.asarray(lm["step_s"]) * 1e3))}
    report["eval"] = {}
    for split in ("dev", "test"):
        for decode, extra in (("greedy", []), ("beam", ["--beam"]),
                              ("beam+lm", ["--beam", "--lm-ckpt", lm_run,
                                           "--set", f"decoding.lm_weight={LM_WEIGHT}"])):
            out = stage(f"evaluate {decode} {split}", lambda: evaluate.main([
                recipe, "--test-manifest", manifest[split], "--ckpt", os.path.join(run, "save"),
                "--avg", str(AVG)] + extra + device))
            out.pop("hyps")
            report["eval"][f"{decode} {split}"] = out
    if args.protocol == "summarydecoder":
        report["jax_cpu_wer"] = JAX_SUMMARYDECODER_WER
        print(f"[protocol] the JAX package's Summary Decoder WER dev/test on the CPU "
              f"(benchmarks/RESULTS.md:616-618): {JAX_SUMMARYDECODER_WER}", flush=True)
    return finish(report, args, ("greedy", "beam", "beam+lm"))


def transducer_evaluations(report: Dict, stage, manifest: Dict, run: str, device) -> tuple:
    """The transducer protocol's decodes on dev and test, and the agreement
    of `--streaming` with `--streaming-full` at 8/4, utterance by
    utterance, in float32 and in bf16."""
    report["eval"], report["streaming_agreement"] = {}, {}
    for split in ("dev", "test"):
        hyps = {}
        for decode, extra in TRANSDUCER_DECODES.items():
            out = stage(f"evaluate {decode} {split}", lambda: evaluate.main([
                TRANSDUCER_RECIPE, "--test-manifest", manifest[split], "--ckpt",
                os.path.join(run, "save"), "--avg", str(AVG)] + extra + device))
            hyps[decode] = out.pop("hyps")
            report["eval"][f"{decode} {split}"] = out
        for prefix in ("", "bf16 "):
            a, b = hyps[prefix + "streaming 8/4"], hyps[prefix + "streaming-full 8/4"]
            same = sum(a[u] == b[u] for u in a)
            report["streaming_agreement"][f"{prefix or 'float32 '}{split}"] = [same, len(a)]
    print(f"[protocol] --streaming vs --streaming-full at 8/4, utterances with the same words: "
          f"{report['streaming_agreement']}", flush=True)
    return tuple(TRANSDUCER_DECODES)


def margin(nbest: Sequence) -> float:
    """The difference of the two best final scores of a score-sorted n-best."""
    return nbest[0][1] - nbest[1][1] if len(nbest) > 1 else float("inf")


def beam_agreement(recipe: str, settings: Sequence[str], run: str, manifest: str,
                   device: Optional[str] = None) -> Dict:
    """The run's averaged checkpoint (the last `AVG`) beam-searched over
    `manifest` (the recipe with `settings`, `KEY=VALUE` each) through
    `evaluate.evaluate_beam` at the recipe's validation
    beam (`valid_beam_size`, temperature 1, no LM, the n-best of 2), with
    the kernels and again inside `plain_kernels()`, on the same batches.
    Returns `rows` (one per utterance: `same`, the best hypotheses' token
    ids of each path, `margin_kernels`/`margin_plain`, the two best final
    scores' difference, and `max_dlogp`, the max |kernel - plain| CTC
    log-prob over the row's frames), `agree` (rows with the same best
    hypothesis), `n`, and `unexplained`: the differing rows whose margin
    is above `max_dlogp` in either path."""
    import contextlib

    import torch

    from summarymixing_tpu_torch.config import load_recipe
    from summarymixing_tpu_torch.data.dataio import read_manifest_csv
    from summarymixing_tpu_torch.evaluate import evaluate_beam
    from summarymixing_tpu_torch.ops.plain import plain_kernels
    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode
    from summarymixing_tpu_torch.utils.device import resolve_device

    cfg = load_recipe(recipe, overrides=common.parse_overrides(settings))
    dev = resolve_device(device)
    utts = read_manifest_csv(manifest)
    tokenizer = evaluate.resolve_tokenizer(cfg, run)
    model, fbank, _, stats = common.restore_inference(cfg, os.path.join(run, "save"), AVG, dev)
    lmax = common.decode_length(cfg, utts, fbank)
    rows: Dict[int, Dict] = {}
    for batch, idx in common.batches(utts, tokenizer, cfg, False, 0, dev):
        wav, lens = batch["wav"], batch["wav_lens"]
        got = {}
        for path, swap in (("kernels", contextlib.nullcontext), ("plain", plain_kernels)):
            with swap(), torch.inference_mode():
                _, out = greedy_ctc_decode(model, fbank, stats, wav, lens)
                beam = evaluate_beam(model, fbank, stats, [(idx, wav, lens)], cfg,
                                     beam_size=cfg.decoding.valid_beam_size, temperature=1.0,
                                     max_length=lmax, nbest=2)
            got[path] = (out["ctc_log_probs"].float(), out["enc_lengths"], beam["nbest"])
        (lp_k, enc_len, nb_k), (lp_p, _, nb_p) = got["kernels"], got["plain"]
        dlogp = (lp_k - lp_p).abs().amax(-1)
        for i, u in enumerate(int(u) for u in idx):
            if u in rows:
                continue   # an evaluation batch repeats utterances to fill up
            rows[u] = {"id": utts[u].utt_id, "same": nb_k[u][0][0] == nb_p[u][0][0],
                       "kernels": nb_k[u][0][0], "plain": nb_p[u][0][0],
                       "margin_kernels": margin(nb_k[u]), "margin_plain": margin(nb_p[u]),
                       "max_dlogp": float(dlogp[i, :int(enc_len[i])].max())}
    ordered = [rows[u] for u in sorted(rows)]
    unexplained = [r["id"] for r in ordered if not r["same"]
                   and max(r["margin_kernels"], r["margin_plain"]) > r["max_dlogp"]]
    result = {"n": len(ordered), "agree": sum(r["same"] for r in ordered),
              "beam": cfg.decoding.valid_beam_size, "unexplained": unexplained, "rows": ordered}
    for r in ordered:
        print(f"[agreement] {r['id']}: {'same' if r['same'] else 'DIFFERENT'}; margin "
              f"kernels {r['margin_kernels']:.4f} plain {r['margin_plain']:.4f}; max |dlogp| "
              f"{r['max_dlogp']:.4f}", flush=True)
    print(f"[agreement] {result['agree']}/{result['n']} rows the same best hypothesis at beam "
          f"{result['beam']}; differing rows with a margin above |dlogp| in either path: "
          f"{unexplained}", flush=True)
    return result


def finish(report: Dict, args, decodes: Sequence[str]) -> Dict:
    print("[protocol] WER dev/test: " + "; ".join(
        f"{d} {report['eval'][d + ' dev']['WER']:.2f}/{report['eval'][d + ' test']['WER']:.2f}"
        for d in decodes) + f"; card {report['card']}", flush=True)
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
