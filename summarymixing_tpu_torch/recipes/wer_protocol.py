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
and the card's name and power limit as `nvidia-smi` gives them."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from summarymixing_tpu_torch.recipes import evaluate, train, train_lm
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECIPE = os.path.join(REPO, "recipes", "Synthetic", "hard_synthetic.yaml")
TRANSDUCER_RECIPE = os.path.join(REPO, "recipes", "Synthetic", "hard_synthetic_transducer.yaml")
SUMMARYDECODER_RECIPE = os.path.join(REPO, "recipes", "Synthetic",
                                     "hard_synthetic_summarydecoder.yaml")
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
    ap.add_argument("protocol", nargs="?", choices=("ctc", "transducer", "summarydecoder"),
                    default="ctc")
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
         "--hard", "--n", str(N_UTTERANCES), "--lm-text", str(LM_SENTENCES), "--seed", "0"],
        check=True, stdout=subprocess.DEVNULL))
    manifest = {s: os.path.join(corpus, f"manifest_{s}.csv") for s in ("train", "dev", "test")}
    recipe = {"ctc": RECIPE, "transducer": TRANSDUCER_RECIPE,
              "summarydecoder": SUMMARYDECODER_RECIPE}[args.protocol]
    res = stage("train", lambda: train.main([
        recipe, "--train-manifest", manifest["train"], "--valid-manifest", manifest["dev"],
        "--output", run, "--set", f"training.number_of_epochs={EPOCHS}",
        "--set", f"training.ckpt_interval_minutes={CKPT_INTERVAL_MINUTES}"] + device))
    ms = np.asarray(res["step_s"][1:]) * 1e3
    report["train"] = {"steps": res["steps"], "epochs": res["epochs"], "valid": res["valid"],
                       "step_ms_median": float(np.median(ms)), "step_ms_mean": float(ms.mean()),
                       "checkpoints_kept": CheckpointManager(
                           os.path.join(run, "save")).all_steps()}
    if args.protocol == "transducer":
        return finish(report, args, transducer_evaluations(report, stage, manifest, run, device))
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
