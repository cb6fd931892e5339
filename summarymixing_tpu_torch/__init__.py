"""summarymixing_tpu_torch — the PyTorch/CUDA port of `summarymixing_tpu`.

The JAX package stays the reference. This package mirrors its module paths,
class names and parameter-tree names (so `utils.convert.load_jax_params`
is a plain tree walk) and runs on an NVIDIA H100: plain tensor code is
PyTorch, and the two Pallas TPU kernels of the JAX package are hand-written
CUDA kernels for `sm_90a` (`csrc/`, built at first use by `ops/_build.py`).

Ported so far, for the flagship Branchformer-SummaryMixing recipe: the
greedy-CTC decode path (Fbank, InputNormalization, the 2-D CNN frontend,
src projection + sine positions, Branchformer layers with a full-mode
SummaryMixing cell and a cgMLP branch, the CTC head and greedy decode) and
the training step (`training/trainer.py::ASRTrainer`: speed perturbation,
SpecAugment, the regularMHA attention decoder, dropout, CTC + KL-div,
AdamW with the Noam schedule). Parameters are float32; the layers compute
in bf16 for `precision: bf16`, as the flax modules do.

Conventions kept from the JAX package at public functions: `[B, T, C]`
sequences, float masks with 1 = valid, NHWC order where the CNN frontend
flattens. Entry points (`config.build_model`, `transcribe.batch_waveforms`,
`training.trainer.ASRTrainer` on the model's device) run on `cuda` unless
the caller passes `device="cpu"`; with no card they raise rather than fall
back.
"""
