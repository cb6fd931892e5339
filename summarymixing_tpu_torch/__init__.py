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
AdamW with the Noam schedule), checkpointing with checkpoint averaging
(`training/checkpoint.py`), and the test-time beam evaluation
(`evaluate.py::evaluate_beam`: the KV-cached attention decoder, the
KV-cached Transformer LM of `models/lm.py` and the joint CTC/attention
beam search of `decoding/s2s_beam.py` with `decoding/ctc_prefix.py`).
For the streaming Conformer-SummaryMixing transducer recipes: the
Conformer encoder with the fast-mode cell (`models/conformer.py`), the
transducer (`models/transducer.py`) and its greedy decode, offline
(`transcribe.transducer_greedy_transcribe`), by encoder chunks
(`evaluate.streaming_decode`) and from raw audio (`streaming.py`); its
training (`training/transducer_trainer.py`: the RNN-T loss of
`losses/transducer.py`, Dynamic Chunk Training, the CTC aux, gradient
accumulation and the warm-up + exponential-decay schedule of
`training/optim.py`) and its test stage (the batched beam search with
RNNLM fusion of `decoding/transducer_search.py` and `models/lm.py`); no
hand-written kernel lies on those paths, as no Pallas kernel does in the
JAX package. The recipes' run loop (`recipes/`: the `train`, `train_lm`
and `evaluate` runners over `data/`'s manifests, bucketed batches and
tokenizers, recipes read by `config/yaml_lite.py`). Serving and shipping
a trained run: `serving.py` (the dynamic batcher and the streaming session
server), the `serve`, `transcribe` and `export_model` runners,
`utils/export.py` (`torch.export` artifacts, the kernels as registered
`torch.library` ops) and FLAC input (`data/flac.py`). Several devices
(`parallel/`): the multi-process launch, data parallelism in both
trainers and the time-sharded greedy CTC decode (`evaluate
--seq-parallel`), on `torch.distributed`. Parameters are
float32; the layers compute in bf16 for `precision: bf16`, as the flax
modules do. On the card a configuration a kernel does not take runs the
plain PyTorch path, counted in the wrapper's `plain_calls`.

Conventions kept from the JAX package at public functions: `[B, T, C]`
sequences, float masks with 1 = valid, NHWC order where the CNN frontend
flattens. Entry points (`config.build_model`, `config.build_lm`,
`transcribe.batch_waveforms`, the checkpoint restores, and on the model's
device `training.trainer.ASRTrainer`,
`training.transducer_trainer.TransducerTrainer`, `evaluate.evaluate_beam`,
`evaluate.streaming_decode` and `streaming.make_streaming_infer_fns`) run
on `cuda` unless the caller passes `device="cpu"`; with no card they raise
rather than fall back.
"""
