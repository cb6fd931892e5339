"""The port's runners of the recipes — the counterparts of the JAX
package's `recipes/train.py`, `train_lm.py`, `evaluate.py`, `serve.py`,
`transcribe.py` and `export_model.py`, with the same flags plus
`--device`, run as `python -m summarymixing_tpu_torch.recipes.<name>`."""
