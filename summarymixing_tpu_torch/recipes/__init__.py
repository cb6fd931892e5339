"""The port's runners of the recipes — the counterparts of the JAX
package's `recipes/train.py`, `recipes/train_lm.py` and
`recipes/evaluate.py`, with the same flags, run as
`python -m summarymixing_tpu_torch.recipes.<name>`."""
