"""Data pipeline of the port: manifests, audio, bucketed batches and
tokenizers (copies of `summarymixing_tpu/data/`)."""
