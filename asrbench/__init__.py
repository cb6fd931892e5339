"""The benchmark of `summarymixing_tpu_torch` on NVIDIA H100 cards: one
command runs one cell (`python3 -m asrbench.run`); cells, configurations,
traffic mixes, limits and per-layer metrics are files found by name."""
