"""Parallelism on `torch.distributed` — the port of `summarymixing_tpu/parallel/`:
the multi-process launch and data feeding (`launch`), the collectives on
device tensors (`comm`), the data-parallel mesh (`mesh`) and the
time-sharded encode and greedy decode (`sequence`). The submodules are
imported where they are used; this package imports none of them."""
