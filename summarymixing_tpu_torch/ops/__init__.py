"""Ops of the port: plain PyTorch modules and the CUDA kernels' wrappers."""
