"""Wrappers of the hand-written CUDA kernels in ``ksim_tpu_torch/csrc``.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for tensors on a CUDA device; it counts its kernel
launches in ``<wrapper>.launches``."""
