"""ksim_tpu_torch — the scheduler simulator's device path in PyTorch and CUDA.

A second implementation of ``ksim_tpu``'s scheduling engine beside it:
the host-side featurizer is a copy of ``ksim_tpu/state`` (kept equal by
tests/test_torch_featurizer.py), the plugin chain is written in PyTorch,
and on an NVIDIA H100 the sequential-commit scan and the batch
evaluation run in hand-written CUDA kernels (``csrc/``, wrapped in
``kernels/``).  Nothing here imports ``jax`` or ``ksim_tpu``.

Layout (mirrors ``ksim_tpu``):
    state/     featurizer and encoders (host, numpy)
    plugins/   per-plugin filter/score/normalize on torch tensors
    engine/    Engine (schedule, evaluate_batch), profiles, annotations
    kernels/   kernel wrappers with their plain PyTorch versions
    csrc/      CUDA C++ sources, built with nvcc at first use
"""

__version__ = "0.1.0"
