"""materialize_tpu_torch: the PyTorch/CUDA port of materialize_tpu.

A second package beside the JAX one, which stays as the reference. It
imports torch and numpy only, never jax and nothing of `materialize_tpu`.
Entry points put their tensors on `cuda` unless the caller passes
`device="cpu"`; the hot-path kernels are CUDA C++ for sm_90a
(`csrc/`, dispatched by ops/kernels/registry.py).
"""
