"""lhrs_bot_tpu_torch: the PyTorch / CUDA port of lhrs_bot_tpu, for one
NVIDIA H100.

Mirrors the JAX package's layout and names so each function's counterpart is
easy to find; `lhrs_bot_tpu` stays the reference the port is tested against.
This package imports torch and never jax.

  core/    config presets, the weight bridge from the JAX pytree, engine build
  ops/     plain torch ops and the hand-written CUDA kernels' wrappers
  csrc/    CUDA C++ sources (sm_90a), built with nvcc at first use
  models/  ViT-L/14 tower, multi-level perceiver, splice, LLaMA-2, VLM
  serve/   generation engine, continuous-batching and paged schedulers,
           prefix cache
  device.py  where tensors live: the card unless the caller names the CPU
"""

__version__ = "0.1.0"
