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
           prefix cache, the HTTP frontend (api.py; `lhrs_serve_torch.py`)
  data/    the training collators; the serving host pipeline without PIL,
           transformers or tokenizers: conversation templates, image-token
           tokenization, a byte-level tokenizer, the CLIP resize, PNG decode
  train/   stage-1 to stage-3 trainers, optimizers, schedules
  parallel/ torch.distributed: rank helpers, the ("data", "model") mesh,
           tensor-parallel partition, ZeRO-2 optimizer-state shards
  utils/   logger setup, environment report
  bench.py the bench's cells on the card (`python -m lhrs_bot_tpu_torch.bench`)
  benchmarks/  the HBM and int8 probes and the int8-dots A/B
  device.py  where tensors live: the card unless the caller names the CPU
"""

__version__ = "0.1.0"
