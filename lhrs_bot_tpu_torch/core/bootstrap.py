"""Engine assembly from the config surface (counterpart of
lhrs_bot_tpu/core/bootstrap.py `build_engine`)."""

from __future__ import annotations

import torch

from ..serve.engine import GenerationEngine


def build_engine(cfg, params, config, device) -> GenerationEngine:
    """A GenerationEngine for `config` (a nested dict with the schema of
    `Config/*.yaml`, e.g. `core.convert.eval_config()`) on `device`.

    Honours `bits` and `kv_bits` (16/16 only: bf16 weights and a bf16 KV
    cache) and sets max_seq_len to text.max_position_embeddings + 256, as
    the JAX package does. Quantized weights or cache, the W8A8 vision tower,
    an int8 lm_head and chunked prefill are not ported and raise."""
    bits = int(config.get("bits", 16) or 16)
    kv_bits = int(config.get("kv_bits", 16) or 16)
    if bits != 16 or kv_bits != 16:
        raise NotImplementedError(
            f"bits={bits} kv_bits={kv_bits}: only the bf16 path (16/16) is "
            "ported")
    for knob in ("vision_w8a8", "lm_head_bits", "prefill_chunk"):
        if config.get(knob):
            raise NotImplementedError(f"{knob} is not ported yet")
    return GenerationEngine(
        cfg, params, device=device,
        max_seq_len=int(config["text"]["max_position_embeddings"]) + 256,
        compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16)
