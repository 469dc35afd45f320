"""Engine assembly from the config surface (counterpart of
lhrs_bot_tpu/core/bootstrap.py `build_engine`)."""

from __future__ import annotations

import torch

from ..serve.engine import GenerationEngine


def build_engine(cfg, params, config, device) -> GenerationEngine:
    """A GenerationEngine for `config` (a nested dict with the schema of
    `Config/*.yaml`, e.g. `core.convert.eval_config()`) on `device`.

    Maps the serving knobs as the JAX package does: `bits: 8` gives int8
    decoder weights, `bits: 4` NF4 (`quant_type: nf4`, the default, with
    `double_quant`) or halves-packed W4A8 (`quant_type: int4h`); `kv_bits: 8`
    an int8 KV cache; `lm_head_bits: 8` an int8 lm_head. max_seq_len is
    text.max_position_embeddings + 256. `vision_w8a8` defaults to off (the
    JAX value off the TPU); asking for it, or for `prefill_chunk`, raises
    NotImplementedError. Other `bits`/`kv_bits` values raise ValueError."""
    bits = int(config.get("bits", 16) or 16)
    kv_bits = int(config.get("kv_bits", 16) or 16)
    if bits not in (4, 8, 16) or kv_bits not in (8, 16):
        raise ValueError(f"bits={bits} kv_bits={kv_bits}: bits must be 4, 8 "
                         "or 16 and kv_bits 8 or 16")
    for knob in ("vision_w8a8", "prefill_chunk"):
        if config.get(knob):
            raise NotImplementedError(f"{knob} is not ported yet")
    return GenerationEngine(
        cfg, params, device=device,
        max_seq_len=int(config["text"]["max_position_embeddings"]) + 256,
        compute_dtype=torch.bfloat16,
        cache_dtype=torch.int8 if kv_bits == 8 else torch.bfloat16,
        quantize_bits=bits if bits in (4, 8) else None,
        quant_type=str(config.get("quant_type", "nf4") or "nf4"),
        double_quant=bool(config.get("double_quant", True)),
        lm_head_bits=int(config.get("lm_head_bits", 0) or 0) or None)
