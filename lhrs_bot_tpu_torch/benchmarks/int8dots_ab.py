"""A/B of the int8-cache decode attention with int8 dots against bf16 dots.

Counterpart of `benchmarks/int8dots_ab.py` (the JAX package's TPU A/B), at
its geometry (B 1, S_max 2304, 2,192 rows filled, LLaMA-2-7B width):

  1. the attention alone: `steps` decode steps of the fused int8-cache
     append + attention over all 32 layers, int8 dots off and on: ms a
     step and the effective GB/s of the cache bytes it must read;
  2. one call's max |difference| between the two on a random cache;
  3. the whole W4A8 + int8 lm_head + int8-KV decode step, off and on: ms a
     step and tok/s.

Run on the card: `python -m lhrs_bot_tpu_torch.benchmarks.int8dots_ab`;
one JSON line with the card's name and power limit. The functions take the
config and the geometry, so they also run tiny on the CPU.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import torch

from ..bench import (device_line, filled_cache, make_decoder_params,
                     measure_decode, sync)
from ..models.llama import LlamaConfig
from ..ops.fused_decode import fused_decode_attention_q
from ..ops.quant import quantize_activation

B, S_MAX, FILL, STEPS = 1, 2304, 2192, 32


def attention_bytes(cfg: LlamaConfig, b: int, fill: int, steps: int) -> int:
    """The int8 K and V rows and their float32 scales a step reads, on
    average over the steps (the JAX A/B's count)."""
    rows = cfg.num_hidden_layers * b * cfg.num_attention_heads * (
        fill + steps // 2)
    return rows * (cfg.head_dim + 4) * 2


def attention_loop(cfg: LlamaConfig, b: int, s_max: int, fill: int,
                   steps: int, int8_dots: bool, *, device="cuda") -> float:
    """ms a step of `steps` steps of the attention alone over every layer
    (the appended rows are codes of 1 with scale 0.02, q is 1, as in the
    JAX A/B), after a warm-up pass."""
    cache = filled_cache(cfg, b, s_max, torch.int8, device=device)
    h, d = cfg.num_attention_heads, cfg.head_dim
    q = torch.ones((b, h, 1, d), dtype=torch.bfloat16, device=device)
    kn = torch.ones((b, h, 1, d), dtype=torch.int8, device=device)
    kns = torch.full((b, h, 1), 0.02, device=device)

    def run():
        for step in range(steps):
            lengths = torch.full((b,), fill + step, dtype=torch.int32,
                                 device=device)
            for layer in range(cfg.num_hidden_layers):
                fused_decode_attention_q(
                    q, kn, kns, kn, kns, cache.k, cache.v, cache.k_scale,
                    cache.v_scale, lengths, layer, int8_dots=int8_dots)

    run()
    sync(device)
    t0 = time.perf_counter()
    run()
    sync(device)
    return (time.perf_counter() - t0) / steps * 1e3


def one_call_diff(cfg: LlamaConfig, b: int, *, device="cuda",
                  s_max: int = 512, length: int = 384) -> float:
    """max |int8 dots - bf16 dots| of one call over a cache of quantized
    N(0, 1) rows (the JAX A/B's check)."""
    gen = torch.Generator(device=device).manual_seed(0)
    h, d = cfg.num_attention_heads, cfg.head_dim

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16)

    kc, ks = quantize_activation(normal(1, b, h, s_max, d))
    vc, vs = quantize_activation(normal(1, b, h, s_max, d))
    q = normal(b, h, 1, d)
    kn, kns = quantize_activation(normal(b, h, 1, d))
    vn, vns = quantize_activation(normal(b, h, 1, d))
    lengths = torch.full((b,), length, dtype=torch.int32, device=device)
    outs = [fused_decode_attention_q(
        q, kn, kns[..., 0], vn, vns[..., 0], kc.clone(), vc.clone(),
        ks[..., 0].contiguous(), vs[..., 0].contiguous(), lengths, 0,
        int8_dots=flag)[0].float() for flag in (False, True)]
    return float((outs[1] - outs[0]).abs().max())


def run_ab(cfg: LlamaConfig, *, device="cuda", b: int = B,
           s_max: int = S_MAX, fill: int = FILL, steps: int = STEPS,
           reps: int = 3) -> Dict[str, float]:
    report = {}
    n_bytes = attention_bytes(cfg, b, fill, steps)
    for flag, tag in ((False, "attn_bf16dots"), (True, "attn_int8dots")):
        ms = attention_loop(cfg, b, s_max, fill, steps, flag, device=device)
        report[f"{tag}_ms"] = ms
        report[f"{tag}_eff_gbs"] = n_bytes / ms / 1e6
    report["onecall_max_abs_diff"] = one_call_diff(cfg, b, device=device)
    params = make_decoder_params(cfg, "4h", True, device=device)
    for flag, tag in ((False, "total_w4h_bf16dots"),
                      (True, "total_w4h_int8dots")):
        cell = measure_decode(params, cfg, b, s_max, fill, steps=steps,
                              reps=reps, cache_dtype=torch.int8,
                              device=device, int8_dots=flag)
        report[f"{tag}_ms"] = cell["step_ms"]
        report[f"{tag}_tok_s"] = cell["tok_s"]
    return report


def main(argv=None) -> Dict:
    del argv
    if not torch.cuda.is_available():
        raise SystemExit("int8dots_ab: no CUDA device visible; this A/B runs "
                         "on the card")
    report = run_ab(LlamaConfig.llama2_7b(), device=torch.device("cuda", 0))
    report["device"] = device_line()
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
