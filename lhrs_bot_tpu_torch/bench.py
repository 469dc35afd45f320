"""Benchmark (one JSON line): 7B decode tok/s/seq and ViT + perceiver
prefill images/s, on one CUDA card.

Counterpart of the repository's `bench.py` (the JAX package's TPU bench),
with its cells at its geometry: LLaMA-2-7B decode at the full parity
context (S_max 2304, 2,192 rows already filled) from seeded random weights,
int8 by default, for

  decode_b1_s2304_int8w_bf16cache_tok_s   int8 weights, bf16 cache, B 1
  decode_b2 / b3_s2304_total_tok_s        the same at B 2 and 3 (total)
  decode_b1_s512_tok_s                    S_max 512, 256 filled
  decode_b1_s2304_int8cache_tok_s         int8 weights, int8 cache
  decode_b7_s2304_int8cache_total_tok_s   the same at B 7 (total)
  decode_b1_s2304_int8cache_lm8_tok_s     + int8 lm_head
  decode_b1_s2304_w4a8_lm8_tok_s          halves-packed W4A8 weights, int8
                                          lm_head, int8 cache: the headline

and ViT-L/14 + perceiver at B 64 through the bf16 tower, the W8A8 one
(`quantize_vision_layers`, `dense_any`) and the fused W8A8 one
(`vit_encode_fused`), each with the W8A8 perceiver where the JAX bench has
it. Int8 caches hold random codes and uniform 0.01-0.03 scale planes, as
there. A decode cell is `steps` greedy `llama_decode_step` calls with the
argmax fed back on the card and one host read at the end, timed on the
host clock: steps * B / the fastest of `reps` runs, after a warm-up run.
The int8-cache cells run the decode kernel that LHRS_DECODE_INT8_DOTS
selects, as the JAX bench does.

Run on the card: `python -m lhrs_bot_tpu_torch.bench`. The line has
`bench.py`'s keys (`metric`, `value`, `unit`, `extra`) without its
TPU-set ratios, plus `device`: the card's name and power limit. A cell
that fails raises, and the run exits non-zero. The functions take the
model config and the geometry, so they also run tiny on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from .models.llama import KVCache, LlamaConfig, llama_decode_step
from .models.vlm import VLMConfig, init_vlm_params
from .ops.quant import QuantizedTensor, quantize_int4h, quantize_int8

METRIC = "llama2_7b_decode_w4a8_full_context_single_chip"
HEADLINE = "decode_b1_s2304_w4a8_lm8_tok_s"
# weight sets: (bits, int8 lm_head)
WEIGHTS = {"int8": (8, False), "int8_lm8": (8, True),
           "w4a8_lm8": ("4h", True)}


def decode_cells(s_full: int = 2304, fill_full: int = 2192,
                 s_short: int = 512, fill_short: int = 256):
    """(key, B, S_max, filled rows, weight set, cache dtype) of each decode
    cell, in the JAX bench's order."""
    bf, i8 = torch.bfloat16, torch.int8
    full, short = (s_full, fill_full), (s_short, fill_short)
    return [
        ("decode_b1_s2304_int8w_bf16cache_tok_s", 1, *full, "int8", bf),
        ("decode_b2_s2304_total_tok_s", 2, *full, "int8", bf),
        ("decode_b3_s2304_total_tok_s", 3, *full, "int8", bf),
        ("decode_b1_s512_tok_s", 1, *short, "int8", bf),
        ("decode_b1_s2304_int8cache_tok_s", 1, *full, "int8", i8),
        ("decode_b7_s2304_int8cache_total_tok_s", 7, *full, "int8", i8),
        ("decode_b1_s2304_int8cache_lm8_tok_s", 1, *full, "int8_lm8", i8),
        (HEADLINE, 1, *full, "w4a8_lm8", i8),
    ]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stack(qts):
    return QuantizedTensor(torch.stack([t.q for t in qts]),
                           torch.stack([t.scale for t in qts]), qts[0].bits)


def make_decoder_params(cfg: LlamaConfig, bits=8, lm8: bool = False, *,
                        device="cuda", seed: int = 0) -> Dict:
    """Seeded LLaMA weights of N(0, 0.02) in bf16 (norms 1) with the seven
    projections quantized per output channel, layer by layer (int8, or
    halves-packed int4 for bits "4h"), and the lm_head int8 with lm8."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02
                ).to(torch.bfloat16)

    quant = quantize_int8 if bits == 8 else quantize_int4h
    d, f, nl = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
              "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    layers = {name: _stack([quant(normal(*shape), axis=0)
                            for _ in range(nl)])
              for name, shape in shapes.items()}
    ones = torch.ones((nl, d), dtype=torch.bfloat16, device=device)
    layers.update(input_norm=ones, post_attn_norm=ones.clone())
    lm_head = normal(d, cfg.vocab_size)
    if lm8:
        lm_head = quantize_int8(lm_head, axis=0)
    return {"embed_tokens": normal(cfg.vocab_size, d), "layers": layers,
            "final_norm": torch.ones(d, dtype=torch.bfloat16, device=device),
            "lm_head": lm_head}


def filled_cache(cfg: LlamaConfig, b: int, s_max: int, dtype, *, device,
                 seed: int = 2) -> KVCache:
    """A cache of random contents: bf16 N(0, 1) rows, or int8 codes in
    [-127, 127) with uniform 0.01-0.03 scale planes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (cfg.num_hidden_layers, b, cfg.num_attention_heads, s_max,
             cfg.head_dim)
    length = torch.zeros(b, dtype=torch.int32, device=device)
    if dtype == torch.int8:
        def codes():
            return torch.randint(-127, 127, shape, generator=gen,
                                 device=device, dtype=torch.int8)

        def planes():
            return torch.rand(shape[:-1], generator=gen,
                              device=device) * 0.02 + 0.01

        return KVCache(codes(), codes(), length, planes(), planes())
    return KVCache(*(torch.randn(shape, generator=gen, device=device,
                                 dtype=dtype) for _ in range(2)), length)


def decode_run(params, cfg: LlamaConfig, cache: KVCache, fill: int,
               steps: int, int8_dots: Optional[bool] = None) -> int:
    """`steps` greedy decode steps from token 0 at `fill` filled rows, the
    argmax fed back on the device; one host read (the token sum) at the
    end."""
    b = cache.length.shape[0]
    cache = dataclasses.replace(cache, length=torch.full_like(cache.length,
                                                              fill))
    tok = torch.zeros(b, dtype=torch.long, device=cache.k.device)
    total = torch.zeros((), dtype=torch.long, device=cache.k.device)
    for _ in range(steps):
        emb = params["embed_tokens"][tok][:, None]
        logits, cache = llama_decode_step(params, cfg, cache,
                                          inputs_embeds=emb,
                                          int8_dots=int8_dots)
        tok = logits.argmax(dim=-1)
        total += tok.sum()
    return int(total)


def measure_decode(params, cfg: LlamaConfig, b: int, s_max: int, fill: int,
                   *, steps: int = 64, reps: int = 3,
                   cache_dtype=torch.bfloat16, device="cuda",
                   int8_dots: Optional[bool] = None) -> Dict:
    """One decode cell: tok/s (steps * B over the fastest run) and ms a
    step."""
    if fill + steps > s_max:
        raise ValueError(f"{steps} steps from {fill} rows overrun S_max "
                         f"{s_max}")
    cache = filled_cache(cfg, b, s_max, cache_dtype, device=device)
    decode_run(params, cfg, cache, fill, steps, int8_dots)  # warm-up
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        decode_run(params, cfg, cache, fill, steps, int8_dots)
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {"tok_s": steps * b / best, "step_ms": best / steps * 1e3}


def bench_decode(cfg: LlamaConfig, *, device="cuda", steps: int = 64,
                 reps: int = 3, cells=None) -> Dict[str, float]:
    """Every decode cell's tok/s, one weight set on the card at a time."""
    cells = decode_cells() if cells is None else cells
    out = {}
    for wname, (bits, lm8) in WEIGHTS.items():
        mine = [c for c in cells if c[4] == wname]
        if not mine:
            continue
        params = make_decoder_params(cfg, bits, lm8, device=device)
        for key, b, s_max, fill, _, cache_dtype in mine:
            out[key] = measure_decode(params, cfg, b, s_max, fill,
                                      steps=steps, reps=reps,
                                      cache_dtype=cache_dtype,
                                      device=device)["tok_s"]
        del params
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return out


def bench_prefill(cfg: VLMConfig, *, device="cuda", batch: int = 64,
                  iters: int = 10) -> Dict[str, float]:
    """ViT + perceiver images/s at B `batch` through the bf16 tower, the
    W8A8 tower (`dense_any`) with the W8A8 perceiver, and the fused W8A8
    tower with the W8A8 perceiver, from seeded bf16 weights."""
    from .models.perceiver import perceiver_resample
    from .models.vit import vit_encode, vit_encode_fused
    from .ops.quant import quantize_vision_layers
    from .ops.vit_block import pack_vit_layers_fused

    tower_cfg = dataclasses.replace(cfg, llama=LlamaConfig.tiny_test())
    params = init_vlm_params(tower_cfg, seed=0, dtype=torch.bfloat16,
                             device=device)
    vp, pp = params["vit"], params["pooler"]
    vq = {**vp, "layers": quantize_vision_layers(vp["layers"])}
    pq = {**pp, "layers": quantize_vision_layers(pp["layers"])}
    packed = pack_vit_layers_fused(vp["layers"])
    size = cfg.vit.image_size
    images = torch.as_tensor(np.random.default_rng(0).integers(
        0, 255, (batch, size, size, 3), dtype=np.uint8), device=device)
    towers = {
        "prefill_bf16_img_per_s": lambda: perceiver_resample(
            pp, vit_encode(vp, images, cfg.vit), cfg.pooler),
        "prefill_w8a8_img_per_s": lambda: perceiver_resample(
            pq, vit_encode(vq, images, cfg.vit), cfg.pooler),
        "vit_perceiver_prefill_img_per_s": lambda: perceiver_resample(
            pq, vit_encode_fused(vp, packed, images, cfg.vit), cfg.pooler),
    }
    out = {}
    for key, fn in towers.items():
        fn()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync(device)
        out[key] = batch * iters / (time.perf_counter() - t0)
    return out


def bench_line(decode: Dict[str, float], prefill: Dict[str, float],
               device: Dict) -> Dict:
    """The JSON object of `bench.py`'s line; every value must be a positive
    number."""
    extra = {**decode, **prefill}
    for key, v in extra.items():
        if not (isinstance(v, float) and np.isfinite(v) and v > 0):
            raise ValueError(f"bench cell {key} gave {v!r}")
    return {"metric": METRIC, "value": decode[HEADLINE], "unit": "tok/s/seq",
            "extra": extra, "device": device}


def device_line(index: int = 0) -> Dict:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def main(argv=None) -> Dict:
    del argv
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device visible; this bench runs on "
                         "the card")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = bench_line(bench_decode(LlamaConfig.llama2_7b(), device=dev),
                      bench_prefill(VLMConfig(), device=dev),
                      device_line())
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
