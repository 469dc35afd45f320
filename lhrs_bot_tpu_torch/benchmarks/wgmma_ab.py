"""Kernel B (int8 GEMM), K1 (flash-attention forward) and the flash
backward (dQ and dK/dV kernels) of one checkout of the repository, timed
on the card at the main path's shapes, and the end to end numbers they
move.

    python3 lhrs_bot_tpu_torch/benchmarks/wgmma_ab.py --root DIR --part P

imports `lhrs_bot_tpu_torch` (and `chip_smoke`'s timing helpers) from the
checkout at DIR, builds its kernels there, and prints one JSON line with
the card's name and power limit. So two checkouts are compared in one call
on one card by running this file against each in turns (parent, change,
change, parent). Parts:

  kernels: B at the tower's five (K, N) shapes at M = 64 * 257 with a bf16
      output, and at FC with bias + QuickGELU and a float32 output; K1 at
      the decoder prefill (B1 H32 S2191 D128 causal), the packed training
      shape (B1 H32 S2048 D128, 4 segments, with the LSE), the ViT (B64 H16
      S257 D64, Q/K/V strided views of one projection, float32 token-major
      output) and the perceiver's group 0 (B64 H16 64 x 320 D64, float32
      output); each beside one PyTorch call of the same function
      (`torch._int_mm` for the product alone, SDPA) and its bound. The
      backward's dQ and dK/dV kernels at the training path's shapes
      (`bwd_shapes`: the packed decoder batch, the kv-mask decoder shape,
      the caption batch and the perceiver's group 0), each launcher as a
      caller with no run table calls it, and the whole backward
      (`flash_attention_bwd`: delta, the run table, both kernels) as the
      training path calls it, beside SDPA's backward, the bounds of
      `chip_smoke.attention_bound` and, where the checkout has the skip
      rule, the time of its run table, each kernel's time given the table,
      and the 64 x 64 tile pairs run and skipped.
  e2e: the bench's three tower cells (`bench.bench_prefill`, B=64), the
      2,191-token bf16 prefill (`generate`'s first step, as
      chip_profile.py times it), and a stage-1 training step on the packed
      batch and on the caption batch (host clock), each with the card's
      busy time and the flash forward's and backward's shares of it under
      torch.profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _kernels(dev):
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from lhrs_bot_tpu_torch.ops.attention import flash_attention_fwd
    from lhrs_bot_tpu_torch.ops.int8_gemm import int8_gemm_kernel
    from lhrs_bot_tpu_torch.ops.quant import transposed_storage

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    m = 64 * 257
    for k, n in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
                 (1024, 2048)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = transposed_storage(torch.randint(-127, 128, (k, n), generator=gen,
                                             device=dev, dtype=torch.int8))
        xs = torch.rand(m, 1, generator=gen, device=dev) * 0.02 + 1e-3
        ws = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        ms = c.cuda_ms(lambda: int8_gemm_kernel(a, xs, w, ws))
        bms, by = c.bound(m * k + k * n + 4 * (m + n) + 2 * m * n,
                          2.0 * m * n * k, "int8")
        row = {"ms": ms, "TOPS": 2 * m * n * k / ms / 1e9,
               "library_ms": c.cuda_ms(lambda: torch._int_mm(a, w)),
               "bound_ms": bms, "bound_by": by}
        if n == 4096:
            bias = torch.randn(n, generator=gen, device=dev) * 0.1
            row["fc_f32_gelu_ms"] = c.cuda_ms(lambda: int8_gemm_kernel(
                a, xs, w, ws, bias=bias, act="quick_gelu",
                out_dtype=torch.float32))
            row["fc_f32_gelu_bound_ms"], _ = c.bound(
                m * k + k * n + 4 * (m + 2 * n) + 4 * m * n, 2.0 * m * n * k,
                "int8")
        out[f"B_K{k}_N{n}"] = row
        del a, w

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def attn_row(name, q, k, v, fwd, sdpa, pairs, out_bytes):
        b, h, sq, d = q.shape
        bms, by = c.bound(2 * b * h * d * (sq + 2 * k.shape[2]) + out_bytes,
                          4.0 * h * d * pairs)
        ms = c.cuda_ms(fwd)
        out[name] = {"ms": ms, "TFLOPs": 4.0 * h * d * pairs / ms / 1e9,
                     "library_ms": c.cuda_ms(sdpa), "bound_ms": bms,
                     "bound_by": by}

    s = 2191
    q, k, v = randn(1, 32, s, 128), randn(1, 32, s, 128), randn(1, 32, s, 128)
    attn_row("K1_prefill", q, k, v,
             lambda: flash_attention_fwd(q, k, v, None, True, 128 ** -0.5),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
             s * (s + 1) // 2, 2 * 32 * s * 128)
    s = 2048
    q, k, v = randn(1, 32, s, 128), randn(1, 32, s, 128), randn(1, 32, s, 128)
    seg = torch.zeros(1, s, dtype=torch.int32, device=dev)
    pos = 0
    for i, n in enumerate((600, 500, 400, 291)):
        seg[:, pos:pos + n] = i + 1
        pos += n
    allowed = ((seg[:, :, None] == seg[:, None, :]) & (seg > 0)[:, :, None]
               & torch.ones(s, s, dtype=torch.bool, device=dev).tril())
    lse = torch.empty(1, 32, s, device=dev)
    attn_row("K1_train_seg_lse", q, k, v,
             lambda: flash_attention_fwd(q, k, v, None, True, 128 ** -0.5,
                                         segment_ids=seg, lse=lse),
             lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=allowed[:, None], scale=128 ** -0.5),
             int(allowed.sum()), (2 * 128 + 4) * 32 * s + 4 * s)
    del allowed
    b, s = 64, 257
    qkv = randn(b, s, 3 * 1024)
    q, k, v = qkv.view(b, s, 3, 16, 64).permute(2, 0, 3, 1, 4).unbind(0)
    o = torch.empty(b, s, 16, 64, device=dev)
    attn_row("K1_vit_b64", q, k, v,
             lambda: flash_attention_fwd(q, k, v, None, False, 0.125,
                                         torch.float32, o.transpose(1, 2)),
             lambda: F.scaled_dot_product_attention(q, k, v),
             b * s * s, 4 * b * s * 1024)
    q, k, v = randn(b, 16, 64, 64), randn(b, 16, 320, 64), randn(b, 16, 320, 64)
    attn_row("K1_perceiver_g0_b64", q, k, v,
             lambda: flash_attention_fwd(q, k, v, None, False, 0.125,
                                         torch.float32),
             lambda: F.scaled_dot_product_attention(q, k, v),
             b * 64 * 320, 4 * b * 16 * 64 * 64)
    out.update(_backward(dev, gen))
    return out


def bwd_shapes(dev, gen):
    """(name, q, k, v, d_out, kv_mask, segment_ids, causal) of the flash
    backward on the training path: the packed decoder batch (B1 H32 S2048
    D128, 4 segments and a padding tail), the kv-mask decoder shape (1791
    valid keys), the caption batch (B8 H32 S335 D128, each row's padding
    tail masked) and the perceiver's group 0 (B8 H16 64 x 320 D64)."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def qkvd(b, h, sq, skv, d):
        return (randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d),
                randn(b, h, sq, d))

    s = 2048
    seg = torch.zeros(1, s, dtype=torch.int32, device=dev)
    pos = 0
    for i, n in enumerate((600, 500, 400, 291)):
        seg[:, pos:pos + n] = i + 1
        pos += n
    yield ("packed", *qkvd(1, 32, s, s, 128), None, seg, True)
    mask = (torch.arange(s, device=dev) < 1791)[None].contiguous()
    yield ("kvmask", *qkvd(1, 32, s, s, 128), mask, None, True)
    pos = torch.arange(335, device=dev)
    mask = torch.stack([pos < n for n in CAPTION_VALID]).contiguous()
    yield ("caption", *qkvd(8, 32, 335, 335, 128), mask, None, True)
    yield ("perceiver_g0", *qkvd(8, 16, 64, 320, 64), None, None, False)


# valid spliced rows of each caption row: BOS, 143 image tokens and 64-192
# text tokens, padded to 335
CAPTION_VALID = (335, 279, 207, 335, 244, 301, 226, 318)


def _backward(dev, gen):
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from lhrs_bot_tpu_torch.ops import attention

    out = {}
    for name, q, k, v, do, mask, seg, causal in bwd_shapes(dev, gen):
        b, h, sq, d = q.shape
        skv = k.shape[2]
        scale = d ** -0.5
        lse = torch.empty(b, h, sq, device=dev)
        o = attention.flash_attention_fwd(q, k, v, mask, causal, scale,
                                          segment_ids=seg, lse=lse)
        delta = (do.float() * o.float()).sum(-1)
        valid = attention._allowed(sq, skv, mask, seg, causal, dev)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=valid,
                                              scale=scale)
        # each launcher as a caller with no run table calls it (the change's
        # builds its table), and the whole backward (delta, the table, both
        # kernels) as the training path calls it, held against SDPA's
        row = {
            "dq_ms": c.cuda_ms(lambda: attention.flash_attention_bwd_dq(
                q, k, v, mask, seg, lse, delta, do, causal, scale)),
            "dkv_ms": c.cuda_ms(lambda: attention.flash_attention_bwd_dkv(
                q, k, v, mask, seg, lse, delta, do, causal, scale)),
            "bwd_ms": c.cuda_ms(lambda: attention.flash_attention_bwd(
                q, k, v, mask, seg, o, lse, do, causal, scale)),
            "library_ms": c.cuda_ms(lambda: torch.autograd.grad(
                sdpa, (qg, kg, vg), do, retain_graph=True)),
        }
        for key, products, q_rows, kv_rows in (("dq", 3, 3, 2),
                                               ("dkv", 4, 2, 4)):
            row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = (
                c.attention_bound(valid, mask, seg, b, h, sq, skv, d,
                                  products, q_rows, kv_rows, 2))
        if hasattr(attention, "bwd_tile_table"):  # the change's skip rule
            runs = attention.bwd_tile_table(mask, seg, b, sq, skv, causal,
                                            dev)
            row["table_ms"] = c.cuda_ms(lambda: attention.bwd_tile_table(
                mask, seg, b, sq, skv, causal, dev))
            # the kernels alone, given the table
            row["dq_kernel_ms"] = c.cuda_ms(
                lambda: attention.flash_attention_bwd_dq(
                    q, k, v, mask, seg, lse, delta, do, causal, scale, runs))
            row["dkv_kernel_ms"] = c.cuda_ms(
                lambda: attention.flash_attention_bwd_dkv(
                    q, k, v, mask, seg, lse, delta, do, causal, scale, runs))
            nq, nk = runs.shape[1:]
            row["tile_pairs_run"] = h * int(runs.sum())
            row["tile_pairs_skipped"] = b * h * int(attention.bwd_tile_pairs(
                None, None, nq, nk, causal).sum()) - row["tile_pairs_run"]
        out[f"bwd_{name}"] = row
        del sdpa, qg, kg, vg
        torch.cuda.empty_cache()
    return out


def _step(trainer, batch):
    """Median host-clock ms of 3 steps after a warm-up step, then the busy
    ms of one profiled step and the flash kernels' shares of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._step_fn(trainer.params, batch)
        torch.cuda.synchronize()
        if i:
            steps.append((time.perf_counter() - t0) * 1e3)
    out = {"step_ms": sorted(steps)[len(steps) // 2]}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer._step_fn(trainer.params, batch)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    out["busy_ms"] = busy
    for key in ("flash_fwd", "flash_bwd"):
        ms = sum(e.self_device_time_total for e in events
                 if key in e.key) / 1e3
        out[f"{key}_ms"], out[f"{key}_share"] = ms, ms / busy
    return out


def _e2e(dev):
    import numpy as np
    import torch

    import chip_smoke as c
    from lhrs_bot_tpu_torch import bench
    from lhrs_bot_tpu_torch.core import build_engine, build_trainer, eval_config
    from lhrs_bot_tpu_torch.core.config import load_yaml_config
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    out = dict(bench.bench_prefill(VLMConfig(), device=dev))
    torch.cuda.empty_cache()
    config = eval_config()
    cfg = VLMConfig.from_config_dict(config)
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    engine = build_engine(cfg, params, config, dev)
    del params
    rng = np.random.default_rng(0)
    ids = rng.integers(3, cfg.llama.vocab_size, 2048).astype(np.int32)
    ids[0], ids[1] = cfg.llama.bos_token_id, -200
    size = cfg.vit.image_size
    img = rng.integers(0, 256, (1, size, size, 3)).astype(np.uint8)
    one = GenerationConfig(max_new_tokens=1)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._start(ids[None], np.asarray([2048], np.int32), img, one)
        torch.cuda.synchronize()
        if i:  # the first call warms up
            times.append((time.perf_counter() - t0) * 1e3)
    out["prefill_2191_ms"] = sorted(times)[len(times) // 2]
    del engine
    torch.cuda.empty_cache()

    config = load_yaml_config("Config/multi_modal_stage1.yaml")
    cfg = VLMConfig.from_config_dict(config)
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    caption, packed = c.train_batches(cfg, np.random.default_rng(11))
    trainer = build_trainer(config, params, [packed], dev)
    del params
    for name, batch in (("packed", packed), ("caption", caption)):
        for key, value in _step(trainer, trainer._put(batch)).items():
            out[f"train_{name}_{key}"] = value
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose lhrs_bot_tpu_torch is measured")
    ap.add_argument("--part", choices=("kernels", "e2e"), required=True)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)  # Config/ and the build directory of that checkout
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("wgmma_ab: no CUDA device visible; this measures "
                         "the card")
    import chip_smoke as c

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    res = _kernels(dev) if args.part == "kernels" else _e2e(dev)
    line = {"root": args.root, "part": args.part, "result": res,
            "seconds": time.time() - t0, "device": c.smi_line()}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
