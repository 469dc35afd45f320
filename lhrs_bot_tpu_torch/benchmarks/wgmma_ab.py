"""The redesigned hand-written kernels of one checkout of the repository,
timed on the card at the main path's shapes, and the end to end numbers
they move: kernel B (int8 GEMM), K1 (flash-attention forward), the flash
backward (dQ and dK/dV kernels), kernel A (LayerNorm + int8 rows), K3
(the W4A8 decode product), K2 / K4 (the contiguous-cache decode
attention, bf16 and int8 cache), the int8-dots decode kernel 5b, the
paged int8 decode kernel, and the probes' kernels (the int8 / bf16 chains,
the cache row write, the HBM readers).

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
      output), and at those two shapes the normalize-first forward
      (`flash_attention_fwd_normalized`) where the checkout has it, and
      also at ViT-L/14 336 px (B64 H16 S577, strided, float32 output) and
      the 336-px perceiver's three groups under their masks (B192 H16
      64 x 640): its split path, or its two-pass path where the checkout
      has no split path; and at ViT-L/14 504 px (B64 H16 S1297, strided,
      float32 and bf16 output; the block's 1,312 keys under its pad mask:
      its cluster path, or its two-pass path where the checkout has no
      cluster path) and the 504-px perceiver's three groups (B192 H16 64 x
      1360, one Q tile a head: the path `flash_attention_fwd_normalized`
      takes, the two-pass path since the cluster path exists); each
      beside one PyTorch call of the same function (`torch._int_mm` for
      the product alone, SDPA) and its bound; K1's registers and spills
      (and the normalize-first kernels') from the checkout's build log. The
      backward's dQ and dK/dV kernels at the training path's shapes
      (`bwd_shapes`: the packed decoder batch, the kv-mask decoder shape,
      the caption batch and the perceiver's group 0), each launcher as a
      caller with no run table calls it, and the whole backward
      (`flash_attention_bwd`: delta, the run table, both kernels) as the
      training path calls it, beside SDPA's backward, the bounds of
      `chip_smoke.attention_bound` and, where the checkout has the skip
      rule, the time of its run table, each kernel's time given the table,
      and the 64 x 64 tile pairs run and skipped.
  norm: the normalize-first forward at `NORM_ROWS` (the 504-px
      perceiver's groups, ViT-L/14 at 504 px and its block and bf16
      forms, rows of 704 to 2,560 keys, ViT-L/14 at 336 px, D128 at 577
      keys):
      each path that takes the rows timed on its own (the two-pass path
      everywhere, the split or cluster path in its range), the dispatch
      and its path, SDPA, the bound, the kernels' registers and spills;
      the readings `norm_path`'s thresholds rest on.
  quant: kernel A through `ln_quant` at every shape a path gives it
      (`A_SHAPES`: the tower's four calls a layer and the perceiver's five
      at B = 64, the int8 cache's K/V rows at decode B = 1, 2, 7 and at the
      2,191-token prefill, single decoder rows of 4096 and 11008), and K3
      at the decoder's three projection shapes for B = 1 and 7 through
      `w4a8_matmul_stacked` (pre-quantized halves) and `w4a8_project` (the
      bf16 activation: the parent's A + K3 + split-K epilogue, the
      change's one launch), each with its bound; where the checkout
      chooses a cluster, its choice, and `w4a8_project` and the resident
      clusters at 2, 4 and 8 CTAs.
  decode: K2 and K4 at L32 H32 S2304 D128, B1 (lengths [2191]), B2
      ([2191, 700]) and B7 (seven lengths up to 2303), each time beside its
      bound (bytes over 3.35 TB/s), the share of the bound, one SDPA call
      over the filled cache (int8: dequantized to bf16) and, where the
      checkout splits the rows across a cluster, the C its plan chooses and
      the time at every C; 5b on K4's caches with block_s 512 and 96 (and,
      where the checkout takes `splits`, its plan and every C); the paged
      int8 kernel at B1, B2, B7 as pages of 128 and at chip_smoke's skewed
      B8 serving case (`PAGED_LENGTHS`, with K4 on the same lengths and
      SDPA over the gathered, dequantized rows), every C where the checkout
      takes `splits`; the bf16 paged kernel at the B8 case; the registers
      of the decode kernels (contiguous, paged, int8 dots) from the
      checkout's build log.
  e2e: the bench's three tower cells (`bench.bench_prefill`, B=64; and
      again with ViT-L/14 at 336 px and the perceiver over 576 image
      tokens a group, keys ending in `_336`), its
      decode cells (`DECODE_CELLS`: W4A8, int8 cache, bf16 cache), a W4A8
      + int8 lm_head + int8-cache decode step and an int8-weight +
      bf16-cache decode step at B = 1 from 2,192 filled rows (host-clock
      ms, busy ms under torch.profiler, the decode attention kernel's
      device ms, and the launches a step of K3, its split-K epilogue, A,
      K2 and K4), the W4A8 step again under LHRS_DECODE_INT8_DOTS=1 (5b's
      device ms, share of the busy ms and launches), and, unless
      --no-train, the
      2,191-token bf16 prefill (`generate`'s first step, as
      chip_profile.py times it) and a stage-1 training step on the packed
      batch and on the caption batch (host clock), each with the card's
      busy time and the flash forward's and backward's shares of it under
      torch.profiler. With --towers-only N: only the three tower cells
      (224, 336 and 504 px, keys ending in `_336` and `_504`), N times,
      and the fused ViT-L block (B8) and the
      fused perceiver
      block, N times each: run the two checkouts in turns (parent, change,
      change, parent, ...) for five or more readings a side.
  probes: the five int8 / bf16 product chains at the probe's shape (g16
      M2048 K = N 1024, 16 products; where the checkout has `chain_form`,
      each with its form), each beside its bound, its share of it and the
      library chain (`torch._int_mm`, `torch.matmul` for bf16); the cache
      row write at B7 H32 S2304 D128 bf16 beside its bound, `index_put_`
      and, where the checkout has one, an empty kernel on its grid (the
      launch floor); the HBM readers (int8 and bf16, one array and two
      halves) over 1.5 GB; the probe kernels' registers and spills from the
      checkout's build log.
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
    from lhrs_bot_tpu_torch.ops import attention, cuda_lib
    from lhrs_bot_tpu_torch.ops.attention import flash_attention_fwd
    from lhrs_bot_tpu_torch.ops.int8_gemm import int8_gemm_kernel
    from lhrs_bot_tpu_torch.ops.quant import transposed_storage

    # the normalize-first forward, where the checkout has one
    norm = getattr(attention, "flash_attention_fwd_normalized", None)
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
    if norm is not None:  # the normalize-first forward, as K1 above
        attn_row("norm_vit_b64", q, k, v,
                 lambda: norm(q, k, v, None, 0.125, torch.float32,
                              o.transpose(1, 2)),
                 lambda: F.scaled_dot_product_attention(q, k, v),
                 b * s * s, 4 * b * s * 1024)
    q, k, v = randn(b, 16, 64, 64), randn(b, 16, 320, 64), randn(b, 16, 320, 64)
    attn_row("K1_perceiver_g0_b64", q, k, v,
             lambda: flash_attention_fwd(q, k, v, None, False, 0.125,
                                         torch.float32),
             lambda: F.scaled_dot_product_attention(q, k, v),
             b * 64 * 320, 4 * b * 16 * 64 * 64)
    if norm is not None:
        attn_row("norm_perceiver_g0_b64", q, k, v,
                 lambda: norm(q, k, v, None, 0.125, torch.float32),
                 lambda: F.scaled_dot_product_attention(q, k, v),
                 b * 64 * 320, 4 * b * 16 * 64 * 64)
    # ViT-L/14 at 336 px (577 tokens) and its perceiver's three groups
    # over 64 + 576 keys under their masks: the normalize-first forward
    # takes its split path there (the two-pass path in a checkout without
    # one)
    if norm is not None:
        from lhrs_bot_tpu_torch.ops.perceiver_block import _kv_mask

        s = 577
        qkv = randn(b, s, 3 * 1024)
        q, k, v = qkv.view(b, s, 3, 16, 64).permute(2, 0, 3, 1, 4).unbind(0)
        o = torch.empty(b, s, 16, 64, device=dev)
        attn_row("norm_vit336_b64", q, k, v,
                 lambda: norm(q, k, v, None, 0.125, torch.float32,
                              o.transpose(1, 2)),
                 lambda: F.scaled_dot_product_attention(q, k, v),
                 b * s * s, 4 * b * s * 1024)
        del qkv, o
        q = randn(3 * b, 16, 64, 64)
        k, v = randn(3 * b, 16, 640, 64), randn(3 * b, 16, 640, 64)
        mask = _kv_mask(b, 64, 640, (64, 48, 32),
                        tuple(n + 576 for n in (64, 48, 32)), dev)
        am = mask[:, None, None, :]
        attn_row("norm_perceiver336_b192", q, k, v,
                 lambda: norm(q, k, v, mask, 0.125, torch.float32),
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=am),
                 64 * int(mask.sum()), 4 * 3 * b * 16 * 64 * 64)
        del q, k, v
        # ViT-L/14 at 504 px (1,297 tokens; the block's 1,312 under its pad
        # mask; a bf16 output: the cluster path, the two-pass path in a
        # checkout without one) and its perceiver's three groups over 64 +
        # 1,296 keys (one Q tile a head: the two-pass path)
        for name, s, valid, dtype in (
                ("norm_vit504_b64", 1297, 1297, torch.float32),
                ("norm_vit504_block_b64", 1312, 1297, torch.float32),
                ("norm_vit504_bf16_b64", 1297, 1297, torch.bfloat16)):
            qkv = randn(b, s, 3 * 1024)
            q, k, v = qkv.view(b, s, 3, 16, 64).permute(2, 0, 3, 1,
                                                        4).unbind(0)
            o = torch.empty(b, s, 16, 64, device=dev, dtype=dtype)
            mask = None if valid == s else (
                torch.arange(s, device=dev) < valid).expand(b,
                                                            s).contiguous()
            am = None if mask is None else mask[:, None, None, :]
            attn_row(name, q, k, v,
                     lambda: norm(q, k, v, mask, 0.125, dtype,
                                  o.transpose(1, 2)),
                     lambda: F.scaled_dot_product_attention(
                         q, k, v, attn_mask=am),
                     b * s * valid, o.element_size() * b * s * 1024)
            del qkv, q, k, v, o
        q = randn(3 * b, 16, 64, 64)
        k, v = randn(3 * b, 16, 1360, 64), randn(3 * b, 16, 1360, 64)
        mask = _kv_mask(b, 64, 1360, (64, 48, 32),
                        tuple(n + 1296 for n in (64, 48, 32)), dev)
        am = mask[:, None, None, :]
        attn_row("norm_perceiver504_b192", q, k, v,
                 lambda: norm(q, k, v, mask, 0.125, torch.float32),
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=am),
                 64 * int(mask.sum()), 4 * 3 * b * 16 * 64 * 64)
        del q, k, v
    # K1's registers and spills (and the normalize-first kernels', whose
    # shared memory is dynamic: csrc/flash_fwd_norm.cu's kSmem)
    out["registers"] = _build_usage(cuda_lib.build(), ("flash_fwd_kernel",
                                                       "flash_norm"))
    out.update(_backward(dev, gen))
    return out


# (name, B, H, Sq, Skv, D, mask, output dtype) of `--part norm`: the
# 504-px perceiver's three groups, ViT-L/14 at 504 px (its 1,297 tokens,
# the block's 1,312 under its pad mask, a bf16 output), more row lengths
# of the cluster path's range (704 to 2,560 keys: where `norm_path` gives
# them to the cluster or the two-pass path), ViT-L/14 at 336 px (the
# split path's rows) and a head dim of 128 at 577 keys
NORM_ROWS = (
    ("perceiver504_b192", 192, 16, 64, 1360, 64, "perceiver", "float32"),
    ("vit504_b64", 64, 16, 1297, 1297, 64, None, "float32"),
    ("vit504_block_b64", 64, 16, 1312, 1312, 64, "pad", "float32"),
    ("vit504_bf16_b64", 64, 16, 1297, 1297, 64, None, "bfloat16"),
    ("s704_b64", 64, 16, 704, 704, 64, None, "float32"),
    ("s832_b64", 64, 16, 832, 832, 64, None, "float32"),
    ("s960_b64", 64, 16, 960, 960, 64, None, "float32"),
    ("s1088_b64", 64, 16, 1088, 1088, 64, None, "float32"),
    ("s1216_b64", 64, 16, 1216, 1216, 64, None, "float32"),
    ("s1408_b64", 64, 16, 1408, 1408, 64, None, "float32"),
    ("s1536_b64", 64, 16, 1536, 1536, 64, None, "float32"),
    ("s1664_b64", 64, 16, 1664, 1664, 64, None, "float32"),
    ("s1792_b64", 64, 16, 1792, 1792, 64, None, "float32"),
    ("s2048_b64", 64, 16, 2048, 2048, 64, None, "float32"),
    ("s2560_b64", 64, 16, 2560, 2560, 64, None, "float32"),
    ("vit336_b64", 64, 16, 577, 577, 64, None, "float32"),
    ("d128_577_b64", 64, 8, 577, 577, 128, None, "float32"),
)


def _norm(dev):
    """The normalize-first forward's paths at NORM_ROWS: the time of each
    path that takes the rows (`_flash_fwd_norm(path=...)`: the two-pass
    path at any length, the split and cluster paths in their ranges),
    the dispatch (`flash_attention_fwd_normalized`) and the path it
    takes, SDPA and the bound; and the registers and spills of the
    normalize-first kernels from the checkout's build log."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as c
    from lhrs_bot_tpu_torch.ops import attention, cuda_lib
    from lhrs_bot_tpu_torch.ops.perceiver_block import _kv_mask

    gen = torch.Generator(device=dev).manual_seed(0)
    norm = attention.flash_attention_fwd_normalized
    out = {}
    for name, b, h, sq, skv, d, mask_kind, dtype in NORM_ROWS:
        dtype = getattr(torch, dtype)
        w = h * d
        if sq == skv:  # strided views of one projection, as the ViT block
            qkv = torch.randn(b, sq, 3 * w, generator=gen, device=dev,
                              dtype=torch.bfloat16)
            q, k, v = qkv.view(b, sq, 3, h, d).permute(2, 0, 3, 1,
                                                       4).unbind(0)
        else:
            q = torch.randn(b, h, sq, d, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            k, v = (torch.randn(b, h, skv, d, generator=gen, device=dev,
                                dtype=torch.bfloat16) for _ in range(2))
        mask = None
        if mask_kind == "perceiver":
            mask = _kv_mask(b // 3, sq, skv, (64, 48, 32),
                            tuple(n + skv - 64 for n in (64, 48, 32)), dev)
        elif mask_kind == "pad":
            mask = (torch.arange(skv, device=dev) < 1297).expand(
                b, skv).contiguous()
        o = torch.empty(b, sq, h, d, device=dev, dtype=dtype)
        ot = o.transpose(1, 2)
        sm = d ** -0.5
        paths = ["two_pass"]
        keys_path = attention.norm_keys_path(skv, d)
        if keys_path != "two_pass":
            paths.append(keys_path)
        row = {"path": attention.norm_path(skv, d, sq)}
        for path in paths:
            row[f"{path}_ms"] = c.cuda_ms(lambda: attention._flash_fwd_norm(
                q, k, v, mask, sm, dtype, ot, path=path))
        row["dispatch_ms"] = c.cuda_ms(lambda: norm(q, k, v, mask, sm, dtype,
                                                    ot))
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        am = None if mask is None else mask[:, None, None, :]
        row["library_ms"] = c.cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=am, scale=sm))
        keys = b * skv if mask is None else int(mask.sum())
        row["bound_ms"], row["bound_by"] = c.bound(
            h * d * (2 * b * sq + 4 * keys + o.element_size() * b * sq)
            + (0 if mask is None else b * skv), 4.0 * h * sq * keys * d)
        out[name] = row
        del q, k, v, qc, kc, vc, o, ot
        torch.cuda.empty_cache()
    out["registers"] = _build_usage(cuda_lib.build(), ("flash_norm",))
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


# (name, M, W, dtype, LayerNorm) of kernel A's calls on the paths: the ViT
# at B = 64 (LN1, the attention output, LN2, the FC output), the perceiver
# at B = 64 (3 groups of 64 query rows and 320 key rows: LN1, LN_kv, then
# the block's back half), the int8 cache's new K/V rows (B * 32 heads of
# 128) at decode and at the 2,191-token prefill, and single decoder rows
A_SHAPES = (
    ("vit_ln1", 64 * 257, 1024, "bfloat16", True),
    ("vit_attn", 64 * 257, 1024, "float32", False),
    ("vit_ln2", 64 * 257, 1024, "float32", True),
    ("vit_fc", 64 * 257, 4096, "float32", False),
    ("perceiver_ln1", 64 * 3 * 64, 1024, "bfloat16", True),
    ("perceiver_ln_kv", 64 * 3 * 320, 1024, "bfloat16", True),
    ("perceiver_attn", 64 * 3 * 64, 1024, "float32", False),
    ("perceiver_ln2", 64 * 3 * 64, 1024, "float32", True),
    ("perceiver_fc", 64 * 3 * 64, 4096, "float32", False),
    ("kv_b1", 32, 128, "bfloat16", False),
    ("kv_b2", 2 * 32, 128, "bfloat16", False),
    ("kv_b7", 7 * 32, 128, "bfloat16", False),
    ("kv_prefill_2191", 32 * 2191, 128, "bfloat16", False),
    ("row_4096", 1, 4096, "bfloat16", False),
    ("row_11008", 1, 11008, "bfloat16", False),
)
# the decoder's projections (K, N) and how many a layer has
PROJECTIONS = ((4096, 4096, 4), (4096, 11008, 2), (11008, 4096, 1))


def _quant(dev):
    import torch

    import chip_smoke as c
    from lhrs_bot_tpu_torch.ops import w4_matmul as w4
    from lhrs_bot_tpu_torch.ops.ln_quant import ln_quant
    from lhrs_bot_tpu_torch.ops.quant import QuantizedTensor

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, m, w, dtype, ln in A_SHAPES:
        x = (torch.randn(m, w, generator=gen, device=dev) * 2 + 0.3).to(
            getattr(torch, dtype))
        g = b = None
        if ln:
            g = torch.rand(w, generator=gen, device=dev) + 0.5
            b = torch.randn(w, generator=gen, device=dev) * 0.1
        bms, by = c.bound(m * w * (x.element_size() + 1) + 4 * m
                          + (8 * w if ln else 0))
        out[f"A_{name}"] = {"M": m, "W": w, "dtype": dtype, "ln": ln,
                            "ms": c.cuda_ms(lambda: ln_quant(x, g, b)),
                            "bound_ms": bms, "bound_by": by}
        del x
    nl = 32
    for k, n, _ in PROJECTIONS:
        wq = torch.randint(-128, 128, (nl, k // 2, n), generator=gen,
                           device=dev, dtype=torch.int8)
        ws = torch.rand(nl, 1, n, generator=gen, device=dev) * 4e-3 + 1e-3
        qt = QuantizedTensor(wq, ws, "4h")
        for bsz in (1, 7):
            x = torch.randn(bsz, 1, k, generator=gen, device=dev).to(
                torch.bfloat16)
            xq = torch.randint(-127, 128, (bsz, k), generator=gen,
                               device=dev, dtype=torch.int8)
            xs = torch.rand(bsz, 1, generator=gen, device=dev) * 0.02 + 1e-3
            turn = iter(range(10**9))  # another layer each call: from HBM
            row = {
                "stacked_ms": c.cuda_ms(lambda: w4.w4a8_matmul_stacked(
                    xq[:, :k // 2], xq[:, k // 2:], xs, wq, ws,
                    next(turn) % nl)),
                "project_ms": c.cuda_ms(lambda: w4.w4a8_project(
                    x, qt, next(turn) % nl)),
            }
            # packed weights and scales, the activation (int8 halves and
            # scales, or bf16), a bf16 output
            row["stacked_bound_ms"], row["bound_by"] = c.bound(
                k // 2 * n + 4 * n + bsz * (k + 4) + 2 * bsz * n,
                2.0 * bsz * k * n, "int8")
            row["project_bound_ms"], _ = c.bound(
                k // 2 * n + 4 * n + 2 * bsz * k + 2 * bsz * n,
                2.0 * bsz * k * n, "int8")
            if hasattr(w4, "w4a8_launch_plan"):  # the change's clusters
                row["plan"] = w4.w4a8_launch_plan(dev, bsz, k // 2, n)
                for cl in (2, 4, 8):
                    row[f"project_c{cl}_ms"] = c.cuda_ms(
                        lambda: w4.w4a8_project_kernel(
                            x[:, 0], wq, ws, next(turn) % nl, cluster=cl))
                    row[f"resident_clusters_c{cl}"] = w4.w4a8_max_clusters(
                        bsz, k // 2, n, cluster=cl)
            else:
                row["ksplit"], row["chunk"] = w4.split_k(k // 2, n)
            out[f"K3_K{k}_N{n}_B{bsz}"] = row
        del wq, ws, qt
        torch.cuda.empty_cache()
    return out


# the bench's decode cells this comparison reads: W4A8 (K3), the int8
# cache (A on the new K/V rows, K4) and the bf16 cache (K2)
DECODE_CELLS = ("decode_b1_s2304_w4a8_lm8_tok_s",
                "decode_b1_s2304_int8cache_tok_s",
                "decode_b7_s2304_int8cache_total_tok_s",
                "decode_b1_s2304_int8cache_lm8_tok_s",
                "decode_b1_s2304_int8w_bf16cache_tok_s",
                "decode_b2_s2304_total_tok_s",
                "decode_b3_s2304_total_tok_s",
                "decode_b1_s512_tok_s")

# K2 / K4's decode batches: the bench's B1 row, the serving paths' B2 rows,
# a B7 batch (chip_smoke.py's DECODE_LENGTHS)
DECODE_LENGTHS = {"B1": [2191], "B2": [2191, 700],
                  "B7": [2192, 5, 1000, 2303, 63, 1500, 2000]}


def _build_usage(so, keys):
    """{mangled name: {"registers", "spill_stores"}} of the kernels of the
    checkout's build log (ptxas -v) whose names hold one of `keys`."""
    import re

    usage, name = {}, None
    for ln in (so.parent / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1) if any(k in m.group(1) for k in keys) else None
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name:
            usage.setdefault(name, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            usage.setdefault(name, {})["registers"] = int(m.group(1))
            name = None
    return usage


def _probes(dev):
    import torch

    import chip_smoke as c
    from lhrs_bot_tpu_torch.benchmarks import hbm_peak_probe as hbm
    from lhrs_bot_tpu_torch.benchmarks import int8_probe as chains
    from lhrs_bot_tpu_torch.ops import cache_update as cu
    from lhrs_bot_tpu_torch.ops import cuda_lib

    # the chain, row-write and reader kernels, and A and K3, which share
    # csrc/rowquant.cuh with the requantized chain
    out = {"registers": _build_usage(cuda_lib.build(), (
        "int8_probe", "cache_update", "hbm_probe", "ln_quant", "w4a8"))}
    gen = torch.Generator(device=dev).manual_seed(0)
    ops = chains.operands(dev, gen)
    for variant in chains.VARIANTS:
        xg, ws = ops["bf16" if variant == "bf16" else "int8"]
        n_ops = chains.chain_ops(xg, ws)
        # chip_smoke.chain_bound's count (the parent's chip_smoke has none)
        bms, by = c.bound(xg.numel() * xg.element_size()
                          + ws.numel() * ws.element_size()
                          + xg.shape[0] * 4096, n_ops,
                          "bf16" if variant == "bf16" else "int8")
        ms = c.cuda_ms(lambda: chains.int8_chain_kernel(xg, ws, variant),
                       warmup=1, reps=5)
        lib = c.cuda_ms(lambda: chains.library_chain(xg, ws, variant),
                        warmup=1, reps=5)
        row = {"ms": ms, "TOPS": n_ops / ms / 1e9, "bound_ms": bms,
               "bound_by": by, "bound_share": bms / ms, "library_ms": lib,
               "library_TOPS": n_ops / lib / 1e9}
        if hasattr(chains, "chain_form"):
            row["form"] = chains.chain_form(variant, ws.shape[0])[0]
        out[f"chain_{variant}"] = row
    del ops
    torch.cuda.empty_cache()

    b, h, s, d = 7, 32, 2304, 128
    cache = torch.randn(b, h, s, d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
    new = torch.randn(b, h, 1, d, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    lens = torch.tensor([0, s - 1, 5, 2191, 700, 1, 2300], dtype=torch.int32,
                        device=dev)
    idx = (torch.arange(b, device=dev)[:, None],
           torch.arange(h, device=dev)[None, :], lens.long()[:, None])
    row = {"ms": c.cuda_ms(lambda: cu.cache_row_update_kernel(cache, new,
                                                                lens)),
           "library_ms": c.cuda_ms(lambda: cache.index_put_(idx,
                                                            new[:, :, 0]))}
    row["bound_ms"], row["bound_by"] = c.bound(2 * b * h * d * 2)
    if hasattr(cu, "empty_kernel"):
        blocks = cu.row_write_blocks(b, h, d * 2)
        row["empty_ms"] = c.cuda_ms(lambda: cu.empty_kernel(dev, blocks))
        row["blocks"] = blocks
    out["cache_row_update"] = row
    del cache
    torch.cuda.empty_cache()

    x8, xb = hbm.buffers(dev, gen)
    for name, x in (("int8", x8), ("bf16", xb)):
        half, half2 = x[:x.shape[0] // 2], x[x.shape[0] // 2:]
        for dual, args in ((False, (x,)), (True, (half, half2))):
            n = x.numel() * x.element_size()
            ms = c.cuda_ms(lambda: hbm.hbm_read_kernel(*args), reps=5)
            bms, by = c.bound(n)
            out[f"hbm_{name}_{'dual' if dual else 'single'}"] = {
                "bytes": n, "ms": ms, "GB_s": n / ms / 1e6, "bound_ms": bms,
                "bound_by": by, "bound_share": bms / ms,
                "library_ms": c.cuda_ms(
                    lambda: [torch.amax(a) for a in args], reps=5)}
    return out


def _takes(fn, name):
    """Whether the checkout's wrapper `fn` takes the keyword `name` (the
    parent's paged int8 and int8-dots kernels take no `splits`)."""
    import inspect

    return name in inspect.signature(fn).parameters


# the paged int8 kernel's batches: DECODE_LENGTHS as pages of 128, and
# chip_smoke's skewed B8 serving case
PAGED_PAGE = 128


def _paged_pools(gen, dev, lengths, nl, h, s, d, int8=True, page=PAGED_PAGE):
    """Random int8 pools (L, N, H, page, D) with scale pages (or bf16
    pools), each row's S / page pages in shuffled order (page 0 null), the
    new rows and q: the paged kernel's inputs before `layer`."""
    import torch

    b, pps = len(lengths), s // page
    n_pages = 1 + b * pps
    table = (torch.randperm(n_pages - 1, generator=torch.Generator()
                            .manual_seed(b)) + 1).int().reshape(b, pps)

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.025 + 0.005

    shape = (nl, n_pages, h, page, d)
    q = torch.randn(b, h, 1, d, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    if not int8:
        def randn(*sh):
            return torch.randn(sh, generator=gen, device=dev,
                               dtype=torch.bfloat16)

        return (q, randn(b, h, 1, d), randn(b, h, 1, d), randn(*shape),
                randn(*shape), table.to(dev),
                torch.tensor(lengths, dtype=torch.int32, device=dev))
    return (q, codes(b, h, 1, d), scales(b, h, 1), codes(b, h, 1, d),
            scales(b, h, 1), codes(*shape), codes(*shape),
            scales(*shape[:-1]), scales(*shape[:-1]), table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _decode(dev):
    import torch

    import chip_smoke as c
    from lhrs_bot_tpu_torch.ops import cuda_lib
    from lhrs_bot_tpu_torch.ops import fused_decode as fd
    from lhrs_bot_tpu_torch.ops import paged_fused as pf

    out = {"registers": {k: v["registers"] for k, v in _build_usage(
        cuda_lib.build(), ("decode",)).items()}}
    split = hasattr(fd, "decode_split_plan")  # the change's clusters
    paged_split = _takes(pf.paged_fused_decode_q_kernel, "splits")
    dots_split = _takes(fd.fused_decode_attention_q_int8dots_kernel,
                        "splits")
    nl, h, s, d = 32, 32, 2304, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    for int8 in (False, True):
        name, elt = ("K4", 1) if int8 else ("K2", 2)
        if split:
            out[f"{name}_smem_bytes"] = fd.decode_smem_bytes(d, elt)
        for key, lengths in DECODE_LENGTHS.items():
            b = len(lengths)
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            q = torch.randn(b, h, 1, d, generator=gen, device=dev,
                            dtype=torch.bfloat16)
            if int8:
                def codes(*shape):
                    return torch.randint(-128, 128, shape, generator=gen,
                                         device=dev, dtype=torch.int8)

                def scales(*shape):
                    return torch.rand(shape, generator=gen,
                                      device=dev) * 0.025 + 0.005

                rows = (codes(b, h, 1, d), scales(b, h, 1),
                        codes(b, h, 1, d), scales(b, h, 1))
                caches = (codes(nl, b, h, s, d), codes(nl, b, h, s, d),
                          scales(nl, b, h, s), scales(nl, b, h, s))
                kernel = fd.fused_decode_attention_q_kernel
                deq = [[(kc[i].float() * ks[i][..., None]).bfloat16()
                        for i in (0, 1)]
                       for kc, ks in ((caches[0], caches[2]),
                                      (caches[1], caches[3]))]
            else:
                rows = tuple(torch.randn(b, h, 1, d, generator=gen,
                                         device=dev, dtype=torch.bfloat16)
                             for _ in range(2))
                caches = tuple(torch.randn(nl, b, h, s, d, generator=gen,
                                           device=dev, dtype=torch.bfloat16)
                               for _ in range(2))
                kernel = fd.fused_decode_attention_kernel
                deq = [list(caches[0]), list(caches[1])]
            turn = iter(range(10**9))  # another layer each call: from HBM

            def call(**kw):
                return kernel(q, *rows, *caches, lens, next(turn) % nl,
                              d ** -0.5, **kw)

            row = {"ms": c.cuda_ms(call)}
            row["bound_ms"], row["bound_by"] = c.decode_bound(lens, h, d,
                                                              elt)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["library_ms"] = c.cuda_ms(lambda: (lambda i: c.masked_sdpa(
                q, deq[0][i], deq[1][i], lens + 1))(next(turn) %
                                                    len(deq[0])))
            if split:
                row["splits"] = fd.decode_launch_splits(dev, b, h, s, d, elt)
                for cl in fd.SPLITS:
                    row[f"ms_c{cl}"] = c.cuda_ms(lambda: call(splits=cl))
            out[f"{name}_{key}"] = row
            if int8:
                # 5b on the same caches, block_s 512 and 96, every C
                dots = fd.fused_decode_attention_q_int8dots_kernel
                for block_s in (512, 96):
                    def dcall(**kw):
                        return dots(q, *rows, *caches, lens,
                                    next(turn) % nl, d ** -0.5, block_s,
                                    **kw)

                    drow = {"ms": c.cuda_ms(dcall),
                            "k4_ms": row["ms"],
                            "bound_ms": row["bound_ms"],
                            "library_ms": row["library_ms"]}
                    drow["share_of_bound"] = drow["bound_ms"] / drow["ms"]
                    if dots_split:
                        drow["splits"] = fd.int8dots_launch_splits(
                            dev, b, h, s, d, block_s)
                        for cl in fd.SPLITS:
                            drow[f"ms_c{cl}"] = c.cuda_ms(
                                lambda: dcall(splits=cl))
                    out[f"5b_{key}_block{block_s}"] = drow
            del caches, deq
            torch.cuda.empty_cache()
    if dots_split:
        out["5b_smem_bytes_block512_c2"] = fd.int8dots_smem_bytes(d, 512, 2)
    # the paged int8 kernel: DECODE_LENGTHS and chip_smoke's B8 case as
    # pages of 128, each beside K4 on the same lengths (B8: K4 timed here)
    if paged_split:
        out["paged_q_smem_bytes"] = fd.decode_smem_bytes(d, 1, paged=True)
    cases = dict(DECODE_LENGTHS, B8=list(c.PAGED_LENGTHS))
    for key, lengths in cases.items():
        b = len(lengths)
        args = _paged_pools(gen, dev, lengths, nl, h, s, d)
        turn = iter(range(10**9))

        def pcall(**kw):
            return pf.paged_fused_decode_q_kernel(
                *args[:-2], args[-2], args[-1], next(turn) % nl, d ** -0.5,
                **kw)

        row = {"ms": c.cuda_ms(pcall)}
        row["bound_ms"], row["bound_by"] = c.decode_bound(args[-1], h, d, 1)
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if paged_split:
            row["splits"] = fd.decode_launch_splits(dev, b, h, s, d, 1)
            for cl in fd.SPLITS:
                row[f"ms_c{cl}"] = c.cuda_ms(lambda: pcall(splits=cl))
        if key == "B8":
            cont = [pf._gather_pages(t[0], args[-2]) for t in args[5:9]]
            deq = [(cont[i].float() * cont[i + 2][..., None]).bfloat16()
                   for i in (0, 1)]
            row["library_ms"] = c.cuda_ms(lambda: c.masked_sdpa(
                args[0], deq[0], deq[1], args[-1] + 1))
            del cont, deq
            kc = torch.randint(-128, 128, (nl, b, h, s, d), generator=gen,
                               device=dev, dtype=torch.int8)
            vc = torch.randint_like(kc, -128, 128)
            ks = torch.rand(nl, b, h, s, generator=gen, device=dev) * 0.025
            vs = torch.rand_like(ks) * 0.025

            def k4call(**kw):
                return fd.fused_decode_attention_q_kernel(
                    *args[:5], kc, vc, ks, vs, args[-1], next(turn) % nl,
                    d ** -0.5, **kw)

            row["k4_ms"] = c.cuda_ms(k4call)
            if split:
                for cl in fd.SPLITS:
                    row[f"k4_ms_c{cl}"] = c.cuda_ms(
                        lambda: k4call(splits=cl))
            del kc, vc, ks, vs
        else:
            row["k4_ms"] = out[f"K4_{key}"]["ms"]
        out[f"paged_q_{key}"] = row
        del args
        torch.cuda.empty_cache()
    # the bf16 paged kernel (one CTA a head) at the B8 case
    args = _paged_pools(gen, dev, list(c.PAGED_LENGTHS), nl, h, s, d,
                        int8=False)
    turn = iter(range(10**9))
    row = {"ms": c.cuda_ms(lambda: pf.paged_fused_decode_kernel(
        *args, next(turn) % nl, d ** -0.5))}
    row["bound_ms"], row["bound_by"] = c.decode_bound(args[-1], h, d, 2)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    kv = [pf._gather_pages(t[0], args[-2]) for t in args[3:5]]
    row["library_ms"] = c.cuda_ms(lambda: c.masked_sdpa(
        args[0], kv[0], kv[1], args[-1] + 1))
    out["paged_bf16_B8"] = row
    return out


def _decode_step(dev, name, bits, lm8, cache_dtype, steps=20,
                 int8_dots=False):
    """One decode step at B = 1 from 2,192 filled rows of one of the
    bench's weight sets and cache dtypes: median host-clock ms of `steps`
    steps, each ended by a synchronize; the card's busy ms a step under
    torch.profiler and the decode attention kernel's share of it; and the
    launches a step of K3, the split-K epilogue kernel (the parent's, one
    per K3 call whose plan splits K), kernel A, K2 and K4 (with
    `int8_dots`, LHRS_DECODE_INT8_DOTS=1: the int8-dots kernel 5b's device
    ms, share and launches too). Keys start with `name`."""
    saved = os.environ.get("LHRS_DECODE_INT8_DOTS")
    os.environ["LHRS_DECODE_INT8_DOTS"] = "1" if int8_dots else "0"
    try:
        return _decode_step_run(dev, name, bits, lm8, cache_dtype, steps)
    finally:
        if saved is None:
            del os.environ["LHRS_DECODE_INT8_DOTS"]
        else:
            os.environ["LHRS_DECODE_INT8_DOTS"] = saved


def _decode_step_run(dev, name, bits, lm8, cache_dtype, steps):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lhrs_bot_tpu_torch import bench
    from lhrs_bot_tpu_torch.models import LlamaConfig, llama_decode_step
    from lhrs_bot_tpu_torch.ops import fused_decode as fd
    from lhrs_bot_tpu_torch.ops import w4_matmul as w4
    from lhrs_bot_tpu_torch.ops.ln_quant import ln_quant_kernel

    lcfg = LlamaConfig.llama2_7b()
    params = bench.make_decoder_params(lcfg, bits, lm8, device=dev)
    cache = bench.filled_cache(lcfg, 1, 2304, cache_dtype, device=dev)
    bench.decode_run(params, lcfg, cache, 2192, 4)  # warm-up
    cache.length.fill_(2192)
    tok = torch.zeros(1, dtype=torch.long, device=dev)

    def step():
        nonlocal cache, tok
        logits, cache = llama_decode_step(
            params, lcfg, cache,
            inputs_embeds=params["embed_tokens"][tok][:, None])
        tok = logits.argmax(dim=-1)

    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counters = (w4.w4a8_matmul_kernel, ln_quant_kernel,
                fd.fused_decode_attention_kernel,
                fd.fused_decode_attention_q_kernel,
                fd.fused_decode_attention_q_int8dots_kernel)
    for k in counters:
        k.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / 4
    attn = sum(e.self_device_time_total for e in events
               if "decode" in e.key and "int8dots" not in e.key) / 1e3 / 4
    dots = sum(e.self_device_time_total for e in events
               if "int8dots" in e.key) / 1e3 / 4
    k3 = w4.w4a8_matmul_kernel.launches / 4
    epilogue = 0.0
    if hasattr(w4, "split_k") and bits == "4h":  # the parent: one more
        split = sum(count for k, n, count in PROJECTIONS  # a split call
                    if w4.split_k(k // 2, n)[0] > 1)
        epilogue = k3 * split / 7
    del params, cache
    torch.cuda.empty_cache()
    return {f"{name}_step_host_ms": sorted(times)[len(times) // 2],
            f"{name}_step_busy_ms": busy,
            f"{name}_step_decode_attention_ms": attn,
            f"{name}_step_k3_launches": k3,
            f"{name}_step_epilogue_launches": epilogue,
            f"{name}_step_a_launches": ln_quant_kernel.launches / 4,
            f"{name}_step_k2_launches":
                fd.fused_decode_attention_kernel.launches / 4,
            f"{name}_step_k4_launches":
                fd.fused_decode_attention_q_kernel.launches / 4,
            f"{name}_step_5b_ms": dots,
            f"{name}_step_5b_share": dots / busy,
            f"{name}_step_5b_launches":
                fd.fused_decode_attention_q_int8dots_kernel.launches / 4}


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


def _e2e(dev, train=True):
    import numpy as np
    import torch

    import chip_smoke as c
    from lhrs_bot_tpu_torch import bench
    from lhrs_bot_tpu_torch.core import build_engine, build_trainer, eval_config
    from lhrs_bot_tpu_torch.core.config import load_yaml_config
    from lhrs_bot_tpu_torch.models import (LlamaConfig, VLMConfig,
                                           init_vlm_params)
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    out = dict(bench.bench_prefill(VLMConfig(), device=dev))
    torch.cuda.empty_cache()
    out.update({f"{k}_336": v for k, v in bench.bench_prefill(
        vlm_336(), device=dev).items()})
    torch.cuda.empty_cache()
    out.update(bench.bench_decode(
        LlamaConfig.llama2_7b(), device=dev,
        cells=[cell for cell in bench.decode_cells()
               if cell[0] in DECODE_CELLS]))
    out.update(_decode_step(dev, "w4a8", "4h", True, torch.int8))
    out.update(_decode_step(dev, "w4a8_int8dots", "4h", True, torch.int8,
                            int8_dots=True))
    out.update(_decode_step(dev, "bf16cache", 8, False, torch.bfloat16))
    if not train:
        return out
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


def vlm_336():
    """The VLM configuration with ViT-L/14 at 336 px (577 tokens) and the
    perceiver over its 576 image tokens a group."""
    return vlm_at(336)


def vlm_504():
    """The VLM configuration with ViT-L/14 at 504 px (1,297 tokens) and the
    perceiver over its 1,296 image tokens a group."""
    return vlm_at(504)


def vlm_at(size):
    """The VLM configuration with ViT-L/14 at `size` px and the perceiver
    over its image tokens a group."""
    import dataclasses

    from lhrs_bot_tpu_torch.models import VLMConfig

    base = VLMConfig()
    n = (size // base.vit.patch_size) ** 2
    return dataclasses.replace(
        base, vit=dataclasses.replace(base.vit, image_size=size),
        pooler=dataclasses.replace(base.pooler, split_part=(n,) * 3))


def _towers(dev, repeats):
    """The bench's three tower cells (`bench.bench_prefill`, B = 64)
    `repeats` times, and the fused ViT-L block at B8 and the fused
    perceiver block (2 images, 3 groups) as chip_smoke.py's vision phase
    times them, `repeats` times each: so that two checkouts run in turns
    resolve a few percent on the fused tower cell."""
    import torch

    import chip_smoke as c
    from lhrs_bot_tpu_torch import bench
    from lhrs_bot_tpu_torch.models import VLMConfig
    from lhrs_bot_tpu_torch.ops.perceiver_block import (
        fused_perceiver_block, pack_perceiver_layers_fused)
    from lhrs_bot_tpu_torch.ops.vit_block import (fused_vit_block,
                                                  pack_vit_layers_fused)

    out = {}
    for _ in range(repeats):
        for key, value in bench.bench_prefill(VLMConfig(), device=dev).items():
            out.setdefault(key, []).append(value)
        torch.cuda.empty_cache()
        for key, value in bench.bench_prefill(vlm_336(), device=dev).items():
            out.setdefault(f"{key}_336", []).append(value)
        torch.cuda.empty_cache()
        for key, value in bench.bench_prefill(vlm_504(), device=dev,
                                              iters=5).items():
            out.setdefault(f"{key}_504", []).append(value)
        torch.cuda.empty_cache()
    # the blocks' inputs as phase_vision_kernels builds them (an older
    # checkout's chip_smoke.py has no helper to share)
    gen = torch.Generator(device=dev).manual_seed(0)
    w, s, s_pad = c.VIT_W, c.VIT_S, c.VIT_S_PAD
    lp = {k: v[0] for k, v in pack_vit_layers_fused(
        c.vit_layers(dev, 1, seed=4)).items()}
    x = torch.zeros(8, s_pad, w, device=dev, dtype=torch.bfloat16)
    x[:, :s] = torch.randn(8, s, w, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    players = c.vit_layers(dev, 1, seed=5)
    players["ln_kv_scale"] = players["ln1_scale"] * 0.9 + 0.1
    players["ln_kv_bias"] = players["ln1_bias"] * -1
    plp = {k: v[0] for k, v in pack_perceiver_layers_fused(players).items()}
    nq, q_pad, kv_pad = (64, 48, 32), 64, 64 + 256
    q = torch.zeros(2, 3, q_pad, w, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(2, 3, kv_pad, w, device=dev, dtype=torch.bfloat16)
    for gi, n in enumerate(nq):
        q[:, gi, :n] = torch.randn(2, n, w, generator=gen, device=dev,
                                   dtype=torch.bfloat16)
        kv[:, gi, :n] = q[:, gi, :n]
        kv[:, gi, q_pad:] = torch.randn(2, 256, w, generator=gen, device=dev,
                                        dtype=torch.bfloat16)
    kw = dict(heads=16, group_nq=nq, kv_valid=tuple(n + 256 for n in nq))
    for _ in range(repeats):
        out.setdefault("fused_vit_block_b8_ms", []).append(c.cuda_ms(
            lambda: fused_vit_block(x, lp, heads=16, s_valid=s, group=8),
            reps=5))
        out.setdefault("fused_perceiver_block_ms", []).append(c.cuda_ms(
            lambda: fused_perceiver_block(q, kv, plp, **kw), reps=5))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="checkout whose lhrs_bot_tpu_torch is measured")
    ap.add_argument("--part", choices=("kernels", "norm", "quant", "decode",
                                       "e2e", "probes"),
                    required=True)
    ap.add_argument("--no-train", action="store_true",
                    help="e2e: leave out the prefill and the training steps")
    ap.add_argument("--towers-only", type=int, default=0, metavar="N",
                    help="e2e: only the three tower cells and the fused "
                    "ViT / perceiver blocks, N times each")
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
    if args.part == "kernels":
        res = _kernels(dev)
    elif args.part == "norm":
        res = _norm(dev)
    elif args.part == "quant":
        res = _quant(dev)
    elif args.part == "decode":
        res = _decode(dev)
    elif args.part == "probes":
        res = _probes(dev)
    elif args.towers_only:
        res = _towers(dev, args.towers_only)
    else:
        res = _e2e(dev, train=not args.no_train)
    line = {"root": args.root, "part": args.part, "result": res,
            "seconds": time.time() - t0, "device": c.smi_line()}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
