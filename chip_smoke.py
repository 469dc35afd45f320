#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lhrs_bot_tpu_torch) on one CUDA card.

Run from the root of a checkout, with one H100 visible:

    python3 chip_smoke.py

Phases, one or more lines each:
  1. device: torch/CUDA versions, the card, its power limit;
  2. build: compile the CUDA kernels from lhrs_bot_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (plus ragged/masked edge cases), with times;
     The vision kernels too: kernel A (LayerNorm + row quantization) and
     kernel B (int8 GEMM, int32 accumulators bit for bit) at the W8A8
     tower's shapes, the fused ViT block (B = 1 and 8), its split form and
     the fused perceiver block against their plain versions, and the fused
     W8A8 tower at full depth against the bf16 tower, with a planted fault;
  4. slices: the serving paths at full width (ViT-L/14, 144-query 6-layer
     perceiver, LLaMA-2-7B, one set of seeded random bf16 weights) through
     build_engine + GenerationEngine.generate: bf16 (three requests), the
     quantized recipe of W4A8 weights, int8 lm_head and int8 KV cache
     (three requests, B up to 7), int8 weights with the int8 cache and, by
     default on the card, the fused W8A8 vision tower and W8A8 perceiver
     (two requests, B 1 and 8), NF4 weights with the int8 cache (one
     request); for each path the kernels' launch counts, and for bf16 and
     W4A8 a prefill/decode consistency check with planted faults.
Then a JSON line with per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Any failure raises: the script
exits non-zero and prints no result. It needs no network and imports nothing
of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# K1/K2/K4 against their plain versions: bf16 kernel output vs the plain
# version in float32 on the same inputs. bf16 output rounding is 2^-9
# relative and the kernels round probabilities (K4: probabilities times
# the value scales, and q * sm_scale) to bf16 before the products, so 1e-2
# absolute + 1e-2 relative bounds a correct kernel while any indexing or
# masking fault shows as O(1). K3 is integer arithmetic and is held to its
# plain version bit for bit.
ATOL = RTOL = 1e-2
# prefill(P + [t]) vs prefill(P) + decode_step(t) at full width in bf16:
# relative L2 of the logits. Seeded random 7B weights amplify bf16 rounding
# (chip_profile.py measures the same check with the plain attention in bf16
# and in float32, where it is about 1e-5: the two paths compute the same
# function). The bound sits above the bf16 noise through the kernels
# (0.049-0.050 on an H100 at 700 W) and below every planted fault of FAULTS
# (1.09-1.40 there); each run requires the faults to exceed it, so every run
# shows that the check can fail.
CONSISTENCY_REL_L2 = 0.15
# The same check through the W4A8 + int8-KV engine: its decode side runs
# per-token int8 activations and the int8 cache, its prefill side bf16
# activations on fresh K/V, so its noise sits above the bf16 path's. On an
# H100 at 700 W the noise read 0.233-0.234 and the planted faults
# 1.15-1.42; the bound sits between, about 2.5x above the noise and 1.9x
# below the smallest fault.
CONSISTENCY_REL_L2_W4A8 = 0.6


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, reps=20, rounds=3):
    """Device time of one call, from CUDA events: the median over `rounds`
    of a run of `reps` calls divided by `reps`. Each run is queued behind a
    20 ms spin of the card, so the calls run back to back on the device
    and the host's enqueue time (tens of microseconds a call) stays out of
    the reading."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40_000_000)  # about 20 ms at the H100's clock
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check_close(name, got, ref, valid_rows=None):
    """Max abs error of got vs ref (float32), raising past ATOL + RTOL."""
    got, ref = got.float(), ref.float()
    if valid_rows is not None:
        got, ref = got[valid_rows], ref[valid_rows]
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > ATOL + RTOL * ref.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"abs err {float(err.max()):.3e}")
    return float(err.max())


# decode steps with a planted fault: the cache length the step is given,
# from the true one. One row early overwrites the last prompt row and
# rotates q and k one position back; one row late reads a stale row.
FAULTS = {"one row early": lambda n: n - 1,
          "one row late": lambda n: n + 1,
          "cache ignored": lambda n: n * 0}


def decode_vs_prefill(lp, lcfg, dev, dtype, cache_dtype=None):
    """The logits of prefill(P) then decode_step(t), of prefill(P + [t]),
    and of decode_step(t) with each planted fault of FAULTS (each on a copy
    of the prefilled cache). Two rows, P of 600 and 451 tokens; the cache
    in `cache_dtype` (default: dtype)."""
    import dataclasses

    import torch

    from lhrs_bot_tpu_torch.models import (KVCache, llama_decode_step,
                                           llama_prefill)

    rng = np.random.default_rng(1)
    plen = torch.tensor([600, 451], dtype=torch.int32, device=dev)
    ids = torch.as_tensor(rng.integers(3, lcfg.vocab_size, (2, 601)),
                          device=dev)
    ids[:, 0] = lcfg.bos_token_id
    embed = lp["embed_tokens"]
    cache_dtype = cache_dtype or dtype
    cache = KVCache.create(lcfg, 2, 1024, cache_dtype, dev)
    logits_p, cache = llama_prefill(lp, lcfg, cache, inputs_embeds=embed[ids],
                                    prompt_len=plen, compute_dtype=dtype)
    tok = logits_p.argmax(dim=-1)
    step = embed[tok][:, None]
    faulty = {}
    for name, length in FAULTS.items():
        bad = dataclasses.replace(
            cache, length=length(cache.length),
            **{f: getattr(cache, f).clone() for f in
               ("k", "v", "k_scale", "v_scale")
               if getattr(cache, f) is not None})
        faulty[name], _ = llama_decode_step(lp, lcfg, bad, inputs_embeds=step,
                                            compute_dtype=dtype)
        del bad
    logits_d, _ = llama_decode_step(lp, lcfg, cache, inputs_embeds=step,
                                    compute_dtype=dtype)
    ids[torch.arange(2, device=dev), plen.long()] = tok
    cache = KVCache.create(lcfg, 2, 1024, cache_dtype, dev)
    logits_f, _ = llama_prefill(lp, lcfg, cache, inputs_embeds=embed[ids],
                                prompt_len=plen + 1, compute_dtype=dtype)
    for name, t in (("decode", logits_d), ("prefill", logits_f)):
        if not bool(t.isfinite().all()):
            raise AssertionError(f"non-finite {name} logits")
    return logits_d, logits_f, faulty


def rel_l2(a, ref):
    """Relative L2 distance of each row of a from ref, as a list."""
    return ((a - ref).norm(dim=-1) / ref.norm(dim=-1)).tolist()


def phase_kernels(dev):
    import torch

    from lhrs_bot_tpu_torch.ops.attention import (flash_attention_fwd,
                                                  mha_reference)
    from lhrs_bot_tpu_torch.ops.fused_decode import (
        fused_decode_attention_kernel, fused_decode_attention_plain)

    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    # (name, B, H, Sq, Skv, D, causal, masked): main-path shapes first
    cases = [
        ("vit", 2, 16, 257, 257, 64, False, False),
        ("perceiver_g0", 2, 16, 64, 320, 64, False, False),
        ("perceiver_g1", 2, 16, 48, 304, 64, False, False),
        ("perceiver_g2", 2, 16, 32, 288, 64, False, False),
        ("prefill", 1, 32, 2191, 2191, 128, True, False),
        ("prefill_b2", 2, 32, 463, 463, 128, True, False),
        ("edge_mask_d128", 2, 4, 77, 133, 128, False, True),
        ("edge_mask_d64", 3, 2, 65, 200, 64, False, True),
        ("edge_causal_rect", 1, 4, 100, 150, 64, True, False),
        ("edge_causal_tail", 2, 2, 130, 130, 128, True, False),
    ]
    k1 = {"max_abs_err": 0.0}
    for name, b, h, sq, skv, d, causal, masked in cases:
        q, k, v = randn(b, h, sq, d), randn(b, h, skv, d), randn(b, h, skv, d)
        mask = None
        valid = None
        if masked:
            mask = torch.rand(b, skv, generator=gen, device=dev) > 0.3
            mask[-1] = False  # a row with no valid key must give exactly 0
            valid = mask.any(dim=1)
        scale = d ** -0.5
        out = flash_attention_fwd(q, k, v, mask, causal, scale)
        ref = mha_reference(q.float(), k.float(), v.float(), mask,
                            causal=causal, sm_scale=scale)
        torch.cuda.synchronize()
        err = check_close(f"K1 {name}", out, ref, valid)
        if valid is not None and bool((out[~valid] != 0).any()):
            raise AssertionError(f"K1 {name}: fully masked rows are not 0")
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        line = f"  K1 {name}: q{(b, h, sq, d)} kv {skv} causal={causal} " \
               f"mask={masked}: max_abs_err {err:.3e}"
        if name in ("vit", "perceiver_g0", "prefill"):
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask, causal,
                                                     scale))
            plain = cuda_ms(lambda: mha_reference(q, k, v, mask,
                                                  causal=causal,
                                                  sm_scale=scale))
            line += f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
            if name == "prefill":
                k1["ms"], k1["plain_ms"] = ms, plain
        log(line)

    # K2 at the decode shape: L32 B2 H32 S2304 D128
    nl, b, h, s, d = 32, 2, 32, 2304, 128
    kc, vc = randn(nl, b, h, s, d), randn(nl, b, h, s, d)
    lengths = torch.tensor([2191, 700], dtype=torch.int32, device=dev)
    q, kn, vn = randn(b, h, 1, d), randn(b, h, 1, d), randn(b, h, 1, d)
    scale = d ** -0.5
    k2 = {"max_abs_err": 0.0}
    for layer in (0, 31):
        kck, vck = kc.clone(), vc.clone()
        out, _, _ = fused_decode_attention_kernel(q, kn, vn, kck, vck,
                                                  lengths, layer, scale)
        kcp, vcp = kc.float(), vc.float()
        ref, _, _ = fused_decode_attention_plain(
            q.float(), kn.float(), vn.float(), kcp, vcp, lengths, layer,
            sm_scale=scale)
        torch.cuda.synchronize()
        err = check_close(f"K2 layer {layer}", out, ref)
        # the appended rows and every other row: exactly equal
        if not (torch.equal(kck.float(), kcp) and torch.equal(vck.float(),
                                                              vcp)):
            raise AssertionError(f"K2 layer {layer}: cache differs from the "
                                 "plain version's")
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        del kcp, vcp
        log(f"  K2 layer {layer}: cache {(nl, b, h, s, d)} lengths "
            f"{lengths.tolist()}: max_abs_err {err:.3e}, caches exact")
    # each timed call reads another layer: the cache comes from device
    # memory, as in decode, not from the 50 MB L2
    turn = iter(range(10**9))
    k2["ms"] = cuda_ms(lambda: fused_decode_attention_kernel(
        q, kn, vn, kck, vck, lengths, next(turn) % nl, scale))
    k2["plain_ms"] = cuda_ms(lambda: fused_decode_attention_plain(
        q, kn, vn, kck, vck, lengths, next(turn) % nl, sm_scale=scale))
    log(f"  K2 time per layer call: kernel {k2['ms']:.4f} ms, plain "
        f"{k2['plain_ms']:.4f} ms")
    del kc, vc, kck, vck
    torch.cuda.empty_cache()
    return k1, k2


def phase_quant_kernels(dev):
    """K3 (W4A8 matmul) and K4 (int8-cache fused decode) against their plain
    versions at the quantized decode path's shapes."""
    import torch

    from lhrs_bot_tpu_torch.ops.fused_decode import (
        fused_decode_attention_q_kernel, fused_decode_attention_q_plain)
    from lhrs_bot_tpu_torch.ops.w4_matmul import (w4a8_matmul_kernel,
                                                  w4a8_matmul_plain)

    gen = torch.Generator(device=dev).manual_seed(2)

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape, lo=0.005, hi=0.03):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    # K3: a 32-layer stack of each LLaMA-2-7B projection shape; the kernel
    # must equal its plain version bit for bit
    nl = 32
    k3 = {"max_abs_err": 0.0, "shapes": []}
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
        w, ws = codes(nl, k // 2, n), scales(nl, 1, n, lo=1e-3, hi=5e-3)
        for b in (1, 7):
            # the halves of one (B, K) activation, as w4a8_project passes
            xq, xs = codes(b, k), scales(b, 1)
            xlo, xhi = xq[:, :k // 2], xq[:, k // 2:]
            for layer in (0, 31):
                got = w4a8_matmul_kernel(xlo, xhi, xs, w, ws, layer)
                ref = w4a8_matmul_plain(xlo, xhi, xs, w, ws, layer)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    err = float((got.float() - ref.float()).abs().max())
                    raise AssertionError(
                        f"K3 K{k} N{n} B{b} layer {layer}: differs from the "
                        f"plain version, max abs err {err:.3e}")
            # each timed call reads another layer: the weights come from
            # device memory, as in decode, not from the 50 MB L2
            turn = iter(range(10**9))
            ms = cuda_ms(lambda: w4a8_matmul_kernel(
                xlo, xhi, xs, w, ws, next(turn) % nl))
            plain = cuda_ms(lambda: w4a8_matmul_plain(
                xlo, xhi, xs, w, ws, next(turn) % nl))
            gbs = k // 2 * n / ms / 1e6
            k3["shapes"].append({"K": k, "N": n, "B": b, "ms": ms,
                                 "plain_ms": plain, "GB_s": gbs})
            log(f"  K3 K{k} N{n} B{b}, layers 0/31: bit-identical; kernel "
                f"{ms:.4f} ms ({gbs:.0f} GB/s), plain {plain:.4f} ms")
        del w, ws
    main = next(r for r in k3["shapes"]
                if (r["K"], r["N"], r["B"]) == (4096, 11008, 1))
    k3["ms"], k3["plain_ms"] = main["ms"], main["plain_ms"]

    # K4 at the decode shape: L32 H32 S2304 D128, B2 and B7
    h, s, d = 32, 2304, 128
    scale = d ** -0.5
    k4 = {"max_abs_err": 0.0}
    for lengths in ([2191, 700], [2192, 5, 1000, 2303, 63, 1500, 2000]):
        b = len(lengths)
        kc, vc = codes(nl, b, h, s, d), codes(nl, b, h, s, d)
        ks, vs = scales(nl, b, h, s), scales(nl, b, h, s)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q = torch.randn(b, h, 1, d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        kn, vn = codes(b, h, 1, d), codes(b, h, 1, d)
        kns, vns = scales(b, h, 1), scales(b, h, 1)
        for layer in (0, 31):
            mine = [t.clone() for t in (kc, vc, ks, vs)]
            out = fused_decode_attention_q_kernel(
                q, kn, kns, vn, vns, *mine, lens, layer, scale)[0]
            plain = [t.clone() for t in (kc, vc, ks, vs)]
            ref = fused_decode_attention_q_plain(
                q.float(), kn, kns, vn, vns, *plain, lens, layer,
                sm_scale=scale)[0]
            torch.cuda.synchronize()
            err = check_close(f"K4 B{b} layer {layer}", out, ref)
            # the appended rows and scales and every other row: exact
            if not all(torch.equal(a, c) for a, c in zip(mine, plain)):
                raise AssertionError(f"K4 B{b} layer {layer}: cache or "
                                     "scales differ from the plain version's")
            k4["max_abs_err"] = max(k4["max_abs_err"], err)
            log(f"  K4 cache {(nl, b, h, s, d)} lengths {lengths}, layer "
                f"{layer}: max_abs_err {err:.3e}, caches and scales exact")
            del mine, plain
        if b == 2:
            turn = iter(range(10**9))
            k4["ms"] = cuda_ms(lambda: fused_decode_attention_q_kernel(
                q, kn, kns, vn, vns, kc, vc, ks, vs, lens, next(turn) % nl,
                scale))
            k4["plain_ms"] = cuda_ms(lambda: fused_decode_attention_q_plain(
                q, kn, kns, vn, vns, kc, vc, ks, vs, lens, next(turn) % nl,
                sm_scale=scale))
            log(f"  K4 time per layer call (B2): kernel {k4['ms']:.4f} ms, "
                f"plain {k4['plain_ms']:.4f} ms")
        del kc, vc, ks, vs
    # a row with no room for the append: nothing written, NaN out
    kc, vc = codes(1, 2, 2, 64, d), codes(1, 2, 2, 64, d)
    ks, vs = scales(1, 2, 2, 64), scales(1, 2, 2, 64)
    before = [t.clone() for t in (kc, vc, ks, vs)]
    lens = torch.tensor([64, 3], dtype=torch.int32, device=dev)
    q = torch.randn(2, 2, 1, d, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    out = fused_decode_attention_q_kernel(
        q, codes(2, 2, 1, d), scales(2, 2, 1), codes(2, 2, 1, d),
        scales(2, 2, 1), kc, vc, ks, vs, lens, 0, scale)[0]
    torch.cuda.synchronize()
    if not (bool(out[0].isnan().all()) and bool(out[1].isfinite().all())
            and all(torch.equal(a[:, 0], c[:, 0])
                    for a, c in zip((kc, vc, ks, vs), before))):
        raise AssertionError("K4: a full row must write nothing and give NaN")
    log("  K4 full row (lengths[b] == S): nothing written, NaN out")
    torch.cuda.empty_cache()
    return k3, k4


VIT_W, VIT_S, VIT_S_PAD = 1024, 257, 272
# (K, N) of the vision tower's int8 projections: QKV, O (and the
# perceiver's q), FC, proj, and the perceiver's fused K|V
GEMM_SHAPES = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
               (1024, 2048))
# Kernel B's epilogues against their plain versions: each element within
# BLOCK_TOL of max|plain| plus one bf16 rounding step of its own size (2^-8
# |plain|: a last-bit difference before the output's rounding to bf16 may
# land it one step away). The accumulators are exact on both sides; what
# differs is the last bits of the float32 GELUs. An indexing fault gives
# O(1). BLOCK_TOL is the JAX package's own grouped-vs-ungrouped bound
# (tests/test_ops.py:442).
BLOCK_TOL = 5e-3
# The fused blocks (A, B and K1 composed) against their plain versions:
# relative L2 within FUSED_REL_L2 and each element within FUSED_TOL of
# max|plain| plus one bf16 step. Here K1 rounds the unnormalised
# probabilities to bf16 where the plain attention rounds the normalised
# ones, and the block's int8 activation quantization turns that 1.4e-3
# relative L2 at the attention output into about 4.4e-3 at the block's
# output: on an H100 at 700 W the plain attention and K1 sat equally far
# from an attention with float32 probabilities, 4.2e-3 each at the block's
# output, and the blocks read 4.7-6.0e-3 relative L2 and elements within
# 7.5e-3 of max|plain| against their plain versions. The bounds sit about
# 2x above (PERF.md has the readings).
FUSED_REL_L2 = 1e-2
FUSED_TOL = 1.5e-2
# The fused W8A8 tower against the bf16 tower at full depth (22 blocks),
# relative L2 of the (B, 768, 1024) features: int8 noise read 0.028 on an
# H100 at 700 W, and the planted fault, one block skipped, 0.39; the fault
# must exceed the bound in every run.
TOWER_REL_L2 = 0.08


def vit_layers(dev, n_layers, seed):
    """Seeded random stacked ViT-L layers in float32: weights N(0, 0.02),
    LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.02)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=0.02, mean=0.0):
        return torch.randn((n_layers,) + shape, generator=gen,
                           device=dev) * scale + mean

    w, f = VIT_W, 4 * VIT_W
    return {"ln1_scale": rand(w, scale=0.1, mean=1.0), "ln1_bias": rand(w),
            "wq": rand(w, w), "bq": rand(w), "wk": rand(w, w), "bk": rand(w),
            "wv": rand(w, w), "bv": rand(w), "wo": rand(w, w), "bo": rand(w),
            "ln2_scale": rand(w, scale=0.1, mean=1.0), "ln2_bias": rand(w),
            "w_fc": rand(w, f), "b_fc": rand(f), "w_proj": rand(f, w),
            "b_proj": rand(w)}


def check_block(name, got, ref, tol=BLOCK_TOL, rel_l2=None):
    """got vs ref elementwise within tol * max|ref| + 2^-8 |ref|, and within
    `rel_l2` relative L2 when given, raising past either; returns the max
    abs error."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    top = float(ref.abs().max())
    bad = err > tol * top + ref.abs() * 2.0 ** -8
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max "
                             f"abs err {float(err.max()):.3e} (max|plain| "
                             f"{top:.3e})")
    rel = float((got - ref).norm() / ref.norm())
    if rel_l2 is not None and rel > rel_l2:
        raise AssertionError(f"{name}: relative L2 {rel:.3e} > {rel_l2}")
    return float(err.max())


def check_fused(name, got, ref):
    return check_block(name, got, ref, FUSED_TOL, FUSED_REL_L2)


def phase_vision_kernels(dev):
    """Kernel A (LayerNorm + row quantization) and kernel B (int8 GEMM)
    against their plain versions at the W8A8 vision tower's shapes, then
    the fused ViT block (B = 1 and 8), its split form and the fused
    perceiver block at ViT-L / perceiver width against their plain
    versions, with times."""
    import torch

    from lhrs_bot_tpu_torch.ops.int8_gemm import (int8_gemm_kernel,
                                                  int8_gemm_plain)
    from lhrs_bot_tpu_torch.ops.ln_quant import (ln_quant_kernel,
                                                 ln_quant_plain)
    from lhrs_bot_tpu_torch.ops.perceiver_block import (
        fused_perceiver_block, fused_perceiver_block_plain,
        pack_perceiver_layers_fused)
    from lhrs_bot_tpu_torch.ops.quant import transposed_storage
    from lhrs_bot_tpu_torch.ops.vit_block import (
        _heads, attend_token_major, fused_vit_block, fused_vit_block_plain,
        fused_vit_post, fused_vit_post_plain, fused_vit_qkv,
        fused_vit_qkv_plain, pack_vit_layers_fused)

    gen = torch.Generator(device=dev).manual_seed(3)
    m_big = 64 * VIT_S
    out = {}

    # -- kernel A -------------------------------------------------------------
    ka = {"max_abs_err": 0.0}
    for w, dtype in ((VIT_W, torch.bfloat16), (4 * VIT_W, torch.float32),
                     (11008, torch.bfloat16)):
        x = torch.randn(m_big, w, generator=gen, device=dev).to(dtype)
        x[1] = 0  # amax 0: scale 1, codes 0
        x[2, 5] = 50.0  # an outlier row
        q, s = ln_quant_kernel(x)
        qp, sp = ln_quant_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(q, qp) and torch.equal(s, sp)):
            raise AssertionError(
                f"A quantize-only W{w} {dtype}: {int((q != qp).sum())} codes "
                f"and {int((s != sp).sum())} scales differ from the plain "
                "version")
        log(f"  A quantize-only ({m_big}, {w}) {dtype}: codes and scales "
            "equal")
    x = torch.randn(m_big, VIT_W, generator=gen, device=dev,
                    dtype=torch.bfloat16) * 2 + 0.3
    g = torch.rand(VIT_W, generator=gen, device=dev) + 0.5
    b = torch.randn(VIT_W, generator=gen, device=dev) * 0.1
    q, s = ln_quant_kernel(x, g, b, 1e-5)
    qp, sp = ln_quant_plain(x, g, b, 1e-5)
    torch.cuda.synchronize()
    code_diff = (q.int() - qp.int()).abs()
    s_rel = float(((s - sp).abs() / sp).max())
    share = float((code_diff > 0).float().mean())
    if int(code_diff.max()) > 1 or share > 1e-3 or s_rel > 1e-5:
        raise AssertionError(f"A LayerNorm: codes off by up to "
                             f"{int(code_diff.max())} ({share:.2e} of them), "
                             f"scales by {s_rel:.2e} relative")
    # dequantized, the LayerNorm mode's error is that of one code at most
    ka["max_abs_err"] = float((q.float() * s - qp.float() * sp).abs().max())
    log(f"  A LayerNorm ({m_big}, {VIT_W}) bf16: codes within one "
        f"({share:.2e} differ), scales within {s_rel:.2e} relative, "
        f"dequantized max abs err {ka['max_abs_err']:.3e}")
    ka["ms"] = cuda_ms(lambda: ln_quant_kernel(x, g, b, 1e-5))
    ka["plain_ms"] = cuda_ms(lambda: ln_quant_plain(x, g, b, 1e-5))
    log(f"  A time, LN1 of 64 images ({m_big}, {VIT_W}): kernel "
        f"{ka['ms']:.4f} ms, plain {ka['plain_ms']:.4f} ms")
    out["A"] = ka

    # -- kernel B: int32 accumulators exact, then each epilogue ----------------
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    kb = {"max_abs_err": 0.0, "shapes": []}
    for k, n in GEMM_SHAPES:
        w = transposed_storage(codes(k, n))
        ws = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        for m in (VIT_S, m_big):
            a = codes(m, k)
            xs = torch.rand(m, 1, generator=gen, device=dev) * 0.02 + 1e-3
            acc = int8_gemm_kernel(a, xs, w, ws, out_dtype=torch.int32)
            ref = int8_gemm_plain(a, xs, w, ws, out_dtype=torch.int32)
            torch.cuda.synchronize()
            if not torch.equal(acc, ref):
                bad = int((acc != ref).sum())
                raise AssertionError(f"B K{k} N{n} M{m}: {bad} int32 "
                                     "accumulators differ from the plain "
                                     "product")
        ms = cuda_ms(lambda: int8_gemm_kernel(a, xs, w, ws))
        plain = cuda_ms(lambda: int8_gemm_plain(a, xs, w, ws))
        tops = 2 * m_big * n * k / ms / 1e9
        kb["shapes"].append({"K": k, "N": n, "M": m_big, "ms": ms,
                             "plain_ms": plain, "TOPS": tops})
        log(f"  B K{k} N{n}, M {VIT_S} and {m_big}: int32 accumulators "
            f"bit-identical; bf16 out at M {m_big}: kernel {ms:.4f} ms "
            f"({tops:.0f} TOPS), plain {plain:.4f} ms")
    # epilogues at the FC shape (M 64 * 257, K 1024, N 4096)
    k, n = VIT_W, 4 * VIT_W
    a, w = codes(m_big, k), transposed_storage(codes(k, n))
    xs = torch.rand(m_big, 1, generator=gen, device=dev) * 0.02 + 1e-3
    ws = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
    bias = torch.randn(n, generator=gen, device=dev) * 0.1
    res16 = torch.randn(m_big, n, generator=gen, device=dev,
                        dtype=torch.bfloat16)
    res32 = torch.randn(m_big, n, generator=gen, device=dev)
    epilogues = {
        "QKV: ws-first, q fold, bf16": dict(
            bias=bias, ws_first=True, q_fold=0.125, n_fold=n // 3),
        "O: bf16 residual -> f32": dict(bias=bias, residual=res16,
                                        out_dtype=torch.float32),
        "FC: QuickGELU -> f32": dict(bias=bias, act="quick_gelu",
                                     out_dtype=torch.float32),
        "proj: f32 residual -> bf16": dict(bias=bias, residual=res32),
        "XLA W8A8: round, bias, erf GELU": dict(bias=bias, round_mid=True,
                                                act="gelu"),
        "perceiver q: ws-first, out_mult": dict(bias=bias, ws_first=True,
                                                out_mult=0.125),
        "perceiver FC: tanh GELU -> f32": dict(bias=bias, act="gelu_tanh",
                                               out_dtype=torch.float32),
    }
    for name, kw in epilogues.items():
        got = int8_gemm_kernel(a, xs, w, ws, **kw)
        ref = int8_gemm_plain(a, xs, w, ws, **kw)
        torch.cuda.synchronize()
        err = check_block(f"B epilogue {name}", got, ref)
        kb["max_abs_err"] = max(kb["max_abs_err"], err)
        log(f"  B epilogue {name}: max abs err {err:.3e}")
    fc = epilogues["FC: QuickGELU -> f32"]
    kb["ms"] = cuda_ms(lambda: int8_gemm_kernel(a, xs, w, ws, **fc))
    kb["plain_ms"] = cuda_ms(lambda: int8_gemm_plain(a, xs, w, ws, **fc))
    log(f"  B time, FC + QuickGELU of 64 images ({m_big} x {k} x {n}): "
        f"kernel {kb['ms']:.4f} ms, plain {kb['plain_ms']:.4f} ms")
    del a, w, res16, res32
    out["B"] = kb

    # -- K1 as the blocks launch it: Q, K and V strided views of one (B, S,
    # 3W) projection, pad keys masked, float32 output written token-major
    qkv = torch.randn(8, VIT_S_PAD, 3 * VIT_W, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    mask = (torch.arange(VIT_S_PAD, device=dev) < VIT_S).expand(
        8, VIT_S_PAD).contiguous()
    q, k, v = _heads(qkv, 3, 16)
    got = attend_token_major(q, k, v, mask, 0.125, torch.float32)
    ref = attend_token_major(q, k, v, mask, 0.125, torch.float32, plain=True)
    torch.cuda.synchronize()
    err = check_close("K1 strided, float32 out", got, ref)
    log(f"  K1 as the blocks launch it (strided QKV views, 8 x {VIT_S_PAD} "
        f"tokens, {VIT_S} valid keys, float32 token-major out): max abs err "
        f"{err:.3e}")
    del qkv, q, k, v

    # -- the fused blocks against their plain versions --------------------------
    lp = {k: v[0] for k, v in pack_vit_layers_fused(
        vit_layers(dev, 1, seed=4)).items()}
    blocks = {}
    for nb in (1, 8):
        x = torch.zeros(nb, VIT_S_PAD, VIT_W, device=dev, dtype=torch.bfloat16)
        x[:, :VIT_S] = torch.randn(nb, VIT_S, VIT_W, generator=gen,
                                   device=dev, dtype=torch.bfloat16)
        kw = dict(heads=16, s_valid=VIT_S, group=8)
        got = fused_vit_block(x, lp, **kw)
        ref = fused_vit_block_plain(x, lp, **kw)
        torch.cuda.synchronize()
        err = check_fused(f"fused_vit_block B{nb}", got, ref)
        ms = cuda_ms(lambda: fused_vit_block(x, lp, **kw), reps=5)
        plain = cuda_ms(lambda: fused_vit_block_plain(x, lp, **kw), reps=5)
        blocks[f"fused_vit_block_b{nb}"] = {"max_abs_err": err, "ms": ms,
                                            "plain_ms": plain}
        log(f"  fused_vit_block B{nb} (S_pad {VIT_S_PAD}): max abs err "
            f"{err:.3e}; kernels {ms:.4f} ms, plain {plain:.4f} ms")
    xg = x.reshape(1, 8 * VIT_S_PAD, VIT_W)
    got = fused_vit_qkv(xg, lp)
    err_q = check_fused("fused_vit_qkv", got,
                        fused_vit_qkv_plain(xg, lp))
    attn = torch.randn(xg.shape, generator=gen, device=dev,
                       dtype=torch.bfloat16) * 0.3
    got = fused_vit_post(xg, attn, lp)
    err_p = check_fused("fused_vit_post", got,
                        fused_vit_post_plain(xg, attn, lp))
    blocks["fused_vit_qkv"] = {"max_abs_err": err_q}
    blocks["fused_vit_post"] = {"max_abs_err": err_p}
    log(f"  fused_vit_qkv / fused_vit_post (8 images): max abs err "
        f"{err_q:.3e} / {err_p:.3e}")
    players = vit_layers(dev, 1, seed=5)
    players["ln_kv_scale"] = players["ln1_scale"] * 0.9 + 0.1
    players["ln_kv_bias"] = players["ln1_bias"] * -1
    plp = {k: v[0] for k, v in pack_perceiver_layers_fused(players).items()}
    nq, q_pad, kv_pad = (64, 48, 32), 64, 64 + 256
    q = torch.zeros(2, 3, q_pad, VIT_W, device=dev, dtype=torch.bfloat16)
    kv = torch.zeros(2, 3, kv_pad, VIT_W, device=dev, dtype=torch.bfloat16)
    for gi, n in enumerate(nq):
        q[:, gi, :n] = torch.randn(2, n, VIT_W, generator=gen, device=dev,
                                   dtype=torch.bfloat16)
        kv[:, gi, :n] = q[:, gi, :n]
        kv[:, gi, q_pad:] = torch.randn(2, 256, VIT_W, generator=gen,
                                        device=dev, dtype=torch.bfloat16)
    kw = dict(heads=16, group_nq=nq, kv_valid=tuple(n + 256 for n in nq))
    got = fused_perceiver_block(q, kv, plp, **kw)
    err = check_fused("fused_perceiver_block", got,
                      fused_perceiver_block_plain(q, kv, plp, **kw))
    ms = cuda_ms(lambda: fused_perceiver_block(q, kv, plp, **kw), reps=5)
    plain = cuda_ms(lambda: fused_perceiver_block_plain(q, kv, plp, **kw),
                    reps=5)
    blocks["fused_perceiver_block"] = {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain}
    log(f"  fused_perceiver_block (2 images, 3 groups): max abs err "
        f"{err:.3e}; kernels {ms:.4f} ms, plain {plain:.4f} ms")
    out["blocks"] = blocks
    torch.cuda.empty_cache()
    return out


def phase_tower(dev, n_img=8):
    """The fused W8A8 tower (22 blocks) against the bf16 tower on the same
    seeded ViT-L weights: relative L2 of the (B, 768, 1024) features, which
    must stay within TOWER_REL_L2, and of the fused tower with one block
    skipped (its O and proj weights and biases zeroed: the block adds
    nothing to the residual stream), which must exceed it."""
    import torch

    from lhrs_bot_tpu_torch.models.vit import (ViTConfig, vit_encode,
                                               vit_encode_fused)
    from lhrs_bot_tpu_torch.ops.vit_block import pack_vit_layers_fused

    cfg = ViTConfig.vit_large()
    n_layers = cfg.extract_stages[-1]
    layers = vit_layers(dev, n_layers, seed=6)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = {
        "patch_proj": torch.randn(14 * 14 * 3, VIT_W, generator=gen,
                                  device=dev) * 0.02,
        "class_emb": torch.randn(VIT_W, generator=gen, device=dev) * 0.02,
        "pos_emb": torch.randn(VIT_S, VIT_W, generator=gen, device=dev) * 0.02,
        "pre_ln": {"scale": torch.ones(VIT_W, device=dev),
                   "bias": torch.zeros(VIT_W, device=dev)}}
    packed = pack_vit_layers_fused(layers)
    bf16 = {**{k: v.to(torch.bfloat16) for k, v in params.items()
               if k != "pre_ln"}, "pre_ln": params["pre_ln"],
            "layers": {k: v.to(torch.bfloat16) for k, v in layers.items()}}
    del layers
    images = torch.randint(0, 256, (n_img, 224, 224, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    ref = vit_encode(bf16, images, cfg).float()
    got = vit_encode_fused(bf16, packed, images, cfg).float()
    skip = 3  # before the first tap: every tap sees it
    faulty = dict(packed)
    for k in ("wo", "bo", "w_proj", "b_proj"):
        faulty[k] = packed[k].clone()
        faulty[k][skip] = 0
    bad = vit_encode_fused(bf16, faulty, images, cfg).float()
    torch.cuda.synchronize()
    if got.shape != (n_img, 3 * 256, VIT_W) or not bool(
            got.isfinite().all()):
        raise AssertionError(f"fused tower: bad features {tuple(got.shape)}")

    def rel(a):
        return float((a - ref).norm() / ref.norm())

    dev_rel, fault_rel = rel(got), rel(bad)
    per_tap = [float((got[:, t * 256:(t + 1) * 256] - ref[:, t * 256:(
        t + 1) * 256]).norm() / ref[:, t * 256:(t + 1) * 256].norm())
        for t in range(3)]
    log(f"  fused W8A8 tower vs bf16 tower, {n_img} images, 22 blocks: rel "
        f"L2 {dev_rel:.4f} (taps {[round(r, 4) for r in per_tap]}), bound "
        f"{TOWER_REL_L2}; planted fault (block {skip} skipped): rel L2 "
        f"{fault_rel:.4f}")
    if dev_rel > TOWER_REL_L2:
        raise AssertionError(f"fused tower deviation {dev_rel:.4f} > "
                             f"{TOWER_REL_L2}")
    if fault_rel <= TOWER_REL_L2:
        raise AssertionError(f"the planted fault passes: {fault_rel:.4f}")
    del packed, faulty, bf16
    torch.cuda.empty_cache()
    return {"rel_l2": dev_rel, "taps": per_tap, "fault_rel_l2": fault_rel,
            "bound": TOWER_REL_L2}


def kernel_wrappers():
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from lhrs_bot_tpu_torch.ops.attention import flash_attention_fwd
    from lhrs_bot_tpu_torch.ops.fused_decode import (
        fused_decode_attention_kernel, fused_decode_attention_q_kernel)
    from lhrs_bot_tpu_torch.ops.int8_gemm import int8_gemm_kernel
    from lhrs_bot_tpu_torch.ops.ln_quant import ln_quant_kernel
    from lhrs_bot_tpu_torch.ops.w4_matmul import w4a8_matmul_kernel

    return {"flash_attention_fwd": flash_attention_fwd,
            "fused_decode_attention": fused_decode_attention_kernel,
            "fused_decode_attention_q": fused_decode_attention_q_kernel,
            "w4a8_matmul": w4a8_matmul_kernel,
            "ln_quant": ln_quant_kernel,
            "int8_gemm": int8_gemm_kernel}


def serve(engine, cfg, requests, new=32):
    """Each request through `generate`: a warm-up call, a timed prefill
    (one new token) and a timed call with `new` tokens; checks the rows."""
    import torch

    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    vocab = cfg.llama.vocab_size
    results = []
    for name, (ids, lens), imgs in requests:
        # warm-up: the first call at new shapes loads cuBLAS kernels
        engine.generate(ids, lens, images=imgs,
                        gen_cfg=GenerationConfig(max_new_tokens=2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = engine.generate(ids, lens, images=imgs,
                                gen_cfg=GenerationConfig(max_new_tokens=1))
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = engine.generate(ids, lens, images=imgs,
                              gen_cfg=GenerationConfig(max_new_tokens=new))
        t_all = time.perf_counter() - t0
        if len(out) != len(ids):
            raise AssertionError(f"{name}: {len(out)} rows for {len(ids)}")
        for r, row in enumerate(out):
            if len(row) > new or any(not 0 <= t < vocab for t in row):
                raise AssertionError(f"{name}: bad output row {row}")
            if row[:1] != first[r][:1]:
                raise AssertionError(f"{name}: first token differs between "
                                     "two prefills of the same request")
        rate = (new - 1) / (t_all - t_prefill)
        spliced = [int(n) + cfg.pooler.num_query - 1 for n in lens]
        results.append({"request": name, "batch": len(ids),
                        "spliced_len": spliced,
                        "prefill_ms": t_prefill * 1e3,
                        "decode_tok_s_per_seq": rate,
                        "decode_tok_s_total": rate * len(ids)})
        log(f"  {name}: B={len(ids)} spliced {spliced}: prefill "
            f"{t_prefill * 1e3:.1f} ms, decode {rate:.1f} tok/s/seq "
            f"({rate * len(ids):.1f} total); tokens {out[0][:8]}...")
    return results


def check_consistency(name, lp, lcfg, dev, cache_dtype, bound):
    """decode_vs_prefill through the engine's decoder: the deviation must
    stay within `bound` and every planted fault must exceed it."""
    import torch

    logits_d, logits_f, faulty = decode_vs_prefill(lp, lcfg, dev,
                                                   torch.bfloat16,
                                                   cache_dtype)
    rel = rel_l2(logits_d, logits_f)
    faults = {fault: rel_l2(logits, logits_f)
              for fault, logits in faulty.items()}
    max_dev = (logits_d - logits_f).abs().amax(dim=-1).tolist()
    top2 = logits_f.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (logits_d.argmax(-1) == logits_f.argmax(-1)).tolist()
    log(f"  consistency ({name}, bound {bound}): rel L2 {rel}, max abs dev "
        f"{max_dev}, top-1 margin {margin}, top-1 agree {agree}; rel L2 "
        f"with each planted fault {faults}")
    for r in range(2):
        if rel[r] > bound:
            raise AssertionError(f"consistency ({name}) row {r}: rel L2 "
                                 f"{rel[r]:.3e}")
        for fault, readings in faults.items():
            if readings[r] <= bound:
                raise AssertionError(f"consistency ({name}) row {r}: the "
                                     f"planted fault {fault!r} passes")
        # a row whose top-2 gap lies within the measured deviation may
        # legitimately flip; every other row must agree
        if margin[r] > max_dev[r] and not agree[r]:
            raise AssertionError(f"consistency ({name}) row {r}: top-1 "
                                 "differs")
    return {"rel_l2": rel, "faults": faults, "bound": bound}


def phase_slice(dev):
    """The serving paths at full width from one set of seeded bf16 weights:
    bf16, the W4A8 + int8 lm_head + int8 KV recipe, int8 weights + int8 KV,
    NF4 + int8 KV. Each path's engine is built, its launch counts are set
    to 0, its requests are served, the counts are read, and the engine is
    freed before the next."""
    import torch

    from lhrs_bot_tpu_torch.core import build_engine, eval_config
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params

    config = eval_config()
    cfg = VLMConfig.from_config_dict(config)
    t0 = time.time()
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for part in params.values()
                   for t in _leaves(part))
    log(f"  seeded bf16 weights: {n_params / 1e9:.3f} B parameters in "
        f"{time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)

    def prompt(n):
        ids = rng.integers(3, cfg.llama.vocab_size, n).astype(np.int32)
        ids[0] = cfg.llama.bos_token_id
        ids[1] = -200  # the image marker
        return ids

    def batch(*rows):
        width = max(len(r) for r in rows)
        ids = np.zeros((len(rows), width), np.int32)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
        return ids, np.asarray([len(r) for r in rows], np.int32)

    size = cfg.vit.image_size
    images = rng.integers(0, 256, (8, size, size, 3)).astype(np.uint8)
    short = ("short", batch(prompt(40)), images[:1])
    long = ("long", batch(prompt(2048)), images[:1])
    batch7 = ("batch7", batch(*(prompt(n) for n in (2048, 40, 300, 120,
                                                      1000, 1500, 700))),
              images[:7])
    # B = 8 images: the fused tower over 8 * 257 tokens (the TPU's grouped
    # form, group 8)
    batch8 = ("batch8", batch(*(prompt(n) for n in (40, 300, 120, 1000, 64,
                                                      200, 500, 80))),
              images)
    paths = [
        ("bf16", {}, [short, long,
                      ("batch2", batch(prompt(300), prompt(120)),
                       images[:2])],
         ("flash_attention_fwd", "fused_decode_attention"),
         (torch.bfloat16, CONSISTENCY_REL_L2)),
        ("w4a8", {"bits": 4, "quant_type": "int4h", "kv_bits": 8,
                  "lm_head_bits": 8}, [short, long, batch7],
         ("flash_attention_fwd", "fused_decode_attention_q", "w4a8_matmul"),
         (torch.int8, CONSISTENCY_REL_L2_W4A8)),
        # bits 8 on the card turns the fused W8A8 vision tower on
        ("int8", {"bits": 8, "kv_bits": 8}, [short, batch8],
         ("flash_attention_fwd", "fused_decode_attention_q", "ln_quant",
          "int8_gemm"), None),
        ("nf4", {"bits": 4, "quant_type": "nf4", "kv_bits": 8}, [short],
         ("flash_attention_fwd", "fused_decode_attention_q"), None),
    ]
    wrappers = kernel_wrappers()
    out = {}
    for name, knobs, requests, needed, consistency in paths:
        t0 = time.time()
        engine = build_engine(cfg, params, {**config, **knobs}, dev)
        torch.cuda.synchronize()
        log(f"  [{name}] engine {knobs or 'bf16'} built in "
            f"{time.time() - t0:.1f} s; fused W8A8 vision tower "
            f"{'on' if engine._vision_packed is not None else 'off'}")
        if (engine._vision_packed is not None) != (name == "int8"):
            raise AssertionError(f"{name}: vision_w8a8 default is wrong")
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        results = serve(engine, cfg, requests)
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"  [{name}] kernel launches in the main path: {launches}; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for kname in needed:
            if launches[kname] <= 0:
                raise AssertionError(f"{kname} was not launched by the "
                                     f"{name} path")
        out[name] = {"requests": results, "launches": launches}
        if consistency is not None:
            out[name]["consistency"] = check_consistency(
                name, engine.llama_params, cfg.llama, dev, *consistency)
        del engine
        torch.cuda.empty_cache()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this check "
                         "runs on the card")
    from lhrs_bot_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[1/4 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability "
        f"{torch.cuda.get_device_capability(0)}, count "
        f"{torch.cuda.device_count()}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    so = cuda_lib.build()
    cuda_lib.load_library()
    build_s = time.time() - t0
    usage = [ln.strip() for ln in
             (so.parent / "build.log").read_text().splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    log(f"[2/4 build] {so.relative_to(cuda_lib.BUILD_ROOT.parents[1])} in "
        f"{build_s:.1f} s")
    for ln in usage:
        log(f"  {ln}")

    log("[3/4 kernels vs plain]")
    k1, k2 = phase_kernels(dev)
    k3, k4 = phase_quant_kernels(dev)
    vision = phase_vision_kernels(dev)
    tower = phase_tower(dev)

    log("[4/4 slices at full width]")
    paths = phase_slice(dev)
    bf16, w4a8 = paths["bf16"]["launches"], paths["w4a8"]["launches"]
    int8 = paths["int8"]["launches"]

    def row(name, source, replaces, launches, k):
        return {"name": name, "route": "cuda",
                "source": f"lhrs_bot_tpu_torch/csrc/{source}",
                "replaces": ", ".join(f"lhrs_bot_tpu/ops/{r}"
                                      for r in replaces.split(", ")),
                "launches": launches[name], "max_abs_err": k["max_abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"]}

    vision_tpu = ("vit_block.py:111, vit_block.py:132, vit_block.py:319, "
                  "vit_block.py:338, perceiver_block.py:53")

    kernels = [
        row("flash_attention_fwd", "flash_fwd.cu", "attention.py:84", bf16,
            k1),
        row("fused_decode_attention", "fused_decode.cu",
            "fused_decode.py:43", bf16, k2),
        row("fused_decode_attention_q", "fused_decode_q.cu",
            "fused_decode.py:222", w4a8, k4),
        row("w4a8_matmul", "w4a8_matmul.cu", "w4_matmul.py:43", w4a8, k3),
        row("ln_quant", "ln_quant.cu", vision_tpu, int8, vision["A"]),
        row("int8_gemm", "int8_gemm.cu", vision_tpu, int8, vision["B"]),
    ]
    log(json.dumps({"w4a8_shapes": k3["shapes"]}))
    log(json.dumps({"int8_gemm_shapes": vision["B"]["shapes"],
                    "vision_blocks": vision["blocks"], "tower": tower}))
    log(json.dumps({"paths": paths}))
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
