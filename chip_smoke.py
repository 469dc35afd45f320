#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lhrs_bot_tpu_torch) on one CUDA card.

Run from the root of a checkout, with one H100 visible:

    python3 chip_smoke.py

Phases, one or more lines each:
  1. device: torch/CUDA versions, the card, its power limit;
  2. build: compile the CUDA kernels from lhrs_bot_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (plus ragged/masked edge cases), with times;
     K2 and K4 (the contiguous-cache decode kernels, rows split across a
     cluster) at B1, B2 and B7 at the plan's cluster size and every forced
     one (1, 2, 4, 8), caches exact, at the edge lengths (0, 127, 128,
     S - 1, a full row, S not a multiple of 4), one CTA a head bit for bit
     against the paged kernel, and a planted merge fault (the last rank
     left out) that must fail and match the plain split-and-merge's;
     K3 (the W4A8 decode product) in both modes, the fused one quantizing
     its own bf16 activation, bit for bit against the plain quantize +
     product at the decoder's three projection shapes, B = 1, 2, 7, 8, 9,
     layers 0 and 31, a zero row and an outlier row, every cluster size,
     and two planted faults (a peer's row maximum, a CTA's sums left out
     of the cluster's exchange) that must differ;
     the vision kernels too: kernel A (LayerNorm + row quantization; the
     quantize-only mode bit for bit at every path shape and the row
     grouping's edges, outputs poisoned, and at near ties) and
     kernel B (int8 GEMM, int32 accumulators bit for bit) at the W8A8
     tower's shapes and at the edges of its 128 x 128 tile and 128-byte K
     stage (M of 40 to 16448, N 1032 and 8, K 1088 and 64, a strided A),
     one epilogue each; K1 at kv lengths one past its 64-row tiles (129)
     and strided at a ragged 257 rows; the fused ViT block (B = 1 and 8),
     its split form and the fused perceiver block against their plain
     versions, and the fused
     W8A8 tower at full depth against the bf16 tower, with a planted fault;
     the paged decode pair (bf16 and int8 pools) at L32 H32 D128, pages of
     128 and 16 (int8, split across a cluster: also 48, at the plan's C and
     at 1, 2, 4, 8, bit for bit K4 at the same C on the gathered rows, a
     bad page id in rank 1's share giving NaN and no write, a planted
     merge fault), eight rows around page boundaries and a ghost row,
     shuffled pages, the null and unallocated pages poisoned, pools
     byte-equal to plain's; the training kernels (the forward's LSE and
     segment ids, the dQ and dK/dV backward kernels) at the decoder's
     training shapes (B1 H32 S2048 D128 causal, with a kv_mask and with
     packed segments, and 1000 rows with a padding tail) and the
     perceiver's (B8 H16 D64), each against its
     plain version with a planted fault, twice for bit-identical
     gradients; the bench path's kernels: the int8-dots variant of the
     int8-cache decode kernel (L32 B2 H32 S2304 D128, lengths around a
     block edge and the main path's, block_s 512 and 96, at the plan's
     cluster size and at 1, 2, 4, 8, within 1e-5; planted faults: the
     probability row's scale over the whole row, the last rank's int32
     P.V left out of the cluster's exchange), the
     cache row write (B8 H32 S2304 D128 bf16, byte-equal, a full row
     untouched, beside an empty kernel's time), the two HBM readers over
     1.4 GB buffers (a unique maximum planted at six places in turn, and
     a reader that skips a word must fail) and the five product chains
     (on the card two computations, accumulating and requantized; int8
     bit for bit at 16 products and at 3, where int8_alt's window is
     transposed, the requantized ones on clusters of 1 to 4 CTAs, the bf16
     window and total apart, a refused shape);
     every kernel with its bound (bytes over 3.35 TB/s or
     operations over the dense peak) and, where one PyTorch call computes
     the same function, that call's time;
  4. slices: the serving paths at full width (ViT-L/14, 144-query 6-layer
     perceiver, LLaMA-2-7B, one set of seeded random bf16 weights) through
     build_engine + GenerationEngine.generate: bf16 (three requests), the
     quantized recipe of W4A8 weights, int8 lm_head and int8 KV cache
     (three requests, B up to 7), int8 weights with the int8 cache and, by
     default on the card, the fused W8A8 vision tower and W8A8 perceiver
     (two requests, B 1 and 8), NF4 weights with the int8 cache (one
     request); for each path the kernels' launch counts (a W4A8 decode
     step: K3 7 times a layer, A twice a layer with the int8 cache and
     never with the bf16 one), and for bf16 and
     W4A8 a prefill/decode consistency check with planted faults. Then,
     from the bf16 engine's parameters, paged against contiguous decode on
     the same cache contents (bf16 and int8 caches, with a swapped-page
     fault; the int8 side as served, equal logits), the paged prefill against the contiguous one in float32 on
     the first layers (a shared prefix, two planted faults), a 12-request serving wave through the contiguous
     scheduler, the paged scheduler (a pool of 4 x 2304 tokens), the paged
     one with prefill_chunk 512, and, from the int8 engine's (bits 8,
     kv_bits 8), the paged one over an int8 pool: tokens/s, time to first
     token, admissions (the pool defers one, pages recycle), prefix hits,
     pool state and launch counts (the paged kernels 32 times a decode
     step, K2 / K4 never, and the reverse for the contiguous run); and the
     reference's page-table hazard wave (pages of 16), where no idle
     slot's table row may name a live page after any tick; the W4A8
     engine again with LHRS_DECODE_INT8_DOTS=1: the int8-dots kernel 32
     times a decode step and K4 never, and its consistency check;
  5. training: stage 1 at full width (ViT-L/14 frozen, the perceiver
     trained, LLaMA-2-7B frozen in bf16) from seeded weights through
     build_trainer with Config/multi_modal_stage1.yaml's optimizer and
     schedule: the first step's pooler gradient through the kernels
     against the plain attention (two planted faults), then six steps on a
     caption batch (8 rows, 335 spliced tokens; the loss must fall) and two
     on a packed batch (2 rows of 2620 spliced tokens with segment ids),
     each with its loss, grad_norm, lr, time, tokens/s, peak memory and
     launch counts (72 forward, 50 dQ, 50 dK/dV a step; the plain
     backward never);
  6. the bench path: `lhrs_bot_tpu_torch.bench`'s decode cells and prefill
     towers at the bench's geometry (one timed run a cell) and its JSON
     line, the int8-dots A/B's line and the two probes' lines; every value
     positive, each kernel of the path launched;
  7. checkpoints at full width: the reference's artifacts written from
     named seeds under build/ (an HF LLaMA-2-7B directory of two fp16
     safetensors shards, an HF CLIP directory, FINAL.pt with the nested
     other_ckpt and embed_tokens resized to 32,004 rows, TextLoRA/ at r
     128 on all 7 linears with B != 0; free disk and host memory checked
     first, the directory deleted at the end), loaded at stage 0 through
     `load_pretrained` bit for bit against trees built from the seeds
     (three planted faults: alpha / r swapped, a layer's q_proj / k_proj
     swapped in the shard's header, the w_down adapters dropped), the bf16
     and W4A8 + int8 lm_head + int8 KV engines over the loaded tree bit for
     bit against engines over the expected tree; stage 2
     (`Config/multi_modal_stage2.yaml` through build_model: int8 base,
     live adapters) with the adapters' and pooler's gradient against the
     plain attention (the training phase's bound and faults), six steps
     (loss, ms, tokens/s, peak memory, busy share, launches; the loss must
     fall) and save_final; stage 3 (`multi_modal_stage3.yaml`) from that
     output, the adapters bit for bit, two steps, save_final; and the eval
     load of stage 3's output (adapters merged) served bit for bit against
     the plainly merged tree; each part's seconds.
Then a JSON line with per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Any failure raises: the script
exits non-zero and prints no result, and the failing phase's traceback is
kept in chiprun_out/chip_smoke_<phase>.err (a crash of the interpreter
leaves its stacks in chiprun_out/chip_smoke_crash.txt). It needs no network
and imports nothing of JAX.
"""

import contextlib
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

# K1/K2/K4 against their plain versions: bf16 kernel output vs the plain
# version in float32 on the same inputs. bf16 output rounding is 2^-9
# relative and the kernels round probabilities (K4: probabilities times
# the value scales, and q * sm_scale) to bf16 before the products, so 1e-2
# absolute + 1e-2 relative bounds a correct kernel while any indexing or
# masking fault shows as O(1). K3 is integer arithmetic and is held to its
# plain version bit for bit, its fused quantize too.
ATOL = RTOL = 1e-2
# the int8-dots kernel against its plain version: both take the same float32
# steps (exp, the two quotients, the scalings) in the same order, so they
# agree to the bit; the bound leaves room for one ulp of an output, not for
# a probability code that moves across a rounding tie
INT8DOTS_ATOL = 1e-5
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


@contextlib.contextmanager
def plain_attention():
    """Route the decoder's two attention entry points to their plain
    versions, on CUDA tensors too, for as long as the block runs."""
    import lhrs_bot_tpu_torch.models.llama as llama
    from lhrs_bot_tpu_torch.ops.attention import mha_reference
    from lhrs_bot_tpu_torch.ops.fused_decode import \
        fused_decode_attention_plain

    def flash(q, k, v, kv_mask=None, *, causal=False, sm_scale=None):
        return mha_reference(q, k, v, kv_mask, causal=causal,
                             sm_scale=sm_scale)

    saved = llama.flash_attention, llama.fused_decode_attention
    llama.flash_attention = flash
    llama.fused_decode_attention = fused_decode_attention_plain
    try:
        yield
    finally:
        llama.flash_attention, llama.fused_decode_attention = saved


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


def check_within(name, got, ref, atol):
    """Max abs error of got vs ref (float32), raising past atol."""
    got, ref = got.float(), ref.float()
    if not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    if bool((err > atol).any()):
        raise AssertionError(f"{name}: {int((err > atol).sum())} elements "
                             f"off, max abs err {float(err.max()):.3e}")
    return float(err.max())


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
        # one row past the 64-row q and kv tiles (two of them)
        ("edge_skv129", 2, 2, 129, 129, 128, False, False),
        ("edge_skv129_causal_mask_d64", 2, 3, 129, 129, 64, True, True),
        ("edge_q48_kv129_d64", 2, 3, 48, 129, 64, False, True),
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
                import torch.nn.functional as F

                k1["ms"], k1["plain_ms"] = ms, plain
                k1["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True))
                # q, k, v read and o written once; QK^T and PV over the
                # causal pairs
                k1["bound_ms"], k1["bound_by"] = bound(
                    4 * b * h * sq * d * 2,
                    4.0 * b * h * d * sq * (sq + 1) / 2)
                line += (f", library (SDPA, causal) {k1['library_ms']:.4f} "
                         f"ms, bound {k1['bound_ms']:.4f} ms "
                         f"({k1['bound_by']})")
        log(line)

    k2 = phase_decode_split(dev, gen, int8=False)
    return k1, k2


# K2 and K4 (the contiguous-cache decode kernels, csrc/decode_split.cuh) at
# the decode shapes: L32 H32 S2304 D128, the bench's B1 row, the B2 rows of
# the serving paths and a B7 batch; each at the plan's cluster size and at
# every forced one. Edge lengths: 0, one whole block (127), the appended
# row alone in a new block (128: a share boundary), S - 1 and a share
# boundary of C = 4 (640); a full row (S: NaN, nothing written); S % 4 != 0
# (the int8 kernel reads the scales without bulk copies).
DECODE_LENGTHS = {"B1": [2191], "B2": [2191, 700],
                  "B7": [2192, 5, 1000, 2303, 63, 1500, 2000]}
DECODE_EDGES = [0, 127, 128, 2303, 640]


def decode_case(dev, gen, int8, lengths, nl, s=2304, h=32, d=128):
    """Seeded inputs of K2 (bf16) or K4 (int8 codes, scales in [0.005,
    0.03]): q, the new rows (and scales), the stacked caches (and planes)
    and the lengths, as a dict."""
    import torch

    b = len(lengths)

    def bf(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.025 + 0.005

    x = {"q": bf(b, h, 1, d),
         "lens": torch.tensor(lengths, dtype=torch.int32, device=dev)}
    if int8:
        x.update(kn=codes(b, h, 1, d), kns=scales(b, h, 1),
                 vn=codes(b, h, 1, d), vns=scales(b, h, 1),
                 kc=codes(nl, b, h, s, d), vc=codes(nl, b, h, s, d),
                 ks=scales(nl, b, h, s), vs=scales(nl, b, h, s))
    else:
        x.update(kn=bf(b, h, 1, d), vn=bf(b, h, 1, d),
                 kc=bf(nl, b, h, s, d), vc=bf(nl, b, h, s, d))
    return x


def decode_caches(x):
    return [x[k] for k in (("kc", "vc", "ks", "vs") if "ks" in x else
                           ("kc", "vc"))]


def decode_kernel(x, caches, layer, **kw):
    """K2 or K4 on x's inputs and the given caches (updated in place)."""
    from lhrs_bot_tpu_torch.ops import fused_decode as fd

    d = x["q"].shape[-1]
    if "ks" in x:
        return fd.fused_decode_attention_q_kernel(
            x["q"], x["kn"], x["kns"], x["vn"], x["vns"], *caches, x["lens"],
            layer, d ** -0.5, **kw)[0]
    return fd.fused_decode_attention_kernel(
        x["q"], x["kn"], x["vn"], *caches, x["lens"], layer, d ** -0.5,
        **kw)[0]


def decode_plain(x, layer, split=None, fault=0):
    """The plain version on a float32 (bf16) or int8 copy of the layer:
    (output, the layer's caches after the append). `split` runs the plain
    split-and-merge with that many ranks (and the planted `fault`)."""
    from lhrs_bot_tpu_torch.ops import fused_decode as fd

    int8 = "ks" in x
    lay = [t[layer:layer + 1].clone() if int8 else t[layer:layer + 1].float()
           for t in decode_caches(x)]
    q = x["q"].float()
    rows = ((x["kn"], x["kns"], x["vn"], x["vns"]) if int8 else
            (x["kn"].float(), x["vn"].float()))
    kw = dict(sm_scale=x["q"].shape[-1] ** -0.5)
    if split is None:
        fn = (fd.fused_decode_attention_q_plain if int8 else
              fd.fused_decode_attention_plain)
    else:
        fn = (fd.fused_decode_attention_q_split_plain if int8 else
              fd.fused_decode_attention_split_plain)
        kw.update(splits=split, fault=fault)
    return fn(q, *rows, *lay, x["lens"], 0, **kw)[0], lay


def decode_plain_in_place(x, layer):
    """The plain version as the CPU path runs it, on x's own (bf16 or
    int8) caches, in place: the time beside the kernel's."""
    from lhrs_bot_tpu_torch.ops import fused_decode as fd

    d = x["q"].shape[-1]
    if "ks" in x:
        return fd.fused_decode_attention_q_plain(
            x["q"], x["kn"], x["kns"], x["vn"], x["vns"], *decode_caches(x),
            x["lens"], layer, sm_scale=d ** -0.5)[0]
    return fd.fused_decode_attention_plain(
        x["q"], x["kn"], x["vn"], *decode_caches(x), x["lens"], layer,
        sm_scale=d ** -0.5)[0]


def decode_written(x, caches, lay, layer, name):
    """The kernel's caches equal the inputs but for the layer, which equals
    the plain version's after its append: the written rows (and scales) and
    every other row exact."""
    import torch

    for got, orig, want in zip(caches, decode_caches(x), lay):
        want = want[0].to(got.dtype)
        if not torch.equal(got[layer], want):
            raise AssertionError(f"{name}: layer {layer} differs from the "
                                 "plain version's")
        others = [i for i in range(got.shape[0]) if i != layer]
        if not torch.equal(got[others], orig[others]):
            raise AssertionError(f"{name}: another layer was written")


def as_pages(x, page=256):
    """x's first two layers as a paged pool (a null page 0, then each
    row's pages in order) and its page table, for the paged kernels."""
    import torch

    b, h, s = x["kc"].shape[1:4]
    npg = s // page

    def pool(t):
        tail = t.shape[4:]
        p = t[:2].reshape(2, b, h, npg, page, *tail).transpose(2, 3)
        p = p.reshape(2, b * npg, h, page, *tail)
        return torch.cat([torch.zeros_like(p[:, :1]), p], 1).contiguous()

    table = (1 + torch.arange(b * npg, dtype=torch.int32,
                              device=x["kc"].device)).reshape(b, npg)
    return [pool(t) for t in decode_caches(x)], table


def phase_decode_split(dev, gen, int8):
    """K2 (bf16 cache) or K4 (int8 cache) against its plain version at
    DECODE_LENGTHS, at the plan's cluster size and at every forced one (1,
    2, 4, 8), outputs within ATOL + RTOL and caches exact; the edge
    lengths; C = 1 against the paged kernel bit for bit (the one-CTA
    design); a planted fault (rank 0 leaves the last rank's state out)
    that must fail the check and match the plain split-and-merge's fault;
    the plan's clusters resident in one wave; times at B1, B2 and B7 with
    every cluster size, the plain version, SDPA and the bound. Returns the
    kernel row's numbers (at B2) with the other shapes under "shapes"."""
    import torch

    from lhrs_bot_tpu_torch.ops import fused_decode as fd
    from lhrs_bot_tpu_torch.ops import paged_fused as pf

    name = "K4" if int8 else "K2"
    elt = 1 if int8 else 2
    nl, h, s, d = 32, 32, 2304, 128
    out = {"max_abs_err": 0.0, "shapes": {}}
    for key, lengths in DECODE_LENGTHS.items():
        x = decode_case(dev, gen, int8, lengths, nl)
        b = len(lengths)
        plan = fd.decode_launch_splits(dev, b, h, s, d, elt)
        resident = fd.decode_max_clusters(d, plan, int8=int8)
        if resident < b * h:
            raise AssertionError(f"{name} {key}: the plan's {b * h} clusters "
                                 f"of {plan} exceed the {resident} resident")
        layer = nl - 1
        ref, lay = decode_plain(x, layer)
        for splits in (None, 1, 2, 4, 8):
            caches = [t.clone() for t in decode_caches(x)]
            got = decode_kernel(x, caches, layer, splits=splits)
            torch.cuda.synchronize()
            label = f"{name} {key} C={splits or plan}"
            err = check_close(label, got, ref)
            decode_written(x, caches, lay, layer, label)
            out["max_abs_err"] = max(out["max_abs_err"], err)
            log(f"  {label}{' (plan)' if splits is None else ''}: lengths "
                f"{lengths}, layer {layer}: max_abs_err {err:.3e}, caches "
                "exact")
            del caches
        del ref, lay
        # C = 1 is the one-CTA design: the bf16 paged kernel's bits, and
        # the int8 paged kernel's at one CTA a head
        pools, table = as_pages(x)
        one = decode_kernel(x, [t[:2].clone() for t in decode_caches(x)], 1,
                            splits=1)
        if int8:
            paged = pf.paged_fused_decode_q_kernel(
                x["q"], x["kn"], x["kns"], x["vn"], x["vns"], *pools, table,
                x["lens"], 1, d ** -0.5, splits=1)[0]
        else:
            paged = pf.paged_fused_decode_kernel(
                x["q"], x["kn"], x["vn"], *pools, table, x["lens"], 1,
                d ** -0.5)[0]
        if not torch.equal(one, paged):
            raise AssertionError(f"{name} {key}: C = 1 differs from the "
                                 "paged kernel's bits")
        del pools, table, one, paged
        # times: the plan, every cluster size, plain, SDPA; each timed call
        # reads another layer, so the cache comes from device memory
        caches = decode_caches(x)
        turn = iter(range(10**9))
        row = {"splits": plan, "resident_clusters": resident,
               "ms": cuda_ms(lambda: decode_kernel(x, caches,
                                                   next(turn) % nl))}
        for splits in fd.SPLITS:
            row[f"ms_c{splits}"] = cuda_ms(lambda: decode_kernel(
                x, caches, next(turn) % nl, splits=splits))
        row["plain_ms"] = cuda_ms(lambda: decode_plain_in_place(
            x, next(turn) % nl))
        # SDPA over the filled cache (int8: two layers dequantized to bf16,
        # taken in turns, so that neither stays in the 50 MB L2)
        if int8:
            deq = [[(c[i].float() * sc[i][..., None]).bfloat16()
                    for i in (0, 1)]
                   for c, sc in ((x["kc"], x["ks"]), (x["vc"], x["vs"]))]
        else:
            deq = [list(x["kc"]), list(x["vc"])]
        row["library_ms"] = cuda_ms(lambda: (lambda i: masked_sdpa(
            x["q"], deq[0][i], deq[1][i], x["lens"] + 1))(
                next(turn) % len(deq[0])))
        row["bound_ms"], row["bound_by"] = decode_bound(x["lens"], h, d, elt)
        del deq
        log(f"  {name} {key} time per layer call: kernel {row['ms']:.4f} ms "
            f"(C = {plan}; " + ", ".join(
                f"C={c} {row[f'ms_c{c}']:.4f}" for c in sorted(fd.SPLITS))
            + f"), plain {row['plain_ms']:.4f} ms, library (SDPA over the "
            f"{'dequantized ' if int8 else ''}filled cache, append "
            f"excluded) {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.0%} of it")
        out["shapes"][key] = row
        del x, caches
        torch.cuda.empty_cache()
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "splits"):
        out[key] = out["shapes"]["B2"][key]
    # clusters of each size resident at once, and the fixed cost of a
    # launch: one row (length 0) at B1, every C
    out["resident_clusters"] = {f"c{c}": fd.decode_max_clusters(
        d, c, int8=int8) for c in sorted(fd.SPLITS)}
    log(f"  {name} clusters resident at once: {out['resident_clusters']}")
    x = decode_case(dev, gen, int8, [0], nl)
    caches = decode_caches(x)
    turn = iter(range(10**9))
    out["length0_ms"] = {f"c{c}": cuda_ms(lambda: decode_kernel(
        x, caches, next(turn) % nl, splits=c)) for c in sorted(fd.SPLITS)}
    out["empty_kernel_ms"] = cuda_ms(lambda: torch.cuda._sleep(1))
    log(f"  {name} B1 length 0 (the fixed cost of a launch): " + ", ".join(
        f"C={k[1:]} {v:.4f} ms" for k, v in out["length0_ms"].items())
        + f"; an empty kernel in the same queue {out['empty_kernel_ms']:.4f}"
        " ms")
    del x, caches
    # edge lengths, at every cluster size
    x = decode_case(dev, gen, int8, DECODE_EDGES, 2)
    ref, lay = decode_plain(x, 1)
    for splits in fd.SPLITS:
        caches = [t.clone() for t in decode_caches(x)]
        label = f"{name} edges C={splits}"
        err = check_close(label, decode_kernel(x, caches, 1, splits=splits),
                          ref)
        decode_written(x, caches, lay, 1, label)
        out["max_abs_err"] = max(out["max_abs_err"], err)
    log(f"  {name} edge lengths {DECODE_EDGES} at C = 1, 2, 4, 8: within "
        "the bound, caches exact")
    # a full row (lengths[b] == S) next to a live one, and S % 4 != 0
    for s_small, lengths in ((64, [64, 3]), (130, [129, 64, 0, 130])):
        x = decode_case(dev, gen, int8, lengths, 1, s=s_small)
        full = [i for i, n in enumerate(lengths) if n >= s_small]
        live = [i for i, n in enumerate(lengths) if n < s_small]
        xr = dict(x, lens=x["lens"].clamp(max=s_small - 1))
        ref, _ = decode_plain(xr, 0)
        for splits in fd.SPLITS:
            caches = [t.clone() for t in decode_caches(x)]
            got = decode_kernel(x, caches, 0, splits=splits)
            torch.cuda.synchronize()
            check_close(f"{name} S{s_small} C={splits}", got[live], ref[live])
            if not (all(bool(got[i].isnan().all()) for i in full) and all(
                    torch.equal(c[:, i], o[:, i]) for c, o in
                    zip(caches, decode_caches(x)) for i in full)):
                raise AssertionError(f"{name} S{s_small} C={splits}: a full "
                                     "row must write nothing and give NaN")
    log(f"  {name} full row (lengths[b] == S) at every C: nothing written, "
        "NaN out; S = 130 (not a multiple of 4) within the bound")
    # the planted fault: rank 0 leaves the last rank's state out
    x = decode_case(dev, gen, int8, [2191], 2)
    x["vc"][:, :, :, 1920:] = 120 if int8 else 4  # the last rank at C = 4
    ref, _ = decode_plain(x, 1)
    bad_ref, _ = decode_plain(x, 1, split=4, fault=1)
    bad = decode_kernel(x, [t.clone() for t in decode_caches(x)], 1,
                        splits=4, fault=1)
    try:
        check_close(f"{name} planted fault", bad, ref)
    except AssertionError as e:
        log(f"  {name} planted fault (rank 0 leaves rank 3 out) fails the "
            f"check as it must: {e}")
    else:
        raise AssertionError(f"{name}: the planted merge fault passes")
    err = check_close(f"{name} planted fault vs the plain split", bad,
                      bad_ref)
    log(f"  {name} planted fault vs the plain split-and-merge's: max_abs_err "
        f"{err:.3e}")
    out["fault_err"] = float((bad.float() - ref.float()).abs().max())
    del x
    torch.cuda.empty_cache()
    return out


# K3's projection shapes (K, N) and the decode batches it is checked at: 9
# crosses its 8-row group
K3_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
K3_BATCHES = (1, 2, 7, 8, 9)


def k3_activation(gen, dev, b, k, chunk):
    """A (B, K) bf16 activation with a row of zeros (scale 1) and a row
    whose one outlier lies in the second CTA's chunk of the low half, so
    that only the amax exchange brings it to the other CTAs."""
    import torch

    x = torch.randn(b, k, generator=gen, device=dev).to(torch.bfloat16)
    if b > 1:
        x[0] = 0
        x[1, min(chunk + 3, k // 2 - 1)] = 40.0
    return x


def phase_k3(dev, gen, nl):
    """K3 (W4A8 matmul) in both modes against the plain quantize +
    product, bit for bit, at the decoder's three projection shapes, B in
    K3_BATCHES, layers 0 and 31, and at every cluster size for B = 7; the
    planted faults (a peer's amax, a CTA's sums left out) must differ;
    times of the fused projection, mode (a), and A + mode (a)."""
    import torch

    from lhrs_bot_tpu_torch.ops.ln_quant import ln_quant_kernel, ln_quant_plain
    from lhrs_bot_tpu_torch.ops.w4_matmul import (
        FAULT_PEER_AMAX, FAULT_PEER_SUMS, w4a8_matmul_kernel,
        w4a8_launch_plan, w4a8_matmul_plain, w4a8_max_clusters, w4a8_plan,
        w4a8_project_kernel)

    def plain(x, w, ws, layer):
        xq, xs = ln_quant_plain(x)
        k2 = x.shape[1] // 2
        return w4a8_matmul_plain(xq[:, :k2], xq[:, k2:], xs, w, ws, layer)

    def same(name, got, ref):
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            err = float((got.float() - ref.float()).abs().max())
            raise AssertionError(f"{name}: differs from the plain version, "
                                 f"{int((got != ref).sum())} outputs, max abs "
                                 f"err {err:.3e}")

    k3 = {"max_abs_err": 0.0, "shapes": []}
    for k, n in K3_SHAPES:
        w = torch.randint(-128, 128, (nl, k // 2, n), generator=gen,
                          device=dev, dtype=torch.int8)
        ws = torch.rand(nl, 1, n, generator=gen, device=dev) * 4e-3 + 1e-3
        for b in K3_BATCHES:
            cluster, chunk = w4a8_launch_plan(dev, b, k // 2, n)
            x = k3_activation(gen, dev, b, k, chunk)
            xq, xs = ln_quant_plain(x)
            xlo, xhi = xq[:, :k // 2], xq[:, k // 2:]
            for layer in (0, nl - 1):
                ref = plain(x, w, ws, layer)
                same(f"K3 fused K{k} N{n} B{b} layer {layer}",
                     w4a8_project_kernel(x, w, ws, layer), ref)
                same(f"K3 mode (a) K{k} N{n} B{b} layer {layer}",
                     w4a8_matmul_kernel(xlo, xhi, xs, w, ws, layer), ref)
            if b == 7:
                ref = plain(x, w, ws, 3)
                for c in (1, 2, 4, 8):
                    same(f"K3 fused K{k} N{n} B7 cluster {c}",
                         w4a8_project_kernel(x, w, ws, 3, cluster=c), ref)
                    same(f"K3 mode (a) K{k} N{n} B7 cluster {c}",
                         w4a8_matmul_kernel(xlo, xhi, xs, w, ws, 3,
                                            cluster=c), ref)
                # the faults in a cluster of 4, the outlier in rank 1's chunk
                xf = k3_activation(gen, dev, b, k, w4a8_plan(k // 2, n, 4)[1])
                ref = plain(xf, w, ws, 3)
                for fault, name in ((FAULT_PEER_AMAX, "a peer's amax"),
                                    (FAULT_PEER_SUMS, "a CTA's sums")):
                    got = w4a8_project_kernel(xf, w, ws, 3, cluster=4,
                                              fault=fault)
                    torch.cuda.synchronize()
                    if torch.equal(got, ref):
                        raise AssertionError(f"K3 K{k} N{n}: the planted "
                                             f"fault ({name} left out) "
                                             "passes")
            log(f"  K3 K{k} N{n} B{b} (cluster {cluster}, chunk {chunk}), "
                "layers 0/31: fused and mode (a) bit-identical to the plain "
                "quantize + product" + (
                    "; clusters 1/2/4/8 too; both planted faults differ"
                    if b == 7 else ""))
            if b not in (1, 7):
                continue
            # each timed call reads another layer: the weights come from
            # device memory, as in decode, not from the 50 MB L2
            turn = iter(range(10**9))
            fused = cuda_ms(lambda: w4a8_project_kernel(
                x, w, ws, next(turn) % nl))
            mode_a = cuda_ms(lambda: w4a8_matmul_kernel(
                xlo, xhi, xs, w, ws, next(turn) % nl))

            def two_launches():
                q, s_ = ln_quant_kernel(x)
                return w4a8_matmul_kernel(q[:, :k // 2], q[:, k // 2:], s_,
                                          w, ws, next(turn) % nl)

            a_then_k3 = cuda_ms(two_launches)
            plain_ms = cuda_ms(lambda: plain(x, w, ws, next(turn) % nl))
            # packed weights and their scales, x in bf16, a bf16 output
            bms, by = bound(k // 2 * n + 4 * n + 2 * b * k + 2 * b * n,
                            2.0 * b * k * n, "int8")
            row = {"K": k, "N": n, "B": b, "cluster": cluster,
                   "chunk": chunk, "ms": fused, "mode_a_ms": mode_a,
                   "a_then_mode_a_ms": a_then_k3, "plain_ms": plain_ms,
                   "GB_s": k // 2 * n / fused / 1e6, "bound_ms": bms,
                   "bound_by": by,
                   "max_active_clusters": w4a8_max_clusters(
                       b, k // 2, n, cluster=cluster)}
            k3["shapes"].append(row)
            log(f"  K3 K{k} N{n} B{b}: fused {fused:.4f} ms "
                f"({row['GB_s']:.0f} GB/s), mode (a) {mode_a:.4f}, A + mode "
                f"(a) {a_then_k3:.4f}, plain {plain_ms:.4f}, bound "
                f"{bms:.4f} ms ({by}); {row['max_active_clusters']} clusters "
                "resident at most")
        del w, ws
    main = next(r for r in k3["shapes"]
                if (r["K"], r["N"], r["B"]) == (4096, 11008, 1))
    for key in ("ms", "mode_a_ms", "plain_ms", "bound_ms", "bound_by"):
        k3[key] = main[key]
    k3["library_ms"] = None  # no one PyTorch call computes W4A8
    return k3


def phase_quant_kernels(dev):
    """K3 (W4A8 matmul) and K4 (int8-cache fused decode) against their plain
    versions at the quantized decode path's shapes."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    k3 = phase_k3(dev, gen, 32)
    k4 = phase_decode_split(dev, gen, int8=True)
    torch.cuda.empty_cache()
    return k3, k4


def int8dots_fault_case(dev, gen, nl, h, s, d, scale):
    """A row of length 2191 (five blocks of 512) whose scores are flat but
    for one key 6 above the rest, and whose values lean one way: most of
    the probability mass lies in small p's outside the peak's block, which
    a p scale taken over the whole row rounds to 0 and a per-block scale
    keeps. Returns the int8-dots kernel's inputs before `layer`."""
    import torch

    from lhrs_bot_tpu_torch.ops.ln_quant import div_exact

    length, peak = 2191, 100
    q = torch.randn(1, h, 1, d, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    qf = q.float()[0, :, 0] * scale
    qs = div_exact(qf.abs().amax(dim=-1, keepdim=True), 127.0) + 1e-12
    qi = torch.round(qf / qs)
    kc = torch.zeros(nl, 1, h, s, d, dtype=torch.int8, device=dev)
    kc[:, 0, :, peak] = (torch.sign(qi) * 127).to(torch.int8)
    ks = torch.full((nl, 1, h, s), 1e-4, device=dev)
    dot = qi.abs().sum(dim=-1) * 127                       # (H,)
    ks[:, 0, :, peak] = 6.0 / (dot * qs[:, 0])
    vc = torch.randint(60, 127, (nl, 1, h, s, d), generator=gen, device=dev,
                       dtype=torch.int8)
    vs = torch.rand(nl, 1, h, s, generator=gen, device=dev) * 0.02 + 0.01
    kn = torch.zeros(1, h, 1, d, dtype=torch.int8, device=dev)
    kns = torch.full((1, h, 1), 1e-4, device=dev)
    vn = torch.randint(60, 127, (1, h, 1, d), generator=gen, device=dev,
                       dtype=torch.int8)
    vns = torch.full((1, h, 1), 0.02, device=dev)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    return q, kn, kns, vn, vns, kc, vc, ks, vs, lens


def phase_bench_kernels(dev):
    """The bench path's kernels against their plain versions: the int8-dots
    variant of the int8-cache decode kernel at L32 B2 H32 S2304 D128
    (lengths around a block edge and the main path's, block_s 512 and 96,
    at the plan's cluster size and at C = 1, 2, 4, 8; output within
    INT8DOTS_ATOL, caches and planes byte-equal; a planted fault, the p
    scale taken over the whole row, must exceed that bound at every C at
    the main path's lengths and on a crafted row; a planted exchange fault,
    the last rank's int32 P.V left out, must exceed it at C = 2, 4, 8 and
    match the plain split's), the cache row write at B8
    H32 S2304 D128 bf16 (byte-equal; rows 0 and S - 1, a full row left
    untouched; beside it an empty kernel on its grid, the launch floor),
    the HBM readers over 1.4 GB int8 and bf16 buffers (a
    unique maximum planted at six places in turn, each read back; a reader
    that skips the last word must fail that check) and the five chain
    variants (the two computations of `chain_form`) at M 2048, K = N 1024,
    16 products and at M = K = N 256, 3 products (int8_alt's transposed
    window), two blocks each (int8 bit for bit; bf16's window and total
    each within 1e-2 relative of their own scale), int8_req and int8_alt
    also at M 128, K = N 512 and 768 (the requantized kernel's clusters of
    2 and 3 CTAs; bit for bit), and a refused shape (M 192) that must
    raise. Each with its time, its plain version's, its
    bound and a library call's."""
    import torch

    from lhrs_bot_tpu_torch.benchmarks import hbm_peak_probe as hbm
    from lhrs_bot_tpu_torch.benchmarks import int8_probe as chains
    from lhrs_bot_tpu_torch.ops.cache_update import (
        cache_row_update_kernel, cache_row_update_plain, empty_kernel,
        row_write_blocks)
    from lhrs_bot_tpu_torch.ops.fused_decode import (
        SPLITS, fused_decode_attention_q_int8dots_kernel,
        fused_decode_attention_q_int8dots_plain,
        fused_decode_attention_q_int8dots_split_plain,
        fused_decode_attention_q_kernel, int8dots_launch_splits,
        int8dots_max_clusters)

    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}

    def codes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.025 + 0.005

    # the int8-dots decode kernel, at the plan's cluster size and every
    # forced one
    nl, h, s, d = 32, 32, 2304, 128
    scale = d ** -0.5
    dots = {"max_abs_err": 0.0}
    kc, vc = codes(nl, 2, h, s, d), codes(nl, 2, h, s, d)
    ks, vs = scales(nl, 2, h, s), scales(nl, 2, h, s)
    q = torch.randn(2, h, 1, d, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kn, vn = codes(2, h, 1, d), codes(2, h, 1, d)
    kns, vns = scales(2, h, 1), scales(2, h, 1)
    split_runs = (None,) + tuple(sorted(SPLITS))
    main_case = {}
    for lengths in ([511, 2191], [512, 700], [2191, 700]):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for block_s, layer in ((512, 0), (512, 31), (96, 5)):
            plain = [t.clone() for t in (kc, vc, ks, vs)]
            ref = fused_decode_attention_q_int8dots_plain(
                q, kn, kns, vn, vns, *plain, lens, layer, sm_scale=scale,
                block_s=block_s)[0]
            plan = int8dots_launch_splits(dev, 2, h, s, d, block_s)
            for splits in split_runs:
                mine = [t.clone() for t in (kc, vc, ks, vs)]
                got = fused_decode_attention_q_int8dots_kernel(
                    q, kn, kns, vn, vns, *mine, lens, layer, scale, block_s,
                    splits=splits)[0]
                torch.cuda.synchronize()
                label = (f"int8 dots lengths {lengths} block_s {block_s} "
                         f"layer {layer} C={splits or plan}")
                err = check_within(label, got, ref, INT8DOTS_ATOL)
                if not all(torch.equal(a, c) for a, c in zip(mine, plain)):
                    raise AssertionError(f"{label}: caches or planes differ")
                dots["max_abs_err"] = max(dots["max_abs_err"], err)
                log(f"  {label}{' (plan)' if splits is None else ''}: "
                    f"max_abs_err {err:.3e} (bound {INT8DOTS_ATOL:g}), "
                    "caches and planes exact")
                if lengths == [2191, 700] and block_s == 512 and layer == 0:
                    main_case[splits or plan] = got
                del mine
            del plain

    def whole_row_fault(name, q, kn, kns, vn, vns, kc, vc, ks, vs, lens,
                        layer, got):
        # the planted fault: the p scale over the whole row (one block of
        # S), held to the kernel's output by the same comparison
        bad = fused_decode_attention_q_int8dots_plain(
            q, kn, kns, vn, vns, kc.clone(), vc.clone(), ks.clone(),
            vs.clone(), lens, layer, sm_scale=scale, block_s=s)[0]
        torch.cuda.synchronize()
        try:
            check_within(name, got, bad, INT8DOTS_ATOL)
        except AssertionError:
            return float((bad.float() - got.float()).abs().max())
        raise AssertionError(f"int8 dots {name}: the whole-row p scale "
                             "passes the kernel's check")

    lens = torch.tensor([2191, 700], dtype=torch.int32, device=dev)
    dots["fault_max_abs_diff"] = {}
    for c, got in sorted(main_case.items()):
        fault = whole_row_fault(f"lengths [2191, 700] C={c}", q, kn, kns, vn,
                                vns, kc, vc, ks, vs, lens, 0, got)
        dots["fault_max_abs_diff"][f"c{c}"] = fault
    log(f"  int8 dots lengths [2191, 700] block_s 512 layer 0: planted fault "
        f"(p scale over the whole row) off by {dots['fault_max_abs_diff']} "
        "at C = 1, 2, 4, 8, above the bound")
    case = int8dots_fault_case(dev, gen, nl, h, s, d, scale)
    ref = fused_decode_attention_q_int8dots_plain(
        *[t.clone() for t in case[:9]], case[9], 0, sm_scale=scale,
        block_s=512)[0]
    dots["crafted_fault_max_abs_diff"] = {}
    for splits in sorted(SPLITS):
        got = fused_decode_attention_q_int8dots_kernel(
            *[t.clone() for t in case[:9]], case[9], 0, scale, 512,
            splits=splits)[0]
        torch.cuda.synchronize()
        err = check_within(f"int8 dots, mass outside the peak's block, "
                           f"C={splits}", got, ref, INT8DOTS_ATOL)
        dots["max_abs_err"] = max(dots["max_abs_err"], err)
        dots["crafted_fault_max_abs_diff"][f"c{splits}"] = whole_row_fault(
            f"mass outside the peak's block C={splits}", *case, 0, got)
    log(f"  int8 dots, mass outside the peak's block (length 2191), C = 1, "
        f"2, 4, 8: within the bound; planted fault (p scale over the whole "
        f"row) off by {dots['crafted_fault_max_abs_diff']}, above it")
    # the planted exchange fault: rank 0 leaves the last rank's int32 P.V
    # columns out; it must fail the check and match the plain split's
    dots["exchange_fault_max_abs_diff"] = {}
    for splits in (2, 4, 8):
        bad = fused_decode_attention_q_int8dots_kernel(
            q, kn, kns, vn, vns, kc.clone(), vc.clone(), ks.clone(),
            vs.clone(), lens, 0, scale, 512, splits=splits, fault=1)[0]
        bad_ref = fused_decode_attention_q_int8dots_split_plain(
            q, kn, kns, vn, vns, kc.clone(), vc.clone(), ks.clone(),
            vs.clone(), lens, 0, sm_scale=scale, block_s=512, splits=splits,
            fault=1)[0]
        torch.cuda.synchronize()
        try:
            check_within(f"int8 dots exchange fault C={splits}", bad,
                         main_case[splits], INT8DOTS_ATOL)
        except AssertionError as e:
            log(f"  int8 dots planted exchange fault (rank 0 leaves rank "
                f"{splits - 1}'s int32 P.V out) fails the check as it must: "
                f"{e}")
        else:
            raise AssertionError(f"int8 dots C={splits}: the planted "
                                 "exchange fault passes")
        err = check_within(f"int8 dots exchange fault C={splits} vs the "
                           "plain split", bad, bad_ref, INT8DOTS_ATOL)
        dots["exchange_fault_max_abs_diff"][f"c{splits}"] = float(
            (bad.float() - main_case[splits].float()).abs().max())
        log(f"  int8 dots planted exchange fault C={splits} vs the plain "
            f"split's: max_abs_err {err:.3e}")
    del case, main_case
    turn = iter(range(10**9))
    dots["splits"] = int8dots_launch_splits(dev, 2, h, s, d, 512)
    dots["resident_clusters"] = int8dots_max_clusters(d, 512, dots["splits"])
    dots["ms"] = cuda_ms(lambda: fused_decode_attention_q_int8dots_kernel(
        q, kn, kns, vn, vns, kc, vc, ks, vs, lens, next(turn) % nl, scale))
    for c in sorted(SPLITS):
        dots[f"ms_c{c}"] = cuda_ms(
            lambda: fused_decode_attention_q_int8dots_kernel(
                q, kn, kns, vn, vns, kc, vc, ks, vs, lens, next(turn) % nl,
                scale, splits=c))
    dots["k4_ms"] = cuda_ms(lambda: fused_decode_attention_q_kernel(
        q, kn, kns, vn, vns, kc, vc, ks, vs, lens, next(turn) % nl, scale))
    dots["plain_ms"] = cuda_ms(
        lambda: fused_decode_attention_q_int8dots_plain(
            q, kn, kns, vn, vns, kc, vc, ks, vs, lens, next(turn) % nl,
            sm_scale=scale), reps=5)
    deq = [(c[0].float() * sc[0][..., None]).bfloat16()
           for c, sc in ((kc, ks), (vc, vs))]
    dots["library_ms"] = cuda_ms(lambda: masked_sdpa(q, deq[0], deq[1],
                                                     lens + 1))
    dots["bound_ms"], dots["bound_by"] = decode_bound(lens, h, d, 1)
    log(f"  int8 dots time per layer call (B2, lengths [2191, 700], block_s "
        f"512): kernel {dots['ms']:.4f} ms (C = {dots['splits']}; "
        + ", ".join(f"C={c} {dots[f'ms_c{c}']:.4f}" for c in sorted(SPLITS))
        + f"; K4, bf16 dots, same call: {dots['k4_ms']:.4f} ms), plain "
        f"{dots['plain_ms']:.4f} ms, library (SDPA over the dequantized bf16 "
        f"cache) {dots['library_ms']:.4f} ms, bound {dots['bound_ms']:.4f} "
        f"ms ({dots['bound_by']})")
    out["int8dots"] = dots
    del kc, vc, ks, vs, deq
    torch.cuda.empty_cache()

    # the cache row write
    b, s_max = 8, 2304
    cache = torch.randn(b, h, s_max, d, generator=gen, device=dev,
                        dtype=torch.bfloat16)
    new = torch.randn(b, h, 1, d, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    lengths = [0, s_max - 1, 5, 2191, 700, 1, 2300, s_max]  # last: full
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    mine = cache_row_update_kernel(cache.clone(), new, lens)
    ref = cache.clone()
    cache_row_update_plain(ref[:-1], new[:-1], lens[:-1])
    torch.cuda.synchronize()
    if not torch.equal(mine, ref):
        raise AssertionError("cache_row_update: differs from the plain "
                             "version (or wrote into the full row)")
    for dtype in (torch.float32, torch.int8):  # the other dtypes it takes
        small = torch.randint(-100, 100, (4, 4, 64, 64), generator=gen,
                              device=dev).to(dtype)
        vals4 = torch.randint(-100, 100, (4, 4, 1, 64), generator=gen,
                              device=dev).to(dtype)
        lens4 = torch.tensor([0, 63, 17, 64], dtype=torch.int32, device=dev)
        got4 = cache_row_update_kernel(small.clone(), vals4, lens4)
        ref4 = small.clone()
        cache_row_update_plain(ref4[:-1], vals4[:-1], lens4[:-1])
        torch.cuda.synchronize()
        if not torch.equal(got4, ref4):
            raise AssertionError(f"cache_row_update {dtype}: differs from "
                                 "the plain version")
    upd = {"max_abs_err": 0.0}
    rows = torch.arange(b - 1, device=dev)
    idx = (rows[:, None], torch.arange(h, device=dev)[None, :],
           lens[:-1].long()[:, None])
    part = (cache[:-1].clone(), new[:-1], lens[:-1])
    upd["ms"] = cuda_ms(lambda: cache_row_update_kernel(*part))
    upd["plain_ms"] = cuda_ms(lambda: cache_row_update_plain(*part))
    vals = new[:-1, :, 0]
    upd["library_ms"] = cuda_ms(lambda: part[0].index_put_(idx, vals))
    upd["bound_ms"], upd["bound_by"] = bound(2 * (b - 1) * h * d * 2)
    # the launch floor: a kernel that does nothing, on the row write's grid
    upd["empty_ms"] = cuda_ms(lambda: empty_kernel(
        dev, row_write_blocks(b - 1, h, d * 2)))
    log(f"  cache_row_update B{b} H{h} S{s_max} D{d} bf16, lengths "
        f"{lengths} (the last row full): byte-equal to plain, full row "
        f"untouched (float32 and int8 at B4 H4 S64 D64 too); kernel {upd['ms']:.4f} ms, empty kernel on its grid "
        f"{upd['empty_ms']:.4f} ms, plain {upd['plain_ms']:.4f} "
        f"ms, library (index_put_) {upd['library_ms']:.4f} ms, bound "
        f"{upd['bound_ms']:.5f} ms ({upd['bound_by']})")
    out["cache_row_update"] = upd
    del cache, mine, ref, part
    torch.cuda.empty_cache()

    # the HBM readers
    x8, xb = hbm.buffers(dev, gen)
    reader = {"max_abs_err": 0.0, "shapes": []}
    for name, x in (("int8", x8), ("bf16", xb)):
        half, half2 = x[:x.shape[0] // 2], x[x.shape[0] // 2:]
        for dual, args in ((False, (x,)), (True, (half, half2))):
            checked = hbm.check_reader(*args, seed=len(reader["shapes"]),
                                       plants=6, read=hbm.hbm_read_kernel)
            n = x.numel() * x.element_size()
            ms = cuda_ms(lambda: hbm.hbm_read_kernel(*args), reps=5)
            plain_ms = cuda_ms(lambda: (hbm.hbm_dual_read_plain(*args)
                                        if dual else
                                        hbm.hbm_read_plain(*args)), reps=3)
            lib_ms = cuda_ms(lambda: [torch.amax(a) for a in args], reps=5)
            bms, by = bound(n)
            reader["shapes"].append({
                "dtype": name, "dual": dual, "bytes": n, "ms": ms,
                "GB_s": n / ms / 1e6, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": bms, "bound_by": by})
            log(f"  HBM reader {name} {'dual' if dual else 'single'} over "
                f"{n / 1e9:.2f} GB: a unique maximum planted at {checked} "
                f"places in turn, each read back and equal to plain; kernel "
                f"{ms:.4f} ms "
                f"({n / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, "
                f"library (torch.amax) {lib_ms:.4f} ms, bound {bms:.4f} ms")
        # planted fault: a reader that skips the array's last 16-byte word
        skip = 16 // x.element_size()
        try:
            hbm.check_reader(x, seed=9, plants=2, read=lambda a: (
                hbm.hbm_read_kernel(a.view(-1)[:-skip])))
        except AssertionError as e:
            log(f"  HBM reader {name}, planted fault (the last 16-byte word "
                f"skipped) caught: {e}")
        else:
            raise AssertionError(f"HBM reader {name}: the planted-maximum "
                                 "check passes a reader that skips a word")
    main = reader["shapes"][0]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        reader[key] = main[key]
    out["hbm_read"] = reader
    del x8, xb, half, half2, args
    torch.cuda.empty_cache()

    # the chains: every variant against its plain version at the probe's
    # shape, at an odd number of products (int8_alt's transposed window)
    # and over two blocks whose rows 0-7 differ; the requantized kernel
    # also on clusters of 2 and 3 CTAs; a refused shape raises
    ops = chains.operands(dev, gen)
    chain = {"max_abs_err": 0.0, "variants": []}

    def int8_case(g, m, n, ndots):
        return (torch.randint(-127, 127, (g, m, n), generator=gen,
                              device=dev, dtype=torch.int8),
                chains.weight_storage(torch.randint(
                    -127, 127, (ndots, n, n), generator=gen, device=dev,
                    dtype=torch.int8)))

    def odd_case(dtype):
        if dtype == "int8":
            return int8_case(2, 256, 256, 3)
        return ((torch.randn(2, 256, 256, generator=gen, device=dev) * 0.1
                 ).to(torch.bfloat16),
                chains.weight_storage((torch.randn(
                    3, 256, 256, generator=gen, device=dev) * 0.1
                ).to(torch.bfloat16)))

    odd = {"int8": odd_case("int8"), "bf16": odd_case("bf16")}
    for variant in chains.VARIANTS:
        kind = "bf16" if variant == "bf16" else "int8"
        xg, ws = ops[kind]
        if torch.equal(xg[0, :8], xg[1, :8]):
            raise AssertionError("chains: blocks 0 and 1 share rows 0-7")
        err = chains.check_chain(xg, ws, variant)
        xo, wo = odd[kind]
        err = max(err, chains.check_chain(xo, wo, variant))
        form = chains.chain_form(variant, ws.shape[0])[0]
        odd_trans = chains.chain_form(variant, wo.shape[0])[1]
        verdict = (f"window and total each within {err:.2e} relative"
                   if variant == "bf16" else "bit-identical")
        ms = cuda_ms(lambda: chains.int8_chain_kernel(xg, ws, variant),
                     warmup=1, reps=3)
        plain_ms = cuda_ms(lambda: chains.int8_chain_plain(xg, ws, variant),
                           warmup=1, reps=1, rounds=1)
        lib_ms = cuda_ms(lambda: chains.library_chain(xg, ws, variant),
                         warmup=1, reps=3)
        n_ops = chains.chain_ops(xg, ws)
        bms, by = chain_bound(xg, ws, variant)
        chain["variants"].append({
            "variant": variant, "form": form, "ms": ms,
            "TOPS": n_ops / ms / 1e9,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_TOPS": n_ops / lib_ms / 1e9, "bound_ms": bms,
            "bound_by": by, "bound_share": bms / ms, "max_rel_err": err})
        log(f"  chain {variant} ({form}; g {xg.shape[0]}, M {xg.shape[1]}, "
            f"K {xg.shape[2]}, N {ws.shape[2]}, {ws.shape[0]} products; and "
            f"g 2, M = K = N 256, 3 products, window "
            f"{'transposed' if odd_trans else 'plain'}): {verdict}; kernel "
            f"{ms:.4f} ms ({n_ops / ms / 1e9:.0f} TOPS, {bms / ms:.0%} of "
            f"the bound), plain {plain_ms:.2f} ms, library {lib_ms:.4f} ms "
            f"({n_ops / lib_ms / 1e9:.0f} TOPS), bound {bms:.4f} ms ({by})")
    try:
        chains.int8_chain_kernel(ops["int8"][0][:1, :192], ops["int8"][1],
                                 "int8")
    except ValueError as e:
        log(f"  chain int8 at M 192 refused: {e}")
    else:
        raise AssertionError("int8_chain_kernel took M 192")
    # N 1024 and 256 ran above: clusters of 4 and 1 CTAs
    for n, ndots in ((512, 2), (768, 3)):
        xc, wc = int8_case(1, 128, n, ndots)
        for variant in ("int8_req", "int8_alt"):
            chains.check_chain(xc, wc, variant)
        log(f"  chain int8_req / int8_alt at g 1, M 128, K = N {n}, "
            f"{ndots} products (a cluster of {n // 256}): bit-identical")
    del odd, xc, wc
    main = chain["variants"][0]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        chain[key] = main[key]
    out["int8_chain"] = chain
    del ops
    torch.cuda.empty_cache()
    return out


def chain_bound(xg, ws, variant):
    """The bound of a chain call: its blocks and weights read once, its
    (g, 8, 128) output written once; 2 M K N operations a product."""
    from lhrs_bot_tpu_torch.benchmarks import int8_probe as chains

    n_bytes = (xg.numel() * xg.element_size()
               + ws.numel() * ws.element_size() + xg.shape[0] * 4096)
    return bound(n_bytes, chains.chain_ops(xg, ws),
                 "bf16" if variant == "bf16" else "int8")


HBM_BYTES_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks


def bound(n_bytes, ops=0.0, kind="bf16"):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the card's memory rate and the operations over its peak rate."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def block_bound(n_bytes, int8_ops, bf16_ops):
    """The bound of a fused block: its bytes over the memory rate, or its
    int8 and bf16 operations each over their peak, summed."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = (int8_ops / PEAK_OPS_S["int8"] + bf16_ops / PEAK_OPS_S["bf16"]) \
        * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_bound(lengths, h, d, elt):
    """The bound of a decode attention call: the K and V rows (and, for an
    int8 cache of elt 1, their float32 scales) of each row's lengths + 1
    positions read once, q / the new rows read and the output written once;
    4 (len + 1) D operations a head."""
    n = int((lengths.long() + 1).sum())
    row = h * (d * elt + (4 if elt == 1 else 0))
    b = lengths.numel()
    return bound(2 * n * row + b * h * d * (2 * 2 + 2 * elt), 4.0 * n * h * d)


def masked_sdpa(q, k, v, lengths):
    """The library call beside the decode kernels: one
    scaled_dot_product_attention of q (B, H, 1, D) over the first
    lengths[b] rows of contiguous (B, H, S, D) K/V (attention only)."""
    import torch
    import torch.nn.functional as F

    mask = (torch.arange(k.shape[2], device=k.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


# The paged kernels' rows: lengths around page boundaries (128, 127) and the
# serving wave's spliced lengths; one more row is a ghost (an idle slot:
# all-null table, a frozen length).
PAGED_LENGTHS = (2191, 1143, 843, 443, 263, 183, 128, 127)
GHOST_LENGTH = 300
POISON = 1.0e4


def paged_case(dev, gen, page, int8, nl=32, h=32, d=128, s_max=2304,
               spare=8):
    """Pools (L, N, H, page, D) of random rows, a table whose rows hold
    ceil((len + 1) / page) shuffled pages each and a ghost row of null
    pages, `spare` unallocated pages; the null and unallocated pages
    poisoned. Returns a dict of the inputs and the valid page ids."""
    import torch

    lengths = list(PAGED_LENGTHS) + [GHOST_LENGTH]
    b, pps = len(lengths), -(-s_max // page)
    need = [-(-(n + 1) // page) for n in PAGED_LENGTHS]
    n_pages = 1 + sum(need) + spare
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(
        page)) + 1
    table = torch.zeros(b, pps, dtype=torch.int32)
    at = 0
    for r, n in enumerate(need):
        table[r, :n] = perm[at:at + n].int()
        at += n
    used = perm[:at].tolist()
    free = [0] + perm[at:].tolist()
    shape = (nl, n_pages, h, page, d)
    if int8:
        def pool():
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)

        def scales(*sh):
            return torch.rand(sh, generator=gen, device=dev) * 0.02 + 0.005

        case = {"k_pages": pool(), "v_pages": pool(),
                "k_scale_pages": scales(*shape[:-1]),
                "v_scale_pages": scales(*shape[:-1]),
                "k_new": torch.randint(-127, 128, (b, h, 1, d), generator=gen,
                                       device=dev, dtype=torch.int8),
                "v_new": torch.randint(-127, 128, (b, h, 1, d), generator=gen,
                                       device=dev, dtype=torch.int8),
                "k_new_scale": scales(b, h, 1), "v_new_scale": scales(b, h, 1)}
        for name in ("k_pages", "v_pages"):
            case[name][:, free] = 127
        for name in ("k_scale_pages", "v_scale_pages"):
            case[name][:, free] = POISON
    else:
        def randn(*sh):
            return torch.randn(sh, generator=gen, device=dev,
                               dtype=torch.bfloat16)

        case = {"k_pages": randn(*shape), "v_pages": randn(*shape),
                "k_new": randn(b, h, 1, d), "v_new": randn(b, h, 1, d)}
        for name in ("k_pages", "v_pages"):
            case[name][:, free] = POISON
    case["q"] = torch.randn(b, h, 1, d, generator=gen, device=dev,
                            dtype=torch.bfloat16)
    case["page_table"] = table.to(dev)
    case["lengths"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return case, used, free


POOLS = ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages")


def paged_args(case, pools, int8):
    """The positional arguments of the paged wrappers (kernel and plain)
    before `layer`, with `pools` in place of the case's pools."""
    if int8:
        return (case["q"], case["k_new"], case["k_new_scale"], case["v_new"],
                case["v_new_scale"], *pools, case["page_table"],
                case["lengths"])
    return (case["q"], case["k_new"], case["v_new"], *pools,
            case["page_table"], case["lengths"])


PAGED_SIZES = (128, 48, 16)  # pages: the serving paths', stages that
# cross pages (48: a 128-row stage spans three), the CPU tests' 16
PAGED_BAD_ENTRY = 12  # row 0's entry in rank 1's share at C = 2 (page 128)


def paged_gathered_k4(case, pools, layer, splits):
    """K4 at `splits` on the case's rows gathered from the pools (before
    the append) into a one-layer contiguous cache: the paged int8 kernel's
    bits at that C."""
    from lhrs_bot_tpu_torch.ops import fused_decode as fd
    from lhrs_bot_tpu_torch.ops.paged_fused import _gather_pages

    cont = [_gather_pages(p[layer], case["page_table"])[None].contiguous()
            for p in pools]
    return fd.fused_decode_attention_q_kernel(
        case["q"], case["k_new"], case["k_new_scale"], case["v_new"],
        case["v_new_scale"], *cont, case["lengths"], 0, 128 ** -0.5,
        splits=splits)[0]


def phase_paged_kernels(dev):
    """The paged decode pair against their plain versions at L32 H32 D128:
    eight rows around page boundaries plus a ghost row, shuffled pages, the
    null and unallocated pages poisoned, layers 0 and 31; the bf16 pool at
    pages of 128 and 16, the int8 pool (the split kernel) at pages of 128,
    48 and 16 at the plan's cluster size and every forced one. Outputs of
    the live rows within ATOL + RTOL of plain and unmoved by the poison
    (equal to a run on unpoisoned pools); pools and scale pages byte-equal
    to plain's and to the inputs with the appended rows written. The int8
    kernel also: bit for bit K4 at the same C on the rows gathered from the
    pages; a page id outside the pool in rank 1's share of row 0 gives NaN
    for row 0 alone and writes nothing of it, at every C (no hang); a
    planted merge fault (the last rank left out) fails the check and
    matches the plain split's. Times at page 128 (int8: every C), with the
    library call (scaled_dot_product_attention over the gathered,
    already-appended cache) and the bound."""
    import torch

    from lhrs_bot_tpu_torch.ops import fused_decode as fd
    from lhrs_bot_tpu_torch.ops.paged_fused import (
        _append_target, _gather_pages, paged_fused_decode_kernel,
        paged_fused_decode_plain, paged_fused_decode_q_kernel,
        paged_fused_decode_q_plain, paged_fused_decode_q_split_plain,
        paged_max_clusters)

    gen = torch.Generator(device=dev).manual_seed(9)
    live = slice(0, len(PAGED_LENGTHS))
    scale = 128 ** -0.5
    out = {}
    for int8 in (False, True):
        name = "paged_fused_decode_q" if int8 else "paged_fused_decode"
        kernel = paged_fused_decode_q_kernel if int8 else \
            paged_fused_decode_kernel
        plain = paged_fused_decode_q_plain if int8 else \
            paged_fused_decode_plain
        pool_names = POOLS if int8 else POOLS[:2]
        # the int8 kernel at the plan's C and every forced one; the bf16
        # kernel takes no cluster
        split_runs = (None,) + tuple(sorted(fd.SPLITS)) if int8 else (None,)
        res = {"max_abs_err": 0.0}
        for page in PAGED_SIZES if int8 else (128, 16):
            case, used, free = paged_case(dev, gen, page, int8)
            pools = [case[p] for p in pool_names]
            lengths, table = case["lengths"], case["page_table"]
            plan = fd.decode_launch_splits(dev, len(PAGED_LENGTHS) + 1, 32,
                                           table.shape[1] * page, 128, 1)
            for layer in (0, 31):
                ref_pools = [p.clone() for p in pools]
                args = list(paged_args(case, ref_pools, int8))
                args[0] = args[0].float()
                ref = plain(*args, layer, sm_scale=scale)[0]
                # the expected pools: the inputs with the rows appended
                want = [p.clone() for p in pools]
                pg, off = _append_target(table, lengths, page)
                rows = [case["k_new"][:, :, 0], case["v_new"][:, :, 0]]
                if int8:
                    rows += [case["k_new_scale"][:, :, 0],
                             case["v_new_scale"][:, :, 0]]
                for w, r in zip(want, rows):
                    w[layer, pg, :, off] = r
                # unpoisoned pools: live outputs unmoved by the poison
                clean = [p.clone() for p in pools]
                for p in clean:
                    p[:, free] = 0 if p.dtype == torch.int8 else 1
                for splits in split_runs:
                    kw = {"splits": splits} if int8 else {}
                    mine = [p.clone() for p in pools]
                    got = kernel(*paged_args(case, mine, int8), layer, scale,
                                 **kw)[0]
                    got_clean = kernel(
                        *paged_args(case, [p.clone() for p in clean], int8),
                        layer, scale, **kw)[0]
                    torch.cuda.synchronize()
                    c = splits or plan
                    tag = (f"{name} page {page} layer {layer}"
                           + (f" C={c}" if int8 else ""))
                    err = check_close(tag, got[live], ref[live])
                    if not torch.equal(got[live], got_clean[live]):
                        raise AssertionError(f"{tag}: live outputs move "
                                             "with the poisoned null/"
                                             "unallocated pages")
                    if not all(torch.equal(a, c_) for a, c_ in
                               zip(mine, ref_pools)):
                        raise AssertionError(f"{tag}: pools differ from the "
                                             "plain version's")
                    if not all(torch.equal(a, w) for a, w in
                               zip(mine, want)):
                        raise AssertionError(f"{tag}: rows other than the "
                                             "appended ones changed")
                    bits = ""
                    if int8:
                        k4 = paged_gathered_k4(case, pools, layer, c)
                        if not torch.equal(got[live], k4[live]):
                            raise AssertionError(f"{tag}: differs from K4 at "
                                                 f"C = {c} on the gathered "
                                                 "rows")
                        bits = f", K4 at C = {c} bit for bit"
                    res["max_abs_err"] = max(res["max_abs_err"], err)
                    log(f"  {tag}{' (plan)' if int8 and not splits else ''}:"
                        f" lengths {lengths.tolist()} (last a ghost row of "
                        f"null pages), {len(used)} shuffled pages, "
                        f"{len(free)} poisoned: max_abs_err {err:.3e}, pools "
                        f"exact, poison unseen{bits}")
                    del mine
                del ref_pools, want, clean
            if int8 and page in (128, 48):
                paged_bad_page(case, pools, page, scale, kernel)
            if int8 and page == 128:
                res["fault_err"] = paged_merge_fault(
                    case, pools, scale, kernel,
                    paged_fused_decode_q_split_plain)
            if page == 128:
                lens = lengths[live]
                sub = dict(case)
                sub["q"] = case["q"][live].contiguous()
                for key in ("k_new", "v_new", "k_new_scale", "v_new_scale"):
                    if key in case:
                        sub[key] = case[key][live].contiguous()
                sub["page_table"] = table[live].contiguous()
                sub["lengths"] = lens.contiguous()
                turn = iter(range(10**9))
                nl = pools[0].shape[0]
                res["ms"] = cuda_ms(lambda: kernel(
                    *paged_args(sub, pools, int8), next(turn) % nl, scale))
                if int8:
                    res["splits"] = fd.decode_launch_splits(
                        dev, len(PAGED_LENGTHS), 32, table.shape[1] * page,
                        128, 1)
                    res["resident_clusters"] = paged_max_clusters(
                        128, res["splits"])
                    sms = torch.cuda.get_device_properties(
                        dev).multi_processor_count
                    if res["resident_clusters"] * res["splits"] < 2 * sms:
                        raise AssertionError(
                            f"{name}: {res['resident_clusters']} clusters of "
                            f"{res['splits']} resident, not 2 CTAs an SM")
                    for c in sorted(fd.SPLITS):
                        res[f"ms_c{c}"] = cuda_ms(lambda: kernel(
                            *paged_args(sub, pools, int8), next(turn) % nl,
                            scale, splits=c))
                res["plain_ms"] = cuda_ms(lambda: plain(
                    *paged_args(sub, pools, int8), next(turn) % nl,
                    sm_scale=scale))
                # library: SDPA over the contiguous gathered cache (bf16;
                # int8 dequantized), the append excluded
                kv = [_gather_pages(p[0], sub["page_table"]) for p in pools]
                if int8:
                    kv = [(kv[0].float() * kv[2][..., None]).bfloat16(),
                          (kv[1].float() * kv[3][..., None]).bfloat16()]
                res["library_ms"] = cuda_ms(lambda: masked_sdpa(
                    sub["q"], kv[0], kv[1], lens + 1))
                res["bound_ms"], res["bound_by"] = decode_bound(
                    lens, 32, 128, 1 if int8 else 2)
                sweep = ""
                if int8:
                    sweep = (f" (C = {res['splits']}; " + ", ".join(
                        f"C={c} {res[f'ms_c{c}']:.4f}"
                        for c in sorted(fd.SPLITS)) + ")")
                log(f"  {name} time per layer call, B8 page 128: kernel "
                    f"{res['ms']:.4f} ms{sweep}, plain {res['plain_ms']:.4f}"
                    f" ms, library (SDPA, append excluded) "
                    f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} "
                    f"ms ({res['bound_by']}); {smi_line()}")
                del kv
            del case, pools
            torch.cuda.empty_cache()
        out[name] = res
    return out


def paged_bad_page(case, pools, page, scale, kernel):
    """Row 0's table entry PAGED_BAD_ENTRY names a page past the pool: at
    every C row 0 gives NaN and nothing of it is written (its append page
    unchanged), the other rows' outputs and appends are the good table's;
    every rank checks every valid entry, so no rank waits for one that
    left (a hang would trap in the barrier wait and fail the launch)."""
    import torch

    from lhrs_bot_tpu_torch.ops import fused_decode as fd

    bad = dict(case)
    bad["page_table"] = case["page_table"].clone()
    n_pages = pools[0].shape[1]
    bad["page_table"][0, PAGED_BAD_ENTRY * 128 // page] = n_pages + 7
    for splits in sorted(fd.SPLITS):
        mine = [p.clone() for p in pools]
        good = [p.clone() for p in pools]
        got = kernel(*paged_args(bad, mine, True), 0, scale,
                     splits=splits)[0]
        ref = kernel(*paged_args(case, good, True), 0, scale,
                     splits=splits)[0]
        torch.cuda.synchronize()
        ap = int(case["page_table"][0, int(case["lengths"][0]) // page])
        if not bool(got[0].isnan().all()):
            raise AssertionError(f"paged int8 page {page} C={splits}: a bad "
                                 "page id must give NaN")
        if not torch.equal(got[1:len(PAGED_LENGTHS)],
                           ref[1:len(PAGED_LENGTHS)]):
            raise AssertionError(f"paged int8 page {page} C={splits}: a bad "
                                 "page in row 0 moved other rows")
        for m, g, p in zip(mine, good, pools):
            if not torch.equal(m[0, ap], p[0, ap]):
                raise AssertionError(f"paged int8 page {page} C={splits}: "
                                     "row 0 wrote its append page")
            others = [i for i in range(p.shape[1]) if i != ap]
            if not torch.equal(m[:, others], g[:, others]):
                raise AssertionError(f"paged int8 page {page} C={splits}: "
                                     "other rows' appends differ")
        del mine, good
    log(f"  paged_fused_decode_q page {page}: row 0's entry "
        f"{PAGED_BAD_ENTRY * 128 // page} past the pool (rank 1's share at "
        "C = 2): NaN for row 0, nothing of it written, other rows "
        "unchanged, at C = 1, 2, 4, 8")


def paged_merge_fault(case, pools, scale, kernel, split_plain):
    """The planted merge fault at C = 4 (rank 0 leaves rank 3 out, which
    holds row 0's rows 1920.. and values of 120) must fail the check and
    match the plain split's own fault."""
    import torch

    from lhrs_bot_tpu_torch.ops.paged_fused import paged_fused_decode_q_plain

    pools = [p.clone() for p in pools]
    pools[1][0, case["page_table"][0, 15:18].long()] = 120
    live = slice(0, len(PAGED_LENGTHS))

    def plain(fn, **kw):
        args = list(paged_args(case, [p.clone() for p in pools], True))
        args[0] = args[0].float()
        return fn(*args, 0, sm_scale=scale, **kw)[0]

    ref = plain(paged_fused_decode_q_plain)
    bad_ref = plain(split_plain, splits=4, fault=1)
    bad = kernel(*paged_args(case, [p.clone() for p in pools], True), 0,
                 scale, splits=4, fault=1)[0]
    torch.cuda.synchronize()
    try:
        check_close("paged int8 planted fault", bad[live], ref[live])
    except AssertionError as e:
        log(f"  paged_fused_decode_q planted fault (rank 0 leaves rank 3 "
            f"out) fails the check as it must: {e}")
    else:
        raise AssertionError("paged int8: the planted merge fault passes")
    err = check_close("paged int8 planted fault vs the plain split",
                      bad[live], bad_ref[live])
    log(f"  paged_fused_decode_q planted fault vs the plain split-and-merge's"
        f": max_abs_err {err:.3e}")
    return float((bad[live].float() - ref[live].float()).abs().max())


VIT_W, VIT_S, VIT_S_PAD = 1024, 257, 272
# (K, N) of the vision tower's int8 projections: QKV, O (and the
# perceiver's q), FC, proj, and the perceiver's fused K|V
GEMM_SHAPES = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
               (1024, 2048))
# Kernel B at the edges of its 128 x 128 output tile and 128-byte K stage:
# (M, K, N, row stride of A or None, epilogue). M below one wgmma's 64 rows
# and not a multiple of 128; N a multiple of 8 but not of 128; K a multiple
# of 64 but not of 128; A a strided view (lda > K).
GEMM_EDGES = ((40, 1024, 1024, None, "O"), (257, 1088, 1032, None, "QKV"),
              (VIT_S * 64, 1088, 1032, None, "FC"),
              (300, 1024, 3072, 1152, "proj"), (513, 64, 8, None, "XLA"))


def gemm_edge_epilogue(name, m, n, gen, dev):
    """Keyword arguments of one of kernel B's epilogues at (m, n)."""
    import torch

    bias = torch.randn(n, generator=gen, device=dev) * 0.1
    if name == "QKV":
        return dict(bias=bias, ws_first=True, q_fold=0.125, n_fold=n // 3)
    if name == "O":
        return dict(bias=bias, out_dtype=torch.float32, residual=torch.randn(
            m, n, generator=gen, device=dev, dtype=torch.bfloat16))
    if name == "FC":
        return dict(bias=bias, act="quick_gelu", out_dtype=torch.float32)
    if name == "proj":
        return dict(bias=bias, residual=torch.randn(m, n, generator=gen,
                                                    device=dev))
    return dict(bias=bias, round_mid=True, act="gelu")


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


# kernel A's quantize-only checks: (M, W, dtype name) of every path shape
# (the tower's 16448 rows of 1024 and its FC's 4096 in float32, the int8
# cache's K/V rows at B = 7, the decoder's single rows of 4096 and 11008)
# and the row grouping's edges: a CTA of 32 rows of 128 cut short (229), a
# width that is not a multiple of 16 (4100), 11008 rows at M = 16448
A_QUANT_SHAPES = ((16448, 1024, "bfloat16"), (16448, 1024, "float32"),
                  (16448, 4096, "float32"), (16448, 11008, "bfloat16"),
                  (7 * 32, 128, "bfloat16"), (229, 128, "bfloat16"),
                  (1, 4096, "bfloat16"), (1, 11008, "bfloat16"),
                  (1, 4100, "bfloat16"), (3, 4100, "float32"))
# and its LayerNorm mode: LN1 (bf16 in), LN2 (float32 in), a strided
# ragged width (rows of 4100 in a 4104-wide buffer)
A_LN_SHAPES = ((16448, 1024, "bfloat16"), (16448, 1024, "float32"),
               (5, 4100, "bfloat16"))


def a_outputs_poisoned(dev, m, w):
    """Fill blocks of the sizes of A's outputs with a code no row takes
    (-128) and NaN scales, then free them: the caching allocator hands them
    to the next call of those sizes, so an element the kernel leaves
    unwritten cannot equal the plain version's. Returns the codes' block
    address, to tell whether the kernel got it."""
    import torch

    q = torch.full((m, w), -128, dtype=torch.int8, device=dev)
    s = torch.full((m, 1), float("nan"), device=dev)
    ptr = q.data_ptr()
    del q, s
    return ptr


def phase_a(dev, gen):
    """Kernel A against its plain version: quantize-only bit for bit at
    A_QUANT_SHAPES (a zero row and an outlier row in each, the outputs'
    blocks poisoned), the LayerNorm mode within one code at A_LN_SHAPES,
    with times."""
    import torch

    from lhrs_bot_tpu_torch.ops.ln_quant import (div_exact, ln_quant_kernel,
                                                 ln_quant_plain, row_plan)

    def rows(m, w, dtype, width=None, mul=1.0, shift=0.0):
        x = (torch.randn(m, width or w, generator=gen, device=dev) * mul
             + shift).to(getattr(torch, dtype))[:, :w]
        if m > 2:
            x[1] = 0  # amax 0: scale 1, codes 0
            x[2, w - 1] = 50.0  # an outlier in the row's last element
        return x

    ka = {"max_abs_err": 0.0, "shapes": []}
    for m, w, dtype in A_QUANT_SHAPES:
        # rows of a width that is not a multiple of 8 lie in a wider buffer
        x = rows(m, w, dtype, width=-(-w // 8) * 8)
        ptr = a_outputs_poisoned(dev, m, w)
        q, s = ln_quant_kernel(x)
        qp, sp = ln_quant_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(q, qp) and torch.equal(s, sp)):
            raise AssertionError(
                f"A quantize-only ({m}, {w}) {dtype}: {int((q != qp).sum())} "
                f"codes and {int((s != sp).sum())} scales differ from the "
                "plain version")
        ms = cuda_ms(lambda: ln_quant_kernel(x))
        bms, by = bound(m * w * (x.element_size() + 1) + 4 * m)
        lanes, chunks, per_cta = row_plan(w)
        ka["shapes"].append({"M": m, "W": w, "dtype": dtype, "ln": False,
                             "ms": ms, "bound_ms": bms, "bound_by": by,
                             "lanes": lanes, "chunks": chunks})
        log(f"  A quantize-only ({m}, {w}) {dtype}: codes and scales equal "
            f"(outputs poisoned: {q.data_ptr() == ptr}); {lanes} lanes x "
            f"{chunks} chunks a row, {per_cta} rows a CTA; {ms:.4f} ms, "
            f"bound {bms:.4f} ms")
    # near ties: float32 rows whose values lie at (k + 1/2) s and one ulp
    # to either side, where a quotient one ulp off would round to another
    # code; some rows' scales small (1e-17, still the reciprocal route) or
    # tiny (1e-27, the IEEE division's)
    m, w = 256, 1024
    amax = torch.rand(m, 1, generator=gen, device=dev) * 10 + 1e-3
    amax[:64] *= 1e-15
    amax[64:96] *= 1e-25
    s_ = div_exact(amax, 127.0)
    k = torch.randint(-126, 126, (m, w), generator=gen, device=dev).float()
    x = (k + 0.5) * s_
    step = torch.randint(-1, 2, (m, w), generator=gen, device=dev)
    x = torch.where(step == 0, x, torch.nextafter(x, x + step * amax))
    x[:, 0] = amax[:, 0]
    q, s = ln_quant_kernel(x)
    qp, sp = ln_quant_plain(x)
    torch.cuda.synchronize()
    if not (torch.equal(q, qp) and torch.equal(s, sp)):
        raise AssertionError(f"A quantize-only, near ties: "
                             f"{int((q != qp).sum())} codes and "
                             f"{int((s != sp).sum())} scales differ")
    log(f"  A quantize-only, near ties ({m}, {w}) float32, scales down to "
        f"{float(s.min()):.1e}: codes and scales equal")
    for m, w, dtype in A_LN_SHAPES:
        x = rows(m, w, dtype, width=-(-w // 8) * 8, mul=2.0, shift=0.3)
        g = torch.rand(w, generator=gen, device=dev) + 0.5
        b = torch.randn(w, generator=gen, device=dev) * 0.1
        a_outputs_poisoned(dev, m, w)
        q, s = ln_quant_kernel(x, g, b, 1e-5)
        qp, sp = ln_quant_plain(x, g, b, 1e-5)
        torch.cuda.synchronize()
        code_diff = (q.int() - qp.int()).abs()
        s_rel = float(((s - sp).abs() / sp).max())
        share = float((code_diff > 0).float().mean())
        if int(code_diff.max()) > 1 or share > 1e-3 or s_rel > 1e-5:
            raise AssertionError(f"A LayerNorm ({m}, {w}) {dtype}: codes off "
                                 f"by up to {int(code_diff.max())} "
                                 f"({share:.2e} of them), scales by "
                                 f"{s_rel:.2e} relative")
        # dequantized, the LayerNorm mode's error is that of one code at most
        err = float((q.float() * s - qp.float() * sp).abs().max())
        ka["max_abs_err"] = max(ka["max_abs_err"], err)
        ms = cuda_ms(lambda: ln_quant_kernel(x, g, b, 1e-5))
        # rows in; codes and float32 row scales out; gamma, beta
        bms, by = bound(m * w * (x.element_size() + 1) + 4 * m + 8 * w)
        ka["shapes"].append({"M": m, "W": w, "dtype": dtype, "ln": True,
                             "ms": ms, "bound_ms": bms, "bound_by": by})
        log(f"  A LayerNorm ({m}, {w}) {dtype}: codes within one "
            f"({share:.2e} differ), scales within {s_rel:.2e} relative, "
            f"dequantized max abs err {err:.3e}; {ms:.4f} ms, bound "
            f"{bms:.4f} ms")
        if (m, w, dtype) == (64 * VIT_S, VIT_W, "bfloat16"):  # LN1
            ka["ms"], ka["bound_ms"], ka["bound_by"] = ms, bms, by
            ka["plain_ms"] = cuda_ms(lambda: ln_quant_plain(x, g, b, 1e-5))
            log(f"  A time, LN1 of 64 images ({m}, {w}): kernel {ms:.4f} "
                f"ms, plain {ka['plain_ms']:.4f} ms, bound {bms:.4f} ms "
                f"({by})")
    ka["library_ms"] = None  # no one PyTorch call quantizes rows
    return ka


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
    out["A"] = phase_a(dev, gen)

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
        # the library yardstick: the int32 product alone, no epilogue
        lib = cuda_ms(lambda: torch._int_mm(a, w))
        tops = 2 * m_big * n * k / ms / 1e9
        bms, by = bound(m_big * k + k * n + 4 * (m_big + n) + 2 * m_big * n,
                        2.0 * m_big * n * k, "int8")
        kb["shapes"].append({"K": k, "N": n, "M": m_big, "ms": ms,
                             "plain_ms": plain, "library_ms": lib,
                             "TOPS": tops, "bound_ms": bms, "bound_by": by})
        log(f"  B K{k} N{n}, M {VIT_S} and {m_big}: int32 accumulators "
            f"bit-identical; bf16 out at M {m_big}: kernel {ms:.4f} ms "
            f"({tops:.0f} TOPS), plain {plain:.4f} ms, library "
            f"(torch._int_mm, int32 product only) {lib:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
    # the edges of the 128 x 128 tile and the 128-byte K stage: int32
    # accumulators bit for bit, then one epilogue each
    for m, k, n, lda, epi in GEMM_EDGES:
        w = transposed_storage(codes(k, n))
        ws = torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4
        a = codes(m, lda or k)[:, :k]
        xs = torch.rand(m, 1, generator=gen, device=dev) * 0.02 + 1e-3
        acc = int8_gemm_kernel(a, xs, w, ws, out_dtype=torch.int32)
        ref = int8_gemm_plain(a, xs, w, ws, out_dtype=torch.int32)
        torch.cuda.synchronize()
        if not torch.equal(acc, ref):
            raise AssertionError(f"B edge M{m} K{k} N{n} lda {lda or k}: "
                                 f"{int((acc != ref).sum())} int32 "
                                 "accumulators differ from the plain product")
        kw = gemm_edge_epilogue(epi, m, n, gen, dev)
        err = check_block(f"B edge M{m} K{k} N{n} {epi}",
                          int8_gemm_kernel(a, xs, w, ws, **kw),
                          int8_gemm_plain(a, xs, w, ws, **kw))
        kb["max_abs_err"] = max(kb["max_abs_err"], err)
        log(f"  B edge M{m} K{k} N{n} lda {lda or k}: int32 accumulators "
            f"bit-identical; epilogue {epi}: max abs err {err:.3e}")
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
    # codes of A and W, their scales and the bias read once, the float32
    # output written once; 2 M N K int8 operations
    kb["bound_ms"], kb["bound_by"] = bound(
        m_big * k + k * n + 4 * (m_big + 2 * n) + 4 * m_big * n,
        2.0 * m_big * n * k, "int8")
    kb["library_ms"] = cuda_ms(lambda: torch._int_mm(a, w))
    log(f"  B time, FC + QuickGELU of 64 images ({m_big} x {k} x {n}): "
        f"kernel {kb['ms']:.4f} ms, plain {kb['plain_ms']:.4f} ms, library "
        f"(torch._int_mm, int32 product only) {kb['library_ms']:.4f} ms, "
        f"bound {kb['bound_ms']:.4f} ms ({kb['bound_by']})")
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
    # the same at a ragged length, no pad: 257 rows, one past four 64-row
    # tiles, so the last q and kv tiles hold one row
    qkv = torch.randn(4, VIT_S, 3 * VIT_W, generator=gen, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = _heads(qkv, 3, 16)
    got = attend_token_major(q, k, v, None, 0.125, torch.float32)
    ref = attend_token_major(q, k, v, None, 0.125, torch.float32, plain=True)
    torch.cuda.synchronize()
    err = check_close("K1 strided, ragged, float32 out", got, ref)
    log(f"  K1 strided QKV views, 4 x {VIT_S} tokens, no pad, float32 "
        f"token-major out: max abs err {err:.3e}")
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
        # int8 weights (QKV, O, FC, proj: 12 W^2) with their float32 scales
        # and biases, the bf16 block input and output; the GEMMs over the
        # valid tokens in int8, the attention in bf16
        m = nb * VIT_S
        bms, by = block_bound(
            12 * VIT_W ** 2 + 8 * 9 * VIT_W + 2 * 2 * nb * VIT_S_PAD * VIT_W,
            2.0 * m * 12 * VIT_W ** 2, 4.0 * nb * VIT_S ** 2 * VIT_W)
        blocks[f"fused_vit_block_b{nb}"] = {"max_abs_err": err, "ms": ms,
                                            "plain_ms": plain,
                                            "bound_ms": bms, "bound_by": by}
        log(f"  fused_vit_block B{nb} (S_pad {VIT_S_PAD}): max abs err "
            f"{err:.3e}; kernels {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
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
    # int8 weights (q, k|v, O, FC, proj: 12 W^2) with float32 scales and
    # biases, the bf16 queries in and out and the keys/values in; q, O, FC
    # and proj over the valid queries and k|v over the valid keys in int8,
    # the attention in bf16
    m_q, m_kv = 2 * sum(nq), 2 * sum(n + 256 for n in nq)
    bms, by = block_bound(
        12 * VIT_W ** 2 + 8 * 9 * VIT_W + 2 * 3 * (2 * q_pad + kv_pad) * VIT_W
        * 2, 2.0 * (m_q * 10 + m_kv * 2) * VIT_W ** 2,
        4.0 * 2 * sum(n * (n + 256) for n in nq) * VIT_W)
    blocks["fused_perceiver_block"] = {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain, "bound_ms": bms,
                                       "bound_by": by}
    log(f"  fused_perceiver_block (2 images, 3 groups): max abs err "
        f"{err:.3e}; kernels {ms:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bms:.4f} ms ({by})")
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


# Paged decode against contiguous decode on the same cache contents: the
# paged kernels and K2 / K4 at one CTA a head (splits=1: the contiguous
# side is forced to it, since the plan's clusters fold the softmax in
# another order) compute the same sums in the same order, so the logits
# should agree to the last bit; 1e-3 relative L2 leaves room for a
# reordering, and a page swapped between two rows' tables moves them O(1).
PAGED_REL_L2 = 1e-3


def phase_paged_vs_contiguous(lp, lcfg, dev):
    """Prefill two rows (600 and 451 tokens) into a contiguous cache, copy
    the rows into shuffled pages of a pool (`scatter_prefill`), then one
    decode step through `llama_decode_step` and one through
    `paged_decode_step`: relative L2 of the logits within PAGED_REL_L2, for
    a bf16 and an int8 cache; with one table entry swapped between the two
    rows it must exceed it. The int8 side runs both paths as served (the
    plan's C on both, the same shares), so their logits must be equal."""
    import dataclasses
    import functools
    import math

    import torch

    from lhrs_bot_tpu_torch.models import (KVCache, llama_decode_step,
                                           llama_prefill)
    from lhrs_bot_tpu_torch.models.llama_paged import (PagedKVCache,
                                                       paged_decode_step,
                                                       scatter_prefill)
    import lhrs_bot_tpu_torch.models.llama as llama
    from lhrs_bot_tpu_torch.ops import fused_decode as fd

    # the bf16 side's contiguous path through K2 at one CTA a head
    # (splits=1): the bf16 paged kernel is not split, and C = 1 gives its
    # sums in its order. The int8 side runs as served: K4 and the paged
    # int8 kernel both at the plan's C (2 here), the same shares.
    scale = 1.0 / math.sqrt(lcfg.head_dim)
    splits1 = {
        "fused_decode_attention": functools.partial(
            fd.fused_decode_attention_kernel, sm_scale=scale, splits=1)}
    rng = np.random.default_rng(2)
    plen = torch.tensor([600, 451], dtype=torch.int32, device=dev)
    ids = torch.as_tensor(rng.integers(3, lcfg.vocab_size, (2, 640)),
                          device=dev)
    embed = lp["embed_tokens"]
    page, pps = 128, 18
    out = {}
    for name, cache_dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        cache = KVCache.create(lcfg, 2, 640, cache_dtype, dev)
        logits, cache = llama_prefill(lp, lcfg, cache,
                                      inputs_embeds=embed[ids],
                                      prompt_len=plen)
        tok = logits.argmax(dim=-1)
        step = embed[tok][:, None]
        n_pages = 1 + 2 * pps
        perm = torch.randperm(n_pages - 1,
                              generator=torch.Generator().manual_seed(3)) + 1
        table = perm.reshape(2, pps).int().to(dev)
        pcache = PagedKVCache.create(lcfg, 2, n_pages, pps, page,
                                     cache_dtype, dev)
        pcache = scatter_prefill(pcache, cache, torch.arange(2, device=dev),
                                 table, plen)
        faulty = dataclasses.replace(
            pcache, **{f: getattr(pcache, f).clone() for f in
                       ("k_pages", "v_pages", "k_scale_pages",
                        "v_scale_pages") if getattr(pcache, f) is not None})
        swapped = table.clone()
        swapped[0, 1], swapped[1, 1] = table[1, 1], table[0, 1]
        faulty.page_table = swapped
        with patched(llama, **(splits1 if name == "bf16" else {})):
            logits_c, _ = llama_decode_step(lp, lcfg, cache,
                                            inputs_embeds=step)
        logits_p, _ = paged_decode_step(lp, lcfg, pcache, inputs_embeds=step)
        logits_f, _ = paged_decode_step(lp, lcfg, faulty, inputs_embeds=step)
        del cache, pcache, faulty
        torch.cuda.empty_cache()
        if not bool(logits_p.isfinite().all()):
            raise AssertionError(f"paged decode ({name}): non-finite logits")
        rel, fault = rel_l2(logits_p, logits_c), rel_l2(logits_f, logits_c)
        log(f"  paged vs contiguous decode ({name} cache, rows of 600 and "
            f"451 tokens, shuffled pages of 128): rel L2 {rel}, bound "
            f"{PAGED_REL_L2}; planted fault (one table entry swapped between "
            f"the rows) {fault}")
        if max(rel) > PAGED_REL_L2:
            raise AssertionError(f"paged decode ({name}) deviates: {rel}")
        if name == "int8" and not torch.equal(logits_p, logits_c):
            raise AssertionError(f"paged decode (int8, as served) differs "
                                 f"from the contiguous one: {rel}")
        if name == "bf16":
            out["prefill"] = prefill_readings(lp, lcfg, dev, embed[ids], plen,
                                              logits, table, n_pages)
            out["prefill_f32"] = check_paged_prefill(lp, lcfg, dev)
        if min(fault) <= PAGED_REL_L2:
            raise AssertionError(f"paged decode ({name}): the planted fault "
                                 f"passes: {fault}")
        out[name] = {"rel_l2": rel, "fault_rel_l2": fault,
                     "bound": PAGED_REL_L2}
    return out


# The paged prefill against the contiguous prefill through the plain
# attention, both in float32 (weights, activations, pool and cache), on the
# first PAGED_PREFILL_DEPTH layers at full width: the same function with
# its sums in another order (the paged scores span the whole table row,
# masked), so the last-token logits should agree to float32 rounding, about
# 1e-6 relative L2. Every layer runs the same code, so depth adds nothing
# but rounding. A suffix written one page early, or a context page read
# from the null page, moves the logits by orders of magnitude more.
PAGED_PREFILL_REL_L2 = 1e-4
PAGED_PREFILL_DEPTH = 4


def check_paged_prefill(lp, lcfg, dev):
    """Two rows of 600 and 451 tokens sharing a 256-token prefix (two pages
    of 128). The contiguous plain prefill of each whole row against the
    paged path of a prefix hit: `paged_prefill_with_context` of the prefix
    alone into two shuffled pages, then of both rows' suffixes with ctx_len
    256 over tables that name those shared pages first; and against the
    whole rows through the paged prefill with ctx_len 0. Float32, the first
    PAGED_PREFILL_DEPTH layers. Relative L2 of the logits within
    PAGED_PREFILL_REL_L2; each planted fault (ctx_len one page short, so
    the suffix lands on a shared page at shifted positions; one row's
    second context page replaced by the null page) must exceed it in a row
    it touches."""
    import dataclasses

    import torch

    from lhrs_bot_tpu_torch.models import KVCache, llama_prefill
    from lhrs_bot_tpu_torch.models.llama_paged import (
        PagedKVCache, paged_prefill_with_context)

    f32 = torch.float32
    depth, page, ctx = PAGED_PREFILL_DEPTH, 128, 256
    cfg = dataclasses.replace(lcfg, num_hidden_layers=depth)
    params = {"layers": {k: v[:depth].float()
                         for k, v in lp["layers"].items()},
              **{k: lp[k].float() for k in ("embed_tokens", "final_norm",
                                            "lm_head")}}
    rng = np.random.default_rng(6)
    plen = torch.tensor([600, 451], dtype=torch.int32, device=dev)
    ids = torch.as_tensor(rng.integers(3, lcfg.vocab_size, (2, 640)),
                          device=dev)
    ids[:, 0] = lcfg.bos_token_id
    ids[1, :ctx] = ids[0, :ctx]
    embeds = params["embed_tokens"][ids]
    with plain_attention():
        ref, _ = llama_prefill(params, cfg, KVCache.create(cfg, 2, 640, f32,
                                                           dev),
                               inputs_embeds=embeds, prompt_len=plen,
                               compute_dtype=f32)
    # pages: 2 shared, 3 + 2 fresh for the suffixes, 2 for row 1's own
    # prefix when ctx_len is 0; shuffled, page 0 the null page. Table rows
    # of 18 pages (2304 tokens, the serving pool's), the rest null.
    pps, n_pages = 18, 10
    perm = (torch.randperm(n_pages - 1,
                           generator=torch.Generator().manual_seed(7)) + 1
            ).int().tolist()
    shared, fresh0, fresh1, own1 = perm[:2], perm[2:5], perm[5:7], perm[7:9]
    table = torch.tensor([shared + fresh0 + [0] * (pps - 5),
                          shared + fresh1 + [0] * (pps - 4)],
                         dtype=torch.int32, device=dev)
    slots = torch.arange(2, device=dev)

    def paged(table_rows, ctx_len, prefix_pool=None):
        pc = PagedKVCache.create(cfg, 2, n_pages, pps, page, f32, dev)
        if ctx_len is None:  # the whole rows, no context
            return paged_prefill_with_context(
                params, cfg, pc, inputs_embeds=embeds, suffix_len=plen,
                ctx_len=torch.zeros_like(plen), slot_idx=slots,
                table_rows=table_rows, compute_dtype=f32)[0]
        pc.k_pages.copy_(prefix_pool[0])
        pc.v_pages.copy_(prefix_pool[1])
        c = torch.tensor([ctx_len] * 2, dtype=torch.int32, device=dev)
        return paged_prefill_with_context(
            params, cfg, pc, inputs_embeds=embeds[:, ctx:],
            suffix_len=plen - ctx, ctx_len=c, slot_idx=slots,
            table_rows=table_rows, compute_dtype=f32)[0]

    # the prefix alone, into the shared pages
    pc = PagedKVCache.create(cfg, 1, n_pages, pps, page, f32, dev)
    paged_prefill_with_context(
        params, cfg, pc, inputs_embeds=embeds[:1, :ctx],
        suffix_len=torch.tensor([ctx], dtype=torch.int32, device=dev),
        ctx_len=torch.zeros(1, dtype=torch.int32, device=dev),
        slot_idx=slots[:1], table_rows=table[:1], compute_dtype=f32)
    prefix_pool = (pc.k_pages, pc.v_pages)
    own = table.clone()
    own[1, :2] = torch.tensor(own1, dtype=torch.int32)
    nulled = table.clone()
    nulled[1, 1] = 0
    got = {"context 256": paged(table, ctx, prefix_pool),
           "context 0": paged(own, None)}
    faults = {"ctx_len one page short": paged(table, ctx - page, prefix_pool),
              "context page nulled": paged(nulled, ctx, prefix_pool)}
    del params, embeds, pc, prefix_pool
    torch.cuda.empty_cache()
    out = {"bound": PAGED_PREFILL_REL_L2, "depth": depth}
    for name, logits in got.items():
        if not bool(logits.isfinite().all()):
            raise AssertionError(f"paged prefill ({name}): non-finite logits")
        out[name] = rel = rel_l2(logits, ref)
        if max(rel) > PAGED_PREFILL_REL_L2:
            raise AssertionError(f"paged prefill ({name}) deviates from the "
                                 f"contiguous prefill in float32: {rel}")
    for name, logits in faults.items():
        out[name] = rel = rel_l2(logits, ref)
        if max(rel) <= PAGED_PREFILL_REL_L2:
            raise AssertionError(f"paged prefill: the planted fault "
                                 f"({name}) passes: {rel}")
    log(f"  paged vs contiguous plain prefill, float32, first {depth} "
        f"layers, rows of 600 and 451 tokens sharing a 256-token prefix: "
        f"{out}")
    return out


def prefill_readings(lp, lcfg, dev, embeds, plen, logits_k1, table,
                     n_pages):
    """A reading, not a check: the first-token logits of the paged
    prefill (`paged_prefill_with_context`, plain attention over the
    gathered table row) against the contiguous prefill through K1 and
    through the plain attention (`mha_reference`), bf16, with the top-1
    agreement and each row's top-2 margin."""
    import torch

    from lhrs_bot_tpu_torch.models import KVCache, llama_prefill
    from lhrs_bot_tpu_torch.models.llama_paged import (
        PagedKVCache, paged_prefill_with_context)

    pcache = PagedKVCache.create(lcfg, 2, n_pages, table.shape[1], 128,
                                 torch.bfloat16, dev)
    logits_pp, _ = paged_prefill_with_context(
        lp, lcfg, pcache, inputs_embeds=embeds, suffix_len=plen,
        ctx_len=torch.zeros_like(plen), slot_idx=torch.arange(2, device=dev),
        table_rows=table)
    del pcache
    with plain_attention():
        logits_plain, _ = llama_prefill(
            lp, lcfg, KVCache.create(lcfg, 2, embeds.shape[1],
                                     torch.bfloat16, dev),
            inputs_embeds=embeds, prompt_len=plen)
    top2 = logits_k1.topk(2, dim=-1).values
    out = {"paged_vs_k1": rel_l2(logits_pp, logits_k1),
           "paged_vs_plain": rel_l2(logits_pp, logits_plain),
           "plain_vs_k1": rel_l2(logits_plain, logits_k1),
           "top1_paged_eq_k1": (logits_pp.argmax(-1)
                                == logits_k1.argmax(-1)).tolist(),
           "top1_paged_eq_plain": (logits_pp.argmax(-1)
                                   == logits_plain.argmax(-1)).tolist(),
           "k1_top2_margin": (top2[:, 0] - top2[:, 1]).tolist()}
    log(f"  prefill logits (a reading), bf16, rows of 600 and 451 tokens: "
        f"{out}")
    return out


def serving_wave(cfg, rng):
    """The full-width serving wave: 12 requests of 40 to 2048 prompt
    tokens, four with an image, three sharing a 256-token text prefix
    (P1 admitted first; P2 and P3 come after the pool defers admission,
    so they hit P1's pages), 32 new tokens each, greedy."""
    vocab = cfg.llama.vocab_size
    prefix = rng.integers(3, vocab, 256).astype(np.int32)
    prefix[0] = cfg.llama.bos_token_id

    def text(n, shared=False):
        ids = rng.integers(3, vocab, n).astype(np.int32)
        ids[0] = cfg.llama.bos_token_id
        if shared:
            ids[:256] = prefix
        return ids

    def image(n):
        ids = text(n)
        ids[1] = -200
        return ids

    size = cfg.vit.image_size
    images = rng.integers(0, 256, (4, size, size, 3)).astype(np.uint8)
    # (prompt, image index or None): pages of 128 for prompt + image
    # + 32 new tokens: 18, 16, 3, 14, 10, 6, 2 fill 69 of the pool's 72;
    # P2's 4 do not fit, so the pool defers it with a slot free
    spec = [(image(2048), 0), (text(2000), None), (text(300, True), None),
            (image(1500), 1), (text(1200), None), (text(700), None),
            (image(40), 2), (text(356, True), None), (image(800), 3),
            (text(120), None), (text(316, True), None), (text(90), None)]
    return [(ids, None if im is None else images[im]) for ids, im in spec]


PAGED_KERNELS = ("paged_fused_decode", "paged_fused_decode_q")
CONTIGUOUS_DECODE = ("fused_decode_attention", "fused_decode_attention_q")


def drive(sched, requests, check_tick=None):
    """Serve `requests` as `ContinuousBatchingScheduler.run` does, timing
    each request's first token from the start of the wave, counting decode
    steps (each tick's `last_tick_k`), and logging every admission;
    `check_tick(sched)` runs after each tick. Returns the wave's numbers."""
    import torch

    steps = 0
    admissions, ttft = [], {}
    pending = list(requests)
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def admit():
        nonlocal pending
        free = getattr(sched, "allocator", None)
        before = None if free is None else free.available()
        n = sched.admit(pending)
        if n:
            admissions.append({
                "uids": [r.uid for r in pending[:n]],
                "deferred": len(pending) - n,
                "free_slots": len(sched._free_slots()),
                "free_pages_before": before,
                "free_pages_after": None if free is None
                else free.available()})
        pending = pending[n:]

    def mark():
        now = time.perf_counter() - t0
        for r in requests:
            if r.output_ids and r.uid not in ttft:
                ttft[r.uid] = now * 1e3

    admit()
    mark()
    while sched.active.any() or pending:
        if pending and sched._free_slots():
            admit()
            mark()
        sched.step(waiting=len(pending))
        steps += sched.last_tick_k
        mark()
        if check_tick is not None:
            check_tick(sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.output_ids) for r in requests)
    return {"wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "decode_steps": steps, "admissions": admissions,
            "ttft_ms": [ttft.get(r.uid) for r in requests]}


def check_paged_pool(sched, name):
    """Every page free or a refcount-0 prefix page, no slot holding one,
    every table row null."""
    st = sched.pool_stats()
    if (st["free_pages"] + st["prefix"]["evictable"] != st["total_pages"]
            or st["prefix"]["entries"] != st["prefix"]["evictable"]
            or any(sched.slot_pages) or bool(sched.cache.page_table.any())):
        raise AssertionError(f"{name}: pool not back to free/evictable: {st}")
    return st


def idle_rows_null(sched):
    """No idle slot's table row names a page that a live slot holds."""
    table = sched.cache.page_table.cpu().numpy()
    held = set(table[sched.active].ravel().tolist()) - {0}
    for slot in np.flatnonzero(~sched.active):
        if set(table[slot].tolist()) & held:
            raise AssertionError(f"idle slot {slot}'s table row names a live "
                                 f"page: {table}")


def serve_wave(name, sched, wave, needed, forbidden, check_tick=None):
    """One scheduler run over `wave` ((ids, image) pairs, 32 new tokens
    each): launch counts set to 0 just before and read just after; the
    kernels of `needed` launched 32 times a decode step, those of
    `forbidden` never; every request done with 1-32 tokens in the
    vocabulary."""
    from lhrs_bot_tpu_torch.serve.scheduler import Request

    wrappers = kernel_wrappers()
    requests = [Request(uid=i, input_ids=ids, image=img, max_new_tokens=32)
                for i, (ids, img) in enumerate(wave)]
    for w in wrappers.values():
        w.launches = 0
    res = drive(sched, requests, check_tick)
    launches = {k: w.launches for k, w in wrappers.items()}
    vocab = sched.cfg.llama.vocab_size
    for r in requests:
        if not r.done or not 1 <= len(r.output_ids) <= r.max_new_tokens or \
                any(not 0 <= t < vocab for t in r.output_ids):
            raise AssertionError(f"{name}: request {r.uid} bad: done "
                                 f"{r.done}, {len(r.output_ids)} tokens")
    n_layers = sched.cfg.llama.num_hidden_layers
    for k in needed:
        if launches[k] != n_layers * res["decode_steps"] or not launches[k]:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times "
                                 f"in {res['decode_steps']} decode steps")
    for k in forbidden:
        if launches[k]:
            raise AssertionError(f"{name}: {k} launched {launches[k]} times")
    res["launches"] = launches
    res["outputs"] = [r.output_ids for r in requests]
    if hasattr(sched, "pool_stats"):
        res["pool_stats"] = check_paged_pool(sched, name)
    log(f"  [{name}] {len(requests)} requests, {res['tokens']} tokens in "
        f"{res['wall_s']:.2f} s: {res['tok_s']:.1f} tokens/s; "
        f"{res['decode_steps']} decode steps; time to first token (ms) "
        f"{[round(t, 1) for t in res['ttft_ms']]}")
    log(f"  [{name}] admissions {res['admissions']}")
    log(f"  [{name}] launches {launches}"
        + (f"; pool {res['pool_stats']}" if "pool_stats" in res else ""))
    return res


def agreement(a, b):
    """The share of token positions where two runs' outputs agree, up to
    the first difference of each request, and the requests equal."""
    same = sum(x == y for x, y in zip(a, b))
    prefix = [next((i for i, (s, t) in enumerate(zip(x, y)) if s != t),
                   min(len(x), len(y))) for x, y in zip(a, b)]
    return {"requests_equal": same, "of": len(a),
            "tokens_before_first_difference": prefix}


# The reference's page-table fault (ROADMAP Queue 3): prompts of 20, 20, 40
# and 45 tokens from np.random.default_rng(5).integers(3, 200), budgets 3,
# 3, 30 and 20; max_batch 3, pages of 16, 6 pages a sequence, 40 pages,
# prefix cache off, prompt_bucket 16, 2 tokens a tick.
HAZARD = ((20, 3), (20, 3), (40, 30), (45, 20))


def phase_hazard(engine, cfg, dev):
    """The hazard wave at full width: the paged scheduler (pages of 16, so
    the kernel's ragged edge too) against the contiguous one, with no idle
    slot's table row naming a live page after any tick."""
    from lhrs_bot_tpu_torch.serve.paged import PagedScheduler
    from lhrs_bot_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler, Request)

    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 200, size=(n,)).astype(np.int32)
               for n, _ in HAZARD]
    common = dict(max_batch=3, prompt_bucket=16, tokens_per_tick=2,
                  cache_dtype=engine.cache_dtype, device=dev,
                  eos_token_id=cfg.llama.eos_token_id)
    outs = {}
    for name, sched in (
            ("contiguous", ContinuousBatchingScheduler(
                cfg, engine.params, engine.llama_params, max_seq_len=96,
                **common)),
            ("paged", PagedScheduler(
                cfg, engine.params, engine.llama_params, num_pages=40,
                page_size=16, pages_per_seq=6, enable_prefix_cache=False,
                **common))):
        reqs = [Request(uid=i, input_ids=p, max_new_tokens=budget)
                for i, (p, (_, budget)) in enumerate(zip(prompts, HAZARD))]
        drive(sched, reqs, idle_rows_null if name == "paged" else None)
        outs[name] = [r.output_ids for r in reqs]
        if name == "paged":
            check_paged_pool(sched, "hazard wave")
        del sched
    agree = agreement(outs["paged"], outs["contiguous"])
    log(f"  hazard wave (full width, pages of 16): no idle table row named a "
        f"live page after any tick; paged vs contiguous greedy ids {agree}")
    return {"agreement": agree, "outputs": outs}


# The training kernels against their plain versions on the same bf16 inputs:
# the forward's log-sum-exp within LSE_ATOL, dQ, dK and dV each within
# GRAD_REL_L2 relative L2 of the plain backward (which follows the TPU
# kernels' rounding points; the kernels sum in another order and round the
# probabilities of the forward's PV product unnormalised). Each check has a
# planted fault that must exceed its bound in every run: the forward with
# its scale 1% off for the LSE, the backward given an LSE 0.5 too high (P
# scaled by 0.61) for the gradients.
LSE_ATOL = 1e-3
GRAD_REL_L2 = 1e-2


def train_attention_cases(dev, gen):
    """(name, q, k, v, d_out, kv_mask, segment_ids, causal) at the training
    path's shapes: the decoder (B1 H32 S2048 D128, causal, a kv_mask with
    1791 valid keys; the same with 4 packed segments and a padding tail),
    the perceiver's groups (B8 H16 D64, non-causal), and ragged edges,
    among them the edges of the backward's 64-row tiles and of its skip
    rule: unsorted segment ids, a q tile all of segment 0, a kv_mask whose
    holes mask whole tiles, and lengths that are no multiple of 64."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def segments(b, s, runs):  # runs of (segment id, length)
        seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
        pos = 0
        for i, n in runs:
            seg[:, pos:pos + n] = i
            pos += n
        return seg

    specs = [  # name, B, H, Sq, Skv, D, causal, mask / seg
        ("decoder_kvmask", 1, 32, 2048, 2048, 128, True, ("mask", 1791)),
        ("decoder_segments", 1, 32, 2048, 2048, 128, True,
         ("seg", (600, 500, 400, 291))),
        ("perceiver_g0", 8, 16, 64, 320, 64, False, None),
        ("perceiver_g1", 8, 16, 48, 304, 64, False, None),
        ("edge_seg_d64", 2, 2, 200, 200, 64, True, ("seg", (70, 1, 90))),
        ("edge_mask_d128", 2, 3, 77, 133, 128, False, ("mask", 100)),
        ("edge_causal_tail_d128", 1, 2, 130, 130, 128, True, None),
        # segments at a length that is no multiple of the 64-row tiles,
        # with a padding tail of segment 0
        ("edge_seg_d128_ragged", 1, 4, 1000, 1000, 128, True,
         ("seg", (300, 129, 450))),
        # segment ids out of order (2, 1, 2, 1) and a padding tail
        ("edge_seg_unsorted_d128", 1, 4, 700, 700, 128, True,
         ("runs", ((2, 150), (1, 130), (2, 200), (1, 90)))),
        # rows 100-249 of segment 0: q tile 2 (rows 128-191) all padding
        ("edge_seg_zero_tile_d64", 2, 2, 400, 400, 64, True,
         ("runs", ((1, 100), (0, 150), (2, 150)))),
        # kv_masks whose holes mask whole 64-row kv tiles mid-sequence
        ("edge_mask_holes_d128", 2, 2, 150, 400, 128, False,
         ("hole", (128, 256))),
        ("edge_mask_hole_causal_d64", 1, 3, 333, 333, 64, True,
         ("hole", (64, 130))),
        # causal, Sq and Skv no multiple of 64 nor of each other
        ("edge_ragged_d128", 2, 2, 95, 161, 128, True, None),
        ("edge_ragged_d64", 3, 2, 161, 95, 64, True, None),
    ]
    for name, b, h, sq, skv, d, causal, extra in specs:
        mask = seg = None
        kind = extra[0] if extra else None
        if kind == "mask":
            mask = (torch.arange(skv, device=dev) < extra[1]).expand(
                b, skv).contiguous()
        elif kind == "hole":
            pos = torch.arange(skv, device=dev)
            mask = ((pos < extra[1][0]) | (pos >= extra[1][1])).expand(
                b, skv).contiguous()
        elif kind == "seg":
            seg = segments(b, sq, [(i + 1, n) for i, n in enumerate(extra[1])])
        elif kind == "runs":
            seg = segments(b, sq, extra[1])
        yield (name, randn(b, h, sq, d), randn(b, h, skv, d),
               randn(b, h, skv, d), randn(b, h, sq, d), mask, seg, causal)


def attention_bound(valid, mask, seg, b, h, sq, skv, d, products, q_rows,
                    kv_rows, lse_rows):
    """Bound of an attention pass over this call's inputs: `products`
    D-long products of 2 operations a head for each pair that attends (the
    pairs counted from the mask `valid`, None for all), or the bytes over
    the memory rate: `q_rows` bf16 (B, H, Sq, D) tensors (Q, dO, O, dQ),
    `kv_rows` (B, H, Skv, D) tensors (K, V, dK, dV), `lse_rows` float32
    (B, H, Sq) rows (LSE, delta), and the kv_mask and segment ids, each
    read or written once."""
    pairs = (b * sq * skv if valid is None
             else int(valid.expand(b, 1, sq, skv).sum()))
    n_bytes = (2 * b * h * d * (q_rows * sq + kv_rows * skv)
               + 4 * b * h * sq * lse_rows
               + (0 if mask is None else mask.numel())
               + (0 if seg is None else 4 * seg.numel()))
    return bound(n_bytes, 2.0 * products * h * pairs * d)


def check_tile_table(name, args, runs, valid, want):
    """That both backward kernels run exactly the tile pairs of the table
    `runs` they are given: with every pair set they give `want` (their
    result on the rule's table) bit for bit, so the pairs the rule skips
    add exactly 0; with none set, zeros; with one pair cleared that holds a
    pair that attends, another result. `args` are the launchers' (q, k, v,
    kv_mask, segment_ids, lse, delta, d_out, causal, sm_scale)."""
    import torch
    import torch.nn.functional as F

    from lhrs_bot_tpu_torch.ops.attention import (
        BWD_TILE, flash_attention_bwd_dkv, flash_attention_bwd_dq)

    def grads(table):
        return (flash_attention_bwd_dq(*args, table),
                *flash_attention_bwd_dkv(*args, table))

    b, nq, nk = runs.shape
    sq, skv = args[0].shape[2], args[1].shape[2]
    if valid is None:
        valid = torch.ones(1, 1, sq, skv, dtype=torch.bool,
                           device=runs.device)
    # the tile pairs that hold a pair that attends
    attends = F.pad(valid.expand(b, 1, sq, skv)[:, 0],
                    (0, nk * BWD_TILE - skv, 0, nq * BWD_TILE - sq)).view(
        b, nq, BWD_TILE, nk, BWD_TILE).any(4).any(2)
    if bool((attends & ~runs).any()):
        raise AssertionError(f"bwd {name}: the table skips a tile pair that "
                             "holds a pair that attends")
    full = grads(torch.ones_like(runs))
    if not all(torch.equal(x, y) for x, y in zip(full, want)):
        raise AssertionError(f"bwd {name}: running every tile pair changes "
                             "the gradients (a skipped pair is not 0)")
    if any(bool(x.any()) for x in grads(torch.zeros_like(runs))):
        raise AssertionError(f"bwd {name}: with no tile pair to run the "
                             "gradients are not 0")
    cut = runs.clone()
    cut.view(-1)[int(attends.view(-1).nonzero()[-1])] = False
    if any(torch.equal(x, y) for x, y in zip(grads(cut), want)):
        raise AssertionError(f"bwd {name}: clearing a tile pair that "
                             "attends leaves a gradient unchanged")


def phase_train_kernels(dev):
    """The forward's LSE and segment ids, and the dQ and dK/dV kernels,
    against their plain versions at the training path's shapes, each with a
    planted fault; that the backward kernels run exactly the tile pairs of
    the table they are given; times at the decoder shape (and the
    perceiver's for the backward) beside the plain versions, SDPA and the
    bound."""
    import torch
    import torch.nn.functional as F

    from lhrs_bot_tpu_torch.ops.attention import (
        BWD_TILE, _allowed, bwd_tile_pairs, bwd_tile_table,
        flash_attention_bwd,
        flash_attention_bwd_dkv, flash_attention_bwd_dq,
        flash_attention_bwd_reference, flash_attention_fwd, mha_reference)

    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"fwd": {"max_abs_err": 0.0, "lse_max_abs_err": 0.0},
           "dq": {"max_abs_err": 0.0, "rel_l2": 0.0},
           "dkv": {"max_abs_err": 0.0, "rel_l2": 0.0}, "cases": {}}
    for name, q, k, v, do, mask, seg, causal in train_attention_cases(
            dev, gen):
        b, h, sq, d = q.shape
        skv = k.shape[2]
        scale = d ** -0.5
        lse = torch.empty(b, h, sq, device=dev)
        o = flash_attention_fwd(q, k, v, mask, causal, scale,
                                segment_ids=seg, lse=lse)
        o_p, lse_p = mha_reference(q, k, v, mask, causal=causal,
                                   sm_scale=scale, segment_ids=seg,
                                   return_lse=True)
        lse_f = torch.empty_like(lse)
        flash_attention_fwd(q, k, v, mask, causal, scale * 1.01,
                            segment_ids=seg, lse=lse_f)
        torch.cuda.synchronize()
        valid = _allowed(sq, skv, mask, seg, causal, dev)
        rows = (torch.ones(b, sq, dtype=torch.bool, device=dev)
                if valid is None else valid.expand(b, 1, sq, skv).any(-1)[:, 0])
        rmask = rows[:, None].expand(b, h, sq)  # rows with a valid key
        err = check_close(f"fwd {name}", o, mha_reference(
            q.float(), k.float(), v.float(), mask, causal=causal,
            sm_scale=scale, segment_ids=seg), rmask)
        if bool((o[~rmask] != 0).any()):
            raise AssertionError(f"fwd {name}: rows with no valid key "
                                 "are not 0")
        if not bool((lse[~rmask] == 1e30).all()):
            raise AssertionError(f"fwd {name}: LSE of rows with no valid "
                                 "key is not 1e30")
        lse_err = float((lse - lse_p)[rmask].abs().max())
        lse_fault = float((lse_f - lse_p)[rmask].abs().max())
        if lse_err > LSE_ATOL or lse_fault <= LSE_ATOL:
            raise AssertionError(f"fwd {name}: LSE max abs err {lse_err:.3e}"
                                 f", planted fault {lse_fault:.3e} (bound "
                                 f"{LSE_ATOL})")
        dq, dk, dv = flash_attention_bwd(q, k, v, mask, seg, o, lse, do,
                                         causal, scale)
        dq_p, dk_p, dv_p = flash_attention_bwd_reference(
            q, k, v, mask, seg, o_p, lse_p, do, causal, scale)
        fq, fk, fv = flash_attention_bwd(q, k, v, mask, seg, o, lse + 0.5,
                                         do, causal, scale)
        dq2, dk2, dv2 = flash_attention_bwd(q, k, v, mask, seg, o, lse, do,
                                            causal, scale)
        torch.cuda.synchronize()
        if not (torch.equal(dq, dq2) and torch.equal(dk, dk2)
                and torch.equal(dv, dv2)):
            raise AssertionError(f"bwd {name}: two runs differ (the kernels "
                                 "must be deterministic)")
        delta = (do.float() * o.float()).sum(-1)
        runs = bwd_tile_table(mask, seg, b, sq, skv, causal, dev)
        check_tile_table(name, (q, k, v, mask, seg, lse, delta, do, causal,
                                scale), runs, valid, (dq, dk, dv))
        reading = {"fwd_max_abs_err": err, "lse_max_abs_err": lse_err,
                   "lse_fault": lse_fault}
        for gname, got, ref, fault, key in (("dq", dq, dq_p, fq, "dq"),
                                            ("dk", dk, dk_p, fk, "dkv"),
                                            ("dv", dv, dv_p, fv, "dkv")):
            if not bool(got.isfinite().all()):
                raise AssertionError(f"{gname} {name}: non-finite")
            rel = float((got.float() - ref.float()).norm()
                        / ref.float().norm())
            rel_f = float((fault.float() - ref.float()).norm()
                          / ref.float().norm())
            if rel > GRAD_REL_L2 or rel_f <= GRAD_REL_L2:
                raise AssertionError(f"{gname} {name}: relative L2 {rel:.3e},"
                                     f" planted fault {rel_f:.3e} (bound "
                                     f"{GRAD_REL_L2})")
            reading[f"{gname}_rel_l2"], reading[f"{gname}_fault"] = rel, rel_f
            out[key]["rel_l2"] = max(out[key]["rel_l2"], rel)
            out[key]["max_abs_err"] = max(
                out[key]["max_abs_err"],
                float((got.float() - ref.float()).abs().max()))
        out["fwd"]["max_abs_err"] = max(out["fwd"]["max_abs_err"], err)
        out["fwd"]["lse_max_abs_err"] = max(out["fwd"]["lse_max_abs_err"],
                                            lse_err)
        line = (f"  train {name}: q{(b, h, sq, d)} kv {skv} causal={causal} "
                f"mask={mask is not None} seg={seg is not None}: fwd "
                f"{err:.3e}, LSE {lse_err:.3e} (fault {lse_fault:.3e}); rel "
                f"L2 dq {reading['dq_rel_l2']:.3e} dk {reading['dk_rel_l2']:.3e}"
                f" dv {reading['dv_rel_l2']:.3e} (faults "
                f"{reading['dq_fault']:.3f} {reading['dk_fault']:.3f} "
                f"{reading['dv_fault']:.3f}); deterministic")
        if name in ("decoder_kvmask", "decoder_segments", "perceiver_g0"):
            # each launcher timed as a caller with no table calls it (it
            # builds the table); the whole backward (delta, the table, both
            # kernels) as the training path calls it, against SDPA's
            attn = valid if valid is not None else None
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=attn, scale=scale)
            t = {
                "fwd_ms": cuda_ms(lambda: flash_attention_fwd(
                    q, k, v, mask, causal, scale, segment_ids=seg, lse=lse)),
                "fwd_plain_ms": cuda_ms(lambda: mha_reference(
                    q, k, v, mask, causal=causal, sm_scale=scale,
                    segment_ids=seg, return_lse=True)),
                "fwd_library_ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=attn, scale=scale)),
                "dq_ms": cuda_ms(lambda: flash_attention_bwd_dq(
                    q, k, v, mask, seg, lse, delta, do, causal, scale)),
                "dkv_ms": cuda_ms(lambda: flash_attention_bwd_dkv(
                    q, k, v, mask, seg, lse, delta, do, causal, scale)),
                "bwd_ms": cuda_ms(lambda: flash_attention_bwd(
                    q, k, v, mask, seg, o, lse, do, causal, scale)),
                "table_ms": cuda_ms(lambda: bwd_tile_table(
                    mask, seg, b, sq, skv, causal, dev)),
                "bwd_plain_ms": cuda_ms(
                    lambda: flash_attention_bwd_reference(
                        q, k, v, mask, seg, o_p, lse_p, do, causal, scale),
                    reps=5),
                "bwd_library_ms": cuda_ms(lambda: torch.autograd.grad(
                    sdpa, (qg, kg, vg), do, retain_graph=True)),
            }
            # forward: Q, K, V in, O and the LSE out, QK^T and PV; dQ: Q,
            # dO, K, V, LSE, delta in, dQ out, QK^T, dO V^T and dS K; dK/dV:
            # the same in, dK and dV out, P^T dO and dS^T Q besides
            for key, products, q_rows, kv_rows, lse_rows in (
                    ("fwd", 2, 2, 2, 1), ("dq", 3, 3, 2, 2),
                    ("dkv", 4, 2, 4, 2)):
                t[f"{key}_bound_ms"], t[f"{key}_bound_by"] = attention_bound(
                    valid, mask, seg, b, h, sq, skv, d, products, q_rows,
                    kv_rows, lse_rows)
            # the 64 x 64 tile pairs the kernels run (those of the table
            # they read, which check_tile_table showed they obey), and those
            # skipped of the pairs on or below the causal diagonal
            nq, nk = -(-sq // BWD_TILE), -(-skv // BWD_TILE)
            ran = int(runs.sum()) * h
            t["tile_pairs_run"] = ran
            t["tile_pairs_skipped"] = b * h * int(bwd_tile_pairs(
                None, None, nq, nk, causal).sum()) - ran
            reading.update(t)
            line += (f"; fwd+LSE {t['fwd_ms']:.4f} ms (plain "
                     f"{t['fwd_plain_ms']:.4f}, SDPA {t['fwd_library_ms']:.4f},"
                     f" bound {t['fwd_bound_ms']:.4f}), dq {t['dq_ms']:.4f} ms "
                     f"(bound {t['dq_bound_ms']:.4f}), dkv {t['dkv_ms']:.4f} "
                     f"ms (bound {t['dkv_bound_ms']:.4f}), backward "
                     f"{t['bwd_ms']:.4f} ms (table {t['table_ms']:.4f}), "
                     f"64 x 64 tile pairs run {ran} skipped "
                     f"{t['tile_pairs_skipped']}, plain backward "
                     f"{t['bwd_plain_ms']:.4f} ms, SDPA backward "
                     f"{t['bwd_library_ms']:.4f} ms")
            del sdpa, qg, kg, vg
        out["cases"][name] = reading
        log(line)
        del q, k, v, do, o, o_p, lse, lse_p, dq, dk, dv, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()
    timed = out["cases"]["decoder_segments"]
    if timed["bwd_ms"] >= timed["bwd_library_ms"]:
        log(f"  note: the flash backward ({timed['bwd_ms']:.4f} ms) is not "
            f"below SDPA's ({timed['bwd_library_ms']:.4f} ms) at the packed "
            "decoder shape")
    for key, kname in (("dq", "dq"), ("dkv", "dkv")):
        out[key].update(ms=timed[f"{kname}_ms"],
                        plain_ms=timed["bwd_plain_ms"],
                        library_ms=timed["bwd_library_ms"],
                        bound_ms=timed[f"{kname}_bound_ms"],
                        bound_by=timed[f"{kname}_bound_by"])
    out["fwd"].update(ms=timed["fwd_ms"], plain_ms=timed["fwd_plain_ms"],
                      library_ms=timed["fwd_library_ms"],
                      bound_ms=timed["fwd_bound_ms"],
                      bound_by=timed["fwd_bound_by"])
    return out


@contextlib.contextmanager
def patched(module, **names):
    """Set attributes of `module` for as long as the block runs."""
    saved = {k: getattr(module, k) for k in names}
    for k, v in names.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def plain_differentiable_attention(q, k, v, kv_mask=None, *, causal=False,
                                   sm_scale=None, segment_ids=None):
    """The plain attention under autograd, on CUDA tensors too: the
    gradient reading's yardstick for the flash kernels' forward and
    backward."""
    from lhrs_bot_tpu_torch.ops.attention import mha_reference

    return mha_reference(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale,
                         segment_ids=segment_ids)


# The first training step's pooler gradient through the flash kernels
# against the same step through the plain attention (bf16, autograd of
# mha_reference in the decoder and the perceiver): relative L2 over every
# pooler leaf. On an H100 at 700 W it read 0.045 (bf16 rounding at other
# points through 32 layers). Each planted fault, a gross one (dK and dV
# swapped) and a moderate one (dV scaled by 0.9 in every attention call),
# must exceed the bound in every run.
TRAIN_GRAD_REL_L2 = 0.1
TRAIN_GRAD_FAULTS = (
    ("dK and dV swapped", lambda dq, dk, dv: (dq, dv, dk)),
    ("dV scaled by 0.9", lambda dq, dk, dv: (dq, dk, dv * 0.9)),
)
STEPS_CAPTION, STEPS_PACKED = 6, 2


def train_batches(cfg, rng):
    """The two seeded synthetic batches of the training phase: (a) captions,
    8 rows of one 224 x 224 image and 64-192 text tokens, padded by
    SupervisedCollator to 192 (335 spliced tokens); (b) packed,
    PackingCollator with 2 rows of 2048 tokens and up to 4 images a row
    (2620 spliced tokens a row, segment ids)."""
    import types

    from lhrs_bot_tpu_torch.data import PackingCollator, SupervisedCollator

    tok = types.SimpleNamespace(pad_token_id=cfg.llama.pad_token_id,
                                model_max_length=2048)
    size = cfg.vit.image_size

    def sample(n):
        ids = rng.integers(3, cfg.llama.vocab_size, n)
        ids[0] = cfg.llama.bos_token_id
        ids[1] = -200  # the image marker
        labels = ids.copy()
        labels[:2] = -100  # the prompt: BOS and the image
        img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        return {"input_ids": ids, "labels": labels, "image": img}

    lengths = rng.integers(64, 193, 8)
    lengths[3] = 192
    caption = SupervisedCollator(tok, pad_multiple=64)(
        [sample(int(n)) for n in lengths])
    packed = PackingCollator(tok, target_len=2048, rows_per_batch=2,
                             max_images_per_row=4)(
        [sample(int(n)) for n in rng.integers(400, 512, 8)])
    if caption["input_ids"].shape != (8, 192):
        raise AssertionError(f"caption batch {caption['input_ids'].shape}")
    if (packed["images"].shape[:2] != (2, 4)
            or packed["segment_ids"].max() != 4):
        raise AssertionError("packed batch: 2 rows of 4 images and 4 "
                             "segments expected")
    return caption, packed


def spliced_tokens(cfg, batch):
    """(B x spliced width, valid spliced tokens) of a collated batch."""
    n = cfg.pooler.num_query - 1
    b, t = batch["input_ids"].shape
    k = batch["images"].shape[1] if batch["images"].ndim == 5 else 1
    markers = int((batch["input_ids"] == -200).sum())
    return b * (t + k * n), int(batch["attention_mask"].sum()) + markers * n


def pooler_grads(params, cfg, batch, groups=("pooler",)):
    """The gradient of the batch's loss with respect to the leaves of
    `groups` (the pooler; the adapters too at stages 2 and 3), no update,
    flattened."""
    import torch

    from lhrs_bot_tpu_torch.models import vlm_forward_loss

    leaves = [t for g in groups for t in _leaves(params[g])]
    loss = vlm_forward_loss(params, cfg, batch)["total_loss"]
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), torch.cat([g.float().reshape(-1)
                                           for g in grads])


def check_train_grads(params, cfg, batch, groups=("pooler",)):
    """The first step's gradient of the leaves of `groups` through the
    kernels against the plain attention (both bf16), and the planted
    faults."""
    import lhrs_bot_tpu_torch.models.llama as llama
    import lhrs_bot_tpu_torch.models.perceiver as perceiver
    import lhrs_bot_tpu_torch.ops.attention as attention

    loss_k, g_k = pooler_grads(params, cfg, batch, groups)
    with patched(llama, flash_attention=plain_differentiable_attention), \
            patched(perceiver, flash_attention=plain_differentiable_attention):
        loss_p, g_p = pooler_grads(params, cfg, batch, groups)
    bwd = attention.flash_attention_bwd
    rel = float((g_k - g_p).norm() / g_p.norm())
    log(f"  {' + '.join(groups)} gradient, kernels vs plain attention "
        f"(bf16, {g_k.numel()} values): loss {loss_k:.5f} vs {loss_p:.5f}, "
        f"relative L2 {rel:.4e} (bound {TRAIN_GRAD_REL_L2})")
    faults = {}
    for name, fault in TRAIN_GRAD_FAULTS:
        with patched(attention, flash_attention_bwd=lambda *a, f=fault: f(
                *bwd(*a))):
            _, g_f = pooler_grads(params, cfg, batch, groups)
        faults[name] = float((g_f - g_p).norm() / g_p.norm())
        log(f"  planted fault ({name}): relative L2 {faults[name]:.4f}")
    if not (bool(g_k.isfinite().all()) and rel <= TRAIN_GRAD_REL_L2
            and min(faults.values()) > TRAIN_GRAD_REL_L2):
        raise AssertionError(f"{' + '.join(groups)} gradient: relative "
                             f"L2 {rel:.4e}, faults {faults}, bound "
                             f"{TRAIN_GRAD_REL_L2}")
    return {"rel_l2": rel, "faults": faults, "bound": TRAIN_GRAD_REL_L2,
            "loss_kernels": loss_k, "loss_plain": loss_p}


TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


def phase_train(dev):
    """Stage-1 training at full width (ViT-L/14 frozen, the 144-query
    6-layer perceiver trained, LLaMA-2-7B frozen in bf16) from seeded
    weights, through build_trainer with Config/multi_modal_stage1.yaml's
    optimizer and schedule: the gradient reading, then six steps on the
    caption batch and two on the packed batch, with per-step loss,
    grad_norm, lr, time, tokens/s, peak memory and launch counts."""
    import torch

    import lhrs_bot_tpu_torch.ops.attention as attention
    from lhrs_bot_tpu_torch.core import (build_trainer,
                                         training_params_from_numpy)
    from lhrs_bot_tpu_torch.core.config import load_yaml_config
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.train import HookBase

    config = load_yaml_config("Config/multi_modal_stage1.yaml")
    cfg = VLMConfig.from_config_dict(config)
    t0 = time.time()
    seeded = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    params = training_params_from_numpy(seeded, cfg, torch.bfloat16, dev)
    del seeded
    torch.cuda.synchronize()
    n_train = sum(t.numel() for t in _leaves(params["pooler"]))
    log(f"  seeded weights in {time.time() - t0:.1f} s; trainable (pooler) "
        f"{n_train / 1e6:.2f} M float32, the rest frozen in bf16; "
        f"optimizer {config['optimizer']}, lr {config['lr']}, "
        f"max_grad_norm {config['max_grad_norm']}, schedule "
        f"{config['schedule']['name']} with {config['schedule']['warmup_epochs']}"
        f" warmup iters")
    caption, packed = train_batches(cfg, np.random.default_rng(11))
    out = {"grad_check": check_train_grads(params, cfg, caption)}
    torch.cuda.empty_cache()

    wrappers = kernel_wrappers()
    steps = []

    class StepProbe(HookBase):
        """Per step: device time (synchronised), peak memory, launches."""

        def before_iter(self):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.counts = {k: wrappers[k].launches for k in wrappers}
            self.t0 = time.perf_counter()

        def after_iter(self):
            torch.cuda.synchronize()
            ms = (time.perf_counter() - self.t0) * 1e3
            batch = caption if self.trainer.cur_iter < STEPS_CAPTION \
                else packed
            total, valid = spliced_tokens(cfg, batch)
            steps.append({
                "batch": "caption" if batch is caption else "packed",
                "ms": ms, "spliced_tokens": total, "valid_tokens": valid,
                "tokens_per_s": total / ms * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": {k: wrappers[k].launches - self.counts[k]
                             for k in wrappers
                             if wrappers[k].launches - self.counts[k]}})

    plain_calls = []
    plain_bwd = attention.flash_attention_bwd_reference

    def counted_plain(*args):
        plain_calls.append(1)
        return plain_bwd(*args)

    loader = [caption] * STEPS_CAPTION + [packed] * STEPS_PACKED
    trainer = build_trainer(config, params, loader, dev, log_period=1,
                            work_dir="build/train_smoke")
    del params
    trainer.register_hook(StepProbe())
    for w in wrappers.values():
        w.launches = 0
    with patched(attention, flash_attention_bwd_reference=counted_plain):
        trainer.train()
    launches = {k: w.launches for k, w in wrappers.items()}
    ms_ = trainer.metric_storage
    for key in ("total_loss", "grad_norm", "lr"):
        for s, v in zip(steps, ms_[key].values):
            s[key] = v
    for i, s in enumerate(steps):
        log(f"  step {i} ({s['batch']}): loss {s['total_loss']:.5f}, "
            f"grad_norm {s['grad_norm']:.4f}, lr {s['lr']:.4e}, "
            f"{s['ms']:.1f} ms, {s['tokens_per_s']:.0f} spliced tokens/s "
            f"({s['spliced_tokens']} spliced, {s['valid_tokens']} valid), "
            f"peak {s['peak_gib']:.2f} GiB, launches {s['launches']}")
    curve = [s["total_loss"] for s in steps[:STEPS_CAPTION]]
    log(f"  caption loss curve: {curve}; plain backward calls on the card: "
        f"{len(plain_calls)}; launches in the run: {launches}")
    expect = {"flash_attention_fwd": 72, "flash_attention_bwd_dq": 50,
              "flash_attention_bwd_dkv": 50}
    for i, s in enumerate(steps):
        if not all(np.isfinite([s["total_loss"], s["grad_norm"]])):
            raise AssertionError(f"step {i}: non-finite loss or grad_norm")
        if s["launches"] != expect:
            raise AssertionError(f"step {i}: launches {s['launches']}, "
                                 f"expected {expect}")
    if plain_calls:
        raise AssertionError("the plain backward ran on the card")
    if not curve[-1] < curve[0]:
        raise AssertionError(f"the caption loss did not fall: {curve}")
    out.update(steps=steps, caption_loss_curve=curve, launches=launches)
    del trainer
    torch.cuda.empty_cache()
    return out


def kernel_wrappers():
    """Each kernel's wrapper, whose `launches` counts its launches."""
    from lhrs_bot_tpu_torch.ops.attention import (flash_attention_bwd_dkv,
                                                  flash_attention_bwd_dq,
                                                  flash_attention_fwd)
    from lhrs_bot_tpu_torch.benchmarks.hbm_peak_probe import hbm_read_kernel
    from lhrs_bot_tpu_torch.benchmarks.int8_probe import int8_chain_kernel
    from lhrs_bot_tpu_torch.ops.cache_update import cache_row_update_kernel
    from lhrs_bot_tpu_torch.ops.fused_decode import (
        fused_decode_attention_kernel, fused_decode_attention_q_int8dots_kernel,
        fused_decode_attention_q_kernel)
    from lhrs_bot_tpu_torch.ops.int8_gemm import int8_gemm_kernel
    from lhrs_bot_tpu_torch.ops.ln_quant import ln_quant_kernel
    from lhrs_bot_tpu_torch.ops.paged_fused import (
        paged_fused_decode_kernel, paged_fused_decode_q_kernel)
    from lhrs_bot_tpu_torch.ops.w4_matmul import w4a8_matmul_kernel

    return {"flash_attention_fwd": flash_attention_fwd,
            "fused_decode_attention": fused_decode_attention_kernel,
            "fused_decode_attention_q": fused_decode_attention_q_kernel,
            "fused_decode_attention_q_int8dots":
                fused_decode_attention_q_int8dots_kernel,
            "cache_row_update": cache_row_update_kernel,
            "hbm_read": hbm_read_kernel,
            "int8_chain": int8_chain_kernel,
            "w4a8_matmul": w4a8_matmul_kernel,
            "ln_quant": ln_quant_kernel,
            "int8_gemm": int8_gemm_kernel,
            "paged_fused_decode": paged_fused_decode_kernel,
            "paged_fused_decode_q": paged_fused_decode_q_kernel,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv}


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
        if name == "w4a8":
            out[name]["launches_a_decode_step"] = check_w4a8_step_launches(
                engine.llama_params, cfg.llama, dev, wrappers)
            out["w4a8_int8dots"] = phase_int8dots_engine(
                engine, cfg, dev, requests[:2], wrappers)
        if name == "bf16":
            out["paged_vs_contiguous"] = phase_paged_vs_contiguous(
                engine.llama_params, cfg.llama, dev)
        if name in ("bf16", "int8"):
            out.update(phase_serving(engine, cfg, dev, name))
        del engine
        torch.cuda.empty_cache()
    return out


def decode_step_launches(lp, lcfg, dev, wrappers, cache_dtype, steps=3):
    """Kernel launches a decode step through `llama_decode_step` over a
    fresh cache of `cache_dtype` (a 40-token prefill, then `steps` steps),
    each count over the steps."""
    import torch

    from lhrs_bot_tpu_torch.models import (KVCache, llama_decode_step,
                                           llama_prefill)

    ids = torch.as_tensor(np.random.default_rng(5).integers(
        3, lcfg.vocab_size, (1, 40)), device=dev)
    cache = KVCache.create(lcfg, 1, 128, cache_dtype, dev)
    _, cache = llama_prefill(lp, lcfg, cache,
                             inputs_embeds=lp["embed_tokens"][ids],
                             prompt_len=torch.tensor([40], device=dev))
    for w in wrappers.values():
        w.launches = 0
    tok = torch.zeros(1, dtype=torch.long, device=dev)
    for _ in range(steps):
        logits, cache = llama_decode_step(
            lp, lcfg, cache, inputs_embeds=lp["embed_tokens"][tok][:, None])
        tok = logits.argmax(dim=-1)
    torch.cuda.synchronize()
    return {k: w.launches / steps for k, w in wrappers.items() if w.launches}


def check_w4a8_step_launches(lp, lcfg, dev, wrappers):
    """The W4A8 decode step's launches: K3 once a projection (7 a layer,
    its quantize inside the launch, no split-K epilogue kernel), kernel A
    twice a layer with the int8 cache (the new K and V rows) and never with
    the bf16 cache."""
    import torch

    nl = lcfg.num_hidden_layers
    out = {}
    for name, dtype, a_want, attn in (
            ("int8 cache", torch.int8, 2 * nl, "fused_decode_attention_q"),
            ("bf16 cache", torch.bfloat16, 0, "fused_decode_attention")):
        per_step = decode_step_launches(lp, lcfg, dev, wrappers, dtype)
        log(f"  [w4a8, {name}] launches a decode step: {per_step}; split-K "
            "epilogue kernel: none (0)")
        want = {"w4a8_matmul": 7 * nl, attn: nl}
        if a_want:
            want["ln_quant"] = a_want
        if per_step != want:
            raise AssertionError(f"w4a8 {name}: {per_step} launches a decode "
                                 f"step, want {want}")
        out[name] = {**per_step, "w4a8_epilogue": 0}
    return out


@contextlib.contextmanager
def environ(name, value):
    """Set an environment variable for as long as the block runs."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            del os.environ[name]
        else:
            os.environ[name] = saved


def phase_int8dots_engine(engine, cfg, dev, requests, wrappers):
    """The W4A8 + int8 lm_head + int8-KV engine with
    LHRS_DECODE_INT8_DOTS=1, as a user turns the int8 dots on: its
    requests, its launch counts (the int8-dots kernel and never the
    bf16-dot K4; exactly 32 a decode step, counted over three
    `llama_decode_step`s), and the prefill/decode consistency check with
    the W4A8 bound and planted faults."""
    import torch

    from lhrs_bot_tpu_torch.models import (KVCache, llama_decode_step,
                                           llama_prefill)

    lcfg, lp = cfg.llama, engine.llama_params
    with environ("LHRS_DECODE_INT8_DOTS", "1"):
        for w in wrappers.values():
            w.launches = 0
        results = serve(engine, cfg, requests)
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"  [w4a8, LHRS_DECODE_INT8_DOTS=1] kernel launches in the main "
            f"path: {launches}")
        if (launches["fused_decode_attention_q_int8dots"] <= 0
                or launches["fused_decode_attention_q"] != 0):
            raise AssertionError("int8 dots on: the int8-dots kernel must "
                                 "run and K4 never")
        ids = torch.as_tensor(np.random.default_rng(5).integers(
            3, lcfg.vocab_size, (1, 40)), device=dev)
        cache = KVCache.create(lcfg, 1, 128, torch.int8, dev)
        _, cache = llama_prefill(lp, lcfg, cache,
                                 inputs_embeds=lp["embed_tokens"][ids],
                                 prompt_len=torch.tensor([40], device=dev))
        for w in wrappers.values():
            w.launches = 0
        tok = torch.zeros(1, dtype=torch.long, device=dev)
        for _ in range(3):
            logits, cache = llama_decode_step(
                lp, lcfg, cache, inputs_embeds=lp["embed_tokens"][tok][:, None])
            tok = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        per_step = {k: w.launches / 3 for k, w in wrappers.items()
                    if w.launches}
        log(f"  [w4a8, LHRS_DECODE_INT8_DOTS=1] launches a decode step: "
            f"{per_step}")
        if (per_step.get("fused_decode_attention_q_int8dots") !=
                lcfg.num_hidden_layers
                or "fused_decode_attention_q" in per_step):
            raise AssertionError(f"int8 dots on: {per_step} launches a "
                                 "decode step")
        consistency = check_consistency(
            "w4a8, int8 dots", lp, lcfg, dev, torch.int8,
            CONSISTENCY_REL_L2_W4A8)
    return {"requests": results, "launches": launches,
            "launches_a_decode_step": per_step, "consistency": consistency}


def phase_serving(engine, cfg, dev, name):
    """The serving wave through the schedulers, built from the engine's
    parameters as `lhrs_serve.py` builds them: with the bf16 engine the
    contiguous scheduler, the paged one (a pool of 4 x 2304 tokens in pages
    of 128), the paged one with prefill_chunk 512, and the hazard wave;
    with the int8 engine (bits 8, kv_bits 8) the paged one over an int8
    pool."""
    import torch

    from lhrs_bot_tpu_torch.serve.paged import PagedScheduler
    from lhrs_bot_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    wave = serving_wave(cfg, np.random.default_rng(4))
    common = dict(max_batch=8, tokens_per_tick=16, device=dev,
                  max_seq_len=engine.max_seq_len,
                  cache_dtype=engine.cache_dtype,
                  eos_token_id=cfg.llama.eos_token_id)

    def paged(**kw):
        return PagedScheduler(cfg, engine.params, engine.llama_params,
                              num_pages=4 * engine.max_seq_len // 128 + 1,
                              page_size=128, **common, **kw)

    out = {}
    if name == "bf16":
        out["serve_contiguous_bf16"] = serve_wave(
            "contiguous bf16", ContinuousBatchingScheduler(
                cfg, engine.params, engine.llama_params, **common), wave,
            ("fused_decode_attention",), PAGED_KERNELS)
        torch.cuda.empty_cache()
        for key, kw in (("serve_paged_bf16", {}),
                        ("serve_paged_bf16_chunk512", {"prefill_chunk": 512})):
            out[key] = serve_wave(key[6:], paged(**kw), wave,
                                  ("paged_fused_decode",),
                                  CONTIGUOUS_DECODE + PAGED_KERNELS[1:])
            out[key]["agreement_with_contiguous"] = agree = agreement(
                out[key]["outputs"], out["serve_contiguous_bf16"]["outputs"])
            log(f"  [{key[6:]}] greedy ids vs the contiguous run (a reading: "
                f"random weights have thin margins): {agree}")
            torch.cuda.empty_cache()
        out["hazard"] = phase_hazard(engine, cfg, dev)
    else:
        out["serve_paged_int8"] = serve_wave(
            "paged int8 (bits 8, kv_bits 8)", paged(), wave,
            ("paged_fused_decode_q",), CONTIGUOUS_DECODE + PAGED_KERNELS[:1])
    for key, res in out.items():
        if key.startswith("serve_paged"):
            st = res["pool_stats"]
            allocated = sum(a["free_pages_before"] - a["free_pages_after"]
                            for a in res["admissions"])
            deferred = any(a["deferred"] and a["free_slots"]
                           for a in res["admissions"])
            if not (deferred and allocated > st["total_pages"]
                    and st["prefix"]["hits"] >= 1):
                raise AssertionError(
                    f"{key}: the wave must defer admission for pages, "
                    f"recycle them ({allocated} allocated of "
                    f"{st['total_pages']}) and hit the prefix cache ({st})")
    torch.cuda.empty_cache()
    return out


BENCH_KERNELS = ("flash_attention_fwd", "fused_decode_attention",
                 "fused_decode_attention_q",
                 "fused_decode_attention_q_int8dots", "w4a8_matmul",
                 "ln_quant", "int8_gemm", "hbm_read", "int8_chain")


def phase_bench(dev, reps=1):
    """The bench path: `lhrs_bot_tpu_torch.bench`'s decode cells (at
    `reps` timed runs each) and prefill towers at the bench's geometry, its
    JSON line; the int8-dots A/B's line; the two probes' `main()`s. Every
    value must be a positive number, and each kernel of the path must have
    been launched."""
    import torch

    from lhrs_bot_tpu_torch import bench
    from lhrs_bot_tpu_torch.benchmarks import (hbm_peak_probe, int8_probe,
                                               int8dots_ab)
    from lhrs_bot_tpu_torch.models import LlamaConfig, VLMConfig

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    lcfg = LlamaConfig.llama2_7b()
    line = bench.bench_line(bench.bench_decode(lcfg, device=dev, reps=reps),
                            bench.bench_prefill(VLMConfig(), device=dev),
                            bench.device_line())
    log(json.dumps(line))
    ab = int8dots_ab.run_ab(lcfg, device=dev, reps=reps)
    if not all(v > 0 for v in ab.values()):
        raise AssertionError(f"int8-dots A/B: {ab}")
    ab["device"] = line["device"]
    log(json.dumps(ab))
    probes = {"hbm": hbm_peak_probe.main([]), "int8": int8_probe.main([])}
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"  [bench] {time.time() - t0:.1f} s; kernel launches: {launches}")
    for kname in BENCH_KERNELS:
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} was not launched by the bench "
                                 "path")
    torch.cuda.empty_cache()
    return {"line": line, "int8dots_ab": ab, "probes": probes,
            "launches": launches}


# ---------------------------------------------------------------------------
# 7. checkpoints at full width: write, load, serve, stage 2 -> 3 -> eval
# ---------------------------------------------------------------------------

CKPT_RESIZED_VOCAB = 32004  # the reference resizes embed_tokens for its
# special tokens; FINAL.pt carries the resized rows
CKPT_LORA_R, CKPT_LORA_ALPHA = 128, 256
CKPT_SWAP_LAYER = 3  # the layer whose q_proj / k_proj a fault swaps
CKPT_STEPS_STAGE2, CKPT_STEPS_STAGE3 = 6, 2
CKPT_NEW_TOKENS = 8


def seeded(name, shape, dev, base=0.0, scale=0.02):
    """The written checkpoint's tensor `name`: base + scale * N(0, 1)
    drawn on the card from a generator seeded by the name, rounded to
    fp16. The writer and the expected trees both call it."""
    import zlib

    import torch

    g = torch.Generator(device=dev).manual_seed(zlib.crc32(name.encode()))
    return (base + scale * torch.randn(shape, generator=g, device=dev,
                                       dtype=torch.float32)).half()


def llama_specs(lc):
    """HF LlamaForCausalLM key -> (shape, base) of the written decoder."""
    d, f, vocab = lc.hidden_size, lc.intermediate_size, lc.vocab_size
    specs = {"model.embed_tokens.weight": ((vocab, d), 0.0)}
    for i in range(lc.num_hidden_layers):
        p = f"model.layers.{i}."
        specs[p + "input_layernorm.weight"] = ((d,), 1.0)
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            specs[p + f"self_attn.{n}.weight"] = ((d, d), 0.0)
        specs[p + "post_attention_layernorm.weight"] = ((d,), 1.0)
        specs[p + "mlp.gate_proj.weight"] = ((f, d), 0.0)
        specs[p + "mlp.up_proj.weight"] = ((f, d), 0.0)
        specs[p + "mlp.down_proj.weight"] = ((d, f), 0.0)
    specs["model.norm.weight"] = ((d,), 1.0)
    specs["lm_head.weight"] = ((vocab, d), 0.0)
    return specs


def clip_specs(vc, prefix="vision_model."):
    """HF CLIPVisionModel key -> (shape, base): norms around 1, every
    weight and bias drawn (so a swapped bias shows)."""
    w, p, ffn = vc.width, vc.patch_size, vc.width * vc.mlp_ratio
    specs = {
        prefix + "embeddings.patch_embedding.weight": ((w, 3, p, p), 0.0),
        prefix + "embeddings.class_embedding": ((w,), 0.0),
        prefix + "embeddings.position_embedding.weight": ((vc.seq_len, w),
                                                          0.0)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        specs[prefix + ln + ".weight"] = ((w,), 1.0)
        specs[prefix + ln + ".bias"] = ((w,), 0.0)
    for i in range(vc.layers):
        lp = prefix + f"encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            specs[lp + f"self_attn.{n}.weight"] = ((w, w), 0.0)
            specs[lp + f"self_attn.{n}.bias"] = ((w,), 0.0)
        for ln in ("layer_norm1", "layer_norm2"):
            specs[lp + ln + ".weight"] = ((w,), 1.0)
            specs[lp + ln + ".bias"] = ((w,), 0.0)
        specs[lp + "mlp.fc1.weight"] = ((ffn, w), 0.0)
        specs[lp + "mlp.fc1.bias"] = ((ffn,), 0.0)
        specs[lp + "mlp.fc2.weight"] = ((w, ffn), 0.0)
        specs[lp + "mlp.fc2.bias"] = ((w,), 0.0)
    return specs


def pooler_specs(pc):
    """The reference AttnPooler's state-dict key -> (shape, base)."""
    h, ffn = pc.hidden_size, pc.hidden_size * pc.mlp_ratio
    specs = {"query": ((1, pc.num_query, h), 0.0)}
    for i in range(pc.num_layers):
        p = f"layers.{i}."
        specs[p + "attn.in_proj_weight"] = ((3 * h, h), 0.0)
        specs[p + "attn.in_proj_bias"] = ((3 * h,), 0.0)
        specs[p + "attn.out_proj.weight"] = ((h, h), 0.0)
        specs[p + "attn.out_proj.bias"] = ((h,), 0.0)
        for ln in ("ln_1", "ln_1_kv", "ln_2"):
            specs[p + ln + ".weight"] = ((h,), 1.0)
            specs[p + ln + ".bias"] = ((h,), 0.0)
        specs[p + "mlp.c_fc.weight"] = ((ffn, h), 0.0)
        specs[p + "mlp.c_fc.bias"] = ((ffn,), 0.0)
        specs[p + "mlp.c_proj.weight"] = ((h, ffn), 0.0)
        specs[p + "mlp.c_proj.bias"] = ((h,), 0.0)
    specs["out_proj.weight"] = ((pc.output_size, h), 0.0)
    specs["out_proj.bias"] = ((pc.output_size,), 0.0)
    return specs


LORA_MODULES = (("q_proj", "self_attn", "wq"), ("k_proj", "self_attn", "wk"),
                ("v_proj", "self_attn", "wv"), ("o_proj", "self_attn", "wo"),
                ("gate_proj", "mlp", "w_gate"), ("up_proj", "mlp", "w_up"),
                ("down_proj", "mlp", "w_down"))


def lora_specs(lc, r):
    """peft TextLoRA key -> (shape, base, scale): A (r, d_in) at 0.01,
    B (d_out, r) at 0.002 (B != 0: a trained adapter's)."""
    d, f = lc.hidden_size, lc.intermediate_size
    dims = {"q_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d),
            "o_proj": (d, d), "gate_proj": (d, f), "up_proj": (d, f),
            "down_proj": (f, d)}
    specs = {}
    for i in range(lc.num_hidden_layers):
        for peft, group, _ in LORA_MODULES:
            base = f"base_model.model.model.layers.{i}.{group}.{peft}."
            din, dout = dims[peft]
            specs[base + "lora_A.weight"] = ((r, din), 0.0, 0.01)
            specs[base + "lora_B.weight"] = ((dout, r), 0.0, 0.002)
    return specs


def write_reference_checkpoint(root, cfg, dev):
    """The reference's artifacts at full width under `root`, seeded by
    name: llama/ (config.json, two fp16 safetensors shards with their
    index), clip/ (fp16), FINAL.pt (rgb_ckpt under "encoder.", nested
    other_ckpt, embed_tokens resized to 32,004 rows, float32 of fp16
    values) and TextLoRA/ (r 128, alpha 256, all 7 targets, float32 of
    fp16 values). Returns {artifact: bytes written}."""
    import torch

    from lhrs_bot_tpu_torch.core.safetensors_io import save_file

    lc, vc = cfg.llama, cfg.vit
    llama_dir = os.path.join(root, "llama")
    os.makedirs(llama_dir)
    with open(os.path.join(llama_dir, "config.json"), "w") as fh:
        json.dump({"architectures": ["LlamaForCausalLM"],
                   "model_type": "llama", "hidden_size": lc.hidden_size,
                   "intermediate_size": lc.intermediate_size,
                   "num_hidden_layers": lc.num_hidden_layers,
                   "num_attention_heads": lc.num_attention_heads,
                   "num_key_value_heads": lc.num_attention_heads,
                   "vocab_size": lc.vocab_size,
                   "max_position_embeddings": lc.max_position_embeddings,
                   "rms_norm_eps": lc.rms_norm_eps,
                   "torch_dtype": "float16"}, fh)
    half = lc.num_hidden_layers // 2
    shards = {"model-00001-of-00002.safetensors": {},
              "model-00002-of-00002.safetensors": {}}
    names = list(shards)
    for key, (shape, base) in llama_specs(lc).items():
        later = key in ("model.norm.weight", "lm_head.weight") or (
            ".layers." in key and int(key.split(".")[2]) >= half)
        shards[names[later]][key] = (shape, base)
    weight_map = {}
    for name, specs in shards.items():
        save_file({k: seeded(k, s, dev, b) for k, (s, b) in specs.items()},
                  os.path.join(llama_dir, name))
        weight_map.update({k: name for k in specs})
        torch.cuda.empty_cache()
    with open(os.path.join(llama_dir, "model.safetensors.index.json"),
              "w") as fh:
        json.dump({"metadata": {"total_size": 0}, "weight_map": weight_map},
                  fh)

    clip_dir = os.path.join(root, "clip")
    os.makedirs(clip_dir)
    with open(os.path.join(clip_dir, "config.json"), "w") as fh:
        json.dump({"model_type": "clip_vision_model",
                   "hidden_size": vc.width, "num_hidden_layers": vc.layers,
                   "num_attention_heads": vc.heads,
                   "image_size": vc.image_size, "patch_size": vc.patch_size,
                   "intermediate_size": vc.width * vc.mlp_ratio,
                   "hidden_act": "quick_gelu"}, fh)
    save_file({k: seeded(k, s, dev, b) for k, (s, b) in
               clip_specs(vc).items()},
              os.path.join(clip_dir, "model.safetensors"))

    def f32(name, shape, base=0.0, scale=0.02):
        return seeded(name, shape, dev, base, scale).float().cpu()

    rgb = {"encoder." + k: f32("rgb:" + k, s, b)
           for k, (s, b) in clip_specs(vc).items()}
    pooler = {k: f32("pooler:" + k, s, b)
              for k, (s, b) in pooler_specs(cfg.pooler).items()}
    overlay = f32("embed_overlay", (CKPT_RESIZED_VOCAB, lc.hidden_size))
    torch.save({"rgb_ckpt": rgb, "other_ckpt": {
        "rgb_pooler": pooler, "text_proj": {},
        "embed_tokens": {"weight": overlay}, "lm_head": {}}},
        os.path.join(root, "FINAL.pt"))
    del rgb, pooler, overlay
    write_text_lora(os.path.join(root, "TextLoRA"), lc, dev)
    sizes = {}
    for art in ("llama", "clip", "FINAL.pt", "TextLoRA"):
        path = os.path.join(root, art)
        sizes[art] = (os.path.getsize(path) if os.path.isfile(path) else
                      sum(os.path.getsize(os.path.join(path, f))
                          for f in os.listdir(path)))
    return sizes


def write_text_lora(lora_dir, lc, dev, skip=()):
    """TextLoRA/ (adapter_model.bin + adapter_config.json), leaving out
    the peft modules in `skip`."""
    import torch

    os.makedirs(lora_dir, exist_ok=True)
    sd = {k: seeded(k, s, dev, b, sc).float().cpu()
          for k, (s, b, sc) in lora_specs(lc, CKPT_LORA_R).items()
          if not any(f".{m}." in k for m in skip)}
    torch.save(sd, os.path.join(lora_dir, "adapter_model.bin"))
    with open(os.path.join(lora_dir, "adapter_config.json"), "w") as fh:
        json.dump({"peft_type": "LORA", "r": CKPT_LORA_R,
                   "lora_alpha": CKPT_LORA_ALPHA,
                   "target_modules": [m for m, _, _ in LORA_MODULES]}, fh)


def ckpt_bytes(cfg):
    """{artifact: bytes} of the tensors written: fp16 llama/ and clip/,
    float32 FINAL.pt and TextLoRA/; "outputs": what save_final writes at
    stages 2 and 3 together (FINAL.pt without the overlay, TextLoRA/)."""
    n = {k: sum(int(np.prod(s)) for s, *_ in specs.values()) for k, specs in
         (("llama", llama_specs(cfg.llama)), ("clip", clip_specs(cfg.vit)),
          ("pooler", pooler_specs(cfg.pooler)),
          ("lora", lora_specs(cfg.llama, CKPT_LORA_R)))}
    overlay = CKPT_RESIZED_VOCAB * cfg.llama.hidden_size
    return {"llama": 2 * n["llama"], "clip": 2 * n["clip"],
            "FINAL.pt": 4 * (n["clip"] + n["pooler"] + overlay),
            "TextLoRA": 4 * n["lora"],
            "outputs": 2 * 4 * (n["clip"] + n["pooler"] + n["lora"])}


def expected_vit(vc, dev, name=lambda k: k):
    """The port's ViT parameters (float32, on the host) of the written
    CLIP tensors (seed names through `name`: FINAL.pt's rgb_ckpt has its
    own), from their seeds, laid out independently of
    core/torch_import.py."""
    import torch

    prefix = "vision_model."
    specs = clip_specs(vc, prefix)

    def get(key):
        s, b = specs[prefix + key]
        return seeded(name(prefix + key), s, dev, b).float()

    def stack(key, t=False):
        return torch.stack([get(f"encoder.layers.{i}.{key}").T if t else
                            get(f"encoder.layers.{i}.{key}")
                            for i in range(vc.layers)]).cpu()

    conv = get("embeddings.patch_embedding.weight")
    return {
        "patch_proj": conv.permute(2, 3, 1, 0).reshape(-1, vc.width).cpu(),
        "class_emb": get("embeddings.class_embedding").cpu(),
        "pos_emb": get("embeddings.position_embedding.weight").cpu(),
        "pre_ln": {"scale": get("pre_layrnorm.weight").cpu(),
                   "bias": get("pre_layrnorm.bias").cpu()},
        "post_ln": {"scale": get("post_layernorm.weight").cpu(),
                    "bias": get("post_layernorm.bias").cpu()},
        "layers": {
            "ln1_scale": stack("layer_norm1.weight"),
            "ln1_bias": stack("layer_norm1.bias"),
            "wq": stack("self_attn.q_proj.weight", True),
            "bq": stack("self_attn.q_proj.bias"),
            "wk": stack("self_attn.k_proj.weight", True),
            "bk": stack("self_attn.k_proj.bias"),
            "wv": stack("self_attn.v_proj.weight", True),
            "bv": stack("self_attn.v_proj.bias"),
            "wo": stack("self_attn.out_proj.weight", True),
            "bo": stack("self_attn.out_proj.bias"),
            "ln2_scale": stack("layer_norm2.weight"),
            "ln2_bias": stack("layer_norm2.bias"),
            "w_fc": stack("mlp.fc1.weight", True),
            "b_fc": stack("mlp.fc1.bias"),
            "w_proj": stack("mlp.fc2.weight", True),
            "b_proj": stack("mlp.fc2.bias")}}


def expected_pooler(pc, dev):
    import torch

    specs = pooler_specs(pc)

    def get(key):
        s, b = specs[key]
        return seeded("pooler:" + key, s, dev, b).float()

    h = pc.hidden_size

    def stack(fn):
        return torch.stack([fn(f"layers.{i}.") for i in
                            range(pc.num_layers)]).cpu()

    return {
        "query": get("query")[0].cpu(),
        "layers": {
            "ln1_scale": stack(lambda p: get(p + "ln_1.weight")),
            "ln1_bias": stack(lambda p: get(p + "ln_1.bias")),
            "ln_kv_scale": stack(lambda p: get(p + "ln_1_kv.weight")),
            "ln_kv_bias": stack(lambda p: get(p + "ln_1_kv.bias")),
            "wq": stack(lambda p: get(p + "attn.in_proj_weight")[:h].T),
            "bq": stack(lambda p: get(p + "attn.in_proj_bias")[:h]),
            "wk": stack(lambda p: get(p + "attn.in_proj_weight")[h:2 * h].T),
            "bk": stack(lambda p: get(p + "attn.in_proj_bias")[h:2 * h]),
            "wv": stack(lambda p: get(p + "attn.in_proj_weight")[2 * h:].T),
            "bv": stack(lambda p: get(p + "attn.in_proj_bias")[2 * h:]),
            "wo": stack(lambda p: get(p + "attn.out_proj.weight").T),
            "bo": stack(lambda p: get(p + "attn.out_proj.bias")),
            "ln2_scale": stack(lambda p: get(p + "ln_2.weight")),
            "ln2_bias": stack(lambda p: get(p + "ln_2.bias")),
            "w_fc": stack(lambda p: get(p + "mlp.c_fc.weight").T),
            "b_fc": stack(lambda p: get(p + "mlp.c_fc.bias")),
            "w_proj": stack(lambda p: get(p + "mlp.c_proj.weight").T),
            "b_proj": stack(lambda p: get(p + "mlp.c_proj.bias"))},
        "out_proj_w": get("out_proj.weight").T.contiguous().cpu(),
        "out_proj_b": get("out_proj.bias").cpu()}


def expected_lora(lc, dev):
    """The written TextLoRA as the port's stacked float32 adapters."""
    import torch

    specs = lora_specs(lc, CKPT_LORA_R)
    out = {}
    for peft, group, ours in LORA_MODULES:
        parts = {}
        for part, kind in (("a", "lora_A"), ("b", "lora_B")):
            keys = [f"base_model.model.model.layers.{i}.{group}.{peft}."
                    f"{kind}.weight" for i in range(lc.num_hidden_layers)]
            parts[part] = torch.stack([
                seeded(k, specs[k][0], dev, specs[k][1], specs[k][2])
                .float().T for k in keys]).cpu()
        out[ours] = parts
    return out


def expected_llama(lc, dev, overlay=True, lora=None):
    """The port's decoder parameters (float32, host) of the written
    files: the HF directory's tensors, embed_tokens' first rows from
    FINAL.pt's resized overlay (with `overlay`), and `lora` (stacked
    float32 adapters) merged as W + (A @ B) * alpha / r in float32."""
    import torch

    specs = llama_specs(lc)

    def get(key):
        s, b = specs[key]
        return seeded(key, s, dev, b).float()

    def stack(key, t=True):
        return torch.stack([get(f"model.layers.{i}.{key}").T if t else
                            get(f"model.layers.{i}.{key}")
                            for i in range(lc.num_hidden_layers)]).cpu()

    embed = (seeded("embed_overlay", (CKPT_RESIZED_VOCAB, lc.hidden_size),
                    dev).float()[:lc.vocab_size] if overlay
             else get("model.embed_tokens.weight"))
    layers = {"input_norm": stack("input_layernorm.weight", False),
              "wq": stack("self_attn.q_proj.weight"),
              "wk": stack("self_attn.k_proj.weight"),
              "wv": stack("self_attn.v_proj.weight"),
              "wo": stack("self_attn.o_proj.weight"),
              "post_attn_norm": stack("post_attention_layernorm.weight",
                                      False),
              "w_gate": stack("mlp.gate_proj.weight"),
              "w_up": stack("mlp.up_proj.weight"),
              "w_down": stack("mlp.down_proj.weight")}
    scale = CKPT_LORA_ALPHA / CKPT_LORA_R
    for name, ab in (lora or {}).items():
        layers[name] = layers[name] + torch.matmul(
            ab["a"].float(), ab["b"].float()) * scale
    return {"embed_tokens": embed.contiguous().cpu(), "layers": layers,
            "final_norm": get("model.norm.weight").cpu(),
            "lm_head": get("lm_head.weight").T.contiguous().cpu()}


def tree_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def tree_mismatches(got, want):
    """Paths whose leaves differ in keys, shape, dtype or any bit (numpy
    or tensor leaves, compared as float32 tensors on the host)."""
    import torch

    got, want = dict(tree_paths(got)), dict(tree_paths(want))
    bad = sorted(set(got) ^ set(want))
    for p in sorted(set(got) & set(want)):
        g, w = torch.as_tensor(got[p]), torch.as_tensor(want[p])
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            bad.append(p)
    return bad


def ckpt_requests(cfg):
    """One seeded B=2 request with an image a row (40 and 25 tokens)."""
    rng = np.random.default_rng(21)
    ids = rng.integers(3, cfg.llama.vocab_size, (2, 40)).astype(np.int32)
    ids[:, 0] = cfg.llama.bos_token_id
    ids[:, 1] = -200
    ids[1, 25:] = 0
    size = cfg.vit.image_size
    images = rng.integers(0, 256, (2, size, size, 3)).astype(np.uint8)
    return ids, np.asarray([40, 25], np.int32), images


def engine_outputs(cfg, params, config, knobs, dev, wrappers):
    """build_engine over `params` with `knobs`: the prefill logits of
    ckpt_requests, its greedy ids, and the kernels' launches."""
    import torch

    from lhrs_bot_tpu_torch.core import build_engine
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    engine = build_engine(cfg, params, {**config, **knobs}, dev)
    ids, lens, images = ckpt_requests(cfg)
    for w in wrappers.values():
        w.launches = 0
    gen = GenerationConfig(max_new_tokens=CKPT_NEW_TOKENS)
    logits = engine._start(ids, lens, images, gen)[0].float().cpu()
    out = engine.generate(ids, lens, images=images, gen_cfg=gen)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    del engine
    torch.cuda.empty_cache()
    return logits, out, launches


def check_engines(name, cfg, loaded, expected, config, knobs, dev, wrappers,
                  needed):
    """Engines over the loaded and the expected tree: prefill logits and
    greedy ids bit for bit, and the path's kernels launched."""
    import torch

    got = engine_outputs(cfg, loaded, config, knobs, dev, wrappers)
    want = engine_outputs(cfg, expected, config, knobs, dev, wrappers)
    same = torch.equal(got[0], want[0]) and got[1] == want[1]
    log(f"  [{name}] prefill logits {tuple(got[0].shape)} and greedy ids "
        f"{got[1]} vs the expected tree's: "
        f"{'bit for bit' if same else 'DIFFER'} (max abs "
        f"{float((got[0] - want[0]).abs().max()):.3e}); launches {got[2]}")
    if not (same and bool(got[0].isfinite().all())):
        raise AssertionError(f"{name}: the engine over the loaded tree "
                             "differs from the one over the expected tree")
    for k in needed:
        if not got[2].get(k):
            raise AssertionError(f"{name}: {k} was not launched")
    return {"ids": got[1], "launches": got[2]}


def swap_header_offsets(path, a, b):
    """Exchange two same-shape tensors of a safetensors file by swapping
    their offsets in its header (the header keeps its length)."""
    import struct

    with open(path, "r+b") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        header[a]["data_offsets"], header[b]["data_offsets"] = \
            header[b]["data_offsets"], header[a]["data_offsets"]
        blob = json.dumps(header, separators=(",", ":")).encode()
        if len(blob) > n:
            raise AssertionError("the swapped header does not fit")
        fh.seek(8)
        fh.write(blob + b" " * (n - len(blob)))


def host_gib_available():
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise AssertionError("no MemAvailable in /proc/meminfo")


def phase_checkpoint(dev):
    """The checkpoint formats and stages 2 and 3 at full width (ViT-L/14,
    the 144-query perceiver, LLaMA-2-7B): (a) write the reference's
    artifacts from seeds, (b) load them at stage 0 bit for bit, with three
    planted faults, (c) serve the loaded tree (bf16 and W4A8 engines) bit
    for bit against the expected tree, (d) build_model + build_trainer at
    stage 2 (int8 base, live LoRA): the gradient check, six steps,
    save_final, (e) stage 3 from stage 2's output: the adapters bit for
    bit, two steps, save_final, (f) eval: stage 3's output loaded at stage
    0 and served bit for bit against the plainly merged tree."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch

    import lhrs_bot_tpu_torch.ops.attention as attention
    from lhrs_bot_tpu_torch.core import (build_model, build_trainer,
                                         eval_config, load_pretrained,
                                         save_final)
    from lhrs_bot_tpu_torch.core.config import load_yaml_config
    from lhrs_bot_tpu_torch.core.torch_import import load_hf_clip_vision
    from lhrs_bot_tpu_torch.models import LoraConfig, VLMConfig
    from lhrs_bot_tpu_torch.train import HookBase
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {"seconds": {}}
    config0 = eval_config()
    cfg0 = VLMConfig.from_config_dict(config0)
    need = ckpt_bytes(cfg0)
    to_write = sum(v for k, v in need.items() if k != "outputs")
    tree_bytes = 2 * (need["llama"] + need["clip"])  # as float32
    os.makedirs("build", exist_ok=True)
    free = shutil.disk_usage("build").free
    ram = host_gib_available()
    ram_need = 2 * tree_bytes / 2**30 + 8
    log(f"  to write {to_write / 1e9:.2f} GB, then {need['outputs'] / 1e9:.2f}"
        f" GB of stage 2 and 3 outputs; free disk under build/ "
        f"{free / 1e9:.2f} GB; host RAM available {ram:.1f} GiB (needed "
        f"{ram_need:.1f}: two float32 trees and 8 GiB)")
    if free < 1.1 * (to_write + need["outputs"]) or ram < ram_need:
        raise AssertionError("not enough disk or host memory for the "
                             "checkpoint phase")
    root = tempfile.mkdtemp(prefix="ckpt_smoke_", dir="build")
    paths = {"model_path": os.path.join(root, "FINAL.pt"),
             "vit_path": os.path.join(root, "clip"),
             "llama_path": os.path.join(root, "llama")}
    try:
        # (a) write
        t0 = time.time()
        sizes = write_reference_checkpoint(root, cfg0, dev)
        torch.cuda.empty_cache()
        out["seconds"]["a_write"] = time.time() - t0
        written = sum(sizes.values())
        log(f"  (a) wrote {written / 1e9:.3f} GB in "
            f"{out['seconds']['a_write']:.1f} s: " + ", ".join(
                f"{k} {v / 1e9:.3f} GB" for k, v in sizes.items()))
        out["bytes"] = sizes

        # (b) stage-0 load, bit for bit against the expected tree
        t0 = time.time()
        lora_x = expected_lora(cfg0.llama, dev)
        expected = {
            "vit": expected_vit(cfg0.vit, dev, lambda k: "rgb:" + k),
            "pooler": expected_pooler(cfg0.pooler, dev),
            "llama": expected_llama(cfg0.llama, dev, lora=lora_x)}
        torch.cuda.empty_cache()
        t_expect = time.time() - t0
        t0 = time.time()
        loaded, report = load_pretrained(cfg0, **paths)
        t_load = time.time() - t0
        gb_s = written / t_load / 1e9
        t1 = time.time()
        bad = tree_mismatches(loaded, expected)
        t_compare = time.time() - t1
        log(f"  (b) load_pretrained at stage 0: {t_load:.1f} s, "
            f"{gb_s:.2f} GB/s over {written / 1e9:.2f} GB; artifacts "
            f"{sorted(report['artifacts'])}, left at the random init "
            f"{report['random_init']}; expected tree built in "
            f"{t_expect:.1f} s; {len(list(tree_paths(expected)))} leaves "
            f"compared in {t_compare:.1f} s, mismatches {bad}")
        if (sorted(report["artifacts"]) != ["clip", "final_pt", "llama",
                                             "text_lora"]
                or report["random_init"] or bad or "lora" in loaded):
            raise AssertionError(f"stage-0 load: {report}, mismatches {bad}")
        # FINAL.pt's rgb_ckpt replaces the CLIP directory's tower: the
        # directory's own read (load_pretrained's first overlay) alone
        t1 = time.time()
        clip_only = load_hf_clip_vision(paths["vit_path"], cfg0.vit,
                                        torch.float32)
        bad = tree_mismatches(clip_only, expected_vit(cfg0.vit, dev))
        log(f"  (b) the CLIP directory's tower: mismatches {bad} "
            f"({time.time() - t1:.1f} s)")
        if bad:
            raise AssertionError(f"CLIP directory load: {bad}")
        del clip_only
        out["load"] = {"seconds": t_load, "gb_per_s": gb_s,
                       "artifacts": report["artifacts"]}
        out["seconds"]["b_load"] = time.time() - t0 + t_expect

        # (c) serve the loaded tree
        t0 = time.time()
        wrappers = kernel_wrappers()
        out["serve"] = {
            "bf16": check_engines(
                "bf16 engine", cfg0, loaded, expected, config0, {}, dev,
                wrappers, ("flash_attention_fwd", "fused_decode_attention")),
            "w4a8": check_engines(
                "W4A8 + int8 lm_head + int8 KV engine", cfg0, loaded,
                expected, config0, {"bits": 4, "quant_type": "int4h",
                                    "kv_bits": 8, "lm_head_bits": 8},
                dev, wrappers, ("flash_attention_fwd",
                                "fused_decode_attention_q", "w4a8_matmul",
                                "ln_quant"))}
        out["seconds"]["c_serve"] = time.time() - t0
        del loaded
        gc.collect()

        # (b) the planted faults: each load must differ from the expected
        t0 = time.time()
        shard = os.path.join(paths["llama_path"],
                             "model-00001-of-00002.safetensors")
        q = f"model.layers.{CKPT_SWAP_LAYER}.self_attn.q_proj.weight"
        k = q.replace("q_proj", "k_proj")
        lora_dir = os.path.join(root, "TextLoRA")
        faults = {}

        def alpha_r_swapped():
            return load_pretrained(dataclasses.replace(cfg0, lora=LoraConfig(
                r=CKPT_LORA_ALPHA, alpha=CKPT_LORA_R)), **paths)[0]

        def qk_swapped():
            swap_header_offsets(shard, q, k)
            try:
                return load_pretrained(cfg0, **paths)[0]
            finally:
                swap_header_offsets(shard, q, k)

        def w_down_dropped():
            write_text_lora(lora_dir, cfg0.llama, dev, skip=("down_proj",))
            try:
                return load_pretrained(cfg0, **paths)[0]
            finally:
                write_text_lora(lora_dir, cfg0.llama, dev)

        for name, fn in (("alpha / r swapped", alpha_r_swapped),
                         (f"layer {CKPT_SWAP_LAYER} q_proj / k_proj swapped "
                          "in the shard", qk_swapped),
                         ("w_down adapters dropped", w_down_dropped)):
            faulty = fn()
            faults[name] = tree_mismatches(faulty, expected)
            del faulty
            gc.collect()
            log(f"  (b) planted fault ({name}): mismatching leaves "
                f"{faults[name]}")
            if not faults[name]:
                raise AssertionError(f"the planted fault {name!r} passes "
                                     "the stage-0 check")
        out["faults"] = faults
        out["seconds"]["b_faults"] = time.time() - t0
        del expected
        gc.collect()

        # (d) stage 2: int8 base, live LoRA, six steps, save_final
        t0 = time.time()
        config2 = load_yaml_config("Config/multi_modal_stage2.yaml")
        config2["rgb_vision"]["vit_name"] = paths["vit_path"]
        config2["text"]["path"] = paths["llama_path"]
        config2["model_path"] = paths["model_path"]
        cfg2, params2, report2 = build_model(config2, dev)
        t_build = time.time() - t0
        if (sorted(report2["artifacts"]) != ["clip", "final_pt", "llama",
                                              "text_lora"]
                or tree_mismatches(params2["lora"], lora_x)):
            raise AssertionError(f"stage-2 build_model: {report2}")
        caption, _ = train_batches(cfg2, np.random.default_rng(11))
        loader = [caption] * CKPT_STEPS_STAGE2
        trainer = build_trainer(config2, params2, loader, dev, log_period=1,
                                work_dir="build/ckpt_smoke")
        del params2
        gc.collect()
        torch.cuda.synchronize()
        wq = trainer.params["llama"]["layers"]["wq"]
        n_lora = sum(t.numel() for t in _leaves(trainer.params["lora"]))
        log(f"  (d) build_model at stage 2 in {t_build:.1f} s: base "
            f"{type(wq).__name__} bits {wq.bits}, adapters "
            f"{n_lora / 1e6:.1f} M float32 (r {cfg2.lora.r}, alpha "
            f"{cfg2.lora.alpha}) from TextLoRA/, trainable "
            f"{sum(t.numel() for t in trainer.optimizer.params) / 1e6:.1f} "
            "M; optimizer "
            f"{config2['optimizer']}, lr {config2['lr']}, schedule "
            f"{config2['schedule']['name']}")
        grad_check = check_train_grads(trainer.params, cfg2,
                                       trainer._put(caption),
                                       groups=("lora", "pooler"))
        torch.cuda.empty_cache()
        steps = train_steps(trainer, cfg2, caption, wrappers, profile,
                            ProfilerActivity, DeviceType, HookBase,
                            attention, profiled_step=CKPT_STEPS_STAGE2 - 2)
        curve = [s["total_loss"] for s in steps]
        if not curve[-1] < curve[0]:
            raise AssertionError(f"the stage-2 loss did not fall: {curve}")
        out2 = os.path.join(root, "stage2")
        t1 = time.time()
        save_final(out2, trainer.params, cfg2)
        t_save = time.time() - t1
        saved_lora = {n: {p: t.detach().cpu().clone() for p, t in ab.items()}
                      for n, ab in trainer.params["lora"].items()}
        saved_pooler = {k: v for k, v in tree_paths(trainer.params["pooler"])}
        del trainer, lora_x
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  (d) stage-2 loss curve {curve}; save_final in {t_save:.1f} s")
        out["stage2"] = {"grad_check": grad_check, "steps": steps,
                         "loss_curve": curve, "save_s": t_save}
        out["seconds"]["d_stage2"] = time.time() - t0

        # (e) stage 3 from stage 2's output
        t0 = time.time()
        config3 = load_yaml_config("Config/multi_modal_stage3.yaml")
        config3["rgb_vision"]["vit_name"] = paths["vit_path"]
        config3["text"]["path"] = paths["llama_path"]
        config3["model_path"] = os.path.join(out2, "FINAL.pt")
        cfg3, params3, report3 = build_model(config3, dev)
        bad = tree_mismatches(params3["lora"], saved_lora)
        bad_pool = [p for p, v in tree_paths(params3["pooler"])
                    if not torch.equal(torch.as_tensor(v),
                                       saved_pooler[p].detach().float()
                                       .cpu())]
        log(f"  (e) build_model at stage 3 from stage 2's FINAL.pt + "
            f"TextLoRA/: artifacts {sorted(report3['artifacts'])}; adapter "
            f"mismatches with the saved ones {bad}; pooler mismatches "
            f"{bad_pool}")
        if bad or bad_pool or "text_lora" not in report3["artifacts"]:
            raise AssertionError("stage 3 did not load stage 2's output "
                                 "bit for bit")
        trainer = build_trainer(config3, params3, [caption], dev,
                                log_period=1, work_dir="build/ckpt_smoke")
        del params3
        gc.collect()
        trainer.max_iters = CKPT_STEPS_STAGE3  # of the recipe's 1200
        pooler_before = [t.detach().clone()
                         for t in _leaves(trainer.params["pooler"])]
        steps3 = train_steps(trainer, cfg3, caption, wrappers, profile,
                             ProfilerActivity, DeviceType, HookBase,
                             attention)
        if not all(torch.equal(a, b) for a, b in zip(
                pooler_before, _leaves(trainer.params["pooler"]))):
            raise AssertionError("stage 3 moved the frozen perceiver")
        out3 = os.path.join(root, "stage3")
        save_final(out3, trainer.params, cfg3)
        final = {g: {p: torch.as_tensor(v).detach().float().cpu().clone()
                     for p, v in tree_paths(trainer.params[g])}
                 for g in ("vit", "pooler")}
        lora3 = {n: {p: t.detach().cpu().clone() for p, t in ab.items()}
                 for n, ab in trainer.params["lora"].items()}
        del trainer, pooler_before
        gc.collect()
        torch.cuda.empty_cache()
        out["stage3"] = {"steps": steps3}
        out["seconds"]["e_stage3"] = time.time() - t0

        # (f) eval: stage 3's output merged at load, served bit for bit
        t0 = time.time()
        evalp, report_f = load_pretrained(
            cfg0, model_path=os.path.join(out3, "FINAL.pt"),
            vit_path=paths["vit_path"], llama_path=paths["llama_path"])
        plain = {"vit": unflatten(final["vit"]),
                 "pooler": unflatten(final["pooler"]),
                 "llama": expected_llama(cfg0.llama, dev, overlay=False,
                                         lora=lora3)}
        bad = tree_mismatches(evalp, plain)
        log(f"  (f) stage 3's output at stage 0: artifacts "
            f"{sorted(report_f['artifacts'])}; mismatches with the plainly "
            f"merged tree {bad}")
        if bad or "text_lora" not in report_f["artifacts"]:
            raise AssertionError(f"eval load: {bad}")
        out["eval"] = check_engines(
            "eval bf16 engine", cfg0, evalp, plain, config0, {}, dev,
            wrappers, ("flash_attention_fwd", "fused_decode_attention"))
        del evalp, plain
        gc.collect()
        out["seconds"]["f_eval"] = time.time() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  seconds per part: {out['seconds']}")
    return out


def unflatten(flat):
    """{"a/b": leaf} -> {"a": {"b": leaf}}."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def train_steps(trainer, cfg, batch, wrappers, profile, activities,
                device_type, hook_base, attention, profiled_step=None):
    """trainer.train() with a probe: per step its loss, grad_norm, lr,
    ms (synchronised), spliced tokens/s, peak memory and kernel launches
    (the plain backward must never run on the card); with
    `profiled_step`, that step under torch.profiler for the card's busy
    share."""
    import torch

    steps = []
    total, valid = spliced_tokens(cfg, batch)

    class Probe(hook_base):
        def before_iter(self):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.counts = {k: wrappers[k].launches for k in wrappers}
            self.prof = None
            if self.trainer.cur_iter == profiled_step:
                self.prof = profile(activities=[activities.CPU,
                                                activities.CUDA])
                self.prof.__enter__()
            self.t0 = time.perf_counter()

        def after_iter(self):
            torch.cuda.synchronize()
            ms = (time.perf_counter() - self.t0) * 1e3
            step = {"ms": ms, "spliced_tokens": total,
                    "valid_tokens": valid,
                    "tokens_per_s": total / ms * 1e3,
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "launches": {k: wrappers[k].launches - self.counts[k]
                                 for k in wrappers
                                 if wrappers[k].launches - self.counts[k]}}
            if self.prof is not None:
                self.prof.__exit__(None, None, None)
                busy = sum(e.self_device_time_total
                           for e in self.prof.key_averages()
                           if e.device_type == device_type.CUDA) / 1e3
                step.update(profiled=True, busy_ms=busy,
                            busy_share=busy / ms)
            steps.append(step)

    plain_calls = []
    plain_bwd = attention.flash_attention_bwd_reference

    def counted_plain(*args):
        plain_calls.append(1)
        return plain_bwd(*args)

    trainer.register_hook(Probe())
    with patched(attention, flash_attention_bwd_reference=counted_plain):
        trainer.train()
    ms_ = trainer.metric_storage
    for key in ("total_loss", "grad_norm", "lr"):
        for s, v in zip(steps, ms_[key].values):
            s[key] = v
    for i, s in enumerate(steps):
        busy = (f", busy {s['busy_ms']:.1f} ms, busy share "
                f"{s['busy_share']:.3f} (under the profiler)"
                if s.get("profiled") else "")
        log(f"  step {i}: loss {s['total_loss']:.5f}, grad_norm "
            f"{s['grad_norm']:.4f}, lr {s['lr']:.4e}, {s['ms']:.1f} ms, "
            f"{s['tokens_per_s']:.0f} spliced tokens/s ({total} spliced, "
            f"{valid} valid), peak {s['peak_gib']:.2f} GiB{busy}, launches "
            f"{ {k: v for k, v in s['launches'].items() if k in TRAIN_KERNELS} }")
        if not all(np.isfinite([s["total_loss"], s["grad_norm"]])):
            raise AssertionError(f"step {i}: non-finite loss or grad_norm")
        if any(not s["launches"].get(k) for k in TRAIN_KERNELS):
            raise AssertionError(f"step {i}: launches {s['launches']}")
    if plain_calls:
        raise AssertionError("the plain backward ran on the card")
    return steps


# where a failing phase leaves its traceback, and a crash of the
# interpreter its stacks: the output directory a remote run copies back
OUT_DIR = "chiprun_out"


def phase(name, fn, *args):
    """Run one phase; if it raises, keep the traceback in
    OUT_DIR/chip_smoke_<name>.err before passing the exception on."""
    try:
        return fn(*args)
    except BaseException:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"chip_smoke_{name}.err"), "w") as f:
            traceback.print_exc(file=f)
        raise


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

    os.makedirs(OUT_DIR, exist_ok=True)
    faults = open(os.path.join(OUT_DIR, "chip_smoke_crash.txt"), "w")
    faulthandler.enable(faults)  # a segfault or abort leaves its stacks
    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[1/7 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
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
    build_log = (so.parent / "build.log").read_text().splitlines()
    usage = [ln.strip() for ln in build_log
             if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
    log(f"[2/7 build] {so.relative_to(cuda_lib.BUILD_ROOT.parents[1])} in "
        f"{build_s:.1f} s")
    for ln in usage:
        log(f"  {ln}")
    # ptxas serializes the wgmmas of a kernel (C7514) when it sees other
    # code read their registers while they run (a register fence missing,
    # or code it will not keep apart from them): the kernels would run
    # right but slowly, so the build fails the run
    serialized = [ln.strip() for ln in build_log if "C7514" in ln]
    if serialized:
        raise SystemExit("chip_smoke: ptxas serialized wgmma (C7514):\n"
                         + "\n".join(serialized))

    log("[3/7 kernels vs plain]")
    k1, k2 = phase("kernels", phase_kernels, dev)
    train_k = phase("train_kernels", phase_train_kernels, dev)
    k3, k4 = phase("quant_kernels", phase_quant_kernels, dev)
    vision = phase("vision_kernels", phase_vision_kernels, dev)
    tower = phase("tower", phase_tower, dev)
    paged = phase("paged_kernels", phase_paged_kernels, dev)
    bench_k = phase("bench_kernels", phase_bench_kernels, dev)

    log("[4/7 serving slices at full width]")
    paths = phase("slice", phase_slice, dev)
    bf16, w4a8 = paths["bf16"]["launches"], paths["w4a8"]["launches"]
    int8 = paths["int8"]["launches"]

    log("[5/7 stage-1 training at full width]")
    train = phase("train", phase_train, dev)

    log("[6/7 the bench path]")
    bench = phase("bench", phase_bench, dev)

    log("[7/7 checkpoints at full width: load, serve, stage 2 -> 3 -> eval]")
    ckpt = phase("checkpoint", phase_checkpoint, dev)

    def row(name, source, replaces, launches, k):
        return {"name": name, "route": "cuda",
                "source": f"lhrs_bot_tpu_torch/csrc/{source}",
                "replaces": ", ".join(
                    r if r.startswith("benchmarks/") else
                    f"lhrs_bot_tpu/ops/{r}" for r in replaces.split(", ")),
                "launches": launches[name], "max_abs_err": k["max_abs_err"],
                "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k["library_ms"]}

    vision_tpu = ("vit_block.py:111, vit_block.py:132, vit_block.py:319, "
                  "vit_block.py:338, perceiver_block.py:53")

    fwd_row = row("flash_attention_fwd", "flash_fwd.cu", "attention.py:84",
                  bf16, k1)
    fwd_row["note"] = ("also carries the LSE output and segment ids: "
                       f"{train['launches']['flash_attention_fwd']} launches "
                       "on the training path; times at the packed decoder "
                       "shape in train_kernels")
    kernels = [
        fwd_row,
        row("fused_decode_attention", "fused_decode.cu",
            "fused_decode.py:43", bf16, k2),
        row("fused_decode_attention_q", "fused_decode_q.cu",
            "fused_decode.py:222", w4a8, k4),
        row("w4a8_matmul", "w4a8_matmul.cu", "w4_matmul.py:43", w4a8, k3),
        row("ln_quant", "ln_quant.cu", vision_tpu, int8, vision["A"]),
        row("int8_gemm", "int8_gemm.cu", vision_tpu, int8, vision["B"]),
        row("paged_fused_decode", "paged_decode.cu", "paged_fused.py:213",
            paths["serve_paged_bf16"]["launches"],
            paged["paged_fused_decode"]),
        row("paged_fused_decode_q", "paged_decode_q.cu", "paged_fused.py:52",
            paths["serve_paged_int8"]["launches"],
            paged["paged_fused_decode_q"]),
        row("flash_attention_bwd_dq", "flash_bwd.cu", "attention.py:291",
            train["launches"], train_k["dq"]),
        row("flash_attention_bwd_dkv", "flash_bwd.cu", "attention.py:357",
            train["launches"], train_k["dkv"]),
        row("fused_decode_attention_q_int8dots", "fused_decode_q.cu",
            "fused_decode.py:222", paths["w4a8_int8dots"]["launches"],
            bench_k["int8dots"]),
        # no path launches it, as in the JAX package
        row("cache_row_update", "cache_update.cu", "cache_update.py:20",
            {"cache_row_update": 0}, bench_k["cache_row_update"]),
        row("hbm_read", "hbm_probe.cu",
            "benchmarks/hbm_peak_probe.py:41, benchmarks/hbm_peak_probe.py:83",
            bench["launches"], bench_k["hbm_read"]),
        row("int8_chain", "int8_probe.cu", "benchmarks/int8_probe.py:95",
            bench["launches"], bench_k["int8_chain"]),
    ]
    upd = bench_k["cache_row_update"]
    kernels[-3]["note"] = (
        "one thread a 16-byte unit, value and length loaded together; "
        f"launch floor (an empty kernel on its grid) {upd['empty_ms']:.4f} "
        "ms")
    kernels[-1]["note"] = (
        "the int8 variant; on the card the five are two computations "
        "(chain_form): " + ", ".join(
            f"{v['variant']} ({v['form']}) {v['ms']:.4f} ms, "
            f"{v['bound_share']:.0%} of {v['bound_ms']:.4f}"
            for v in bench_k["int8_chain"]["variants"]))
    dots = bench_k["int8dots"]
    kernels[-4]["note"] = (
        "int8_dots=True, block_s 512; launches on the W4A8 path with "
        "LHRS_DECODE_INT8_DOTS=1; each block's rows split across a cluster "
        f"of C CTAs (int8dots_split_plan: C = {dots['splits']} here), a "
        "bulk-copy ring, the block max, p scale and int32 P.V exchanged "
        "over distributed shared memory; every C: " + ", ".join(
            f"C={c} {dots[f'ms_c{c}']:.4f} ms" for c in (1, 2, 4, 8)))
    pq = paged["paged_fused_decode_q"]
    kernels[7]["note"] = (
        "K4's split design over pages (decode_split.cuh, one bulk copy a "
        f"page piece); B8 page 128 at C = {pq['splits']}; every C: "
        + ", ".join(f"C={c} {pq[f'ms_c{c}']:.4f} ms" for c in (1, 2, 4, 8)))
    for k, numbers in ((kernels[1], k2), (kernels[2], k4)):
        k["note"] = (
            "rows split across a cluster of C CTAs (decode_split_plan), "
            "bulk-copy ring, merge over distributed shared memory; times at "
            f"L32 B2 H32 S2304 D128 (C = {numbers['splits']}); B1, B2, B7 "
            "and every C under shapes")
        k["shapes"] = numbers["shapes"]
    step = paths["w4a8"]["launches_a_decode_step"]["int8 cache"]
    kernels[3]["note"] = (
        "one clustered launch a projection; times of the fused mode (b), "
        "which quantizes the bf16 activation itself, at B1 K4096 N11008 "
        f"(mode (a) {k3['mode_a_ms']:.4f} ms); a W4A8 decode "
        f"step launches it {step['w4a8_matmul']:.0f} times and kernel A "
        f"{step['ln_quant']:.0f} times (int8 cache), no epilogue kernel")
    kernels[4]["note"] = ("row groups held in registers; times at LN1 of 64 "
                          "images (16448, 1024) bf16")
    packed = train_k["cases"]["decoder_segments"]
    for k in kernels:
        if k["name"].startswith("flash_attention_bwd"):
            k["note"] = (
                "wgmma + TMA; times at the packed decoder shape, the "
                "launcher building the run table itself "
                f"({packed['table_ms']:.4f} ms); the whole backward "
                f"{packed['bwd_ms']:.4f} ms; the kernels ran the "
                f"{packed['tile_pairs_run']} 64 x 64 tile pairs the table "
                f"sets and skipped {packed['tile_pairs_skipped']}")
    log(json.dumps({"w4a8_shapes": k3["shapes"],
                    "ln_quant_shapes": vision["A"]["shapes"]}))
    log(json.dumps({"int8_gemm_shapes": vision["B"]["shapes"],
                    "vision_blocks": vision["blocks"], "tower": tower}))
    log(json.dumps({"paths": paths, "paged_kernels": paged}))
    log(json.dumps({"train_kernels": train_k, "train": train}))
    log(json.dumps({"bench_kernels": bench_k,
                    "bench_launches": bench["launches"]}))
    log(json.dumps({"checkpoint": ckpt}))
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
