#!/usr/bin/env python3
"""Smoke test of the PyTorch port (lhrs_bot_tpu_torch) on one CUDA card.

Run from the root of a checkout, with one H100 visible:

    python3 chip_smoke.py

Phases, one or more lines each:
  1. device: torch/CUDA versions, the card, its power limit;
  2. build: compile the CUDA kernels from lhrs_bot_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (plus ragged/masked edge cases), with times;
  4. slice: the bf16 serving path at full width (ViT-L/14, 144-query
     6-layer perceiver, LLaMA-2-7B, seeded random weights) through
     build_engine + GenerationEngine.generate: three requests, the kernels'
     launch counts, and a prefill/decode consistency check.
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

# K1/K2 against their plain versions: bf16 kernel output vs the plain
# version in float32 on the same bf16 inputs. bf16 output rounding is
# 2^-9 relative and the kernels round probabilities to bf16 before the PV
# product, so 1e-2 absolute + 1e-2 relative bounds a correct kernel with
# room to spare while any indexing or masking fault shows as O(1).
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


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup=3, reps=15):
    """Median time of one call on the card, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def decode_vs_prefill(lp, lcfg, dev, dtype):
    """The logits of prefill(P) then decode_step(t), of prefill(P + [t]),
    and of decode_step(t) with each planted fault of FAULTS (each on a copy
    of the prefilled cache). Two rows, P of 600 and 451 tokens."""
    import torch

    from lhrs_bot_tpu_torch.models import (KVCache, llama_decode_step,
                                           llama_prefill)

    rng = np.random.default_rng(1)
    plen = torch.tensor([600, 451], dtype=torch.int32, device=dev)
    ids = torch.as_tensor(rng.integers(3, lcfg.vocab_size, (2, 601)),
                          device=dev)
    ids[:, 0] = lcfg.bos_token_id
    embed = lp["embed_tokens"]
    cache = KVCache.create(lcfg, 2, 1024, dtype, dev)
    logits_p, cache = llama_prefill(lp, lcfg, cache, inputs_embeds=embed[ids],
                                    prompt_len=plen, compute_dtype=dtype)
    tok = logits_p.argmax(dim=-1)
    step = embed[tok][:, None]
    faulty = {}
    for name, length in FAULTS.items():
        bad = KVCache(cache.k.clone(), cache.v.clone(), length(cache.length))
        faulty[name], _ = llama_decode_step(lp, lcfg, bad, inputs_embeds=step,
                                            compute_dtype=dtype)
        del bad
    logits_d, _ = llama_decode_step(lp, lcfg, cache, inputs_embeds=step,
                                    compute_dtype=dtype)
    ids[torch.arange(2, device=dev), plen.long()] = tok
    cache = KVCache.create(lcfg, 2, 1024, dtype, dev)
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
    k2["ms"] = cuda_ms(lambda: fused_decode_attention_kernel(
        q, kn, vn, kck, vck, lengths, 5, scale))
    k2["plain_ms"] = cuda_ms(lambda: fused_decode_attention_plain(
        q, kn, vn, kck, vck, lengths, 5, sm_scale=scale))
    log(f"  K2 time per layer call: kernel {k2['ms']:.4f} ms, plain "
        f"{k2['plain_ms']:.4f} ms")
    del kc, vc, kck, vck
    torch.cuda.empty_cache()
    return k1, k2


def phase_slice(dev):
    import torch

    from lhrs_bot_tpu_torch.core import build_engine, eval_config
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.ops.attention import flash_attention_fwd
    from lhrs_bot_tpu_torch.ops.fused_decode import \
        fused_decode_attention_kernel
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    config = eval_config()
    cfg = VLMConfig.from_config_dict(config)
    t0 = time.time()
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for part in params.values()
                   for t in _leaves(part))
    log(f"  seeded bf16 weights: {n_params / 1e9:.3f} B parameters in "
        f"{time.time() - t0:.1f} s")
    engine = build_engine(cfg, params, config, dev)
    del params
    vocab = cfg.llama.vocab_size
    rng = np.random.default_rng(0)

    def prompt(n):
        ids = rng.integers(3, vocab, n).astype(np.int32)
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
    images = rng.integers(0, 256, (2, size, size, 3)).astype(np.uint8)
    requests = [("short", batch(prompt(40)), images[:1]),
                ("long", batch(prompt(2048)), images[:1]),
                ("batch2", batch(prompt(300), prompt(120)), images[:2])]

    flash_attention_fwd.launches = 0
    fused_decode_attention_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    new = 32
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
    launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                "fused_decode_attention": fused_decode_attention_kernel
                .launches}
    log(f"  kernel launches in the main path: {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} was not launched by the main path")

    logits_d, logits_f, faulty = decode_vs_prefill(
        engine.llama_params, cfg.llama, dev, torch.bfloat16)
    rel = rel_l2(logits_d, logits_f)
    faults = {name: rel_l2(logits, logits_f)
              for name, logits in faulty.items()}
    diff = logits_d - logits_f
    max_dev = diff.abs().amax(dim=-1).tolist()
    top2 = logits_f.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (logits_d.argmax(-1) == logits_f.argmax(-1)).tolist()
    log(f"  consistency: rel L2 {rel}, max abs dev {max_dev}, top-1 margin "
        f"{margin}, top-1 agree {agree}; rel L2 with each planted fault "
        f"{faults}")
    for r in range(2):
        if rel[r] > CONSISTENCY_REL_L2:
            raise AssertionError(f"consistency row {r}: rel L2 {rel[r]:.3e}")
        for name, fault in faults.items():
            if fault[r] <= CONSISTENCY_REL_L2:
                raise AssertionError(f"consistency row {r}: the planted fault "
                                     f"{name!r} passes the check")
        # a row whose top-2 gap lies within the measured deviation may
        # legitimately flip; every other row must agree
        if margin[r] > max_dev[r] and not agree[r]:
            raise AssertionError(f"consistency row {r}: top-1 differs")
    return results, launches


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

    log("[4/4 slice at full width]")
    results, launches = phase_slice(dev)

    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "lhrs_bot_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "lhrs_bot_tpu/ops/attention.py:84",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "fused_decode_attention", "route": "cuda",
         "source": "lhrs_bot_tpu_torch/csrc/fused_decode.cu",
         "replaces": "lhrs_bot_tpu/ops/fused_decode.py:43",
         "launches": launches["fused_decode_attention"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
    ]
    log(json.dumps({"requests": results}))
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
