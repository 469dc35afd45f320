#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one CUDA card.

Run from the root of a checkout, with one H100 visible:

    python3 chip_profile.py

It builds the same full-width engines as chip_smoke.py (ViT-L/14, 144-query
6-layer perceiver, LLaMA-2-7B, seeded random bf16 weights; the bf16 path
and the W4A8 + int8 lm_head + int8 KV recipe) and prints:
  1. times, each as (CUDA events ms, host clock ms), median of 5 after a
     warm-up call: encode_image of one image; ViT + perceiver at B=64
     (images/s) through the bf16, the W8A8 `dense_any` and the fused W8A8
     towers, encode_image of one image through the fused tower, and
     profiler traces of one bf16 and one fused batch; prefill +
     first-token logits
     for a 40-token and a 2048-token prompt with one image; one B=1 decode
     step; the lm_head product in float32 (the path's) and in bf16;
  2. a torch.profiler trace of a 16-token generate: wall time, the card's
     busy time (kernel time summed) and busy share, and the top kernels;
     a paged decode tick of 16 steps at B=8 (PagedScheduler, bf16 pool)
     with its profiler trace and busy share; then, for the W4A8 + int8-KV
     engine, its prefill times, its B=1 decode step, the profiler trace of
     its 16-token generate, the same paged tick over an int8 pool, and its
     lm_head product (int8 weights, float32 product);
  3. the prefill/decode consistency readings of chip_smoke.py (relative L2
     of prefill(P) + decode_step(t) against prefill(P + [t]), and of each
     planted fault) through the kernels in bf16, through the plain attention
     in bf16, and through the plain attention in float32; the full
     prefills' logits of the kernels against the plain attention; and the
     same readings through the kernels on the first 1 and 4 layers alone;
  4. a stage-1 training step (build_trainer with
     Config/multi_modal_stage1.yaml, chip_smoke.py's caption and packed
     batches) after a warm-up step, under torch.profiler: wall time, the
     card's busy share, the time in the forward and in the backward (host
     clock), and the top kernels.
It is a measurement, not a check: it fails only if something does not run.
It needs no network and imports nothing of JAX.
"""

import contextlib
import dataclasses
import statistics
import sys
import time

import numpy as np

from chip_smoke import (decode_vs_prefill, log, plain_attention, rel_l2,
                        smi_line, train_batches)


def timed(fn, reps=5):
    """(CUDA events ms, host ms) of one call, medians of `reps` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return statistics.median(dev_ms), statistics.median(host_ms)


def profile_generate(engine, ids, lens, img):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    gen_cfg = GenerationConfig(max_new_tokens=16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(ids, lens, images=img, gen_cfg=gen_cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    log(f"generate of 16 tokens under the profiler: wall {wall_ms:.1f} ms, "
        f"card busy {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}")
    log(events.table(sort_by="self_device_time_total", row_limit=15,
                     max_name_column_width=60))


def paged_tick(engine, cfg, dev, name, k=16):
    """A paged decode tick at B=8: eight text requests (2048, 40, 300, 120,
    1000, 1500, 700 and 443 tokens) admitted into a PagedScheduler with a
    pool of 4 x max_seq_len tokens in pages of 128, then ticks of `k` decode
    steps: the tick's time (events, host), per step, and a profiler trace
    of one tick with the card's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lhrs_bot_tpu_torch.serve.paged import PagedScheduler
    from lhrs_bot_tpu_torch.serve.scheduler import Request

    sched = PagedScheduler(cfg, engine.params, engine.llama_params,
                           max_batch=8, page_size=128,
                           num_pages=4 * engine.max_seq_len // 128 + 1,
                           max_seq_len=engine.max_seq_len,
                           cache_dtype=engine.cache_dtype, tokens_per_tick=k,
                           eos_token_id=-1, device=dev)
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, input_ids=rng.integers(
        3, cfg.llama.vocab_size, n).astype(np.int32), max_new_tokens=200)
        for i, n in enumerate((2048, 40, 300, 120, 1000, 1500, 700, 443))]
    assert sched.admit(reqs) == 8
    dev_ms, host_ms = timed(sched.step, reps=3)
    log(f"paged decode tick, {name}, B=8, k={k}: {dev_ms:.3f} ms (events), "
        f"{host_ms:.3f} ms (host); {host_ms / k:.3f} ms a step")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    log(f"paged decode tick, {name}, under the profiler: wall {wall_ms:.1f} "
        f"ms, card busy {busy_ms:.1f} ms, busy share {busy_ms / wall_ms:.3f}")
    log(events.table(sort_by="self_device_time_total", row_limit=10,
                     max_name_column_width=60))
    del sched
    torch.cuda.empty_cache()


def towers(params, cfg, dev, batch=64):
    """ViT + perceiver throughput at B=`batch` for the three towers of
    `bench.py`'s vit_perceiver_prefill: bf16; the XLA-style W8A8 tower
    (`quantize_vision_layers` weights through `dense_any`) with the W8A8
    perceiver; the fused W8A8 tower (`pack_vit_layers_fused`) with the W8A8
    perceiver, each packed from the same bf16 weights as there. Also
    `encode_image` of one image through the fused tower, and
    torch.profiler traces of one bf16 and one fused batch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lhrs_bot_tpu_torch.models.perceiver import perceiver_resample
    from lhrs_bot_tpu_torch.models.vit import vit_encode, vit_encode_fused
    from lhrs_bot_tpu_torch.models.vlm import encode_image
    from lhrs_bot_tpu_torch.ops.quant import quantize_vision_layers
    from lhrs_bot_tpu_torch.ops.vit_block import pack_vit_layers_fused

    vp, pp = params["vit"], params["pooler"]
    vq = {**vp, "layers": quantize_vision_layers(vp["layers"])}
    pq = {**pp, "layers": quantize_vision_layers(pp["layers"])}
    packed = pack_vit_layers_fused(vp["layers"])
    images = torch.as_tensor(np.random.default_rng(0).integers(
        0, 255, (batch, cfg.vit.image_size, cfg.vit.image_size, 3),
        dtype=np.uint8), device=dev)
    runs = {
        "bf16": lambda: perceiver_resample(
            pp, vit_encode(vp, images, cfg.vit), cfg.pooler),
        "XLA W8A8 (dense_any)": lambda: perceiver_resample(
            pq, vit_encode(vq, images, cfg.vit), cfg.pooler),
        "fused W8A8": lambda: perceiver_resample(
            pq, vit_encode_fused(vp, packed, images, cfg.vit), cfg.pooler),
    }
    for name, fn in runs.items():
        dev_ms, host_ms = timed(fn)
        log(f"ViT + perceiver, B={batch}, {name}: {dev_ms:.3f} ms (events), "
            f"{host_ms:.3f} ms (host): {batch / dev_ms * 1e3:.1f} images/s")
    one = images[:1]
    pq_params = {**params, "pooler": pq}
    log("encode_image, 1 image, fused W8A8 tower + W8A8 perceiver: %.3f ms "
        "(events), %.3f ms (host)" % timed(
            lambda: encode_image(pq_params, one, cfg, vision_packed=packed)))
    for name in ("bf16", "fused W8A8"):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA) / 1e3
        log(f"{name} ViT + perceiver, B={batch}, under the profiler: wall "
            f"{wall_ms:.1f} ms, card busy {busy_ms:.1f} ms, busy share "
            f"{busy_ms / wall_ms:.3f}")
        log(events.table(sort_by="self_device_time_total", row_limit=12,
                         max_name_column_width=60))


def train_profile(dev):
    """One stage-1 training step of each batch of chip_smoke.py's training
    phase, after a warm-up step, under torch.profiler; and the same step
    split by the host clock into the forward (the loss) and the backward
    with the update."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lhrs_bot_tpu_torch.core import build_trainer
    from lhrs_bot_tpu_torch.core.config import load_yaml_config
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.models.vlm import vlm_forward_loss

    config = load_yaml_config("Config/multi_modal_stage1.yaml")
    cfg = VLMConfig.from_config_dict(config)
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    caption, packed = train_batches(cfg, np.random.default_rng(11))
    trainer = build_trainer(config, params, [caption, packed], dev)
    del params
    for name, batch in (("caption", caption), ("packed", packed)):
        batch = trainer._put(batch)
        trainer._step_fn(trainer.params, batch)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = vlm_forward_loss(trainer.params, cfg, batch)["total_loss"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, trainer.optimizer.params)
        trainer.optimizer.step(grads)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        del loss, grads
        log(f"training step, {name} batch: forward {(t1 - t0) * 1e3:.1f} ms, "
            f"backward + update {(t2 - t1) * 1e3:.1f} ms (host clock)")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer._step_fn(trainer.params, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        busy_ms = sum(e.self_device_time_total for e in events
                      if e.device_type == DeviceType.CUDA) / 1e3
        log(f"training step, {name} batch, under the profiler: wall "
            f"{wall_ms:.1f} ms, card busy {busy_ms:.1f} ms, busy share "
            f"{busy_ms / wall_ms:.3f}")
        log(events.table(sort_by="self_device_time_total", row_limit=15,
                         max_name_column_width=60))
    del trainer
    torch.cuda.empty_cache()


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device visible; this "
                         "measurement runs on the card")
    from lhrs_bot_tpu_torch.core import build_engine, eval_config
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.models.vlm import encode_image
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    config = eval_config()
    cfg = VLMConfig.from_config_dict(config)
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    engine = build_engine(cfg, params, config, dev)
    rng = np.random.default_rng(0)

    def request(n):
        ids = rng.integers(3, cfg.llama.vocab_size, n).astype(np.int32)
        ids[0], ids[1] = cfg.llama.bos_token_id, -200
        return ids[None], np.asarray([n], np.int32)

    size = cfg.vit.image_size
    img = rng.integers(0, 256, (1, size, size, 3)).astype(np.uint8)
    timg = torch.as_tensor(img, device=dev)
    log("encode_image, 1 image: %.3f ms (events), %.3f ms (host)" % timed(
        lambda: encode_image(engine.params, timg, cfg)))
    towers(engine.params, cfg, dev)
    one = GenerationConfig(max_new_tokens=1)
    for n in (40, 2048):
        ids, lens = request(n)
        log(f"prefill + first-token logits, {n}-token prompt: "
            "%.3f ms (events), %.3f ms (host)" % timed(
                lambda: engine._start(ids, lens, img, one)))
    ids, lens = request(40)
    logits, cache, _ = engine._start(ids, lens, img,
                                     GenerationConfig(max_new_tokens=64))
    tok = logits.argmax(-1).to(torch.int32)
    log("decode step, B=1 after a 40-token prompt: %.3f ms (events), "
        "%.3f ms (host)" % timed(lambda: engine._decode_step(cache, tok)))
    del cache
    lm_head = engine.llama_params["lm_head"]
    x = torch.randn(1, lm_head.shape[0], device=dev, dtype=torch.bfloat16)
    log("lm_head product, float32: %.3f ms (events), %.3f ms (host)" % timed(
        lambda: torch.matmul(x.float(), lm_head.float())))
    log("lm_head product, bf16: %.3f ms (events), %.3f ms (host)" % timed(
        lambda: torch.matmul(x, lm_head)))

    profile_generate(engine, ids, lens, img)
    paged_tick(engine, cfg, dev, "bf16 pool")

    log("-- W4A8 weights + int8 lm_head + int8 KV cache --")
    w4 = build_engine(cfg, params, {**config, "bits": 4, "quant_type": "int4h",
                                    "kv_bits": 8, "lm_head_bits": 8}, dev)
    del params
    for n in (40, 2048):
        ids, lens = request(n)
        log(f"prefill + first-token logits, {n}-token prompt: "
            "%.3f ms (events), %.3f ms (host)" % timed(
                lambda: w4._start(ids, lens, img, one)))
    ids, lens = request(40)
    logits, cache, _ = w4._start(ids, lens, img,
                                 GenerationConfig(max_new_tokens=64))
    tok = logits.argmax(-1).to(torch.int32)
    log("decode step, B=1 after a 40-token prompt: %.3f ms (events), "
        "%.3f ms (host)" % timed(lambda: w4._decode_step(cache, tok)))
    del cache
    from lhrs_bot_tpu_torch.ops.quant import quantized_matmul
    x = torch.randn(1, cfg.llama.hidden_size, device=dev,
                    dtype=torch.bfloat16)
    log("lm_head product, int8: %.3f ms (events), %.3f ms (host)" % timed(
        lambda: quantized_matmul(x, w4.llama_params["lm_head"],
                                 out_dtype=torch.float32)))
    profile_generate(w4, ids, lens, img)
    paged_tick(w4, cfg, dev, "int8 pool, W4A8 weights")
    del w4
    torch.cuda.empty_cache()

    lp, lcfg = engine.llama_params, cfg.llama
    full = {}
    for name, params, dtype, plain in (
            ("kernels bf16", lp, torch.bfloat16, False),
            ("plain bf16", lp, torch.bfloat16, True),
            ("plain float32", None, torch.float32, True)):
        if params is None:
            params = {k: v.float() if torch.is_tensor(v)
                      else {kk: vv.float() for kk, vv in v.items()}
                      for k, v in lp.items()}
        with plain_attention() if plain else contextlib.nullcontext():
            logits_d, full[name], faulty = decode_vs_prefill(
                params, lcfg, dev, dtype)
        log(f"consistency, {name}: rel L2 {rel_l2(logits_d, full[name])}")
        for fault, logits in faulty.items():
            log(f"  planted fault, {fault}: rel L2 "
                f"{rel_l2(logits, full[name])}")
        del params, faulty
    for name in ("kernels bf16", "plain bf16"):
        log(f"full prefill logits, {name} vs plain float32: rel L2 "
            f"{rel_l2(full[name], full['plain float32'])}")
    log(f"full prefill logits, kernels bf16 vs plain bf16: rel L2 "
        f"{rel_l2(full['kernels bf16'], full['plain bf16'])}")
    # the same check on the first layers alone: bf16 noise grows with depth
    for depth in (1, 4):
        cut = {**lp, "layers": {k: v[:depth]
                                for k, v in lp["layers"].items()}}
        logits_d, logits_f, faulty = decode_vs_prefill(
            cut, dataclasses.replace(lcfg, num_hidden_layers=depth), dev,
            torch.bfloat16)
        log(f"consistency, kernels bf16, first {depth} layer(s): rel L2 "
            f"{rel_l2(logits_d, logits_f)}; planted faults " + "; ".join(
                f"{fault} {rel_l2(logits, logits_f)}"
                for fault, logits in faulty.items()))
    del engine, lp, cut, full
    torch.cuda.empty_cache()
    log("-- stage-1 training --")
    train_profile(dev)
    log(smi_line())


if __name__ == "__main__":
    sys.exit(main())
