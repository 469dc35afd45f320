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
     and strided at a ragged 257 rows; K1's normalize-first variant (the
     vision blocks' softmax rounding) at ViT B64 S257 and the perceiver's
     64x320 in each LHRS_VIT_SOFTMAX mode against its plain version, the
     normalisation skipped (planted) past the bound, its time beside
     plain K1's, SDPA's and the bound; the fused ViT block (B = 1 and 8;
     B 8 in each softmax mode and as before the variant), its split form
     and the fused perceiver block against their plain versions, and the
     fused W8A8 tower at full depth against the bf16 tower, with a planted
     fault, and in each softmax mode against its plain version, with the
     bench's prefill cells in each mode; the normalize-first attention's
     paths by row length (resident, split, cluster, two-pass) at the
     224-, 336- and 504-px shapes and D128 at 577 keys (NORM_K1_SHAPES)
     and the fused tower at 336 px (split path) and 504 px (the path
     `norm_path` gives its 1,297-token rows) with their launches;
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
     slot's table row may name a live page after any tick; the HTTP
     serving frontend (serve/api.py with the byte-level tokenizer) over
     the contiguous and paged bf16 schedulers and the paged int8 one:
     its warmup, then over a live socket a text request, a PNG image, two
     PNG images (written here with zlib, decoded by the port's image_io
     to the arrays encoded), a chat completion with a system message, a
     turn of history and an image_url, and a stream, each with the ids
     the same Request gets from a scheduler built alike (bit for bit; the
     stream's equal the blocking call's), the 2-image request's
     first-token logits within the bf16 consistency bound of the engine's
     (the images swapped must exceed it), 8 concurrent requests, a stream
     abandoned after 2 tokens cancelled (/health reads active 0), a
     corrupt image refused with 400, K1 and the path's decode kernel
     launched, and times over HTTP beside the direct runs'; the W4A8
     engine again with LHRS_DECODE_INT8_DOTS=1: the int8-dots kernel 32
     times a decode step and K4 never, and its consistency check; the
     sessions phase over the bf16 engine (and its part (b) over the W4A8
     + int8-KV one), each logits check within the engine's consistency
     bound with a planted fault (the continuation started one row early):
     the continuation prefill in float32 on the first 4 layers against
     the cacheless forward (chunks of 256, a 400-row prefill continued by
     200, a greedy verify window; ids equal), (a) prefill_chunk 512
     against the monolithic prefill of the 2,191-row prompt (logits, ms,
     K1 in the vision tower only), (b) a three-turn chat with an image,
     session against fresh runs (time to first token a turn, the cache
     allocated once at S_max, K1 on turn 1 only, 32 decode-kernel launches
     a decode step), (c) stream(speculative=4) against plain greedy on a
     repetitive prompt, with prompt lookup, with an always-rejected draft
     (greedy through the verify windows) and with an oracle draft of that
     path's tokens (acceptance per window, tokens/s, K2 launches a token;
     a teacher-forced window held to the decode steps; where the ids part,
     the top-2 margin there within the measured deviation), (d) an
     8-request wave through the contiguous scheduler with speculative 4,
     prompt lookup and an oracle draft of that wave's tokens, against
     plain ticks (tokens/s, time to first token, no K2 in the speculative
     waves) and (e) cli_qa_torch's chat loop over three scripted turns;
     one greedy request at 504 px (the W4A8 recipe with the fused W8A8
     tower, the decoder cut to REQUEST_504_LAYERS layers) against the same
     request with plain kernels, its time to the first token beside the
     224-px one;
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
  7. checkpoints at full width, the decoder cut to CKPT_DEPTH (8) of
     LLaMA-2-7B's 32 layers: the reference's artifacts written from
     named seeds under build/ (an HF LLaMA-2-7B directory of two fp16
     safetensors shards, an HF CLIP directory, FINAL.pt with the nested
     other_ckpt and embed_tokens resized to 32,004 rows, TextLoRA/ at r
     128 on all 7 linears with B != 0; free disk and host memory checked
     first, the directory deleted at the end), loaded at stage 0 through
     `load_pretrained` bit for bit against trees built from the seeds
     (three planted faults, over the artifacts written again at 4 decoder
     layers: alpha / r swapped, a layer's q_proj / k_proj swapped in the
     shard's header, the w_down adapters dropped), the bf16
     and W4A8 + int8 lm_head + int8 KV engines over the loaded tree bit for
     bit against engines over the expected tree; stage 2
     (`Config/multi_modal_stage2.yaml` through build_model: int8 base,
     live adapters) with the adapters' and pooler's gradient against the
     plain attention (the training phase's bound and faults), six steps
     (loss, ms, tokens/s, peak memory, busy share, launches; the loss must
     fall) and save_final; stage 3 (`multi_modal_stage3.yaml`) from that
     output, the adapters bit for bit, two steps, save_final; and the eval
     load of stage 3's output (adapters merged) served bit for bit against
     the plainly merged tree, and `make_cls_eval_fn` over that tree (16
     PNG images, B = 8: images/s, K1 and K2 launched); each part's
     seconds; then, over the same artifacts, training from data on disk
     (`phase_train_from_disk`): a
     32-image PNG corpus written under build/ (JPEGs too where the native
     library builds), `main_pretrain_stage2_torch.main` at full width with
     the decoder cut to 4 layers, checkpoints every 2 iterations: 4
     workers; 1 worker killed before iteration 2; its --auto-resume; 1
     worker uninterrupted; the resumed run's losses, adapters, perceiver
     and optimizer state equal the uninterrupted one's bit for bit; data
     against step time, each checkpoint write's and the resume's bytes
     and seconds, peak memory, the launches of the 4-worker run; and the
     eval entry points (`phase_eval`): five PNG corpora (cls, RSVQA-LR,
     grounding, LHRS-Bench, captions) and each `main_*_torch.main` at
     full width with the decoder cut to 4 layers, bf16, B = 8, batched,
     with --scheduled-eval and with every kernel patched to its plain
     version, each keeping its logits, and the cls entry again under
     W4A8 + int8 KV + int8 lm_head: K1 and K2 (K3, K4 and A) launched on
     the kernel runs and none on the plain ones, the batched and the
     scheduled run's ids held to the plain run's (where they part, the
     plain run's top-2 margin within the measured deviation, every
     position up to there within 0.15 relative L2), a planted fault (K2's
     K and V swapped) that must fail batched and scheduled, images/s of
     each protocol over two timed runs a mode (median and range), and
     whether PIL and cv2 import;
  8. data and tensor parallelism (`phase_parallel`): two ranks of the port
     started as torchrun starts them (`chip_smoke.py --parallel-worker`),
     both on the one card over gloo (the gloo collectives the port runs
     checked on the card's tensors first), at full widths with the decoder
     cut to 2 layers, held to one rank here on the same seeded weights:
     (a) tp = 2 serving through the bf16 engine and the W4A8 + int8 KV +
     int8 lm_head recipe, two requests (B 1 and 2, 12 tokens): the first
     token's logits within TP_REL_L2, the ids equal or parting where one
     rank's top-2 margin lies within the measured deviation, both ranks'
     ids and logits equal, each rank's K1, K2 / K4, K3 (in mode (a) too:
     the row-parallel products) and A launched at the per-rank shapes
     (H 16, K3 at 4096->2048 and ->5504, 2048->4096 and 5504->4096, a
     16,000-row lm_head), the W4 rows sliced along the packed axis (planted)
     past the bound; each rank's W4A8 products at those shapes
     (`check_tp_w4a8`) bit for bit the single rank's, the row-parallel
     codes kernel A's, a CTA's sums left out of mode (a) (planted)
     differing, and their times; dp = 2 serving (x tp = N / 2 with more
     ranks; `dp_serve`): the engine's batch of 2 (a row a data group) and
     a 6-request contiguous wave over 4 slots (2 a group) through both
     recipes, every position's logits up to a parting within DP_REL_L2 of
     one rank's, the ids equal or parting where one rank's top-2 margin
     lies within the deviation, both ranks' ids equal, each group's cache
     holding its share of the rows and slots, each rank's launches, one
     rank's decode step batch-invariant (`batch_invariance`, which also
     reads the tower's and the prefill's batch dependence and the noise
     floor), and the wave's tokens gathered in reverse group order
     (planted) caught in both recipes;
     (b) one stage-2 step (int8 base, LoRA
     with non-zero B, the recipe's AdamW) at dp = 2 with ZeRO-sharded
     slots against dp = 1 on the same 4-row global batch (loss and
     grad_norm within DP_METRIC_REL, every trainable leaf's first moment
     within DP_MOMENT_REL_L2, the updates within DP_UPDATE_REL_L2, every
     trainable leaf equal on both ranks, a rank that skips its gradient
     reduction past both bounds); (c) context parallelism at cp = 2
     (`cp_worker`): the ring (B 2, H 32, S 8,192, D 128, bf16, causal,
     row 1 right-padded to 5,000) through K1 and the flash backward
     against the plain ring on the same rank (output on valid rows, dQ /
     dK / dV, ATOL + RTOL), each rank's launches rank + 1 a kernel, the
     mask left behind and the owner index held (planted) past the bound;
     one stage-1 step over one 4,096-row spliced sequence against cp = 1
     (loss and grad_norm within DP_METRIC_REL, the updates within
     DP_UPDATE_REL_L2, the seq-group gradient reduction skipped past it),
     each rank's peak memory against cp = 1, and `utils.profiler`'s
     ProfilerHook over two more steps (a trace written, the card's memory
     stats); (d) ViT-B/16 at 224² (`vit_base_checks`): the bf16 tower on
     K1 against plain, the fused W8A8 tower against it, float NCHW pixels
     against uint8, and a perceiver with an in_proj (768 -> 1024) fused
     against its plain version, each with a planted fault; and what NCCL
     does with two ranks on one card (the port's init_distributed refuses;
     torch's own group) and gloo with point-to-point calls on CUDA tensors.
     A failing rank fails the phase. The times are two ranks sharing one
     card over gloo, not a machine of two cards;
  9. start-up (`phase_startup`): (a) the port's SentencePiece reader on the
     committed fixture (tests/torch_spm_fixture: a 32,000-piece BPE
     tokenizer.model in LLaMA-2's layout): every corpus string's ids and
     decode under legacy true and false equal to expected.json, the host
     encode time of the LLaMA-2 template with one question and of a
     2,000-token prompt; (b) an HF LLaMA directory at full width with the
     decoder cut to 2 layers and the fixture's tokenizer files beside the
     weights, built through build_model_and_tokenizer -> build_engine from
     a config whose text.path is that directory, three image requests
     through serve.api's frontend (one slot), each reply's ids bit for bit
     the direct generate call's and its text the reader's decode; (c) that
     stage-0 tree converted (save_converted_params), reloaded
     (load_converted_params) byte-equal, an engine over it giving the same
     greedy ids, both load paths' seconds and GB/s; (d) planted: a
     converted leaf with one element changed, two pieces' scores swapped;
     each must be caught.
Then a JSON line with per-kernel numbers, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Every line is also written to
chiprun_out/chip_smoke.log. Any failure raises: the script
exits non-zero and prints no result, and the failing phase's traceback is
kept in chiprun_out/chip_smoke_<phase>.err (a crash of the interpreter
leaves its stacks in chiprun_out/chip_smoke_crash.txt). It needs no network
and imports nothing of JAX.

`python3 chip_smoke.py --eval-only` builds the kernels and runs phase 7's
eval part alone (the artifacts at 4 decoder layers, `phase_eval`, the cls
protocol over them): a short check of the eval path, not the full run.
`python3 chip_smoke.py --startup-only` builds the kernels and runs phase 9
alone (about a minute after the build).
`python3 chip_smoke.py --parallel-only` builds the kernels and runs phase 8
alone (~2 minutes with the build); `--parallel-only --dist-backend nccl
--ranks N` runs it with N ranks over NCCL, a card a rank (a machine of N
cards or more; the NCCL probes are left out).
"""

import base64
import contextlib
import faulthandler
import gc
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


def plain_flash(q, k, v, kv_mask=None, *, causal=False, sm_scale=None):
    """`flash_attention` through its plain version, on CUDA tensors too."""
    from lhrs_bot_tpu_torch.ops.attention import mha_reference

    return mha_reference(q, k, v, kv_mask, causal=causal, sm_scale=sm_scale)


@contextlib.contextmanager
def plain_attention():
    """Route the decoder's two attention entry points to their plain
    versions, on CUDA tensors too, for as long as the block runs."""
    import lhrs_bot_tpu_torch.models.llama as llama
    from lhrs_bot_tpu_torch.ops.fused_decode import \
        fused_decode_attention_plain

    saved = llama.flash_attention, llama.fused_decode_attention
    llama.flash_attention = plain_flash
    llama.fused_decode_attention = fused_decode_attention_plain
    try:
        yield
    finally:
        llama.flash_attention, llama.fused_decode_attention = saved


# every line `log` prints, also kept in OUT_DIR/chip_smoke.log by `main`:
# a whole run's output is longer than a caller may keep of its end
LOG_FILE = []


def log(msg):
    print(msg, flush=True)
    for f in LOG_FILE:
        f.write(f"{msg}\n")
        f.flush()


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
# max|plain| plus one bf16 step. Plain K1 rounds the unnormalised
# probabilities to bf16 where the plain attention rounds the normalised
# ones, and the block's int8 activation quantization turns that 1.4e-3
# relative L2 at the attention output into about 4.4e-3 at the block's
# output: on an H100 at 700 W blocks on plain K1 read 4.7-6.0e-3 relative
# L2 and elements within 7.5e-3 of max|plain| against their plain
# versions, and the bounds sit about 2x above (PERF.md has the readings).
# The blocks now launch K1's normalize-first variant, which rounds where
# the plain attention does (2.6-2.8e-5 relative L2 at the attention output
# on that card), except in the exp2_post softmax mode (1.2e-3).
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


# The normalize-first attention (csrc/flash_fwd_norm.cu, the vision blocks'
# rounding) against its plain version at the vision shapes, in each
# LHRS_VIT_SOFTMAX mode ("jnn" and "exp2_pre" launch it, "exp2_post" plain
# K1): relative L2 of the output. Both round the same probabilities to
# bf16; what is left is float32 summation order and ex2.approx: 2.5e-5 to
# 2.8e-5 on an H100 at 700 W (float32 out). A bf16 output adds one bf16 ulp
# (2^-8 relative) on the elements whose two float32 values straddle a
# rounding boundary, so it is held to NORM_K1_BF16_REL_L2 against the plain
# version rounded alike. Two planted faults must fail: plain K1 in its
# place (the unnormalised probabilities rounded, 2.16e-3 there) and the
# normalisation skipped (each row scaled by its sum). "exp2_post" launches
# plain K1, whose online softmax rounds each probability against its
# running max where the plain version rounds against the row's: 1.18e-3 to
# 1.23e-3 there, held to the 1e-2 of K1's vision checks
NORM_K1_REL_L2 = 2e-4
NORM_K1_BF16_REL_L2 = 5e-4
PLAIN_K1_VISION_REL_L2 = 1e-2
# (name, B, H, Sq, Skv, D, kv_mask, output dtype): ViT-L/14's 257 tokens
# (224 px), the perceiver's first group (64 queries over 64 + 256 keys),
# all three groups under the block's own mask (`perceiver_block._kv_mask`:
# the group's queries and image tokens valid, its pad slots masked; every
# group's 64 query rows, past its count too), the split form's bf16 output,
# ViT-B/16's 197 tokens, ViT-L/14 at 336 px (577 tokens; the block's 592
# padded keys under its pad mask; a bf16 output; its perceiver's three
# groups over 64 + 576 keys: the split path), ViT-L/14 at 504 px (1,297
# tokens; the block's 1,312 padded keys under its pad mask; a bf16 output:
# the path `norm_path` gives them; its perceiver's three groups over 64 +
# 1,296 keys, one Q tile a head: the two-pass path, the cluster path held
# beside it), a head dim of 128 (197 tokens) and a head dim of 128 at 577
# tokens (no split or cluster path: the two-pass path, K streamed through
# its ring twice), 64 images each
NORM_K1_SHAPES = (
    ("vit", 64, 16, 257, 257, 64, None, "float32"),
    ("perceiver_g0", 64, 16, 64, 320, 64, None, "float32"),
    ("perceiver", 64 * 3, 16, 64, 320, 64, "perceiver", "float32"),
    ("split_bf16", 64, 16, 257, 257, 64, None, "bfloat16"),
    ("vit_b16", 64, 12, 197, 197, 64, None, "float32"),
    ("vit_336", 64, 16, 577, 577, 64, None, "float32"),
    ("vit_336_block", 64, 16, 592, 592, 64, "pad", "float32"),
    ("vit_336_bf16", 64, 16, 577, 577, 64, None, "bfloat16"),
    ("perceiver_336", 64 * 3, 16, 64, 640, 64, "perceiver", "float32"),
    ("vit_504", 64, 16, 1297, 1297, 64, None, "float32"),
    ("vit_504_block", 64, 16, 1312, 1312, 64, "pad", "float32"),
    ("vit_504_bf16", 64, 16, 1297, 1297, 64, None, "bfloat16"),
    ("perceiver_504", 64 * 3, 16, 64, 1360, 64, "perceiver", "float32"),
    ("d128", 64, 8, 197, 197, 128, None, "float32"),
    ("d128_577", 64, 8, 577, 577, 128, None, "float32"),
)
# the shapes at which the two-pass kernel, after its checks, runs back to
# back for about NORM_SOAK_MS of device time (at least NORM_SOAK_MIN
# launches), each launch's output bit for bit the first's (the kernel sums
# in a fixed order), the first held to the bound: its own rows (the 504-px
# perceiver's, D128 at 577 keys, ViT-L/14 504 px's and its block's, whose
# odd last Q tile a CTA takes alone) and ViT-L/14's at 336 px
NORM_SOAK = ("vit_336", "vit_504", "vit_504_block", "perceiver_504",
             "d128_577")
NORM_SOAK_MS, NORM_SOAK_MIN = 3000.0, 200
# the valid tokens of a block's padded rows (336 and 504 px)
VIT_PAD_VALID = {592: 577, 1312: 1297}
SOFTMAX_MODES = ("jnn", "exp2_pre", "exp2_post")


def unflagged_k1(q, k, v, kv_mask, sm_scale, out_dtype=None, out=None):
    """Plain K1 in the place of the normalize-first kernel: the vision
    blocks' attention with the probabilities rounded unnormalised, for
    timing against it and as a planted fault."""
    import torch

    from lhrs_bot_tpu_torch.ops.attention import flash_attention_fwd

    return flash_attention_fwd(q, k, v, kv_mask, False, sm_scale,
                               out_dtype or torch.float32, out)


def check_normalized_k1(dev, gen):
    """The normalize-first attention at NORM_K1_SHAPES: in each softmax mode
    `attend_token_major` (Q, K and V strided views of their projections,
    token-major out, as the blocks launch it) against its plain version
    within NORM_K1_REL_L2 (NORM_K1_BF16_REL_L2 for a bf16 output),
    launching the kernel's path for the rows (`norm_path`: resident up to
    NORM_RESIDENT_KEYS[D] keys, split up to NORM_SPLIT_KEYS[D], cluster up
    to NORM_CLUSTER_KEYS[D] with more than one Q tile outside
    NORM_TWO_PASS_TILES[D] key tiles, else two-pass) for
    "jnn" and "exp2_pre" only, and no other; the planted faults (plain K1
    in its place, in those two modes; the normalisation skipped) past the
    bound; its time beside plain K1's, the plain version's, SDPA's and the
    bound; and the other kernel that takes the rows, held to the same bound
    with the same skipped-normalisation fault and timed: the two-pass path
    at the resident, split and cluster shapes, the cluster path at the
    two-pass path's shapes in its range. Where the two-pass kernel takes
    or is held at the rows, it then runs back to back for about
    NORM_SOAK_MS of device time (at least NORM_SOAK_MIN launches) at the
    shapes of NORM_SOAK: every launch's output equal bit for bit to the
    first's, which is held to the same bound."""
    import torch
    import torch.nn.functional as F

    import lhrs_bot_tpu_torch.ops.vit_block as vit_block_mod
    from lhrs_bot_tpu_torch.ops.attention import (
        _flash_fwd_norm, flash_attention_fwd, flash_attention_fwd_normalized,
        flash_attention_fwd_normalized_cluster,
        flash_attention_fwd_normalized_split,
        flash_attention_fwd_normalized_two_pass, norm_keys_path, norm_path)
    from lhrs_bot_tpu_torch.ops.perceiver_block import _kv_mask
    from lhrs_bot_tpu_torch.ops.vit_block import (_LOG2E, _heads,
                                                  attend_token_major,
                                                  attention_plain)

    paths = ("resident", "split", "cluster", "two_pass")
    wrappers = (flash_attention_fwd_normalized,
                flash_attention_fwd_normalized_split,
                flash_attention_fwd_normalized_cluster,
                flash_attention_fwd_normalized_two_pass)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def launches():
        return [fn.launches for fn in wrappers]

    out = {"max_abs_err": 0.0, "shapes": {}}
    for name, b, h, sq, skv, d, mask_kind, dtype in NORM_K1_SHAPES:
        w, sm = h * d, d ** -0.5
        out_dtype = getattr(torch, dtype)
        path = norm_path(skv, d, sq)
        # the other kernel that takes these rows
        alt = "two_pass" if path != "two_pass" else norm_keys_path(skv, d)
        alt = None if alt == path else alt
        if sq == skv:  # one (B, S, 3W) projection, as the ViT block's
            q, k, v = _heads(randn(b, sq, 3 * w), 3, h)
        else:  # the perceiver's q and K|V projections
            (q,) = _heads(randn(b, sq, w), 1, h)
            k, v = _heads(randn(b, skv, 2 * w), 2, h)
        mask = None
        if mask_kind == "perceiver":  # B * 3 (image, group) rows
            mask = _kv_mask(b // 3, sq, skv, (64, 48, 32),
                            tuple(n + skv - 64 for n in (64, 48, 32)), dev)
        elif mask_kind == "pad":  # the block's padded tokens
            mask = (torch.arange(skv, device=dev) < VIT_PAD_VALID[skv]
                    ).expand(b, skv).contiguous()
        limit_norm = (NORM_K1_BF16_REL_L2 if dtype == "bfloat16"
                      else NORM_K1_REL_L2)
        reading = {"path": path}
        for mode in SOFTMAX_MODES:
            scale = sm if mode == "jnn" else sm * _LOG2E
            before = launches()
            got = attend_token_major(q, k, v, mask, scale, out_dtype,
                                     mode=mode)
            after = launches()
            ref = attend_token_major(q, k, v, mask, scale, out_dtype,
                                     plain=True, mode=mode)
            torch.cuda.synchronize()
            r = rel(got, ref)
            err = float((got.float() - ref.float()).abs().max())
            launched = [a - z for a, z in zip(after, before)]
            reading[mode] = {"rel_l2": r, "max_abs_err": err,
                             "launches": launched}
            want = [0] * len(paths)
            if mode != "exp2_post":
                want[paths.index(path)] = 1
            if launched != want:
                raise AssertionError(f"normalize-first {name} {mode}: "
                                     f"launched {launched} ({paths}), not "
                                     f"{want}")
            limit = (PLAIN_K1_VISION_REL_L2 if mode == "exp2_post"
                     else limit_norm)
            if not r <= limit:
                raise AssertionError(f"normalize-first {name} {mode}: rel L2 "
                                     f"{r:.3e} > {limit}")
            if mode != "exp2_post":
                if path == "resident":  # the resident kernel's row
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                with patched(vit_block_mod,
                             flash_attention_fwd_normalized=unflagged_k1):
                    swapped = attend_token_major(q, k, v, mask, scale,
                                                 out_dtype, mode=mode)
                r = reading[mode]["unflagged_rel_l2"] = rel(swapped, ref)
                if r <= limit_norm:
                    raise AssertionError(f"normalize-first {name} {mode}: "
                                         "plain K1 in its place passes "
                                         f"({r:.3e})")
        o = torch.empty(b, sq, h, d, device=dev, dtype=out_dtype)
        ot = o.transpose(1, 2)
        ref = attention_plain(q, k, v, mask, sm, out_dtype)
        _flash_fwd_norm(q, k, v, mask, sm, out_dtype, ot, path=path,
                        fault=1)
        torch.cuda.synchronize()
        fault = rel(ot, ref)
        if fault <= limit_norm:
            raise AssertionError(f"normalize-first {name}: the skipped "
                                 f"normalisation passes ({fault:.3e})")
        if alt is not None:  # the other kernel at the same shape
            _flash_fwd_norm(q, k, v, mask, sm, out_dtype, ot, path=alt)
            torch.cuda.synchronize()
            r = reading[f"{alt}_rel_l2"] = rel(ot, ref)
            reading[f"{alt}_max_abs_err"] = float(
                (ot.float() - ref.float()).abs().max())
            if not r <= limit_norm:
                raise AssertionError(f"normalize-first {name}: the {alt} "
                                     f"path's rel L2 {r:.3e} > {limit_norm}")
            _flash_fwd_norm(q, k, v, mask, sm, out_dtype, ot, path=alt,
                            fault=1)
            torch.cuda.synchronize()
            r = reading[f"{alt}_fault_rel_l2"] = rel(ot, ref)
            if r <= limit_norm:
                raise AssertionError(f"normalize-first {name}: the {alt} "
                                     "path's skipped normalisation passes "
                                     f"({r:.3e})")
            reading[f"{alt}_ms"] = cuda_ms(lambda: _flash_fwd_norm(
                q, k, v, mask, sm, out_dtype, ot, path=alt))
        ms = cuda_ms(lambda: flash_attention_fwd_normalized(
            q, k, v, mask, sm, out_dtype, ot))
        k1_ms = cuda_ms(lambda: flash_attention_fwd(
            q, k, v, mask, False, sm, out_dtype, ot))
        plain = cuda_ms(lambda: attention_plain(q, k, v, mask, sm,
                                                out_dtype), reps=5)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        am = None if mask is None else mask[:, None, None, :]
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, attn_mask=am, scale=sm))
        soak = ""
        if name in NORM_SOAK:  # the two-pass kernel back to back
            n = max(NORM_SOAK_MIN, int(NORM_SOAK_MS / (
                ms if path == "two_pass" else reading["two_pass_ms"])))
            _flash_fwd_norm(q, k, v, mask, sm, out_dtype, ot,
                            path="two_pass")
            first = ot.clone()
            differ = torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(n):
                _flash_fwd_norm(q, k, v, mask, sm, out_dtype, ot,
                                path="two_pass")
                differ += (ot != first).any()
            r, differ = rel(first, ref), int(differ)
            reading["two_pass_soak"] = {"launches": n, "rel_l2": r,
                                        "differ": differ}
            if differ or not r <= limit_norm:
                raise AssertionError(f"normalize-first {name}: the two-pass "
                                     f"path back to back: {differ} of {n} "
                                     "launches differ from the first, whose "
                                     f"rel L2 is {r:.3e} (bound {limit_norm})")
            del first
            soak = (f"; two-pass path {n} launches back to back, each equal "
                    f"to the first, rel L2 {r:.2e}")
        # q read once, the keys' K and V rows that are attended (and the
        # mask) read once, the output written once; Q K^T and P V over
        # every (query, attended key) pair
        keys = b * skv if mask is None else int(mask.sum())
        bms, by = bound(h * d * (2 * b * sq + 4 * keys
                                 + o.element_size() * b * sq)
                        + (0 if mask is None else b * skv),
                        4.0 * h * sq * keys * d)
        reading.update({"fault_rel_l2": fault, "ms": ms, "k1_ms": k1_ms,
                        "plain_ms": plain, "library_ms": lib,
                        "bound_ms": bms, "bound_by": by})
        out["shapes"][name] = reading
        log(f"  normalize-first {name} (B{b} H{h} {sq}x{skv} D{d}, "
            f"{f'{mask_kind} mask, ' if mask is not None else ''}strided, "
            f"{dtype} token-major out; {path} path): rel L2 vs "
            "plain " + ", ".join(f"{m} {reading[m]['rel_l2']:.2e}"
                                 for m in SOFTMAX_MODES)
            + f" (bound {limit_norm}; exp2_post on plain K1, bound "
            f"{PLAIN_K1_VISION_REL_L2}); plain K1 "
            "in its place " + ", ".join(
                f"{m} {reading[m]['unflagged_rel_l2']:.2e}"
                for m in SOFTMAX_MODES[:2])
            + f"; normalisation skipped {fault:.3f}; kernel {ms:.4f} ms"
            + (f" ({alt.replace('_', '-')} path "
               f"{reading[f'{alt}_ms']:.4f} ms, rel L2 "
               f"{reading[f'{alt}_rel_l2']:.2e}, normalisation skipped "
               f"{reading[f'{alt}_fault_rel_l2']:.3f})"
               if alt is not None else "")
            + f", plain K1 {k1_ms:.4f} ms, plain {plain:.4f} ms, library "
            f"(SDPA, bf16 out) {lib:.4f} ms, bound {bms:.4f} ms ({by})"
            + soak)
        del q, k, v, qc, kc, vc, o, ot, got, ref, swapped
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    vit = out["shapes"]["vit"]
    out.update({k: vit[k] for k in keys})
    # the split kernel's row at ViT-L/14 336 px (577 tokens), the cluster
    # kernel's at 504 px (1,297 tokens) and the two-pass kernel's at the
    # 504-px perceiver's 64 x 1,360: each path's own reading, or its
    # reading as the other kernel of those rows
    for path, shape in (("split", "vit_336"), ("cluster", "vit_504"),
                        ("two_pass", "perceiver_504")):
        r = out["shapes"][shape]
        out[path] = {k: r[k] for k in keys}
        if r["path"] == path:
            out[path]["max_abs_err"] = max(r[m]["max_abs_err"]
                                           for m in SOFTMAX_MODES[:2])
        else:
            out[path].update(ms=r[f"{path}_ms"],
                             max_abs_err=r[f"{path}_max_abs_err"])
    return out


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
    out["normalized"] = check_normalized_k1(dev, gen)

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
    # row 9 in each softmax mode, and as before the normalize-first attention
    import lhrs_bot_tpu_torch.ops.vit_block as vit_block_mod

    by_mode = {}
    for mode in SOFTMAX_MODES:
        with environ("LHRS_VIT_SOFTMAX", mode):
            err = check_fused(f"fused_vit_block B8 {mode}",
                              fused_vit_block(x, lp, **kw),
                              fused_vit_block_plain(x, lp, **kw))
            by_mode[mode] = {"max_abs_err": err, "ms": cuda_ms(
                lambda: fused_vit_block(x, lp, **kw), reps=5)}
    with patched(vit_block_mod, flash_attention_fwd_normalized=unflagged_k1):
        by_mode["before"] = {"ms": cuda_ms(
            lambda: fused_vit_block(x, lp, **kw), reps=5)}
    blocks["fused_vit_block_b8"]["softmax_modes"] = by_mode
    log(f"  fused_vit_block B8 by LHRS_VIT_SOFTMAX: " + ", ".join(
        f"{m} {v['ms']:.4f} ms" + (f" (max abs err vs plain "
                                    f"{v['max_abs_err']:.3e})"
                                    if "max_abs_err" in v else "")
        for m, v in by_mode.items()) + " (before: jnn's fold with plain "
        "K1, the probabilities rounded unnormalised)")
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
    with patched(vit_block_mod, flash_attention_fwd_normalized=unflagged_k1):
        before = cuda_ms(lambda: fused_perceiver_block(q, kv, plp, **kw),
                         reps=5)
    blocks["fused_perceiver_block"] = {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain, "bound_ms": bms,
                                       "bound_by": by, "before_ms": before}
    log(f"  fused_perceiver_block (2 images, 3 groups): max abs err "
        f"{err:.3e}; kernels {ms:.4f} ms (plain K1 in the normalize-first "
        f"attention's place "
        f"{before:.4f} ms), plain {plain:.4f} ms, bound {bms:.4f} ms "
        f"({by})")
    out["blocks"] = blocks
    torch.cuda.empty_cache()
    return out


def phase_tower(dev, n_img=8):
    """The fused W8A8 tower (22 blocks) against the bf16 tower on the same
    seeded ViT-L weights: relative L2 of the (B, 768, 1024) features, which
    must stay within TOWER_REL_L2, and of the fused tower with one block
    skipped (its O and proj weights and biases zeroed: the block adds
    nothing to the residual stream), which must exceed it. Then in each
    LHRS_VIT_SOFTMAX mode the fused tower against its plain version (every
    block through the plain kernels) and against the bf16 tower, each
    within TOWER_REL_L2, and the bench's prefill cells (`bench_prefill`,
    B 64) in each mode and with plain K1 in the normalize-first attention's
    place."""
    import functools

    import torch

    import lhrs_bot_tpu_torch.models.vit as vit_mod
    import lhrs_bot_tpu_torch.ops.vit_block as vit_block_mod
    from lhrs_bot_tpu_torch import bench
    from lhrs_bot_tpu_torch.models import VLMConfig
    from lhrs_bot_tpu_torch.models.vit import (ViTConfig, vit_encode,
                                               vit_encode_fused)
    from lhrs_bot_tpu_torch.ops.vit_block import (pack_vit_layers_fused,
                                                  vit_layer_fused)

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
    del faulty
    modes = {}
    plain_layer = functools.partial(vit_layer_fused, plain=True)
    for mode in SOFTMAX_MODES:
        with environ("LHRS_VIT_SOFTMAX", mode):
            got = vit_encode_fused(bf16, packed, images, cfg).float()
            with patched(vit_mod, vit_layer_fused=plain_layer):
                plain = vit_encode_fused(bf16, packed, images, cfg).float()
            torch.cuda.synchronize()
            modes[mode] = {
                "vs_plain_rel_l2": float((got - plain).norm() / plain.norm()),
                "vs_bf16_rel_l2": rel(got)}
            cells = bench.bench_prefill(VLMConfig(), device=dev)
        modes[mode].update(cells)
        if max(modes[mode]["vs_plain_rel_l2"],
               modes[mode]["vs_bf16_rel_l2"]) > TOWER_REL_L2:
            raise AssertionError(f"fused tower, {mode}: {modes[mode]}")
    with environ("LHRS_VIT_SOFTMAX", "jnn"), patched(
            vit_block_mod, flash_attention_fwd_normalized=unflagged_k1):
        modes["before"] = bench.bench_prefill(VLMConfig(), device=dev)
    log("  fused W8A8 tower by LHRS_VIT_SOFTMAX (vs its plain version / vs "
        "the bf16 tower, rel L2; bench prefill cells at B 64, images/s): "
        + "; ".join(f"{m} " + ", ".join(
            f"{k} {v:.4f}" if "rel" in k else f"{k} {v:.2f}"
            for k, v in r.items()) for m, r in modes.items())
        + f" (bound {TOWER_REL_L2}; before: plain K1 in the blocks)")
    del packed, bf16
    torch.cuda.empty_cache()
    return {"rel_l2": dev_rel, "taps": per_tap, "fault_rel_l2": fault_rel,
            "bound": TOWER_REL_L2, "softmax_modes": modes,
            "tower_336": tower_336(dev), "tower_504": tower_504(dev)}


def tower_336(dev):
    """ViT-L/14 at 336 px: `tower_at`, the split path's rows."""
    return tower_at(dev, 336, "flash_attention_fwd_normalized_split")


def tower_504(dev):
    """ViT-L/14 at 504 px (GeoChat's geometry): `tower_at`, its 1,297-token
    rows on the path `norm_path` gives them."""
    return tower_at(dev, 504, norm_wrapper(1297, 64, 1297))


def norm_wrapper(skv, d, sq):
    """The name of the normalize-first wrapper that counts the launches of
    `norm_path`'s kernel for `sq` query rows over `skv` keys at head dim
    `d`."""
    from lhrs_bot_tpu_torch.ops.attention import norm_path

    path = norm_path(skv, d, sq)
    return "flash_attention_fwd_normalized" + (
        "" if path == "resident" else f"_{path}")


def vlm_at(size, base=None):
    """`base` (the default VLM configuration if None) with ViT-L/14 at
    `size` px and the perceiver over its image tokens a group."""
    import dataclasses

    from lhrs_bot_tpu_torch.models import VLMConfig

    base = base or VLMConfig()
    n = (size // base.vit.patch_size) ** 2
    return dataclasses.replace(
        base, vit=dataclasses.replace(base.vit, image_size=size),
        pooler=dataclasses.replace(base.pooler, split_part=(n,) * 3))


def tower_at(dev, size, wrapper, n_img=4):
    """ViT-L/14 at `size` px (336: 577 tokens, the normalize-first
    attention's split path; 504: 1,297 tokens, `norm_path`'s) and the
    perceiver over its image tokens a group, from seeded weights: the fused
    W8A8 tower against its plain version (every block through the plain
    kernels) within TOWER_REL_L2, finite features of the expected shape,
    the launches of each normalize-first path in one fused call (22 on
    `wrapper`'s path, none on another), and the bench's three tower cells
    at B 64 (images/s, ViT + perceiver)."""
    import functools

    import torch

    import lhrs_bot_tpu_torch.models.vit as vit_mod
    from lhrs_bot_tpu_torch import bench
    from lhrs_bot_tpu_torch.models.vit import vit_encode_fused
    from lhrs_bot_tpu_torch.ops.vit_block import (pack_vit_layers_fused,
                                                  vit_layer_fused)

    cfg = vlm_at(size)
    n_tok = cfg.vit.num_patches
    n_layers = cfg.vit.extract_stages[-1]
    gen = torch.Generator(device=dev).manual_seed(8)
    layers = vit_layers(dev, n_layers, seed=6)
    bf16 = {
        "patch_proj": torch.randn(14 * 14 * 3, VIT_W, generator=gen,
                                  device=dev) * 0.02,
        "class_emb": torch.randn(VIT_W, generator=gen, device=dev) * 0.02,
        "pos_emb": torch.randn(cfg.vit.seq_len, VIT_W, generator=gen,
                               device=dev) * 0.02}
    bf16 = {**{k: v.to(torch.bfloat16) for k, v in bf16.items()},
            "pre_ln": {"scale": torch.ones(VIT_W, device=dev),
                       "bias": torch.zeros(VIT_W, device=dev)}}
    packed = pack_vit_layers_fused(layers)
    del layers
    images = torch.randint(0, 256, (n_img, size, size, 3), generator=gen,
                           device=dev, dtype=torch.uint8)
    names = ("flash_attention_fwd_normalized",
             "flash_attention_fwd_normalized_split",
             "flash_attention_fwd_normalized_cluster",
             "flash_attention_fwd_normalized_two_pass")
    wrappers = kernel_wrappers()
    before = [wrappers[n].launches for n in names]
    got = vit_encode_fused(bf16, packed, images, cfg.vit).float()
    torch.cuda.synchronize()
    launches = {n: wrappers[n].launches - z for n, z in zip(names, before)}
    with patched(vit_mod, vit_layer_fused=functools.partial(
            vit_layer_fused, plain=True)):
        plain = vit_encode_fused(bf16, packed, images, cfg.vit).float()
    torch.cuda.synchronize()
    if got.shape != (n_img, 3 * n_tok, VIT_W) or not bool(
            got.isfinite().all()):
        raise AssertionError(f"{size}-px tower: bad features "
                             f"{tuple(got.shape)}")
    rel = float((got - plain).norm() / plain.norm())
    want = {n: n_layers if n == wrapper else 0 for n in names}
    if launches != want:
        raise AssertionError(f"{size}-px tower: launches {launches}, not "
                             f"{want}")
    if rel > TOWER_REL_L2:
        raise AssertionError(f"{size}-px tower vs its plain version: rel L2 "
                             f"{rel:.4f} > {TOWER_REL_L2}")
    del got, plain, packed, bf16
    torch.cuda.empty_cache()
    cells = bench.bench_prefill(cfg, device=dev, iters=5)
    log(f"  fused W8A8 tower at {size} px ({n_img} images, {n_layers} "
        f"blocks, {cfg.vit.seq_len} tokens): vs its plain version rel L2 "
        f"{rel:.4f} (bound {TOWER_REL_L2}); launches {launches}; bench "
        "prefill cells at B 64 (ViT + perceiver, images/s) " + ", ".join(
            f"{k} {v:.2f}" for k, v in cells.items()))
    torch.cuda.empty_cache()
    return {"rel_l2_vs_plain": rel, "launches": launches, **cells}


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
    from lhrs_bot_tpu_torch.ops.attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd,
        flash_attention_fwd_normalized, flash_attention_fwd_normalized_cluster,
        flash_attention_fwd_normalized_split,
        flash_attention_fwd_normalized_two_pass)
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
            "flash_attention_fwd_normalized": flash_attention_fwd_normalized,
            "flash_attention_fwd_normalized_split":
                flash_attention_fwd_normalized_split,
            "flash_attention_fwd_normalized_cluster":
                flash_attention_fwd_normalized_cluster,
            "flash_attention_fwd_normalized_two_pass":
                flash_attention_fwd_normalized_two_pass,
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
         ("flash_attention_fwd", "flash_attention_fwd_normalized",
          "fused_decode_attention_q", "ln_quant", "int8_gemm"), None),
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
        if name in ("bf16", "w4a8"):
            out[f"sessions_{name}"] = phase(
                "sessions", phase_sessions, engine, cfg, dev, name,
                images[0], long)
        del engine
        torch.cuda.empty_cache()
    return out


# One greedy request at 504 px (GeoChat's geometry: ViT-L/14 over 1,297
# tokens, the perceiver over 1,296 image tokens a group) through
# `GenerationEngine.generate` with the W4A8 + int8 lm_head + int8 KV recipe
# and the fused W8A8 tower, at full width with the decoder cut to
# REQUEST_504_LAYERS layers: its prefill logits against the same request
# with every kernel routed to its plain version, within REQUEST_504_REL_L2
# (the normalisation skipped in the tower's attention must exceed it), the
# tower's 22 cluster-path launches, and its time to the first token beside
# the same recipe's at 224 px. The logits read 0.0165 from the plain
# kernels on an H100 (in two runs); the bound leaves three times that, well
# inside the W4A8 recipe's CONSISTENCY_REL_L2_W4A8. It catches a gross
# fault of the request's path; the kernels' own hold is
# `check_normalized_k1` (plain K1 in the cluster path's place, a 2e-3
# fault at the attention, is read and reported here, not held).
REQUEST_504_LAYERS = 4
REQUEST_504_REL_L2 = 0.05


def phase_request_504(dev):
    import dataclasses
    import functools

    import torch

    import lhrs_bot_tpu_torch.models.vit as vit_mod
    import lhrs_bot_tpu_torch.ops.quant as quant
    import lhrs_bot_tpu_torch.ops.vit_block as vit_block_mod
    from lhrs_bot_tpu_torch.core import build_engine, eval_config
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.ops.attention import _flash_fwd_norm, norm_path
    from lhrs_bot_tpu_torch.ops.int8_gemm import int8_gemm_plain
    from lhrs_bot_tpu_torch.ops.vit_block import vit_layer_fused
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    def skipped_norm(q, k, v, kv_mask, sm_scale, out_dtype=torch.float32,
                     out=None):
        return _flash_fwd_norm(q, k, v, kv_mask, sm_scale, out_dtype, out,
                               path=norm_path(k.shape[2], q.shape[3],
                                              q.shape[2]),
                               fault=1)

    config = eval_config()
    knobs = {"bits": 4, "quant_type": "int4h", "kv_bits": 8,
             "lm_head_bits": 8, "vision_w8a8": True}
    wrappers = kernel_wrappers()
    rng = np.random.default_rng(24)
    out = {"layers": REQUEST_504_LAYERS, "bound": REQUEST_504_REL_L2}
    for size in (224, 504):
        base = VLMConfig.from_config_dict(config)
        cfg = vlm_at(size, base)
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(
            cfg.llama, num_hidden_layers=REQUEST_504_LAYERS))
        params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16,
                                 device=dev)
        engine = build_engine(cfg, params, {**config, **knobs}, dev)
        del params
        if engine._vision_packed is None:
            raise AssertionError(f"{size} px: the fused tower is off")
        ids = rng.integers(3, cfg.llama.vocab_size, (1, 40)).astype(np.int32)
        ids[0, 0], ids[0, 1] = cfg.llama.bos_token_id, -200
        lens = np.asarray([40], np.int32)
        image = rng.integers(0, 256, (1, size, size, 3)).astype(np.uint8)
        one, new = (GenerationConfig(max_new_tokens=n) for n in (1, 16))
        engine.generate(ids, lens, images=image, gen_cfg=one)  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(ids, lens, images=image, gen_cfg=one)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        for w in wrappers.values():
            w.launches = 0
        tokens = engine.generate(ids, lens, images=image, gen_cfg=new)[0]
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()
                    if w.launches}
        if not (0 < len(tokens) <= 16 and all(
                0 <= t < cfg.llama.vocab_size for t in tokens)):
            raise AssertionError(f"{size} px: bad greedy ids {tokens}")
        row = {"ttft_ms": sorted(times)[1], "ttft_ms_all": times,
               "tokens": tokens, "launches": launches}
        if size == 504:
            want = {k: 22 if k == norm_wrapper(1297, 64, 1297) else 0
                    for k in ("flash_attention_fwd_normalized",
                              "flash_attention_fwd_normalized_split",
                              "flash_attention_fwd_normalized_cluster",
                              "flash_attention_fwd_normalized_two_pass")}
            got = {k: launches.get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"504 px: normalize-first launches "
                                     f"{got}, not {want}")
            logits = engine._start(ids, lens, image, one)[0].float()
            with plain_kernels(), patched(
                    quant, int8_gemm=int8_gemm_plain), patched(
                    vit_mod, vit_layer_fused=functools.partial(
                        vit_layer_fused, plain=True)):
                plain = engine._start(ids, lens, image, one)[0].float()
            with patched(vit_block_mod,
                         flash_attention_fwd_normalized=skipped_norm):
                faulty = engine._start(ids, lens, image, one)[0].float()
            with patched(vit_block_mod,
                         flash_attention_fwd_normalized=unflagged_k1):
                swapped = engine._start(ids, lens, image, one)[0].float()
            torch.cuda.synchronize()
            rel = rel_l2(logits, plain)[0]
            fault = rel_l2(faulty, plain)[0]
            row.update({"vs_plain_rel_l2": rel, "fault_rel_l2": fault,
                        "unflagged_rel_l2": rel_l2(swapped, plain)[0],
                        "finite": bool(logits.isfinite().all())})
            if not (row["finite"] and rel <= REQUEST_504_REL_L2):
                raise AssertionError(f"504 px: prefill logits vs plain "
                                     f"kernels rel L2 {rel:.4f} > "
                                     f"{REQUEST_504_REL_L2}")
            if fault <= REQUEST_504_REL_L2:
                raise AssertionError("504 px: the skipped normalisation "
                                     f"passes ({fault:.4f})")
        out[f"{size}px"] = row
        log(f"  [w4a8 + fused tower, {REQUEST_504_LAYERS} decoder layers] "
            f"{size} px ({cfg.vit.seq_len} tokens): TTFT "
            f"{row['ttft_ms']:.1f} ms (of {[round(t, 1) for t in times]}); "
            f"greedy ids {tokens[:8]}...; launches {launches}"
            + (f"; prefill logits vs plain kernels rel L2 {rel:.4f} (bound "
               f"{REQUEST_504_REL_L2}), normalisation skipped {fault:.4f}, "
               f"plain K1 in its place {row['unflagged_rel_l2']:.4f} (read, "
               "not held)" if size == 504 else ""))
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
    parameters as `lhrs_serve_torch.py` builds them: with the bf16 engine
    the contiguous scheduler, the paged one (a pool of 4 x 2304 tokens in
    pages of 128), the paged one with prefill_chunk 512, and the hazard
    wave; with the int8 engine (bits 8, kv_bits 8) the paged one over an
    int8 pool. Then the HTTP frontend (`phase_frontend`) over the
    contiguous and paged bf16 schedulers, or the paged int8 one."""
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
    if name == "bf16":
        out["frontend_contiguous_bf16"] = phase_frontend(
            engine, cfg, dev, "contiguous bf16",
            lambda: ContinuousBatchingScheduler(
                cfg, engine.params, engine.llama_params, **common),
            ("flash_attention_fwd", "fused_decode_attention"))
        out["frontend_paged_bf16"] = phase_frontend(
            engine, cfg, dev, "paged bf16", paged,
            ("flash_attention_fwd", "paged_fused_decode"))
    else:
        out["frontend_paged_int8"] = phase_frontend(
            engine, cfg, dev, "paged int8", paged,
            ("flash_attention_fwd", "paged_fused_decode_q"))
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


# The sessions phase (phase 4): the continuation prefill and what is built
# on it (chunked prefill, multi-turn sessions, prompt-lookup speculation) at
# full width, through the engines of the slice phase. First-token and
# verify-window logits are held to the path each replaces within
# CONSISTENCY_REL_L2: the continuation attends through the plain attention
# over the cache row, the path it replaces through K1 (prefill) or K2
# (decode), so the two differ by bf16 rounding only (0.03-0.05 on an H100
# at 700 W). The W4A8 + int8-KV engine's session check is held to the same
# bound: both of its sides are prefills (W4A16 products), so the W4A8
# decode's noise that sets CONSISTENCY_REL_L2_W4A8 is not in it (0.043
# there). Each check has a planted fault that must exceed the bound: the
# continuation started one row early, so its first row overwrites the last
# cached one and every RoPE position moves back one (0.35-0.55). In float32
# on the first CONTINUE_DEPTH layers the continuation equals the cacheless
# forward within PAGED_PREFILL_REL_L2, with equal greedy ids.
SESSION_NEW = 16
SPEC_NEW = 64
SPEC_WIDTH = 4
CHUNK = 512
CONTINUE_DEPTH = 4


@contextlib.contextmanager
def continue_early(engine):
    """The planted fault: every continuation prefill of `engine` starts one
    row early (a start of 0 stays 0)."""
    honest = engine._continue_embeds

    def early(cache, embeds, suffix_len, start, return_all_logits=False):
        return honest(cache, embeds, suffix_len, (start - 1).clamp(min=0),
                      return_all_logits)

    engine._continue_embeds = early
    try:
        yield
    finally:
        del engine._continue_embeds


def hold(name, got, ref, faults, bound):
    """Each row of got (R, V) within `bound` relative L2 of ref's row and
    each planted fault's row beyond it; a row whose top-1 differs from
    ref's must have ref's top-2 margin within the row's max abs deviation.
    Logs and returns the readings."""
    got, ref = got.float(), ref.float()
    rel = rel_l2(got, ref)
    faults = {k: rel_l2(v.float(), ref) for k, v in faults.items()}
    max_dev = (got - ref).abs().amax(dim=-1).tolist()
    top2 = ref.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    agree = (got.argmax(-1) == ref.argmax(-1)).tolist()
    log(f"  {name} (bound {bound}): rel L2 {rel}; max abs dev {max_dev}; "
        f"top-2 margin {margin}; top-1 agree {agree}; planted faults {faults}")
    for r in range(len(rel)):
        if not rel[r] <= bound:
            raise AssertionError(f"{name} row {r}: rel L2 {rel[r]:.3e}")
        for fault, readings in faults.items():
            if not readings[r] > bound:
                raise AssertionError(f"{name} row {r}: the planted fault "
                                     f"{fault!r} passes ({readings[r]:.3e})")
        if margin[r] > max_dev[r] and not agree[r]:
            raise AssertionError(f"{name} row {r}: top-1 differs")
    return {"rel_l2": rel, "faults": faults, "bound": bound,
            "max_abs_dev": max_dev, "top1_agree": agree}


def set_launches(wrappers, value=0):
    for w in wrappers.values():
        w.launches = value


def read_launches(wrappers):
    return {k: w.launches for k, w in wrappers.items() if w.launches}


def decode_steps(emitted, budget):
    """Decode steps a plain stream ran for `emitted` tokens: one a token
    but the last when the budget ended it."""
    return len(emitted) - (len(emitted) == budget)


def phase_chunked(engine, cfg, dev, wrappers, request):
    """(a) prefill_chunk 512 against the monolithic prefill of the
    2,191-row image prompt: first-token logits within the bound, the
    chunks started one row early beyond it, each prefill's ms (median of
    3 after a warm-up), and K1 launched by the vision tower only."""
    import torch

    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    _, (ids, lens), imgs = request
    gen = GenerationConfig(max_new_tokens=1)
    out = {}

    def first(chunk, reps=3):
        engine.prefill_chunk = chunk
        engine._start(ids, lens, imgs, gen)  # warm-up
        times = []
        for _ in range(reps):
            set_launches(wrappers)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = engine._start(ids, lens, imgs, gen)[0]
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return logits, statistics.median(times), read_launches(wrappers)

    try:
        mono, out["monolithic_ms"], mono_l = first(None)
        chunked, out["chunked_ms"], chunk_l = first(CHUNK)
        with continue_early(engine):
            faulty = first(CHUNK, reps=1)[0]
    finally:
        engine.prefill_chunk = None
    nl = cfg.llama.num_hidden_layers
    log(f"  [chunked prefill {CHUNK}] spliced {int(lens[0]) + 143} rows: "
        f"monolithic {out['monolithic_ms']:.1f} ms, chunked "
        f"{out['chunked_ms']:.1f} ms; launches {mono_l} / {chunk_l}")
    if chunk_l.get("flash_attention_fwd", 0) != \
            mono_l["flash_attention_fwd"] - nl:
        raise AssertionError("chunked prefill: K1 must run in the vision "
                             "tower only")
    out["logits"] = hold(f"chunked prefill {CHUNK} vs monolithic", chunked,
                         mono, {"start one row early": faulty},
                         CONSISTENCY_REL_L2)
    out["launches"] = {"monolithic": mono_l, "chunked": chunk_l}
    return out


def clone_cache(cache):
    import dataclasses

    return dataclasses.replace(cache, **{
        f: getattr(cache, f).clone() for f in
        ("k", "v", "length", "k_scale", "v_scale")
        if getattr(cache, f) is not None})


def phase_session_chat(engine, cfg, dev, wrappers, name, image, bound,
                       decode_kernel):
    """(b) a three-turn chat with an image, session=True against fresh
    runs of the same prompts: each turn's time to first token and launch
    counts (K1 on the session's first turn only, the decode kernel 32
    times a decode step on every turn), the session cache allocated once
    at max_seq_len, and the continuation's first-token logits held to the
    fresh prefill's (turn 2 with the planted fault)."""
    import torch

    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    rng = np.random.default_rng(8)
    vocab = cfg.llama.vocab_size
    gen = GenerationConfig(max_new_tokens=SESSION_NEW,
                           eos_token_id=cfg.llama.eos_token_id)
    nl = cfg.llama.num_hidden_layers
    img = image[None]
    captured = {"keep": False}
    cont, pre = engine._prefill_continue, engine._prefill

    def spy_cont(cache, ids, n, start):
        if captured["keep"]:  # the cache and arguments, for the fault
            captured["replay"] = (clone_cache(cache), ids.clone(),
                                  n.clone(), start.clone())
        logits, cache = cont(cache, ids, n, start)
        captured["logits"] = logits.float()
        return logits, cache

    def spy_pre(*a, **k):
        logits, cache = pre(*a, **k)
        captured["logits"] = logits.float()
        return logits, cache

    engine._prefill_continue, engine._prefill = spy_cont, spy_pre

    def turn(prompt, session):
        set_launches(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = engine.stream(prompt[None], len(prompt), images=img,
                           gen_cfg=gen, session=session)
        toks = [next(it)]
        ttft = (time.perf_counter() - t0) * 1e3
        toks += list(it)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_launches(wrappers)
        steps = decode_steps(toks, SESSION_NEW)
        if launches.get(decode_kernel, 0) != nl * steps:
            raise AssertionError(f"[{name} session] {decode_kernel} "
                                 f"launched {launches.get(decode_kernel)} "
                                 f"times in {steps} decode steps")
        if any(not 0 <= t < vocab for t in toks):
            raise AssertionError(f"[{name} session] token out of the "
                                 "vocabulary")
        return {"tokens": toks, "ttft_ms": ttft, "wall_ms": wall,
                "launches": launches, "logits": captured.pop("logits")}

    try:
        ids = rng.integers(3, vocab, 300).astype(np.int32)
        ids[0], ids[1] = cfg.llama.bos_token_id, -200
        prompts = [ids]
        # the chat twice, the first time to warm every shape up (its
        # answers make the later prompts); the second is measured
        for rep in range(2):
            engine.reset_session()
            session = []
            for k in range(3):
                captured["keep"] = rep == 1 and k == 1
                session.append(turn(prompts[k], True))
                st = engine._session
                if st["cache"].k.shape[3] != engine.max_seq_len:
                    raise AssertionError(f"[{name} session] cache of "
                                         f"{st['cache'].k.shape[3]} rows")
                if k == 0:
                    ptr = st["cache"].k.data_ptr()
                elif st["cache"].k.data_ptr() != ptr:
                    raise AssertionError(f"[{name} session] the cache was "
                                         f"reallocated on turn {k + 1}")
                if rep == 0:
                    prompts.append(np.concatenate([
                        prompts[k], np.asarray(session[k]["tokens"],
                                               np.int32),
                        rng.integers(3, vocab, 40).astype(np.int32)]))
        fresh = [turn(prompts[k], False) and turn(prompts[k], False)
                 for k in range(3)]
        replay, ids_2, n_2, start_2 = captured.pop("replay")
        captured["keep"] = False
        faults = {"start one row early": engine._prefill_continue(
            replay, ids_2, n_2, start_2 - 1)[0].float()}
        del replay
    finally:
        del engine._prefill_continue, engine._prefill
    k1 = [t["launches"].get("flash_attention_fwd", 0) for t in session]
    if not (k1[0] > 0 and k1[1] == k1[2] == 0):
        raise AssertionError(f"[{name} session] K1 launches by turn {k1}: "
                             "want the first turn only")
    checks = [hold(f"[{name} session] turn {k + 1} first-token logits vs a "
                   "fresh prefill", session[k]["logits"], fresh[k]["logits"],
                   faults if k == 1 else {}, bound)
              for k in (1, 2)]
    out = {"turns": [{
        "session_ttft_ms": s["ttft_ms"], "fresh_ttft_ms": f["ttft_ms"],
        "session_wall_ms": s["wall_ms"], "fresh_wall_ms": f["wall_ms"],
        "prompt_tokens": len(p), "session_launches": s["launches"],
        "fresh_launches": f["launches"],
        "ids_equal": s["tokens"] == f["tokens"]}
        for s, f, p in zip(session, fresh, prompts)],
        "logits": checks, "cache_rows": engine.max_seq_len,
        "resized_after_turn_1": False}
    for k, t in enumerate(out["turns"]):
        log(f"  [{name} session] turn {k + 1} ({t['prompt_tokens']} prompt "
            f"tokens): time to first token {t['session_ttft_ms']:.1f} ms "
            f"(fresh {t['fresh_ttft_ms']:.1f} ms), whole turn "
            f"{t['session_wall_ms']:.1f} ms (fresh {t['fresh_wall_ms']:.1f}"
            f"); ids equal to fresh: {t['ids_equal']}; launches "
            f"{t['session_launches']}")
    return out


def first_difference(a, b):
    """The first index where two id lists differ (or one ends), or None."""
    part = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if part is None and len(a) != len(b):
        part = min(len(a), len(b))
    return part


def phase_speculation(engine, cfg, dev, wrappers):
    """(c) stream(speculative=4) on a repetitive prompt against plain
    greedy, with the history's prompt lookup ("natural"), with a draft
    that is always rejected ("window path": every step is a verify window,
    so the ids are greedy through the continuation's attention) and with
    an oracle draft that proposes the window path's next tokens (seeded
    random weights, whose answers repeat no n-gram, never give prompt
    lookup a match; plain greedy's own tokens part from the window path at
    the first bf16 top-1 flip, so only the window path's are an oracle):
    windows, acceptance per window, tokens/s and K2 launches per emitted
    token of each. A teacher-forced window (plain greedy's next tokens) is
    held to the decode steps' logits at each position, with the window
    started one row early beyond the bound; where a speculative run's ids
    part from plain greedy's, plain greedy's top-2 margin there must lie
    within the deviation measured in that check."""
    import dataclasses

    import torch

    import lhrs_bot_tpu_torch.serve.speculative as spec_mod
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    rng = np.random.default_rng(9)
    phrase = rng.integers(3, cfg.llama.vocab_size, 12).astype(np.int32)
    ids = np.concatenate([[cfg.llama.bos_token_id]] + [phrase] * 16).astype(
        np.int32)
    gen = GenerationConfig(max_new_tokens=SPEC_NEW,
                           eos_token_id=cfg.llama.eos_token_id)
    nl = cfg.llama.num_hidden_layers
    margins, windows = [], []
    decode, pre, speculate = (engine._decode_step, engine._prefill,
                              engine._speculate)

    def keep_margin(logits):
        top2 = logits[0].float().topk(2).values
        margins.append(float(top2[0] - top2[1]))

    def spy_decode(cache, tok):
        logits, cache = decode(cache, tok)
        keep_margin(logits)
        return logits, cache

    def spy_pre(*a, **k):
        logits, cache = pre(*a, **k)
        keep_margin(logits)
        return logits, cache

    def spy_spec(cache, window, valid, start):
        logits, cache = speculate(cache, window, valid, start)
        w = int(valid[0])
        preds = logits[0, :w].argmax(-1).tolist()
        prop = window[0, 1:w].tolist()
        p = 0
        while p < len(prop) and prop[p] == preds[p]:
            p += 1
        windows.append((w - 1, p))
        return logits, cache

    def run(spec, n=SPEC_NEW):
        g = GenerationConfig(max_new_tokens=n,
                             eos_token_id=cfg.llama.eos_token_id)
        del windows[:]
        set_launches(wrappers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        it = engine.stream(ids[None], len(ids), gen_cfg=g, speculative=spec)
        toks = [next(it)]
        t1 = time.perf_counter()
        toks += list(it)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k2 = read_launches(wrappers).get("fused_decode_attention", 0)
        return {"tokens": toks, "ttft_ms": (t1 - t0) * 1e3,
                "wall_ms": (t2 - t0) * 1e3,
                "tok_s_after_first": (len(toks) - 1) / (t2 - t1),
                "k2_launches_per_token": k2 / len(toks),
                "windows": len(windows),
                "proposed": sum(w for w, _ in windows),
                "accepted": sum(p for _, p in windows),
                "acceptance_per_window": [p for _, p in windows]}

    run(0, 8)
    run(SPEC_WIDTH, 8)  # warm-ups
    engine._decode_step, engine._prefill = spy_decode, spy_pre
    try:
        plain = run(0)
    finally:
        del engine._decode_step, engine._prefill
    if plain["k2_launches_per_token"] * len(plain["tokens"]) != \
            nl * decode_steps(plain["tokens"], SPEC_NEW):
        raise AssertionError("speculation: the plain run's K2 launches")
    honest = spec_mod.propose_from_history

    def draft(source):  # the next tokens of `source` after the prompt
        def propose(hist, hist_len, *, ngram, width, min_token=3):
            nxt = source[int(hist_len[0]) - len(ids):][:width]
            prop = np.zeros((1, width), np.int32)
            prop[0, :len(nxt)] = nxt
            return torch.as_tensor(prop), torch.tensor([len(nxt)],
                                                       dtype=torch.int32)
        return propose

    engine._speculate = spy_spec
    try:
        natural = run(SPEC_WIDTH)
        spec_mod.propose_from_history = draft([0] * SPEC_NEW)
        window_path = run(SPEC_WIDTH)
        spec_mod.propose_from_history = draft(window_path["tokens"])
        oracle = run(SPEC_WIDTH)
    finally:
        del engine._speculate
        spec_mod.propose_from_history = honest
    oracle["first_difference_from_window_path"] = first_difference(
        window_path["tokens"], oracle["tokens"])

    # teacher-forced: the window [g0 .. g4] of plain greedy's tokens
    logits0, cache, _ = engine._start(ids[None], np.asarray([len(ids)]),
                                      None, gen)
    start = int(cache.length[0])
    window, steps = [logits0.argmax(-1).to(torch.int32)], []
    twins = [clone_cache(cache) for _ in range(2)]
    for _ in range(SPEC_WIDTH + 1):
        logits, cache = engine._decode_step(cache, window[-1])
        steps.append(logits[0])
        window.append(logits.argmax(-1).to(torch.int32))
    win = torch.stack(window[:SPEC_WIDTH + 1], dim=1)
    valid = torch.tensor([SPEC_WIDTH + 1], dtype=torch.int32, device=dev)
    verify = engine._speculate(twins[0], win, valid, torch.tensor(
        [start], dtype=torch.int32, device=dev))[0][0]
    early = engine._speculate(twins[1], win, valid, torch.tensor(
        [start - 1], dtype=torch.int32, device=dev))[0][0]
    check = hold("[speculation] teacher-forced window vs decode steps",
                 verify, torch.stack(steps), {"start one row early": early},
                 CONSISTENCY_REL_L2)
    noise = max(check["max_abs_dev"])

    def call_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    # one call's host-clock cost at the same row: a decode step against a
    # verify window of SPEC_WIDTH + 1 rows (what a window must save)
    at = torch.tensor([start], dtype=torch.int32, device=dev)
    check["decode_step_ms"] = call_ms(lambda: engine._decode_step(
        dataclasses.replace(twins[0], length=at), window[0]))
    check["window_ms"] = call_ms(lambda: engine._speculate(
        twins[1], win, valid, at))
    del twins, cache
    out = {"teacher_forced": check, "plain": plain, "natural": natural,
           "window_path": window_path, "oracle": oracle}
    for key, res in (("natural", natural), ("window_path", window_path),
                     ("oracle", oracle)):
        part = first_difference(plain["tokens"], res["tokens"])
        res["first_difference"] = part
        if part is not None and (part >= len(margins)
                                 or margins[part] > noise):
            raise AssertionError(
                f"speculation ({key}): ids part from plain greedy's at "
                f"{part}, where its top-2 margin exceeds the bf16 "
                f"deviation {noise:.3e}")
        res["margin_at_difference"] = (None if part is None
                                       else margins[part])
    for res in out.values():
        res.pop("tokens", None)
    log(f"  [speculation] a decode step {check['decode_step_ms']:.2f} ms, "
        f"a verify window of {SPEC_WIDTH + 1} rows {check['window_ms']:.2f} "
        "ms (host clock, synchronized, median of 5)")
    for key in ("plain", "natural", "window_path", "oracle"):
        res = out[key]
        log(f"  [speculation {SPEC_WIDTH}, {key}] {len(ids)}-token "
            f"repetitive prompt, {SPEC_NEW} new: {res['tok_s_after_first']:.1f}"
            f" tok/s after the first ({res['wall_ms']:.1f} ms); K2 launches "
            f"a token {res['k2_launches_per_token']:.2f}; {res['windows']} "
            f"windows, {res['accepted']} of {res['proposed']} proposals "
            f"accepted {res['acceptance_per_window']}; ids part from plain "
            f"at {res.get('first_difference')} (margin "
            f"{res.get('margin_at_difference')}, deviation {noise:.3e})"
            + (f"; from the window path at "
               f"{res['first_difference_from_window_path']}"
               if key == "oracle" else ""))
    return out


def spec_wave(cfg, rng):
    """Eight repetitive requests (a phrase repeated; two with an image),
    40 to 1,200 prompt tokens, SPEC_NEW new tokens each."""
    vocab = cfg.llama.vocab_size
    size = cfg.vit.image_size
    out = []
    for i, n in enumerate((1200, 40, 600, 300, 900, 120, 200, 500)):
        phrase = rng.integers(3, vocab, int(rng.integers(6, 20)))
        ids = np.resize(phrase, n).astype(np.int32)
        ids[0] = cfg.llama.bos_token_id
        img = None
        if i in (2, 5):
            ids[1] = -200
            img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        out.append((ids, img))
    return out


def oracle_proposals(sched, source_outputs):
    """A stand-in for `propose_from_history` in the scheduler's
    speculative rounds: each active slot proposes the next tokens of its
    request in `source_outputs` (the request's outputs so far are the
    history's length past its prompt)."""
    import torch

    def propose(hist, hist_len, *, ngram, width, min_token=3):
        lens = hist_len.tolist()
        prop = np.zeros((len(lens), width), np.int32)
        n = np.zeros(len(lens), np.int32)
        for slot, req in enumerate(sched.slot_req):
            if req is not None:
                nxt = source_outputs[req.uid][lens[slot] - len(req.input_ids):]
                nxt = nxt[:width]
                prop[slot, :len(nxt)] = nxt
                n[slot] = len(nxt)
        return (torch.as_tensor(prop, device=hist.device),
                torch.as_tensor(n, device=hist.device))

    return propose


def phase_spec_scheduler(engine, cfg, dev, wrappers):
    """(d) the contiguous bf16 scheduler over an 8-request repetitive wave:
    plain ticks, speculative 4 with the history's prompt lookup, and
    speculative 4 with an oracle draft (the natural wave's next tokens: a
    speculative round verifies through the continuation's attention even
    where nothing is accepted, so the natural wave's ids are the window
    path's greedy, which plain ticks' K2 parts from at bf16 top-1 flips):
    tokens/s, time to first token, proposals made and accepted (counted on
    the card through the tick), launches (a speculative wave decodes
    through continuation prefills: K2 never), every request whole; the
    ids' agreement with the plain wave, and the oracle's with the natural
    wave, are readings."""
    import torch

    import lhrs_bot_tpu_torch.serve.scheduler as sched_mod
    from lhrs_bot_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler, Request)

    wave = spec_wave(cfg, np.random.default_rng(10))
    nl = cfg.llama.num_hidden_layers
    out = {}
    for key, width in (("plain", 0), ("natural", SPEC_WIDTH),
                       ("oracle", SPEC_WIDTH)):
        sched = ContinuousBatchingScheduler(
            cfg, engine.params, engine.llama_params, max_batch=8,
            max_seq_len=engine.max_seq_len, cache_dtype=engine.cache_dtype,
            tokens_per_tick=16, eos_token_id=cfg.llama.eos_token_id,
            device=dev, speculative=width)
        sched.run([Request(uid=99, input_ids=wave[1][0], max_new_tokens=4)])
        reqs = [Request(uid=i, input_ids=ids, image=img,
                        max_new_tokens=SPEC_NEW)
                for i, (ids, img) in enumerate(wave)]
        honest = sched_mod.propose_from_history, sched_mod.accept_window
        totals = torch.zeros(2, dtype=torch.long, device=dev)

        def counted(prop, n_prop, preds):  # proposals and acceptances
            p, corr = honest[1](prop, n_prop, preds)
            totals.add_(torch.stack([n_prop.sum(), p.sum()]))
            return p, corr

        sched_mod.accept_window = counted
        if key == "oracle":
            sched_mod.propose_from_history = oracle_proposals(
                sched, out["natural"]["outputs"])
        try:
            set_launches(wrappers)
            res = drive(sched, reqs)
        finally:
            sched_mod.propose_from_history, sched_mod.accept_window = honest
        res["launches"] = read_launches(wrappers)
        res["outputs"] = [r.output_ids for r in reqs]
        res["proposed"], res["accepted"] = totals.tolist()
        for r in reqs:
            if not r.done or not 1 <= len(r.output_ids) <= SPEC_NEW or any(
                    not 0 <= t < cfg.llama.vocab_size for t in r.output_ids):
                raise AssertionError(f"[scheduler {key}] request {r.uid}")
        k2 = res["launches"].get("fused_decode_attention", 0)
        if width and (k2 or not res["launches"].get("flash_attention_fwd")):
            raise AssertionError(f"[scheduler {key}] launches "
                                 f"{res['launches']}")
        if not width and k2 != nl * res["decode_steps"]:
            raise AssertionError(f"[scheduler {key}] K2 launched {k2} times "
                                 f"in {res['decode_steps']} steps")
        if key != "plain":
            res["agreement"] = agreement(res["outputs"],
                                         out["plain"]["outputs"])
        if key == "oracle":
            res["agreement_with_natural"] = agreement(
                res["outputs"], out["natural"]["outputs"])
        out[key] = res
        log(f"  [scheduler {key}] 8 requests, {res['tokens']} tokens in "
            f"{res['wall_s']:.2f} s: {res['tok_s']:.1f} tokens/s; "
            f"{res['decode_steps']} {'rounds' if width else 'steps'}, "
            f"{res['accepted']} of {res['proposed']} proposals accepted; "
            "time to first "
            f"token (ms) {[round(t, 1) for t in res['ttft_ms']]}; launches "
            f"{res['launches']}; ids vs plain (a reading) "
            f"{res.get('agreement')}"
            + (f", vs natural {res['agreement_with_natural']}"
               if key == "oracle" else ""))
        del sched
        torch.cuda.empty_cache()
    return out


def phase_cli(engine, cfg, dev, image):
    """(e) cli_qa_torch's chat loop over the bf16 engine: three scripted
    turns with an image and speculation 4, the byte-level tokenizer; turns
    2 and 3 continue the session."""
    import io

    import cli_qa_torch
    from lhrs_bot_tpu_torch.data.tokenizer import ByteTokenizer
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    lines = ["What is in this image?", "Where is the river?",
             "How many buildings are there?", "exit"]
    calls, streamed = [], []
    cont, stream = engine._prefill_continue, engine.stream

    def counted(*a, **k):
        streamed.append(0)
        for tok in stream(*a, **k):
            streamed[-1] += 1
            yield tok

    engine._prefill_continue = lambda *a: calls.append(1) or cont(*a)
    engine.stream = counted
    out = io.StringIO()
    engine.reset_session()
    t0 = time.perf_counter()
    try:
        answers = cli_qa_torch.chat(
            engine, ByteTokenizer(), lines, out,
            gen_cfg=GenerationConfig(max_new_tokens=SESSION_NEW,
                                     eos_token_id=cfg.llama.eos_token_id),
            image=image[None], image_size=cfg.vit.image_size,
            speculative=SPEC_WIDTH)
    finally:
        del engine._prefill_continue, engine.stream
    wall = time.perf_counter() - t0
    engine.reset_session()
    if len(answers) != 3 or out.getvalue().count("ASSISTANT: ") != 3 \
            or len(calls) != 2 or min(streamed) < 1:
        raise AssertionError(f"cli_qa_torch: {len(answers)} answers, "
                             f"{len(calls)} continuations, {streamed} tokens")
    # the byte-level tokenizer decodes ids 4-259 only: random weights'
    # answers are mostly ids it has no text for
    log(f"  [cli_qa_torch] three turns in {wall:.2f} s, {streamed} tokens "
        f"streamed, {len(calls)} session continuations; answers "
        f"{[a[:24] for a in answers]}")
    return {"wall_s": wall, "continuations": len(calls),
            "tokens": streamed, "answer_chars": [len(a) for a in answers]}


def check_continue_f32(lp, lcfg, dev):
    """The continuation in float32 on the first CONTINUE_DEPTH layers at
    full width, against the cacheless forward (`llama_apply`, plain
    attention) of a 600-token row: the row prefilled through continuations
    of 256-row chunks, and 400 rows prefilled then 200 continued, every
    position's logits within PAGED_PREFILL_REL_L2 with equal greedy ids;
    a greedy verify window after the row equal to the decode steps' and
    every proposal accepted; the continuation started one row early
    beyond the bound."""
    import dataclasses

    import torch

    from lhrs_bot_tpu_torch.models import (KVCache, llama_apply,
                                           llama_decode_step, llama_prefill,
                                           llama_prefill_continue)

    f32 = torch.float32
    depth = min(CONTINUE_DEPTH, lcfg.num_hidden_layers)
    cfg = dataclasses.replace(lcfg, num_hidden_layers=depth)
    params = {"layers": {k: v[:depth].float()
                         for k, v in lp["layers"].items()},
              **{k: lp[k].float() for k in ("embed_tokens", "final_norm",
                                            "lm_head")}}
    n, s_max = 600, 1024
    ids = torch.as_tensor(np.random.default_rng(11).integers(
        3, lcfg.vocab_size, (1, n)), device=dev)
    ids[0, 0] = lcfg.bos_token_id
    emb = params["embed_tokens"][ids]

    def one(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    with plain_attention():
        ref = llama_apply(params, cfg, inputs_embeds=emb,
                          compute_dtype=f32)[0]

    def cont(cache, lo, hi, start=None):
        return llama_prefill_continue(
            params, cfg, cache, inputs_embeds=emb[:, lo:hi],
            suffix_len=one(hi - lo), start=one(lo if start is None else
                                                 start),
            compute_dtype=f32, return_all_logits=True)

    cache = KVCache.create(cfg, 1, s_max, f32, dev)
    parts = []
    for lo in range(0, n, 256):
        logits, cache = cont(cache, lo, min(lo + 256, n))
        parts.append(logits[0])
    chunked = torch.cat(parts)
    with plain_attention():
        _, cache2 = llama_prefill(params, cfg, KVCache.create(
            cfg, 1, s_max, f32, dev), inputs_embeds=emb[:, :400],
            prompt_len=one(400), compute_dtype=f32)
    early = cont(clone_cache(cache2), 400, n, 399)[0][0]
    tail = cont(cache2, 400, n)[0][0]
    out = {"bound": PAGED_PREFILL_REL_L2, "depth": depth}
    for key, got in (("chunks_of_256", chunked), ("400_then_200", tail)):
        want = ref[-len(got):]
        rel = rel_l2(got, want)
        dev_ = (got - want).abs().amax(-1)
        top2 = want.topk(2, -1).values
        clear = (top2[:, 0] - top2[:, 1]) > dev_
        same = got.argmax(-1) == want.argmax(-1)
        out[key] = {"max_rel_l2": max(rel), "ids_equal": int(same.sum()),
                    "of": len(rel)}
        if max(rel) > PAGED_PREFILL_REL_L2 or not bool(same[clear].all()):
            raise AssertionError(f"continuation f32 ({key}): {out[key]}")
    out["start one row early"] = min(rel_l2(early, ref[400:]))
    if out["start one row early"] <= PAGED_PREFILL_REL_L2:
        raise AssertionError("continuation f32: the planted fault passes")
    # a verify window of greedy's next tokens after the whole row
    tok = ref[-1].argmax().view(1)
    window, steps = [tok], []
    twin = clone_cache(cache)
    with plain_attention():
        for _ in range(SPEC_WIDTH + 1):
            logits, cache = llama_decode_step(
                params, cfg, cache, inputs_embeds=params["embed_tokens"][
                    window[-1]][:, None], compute_dtype=f32)
            steps.append(logits[0])
            window.append(logits.argmax(-1))
    win = torch.stack(window[:SPEC_WIDTH + 1], dim=1)
    verify = llama_prefill_continue(
        params, cfg, twin, inputs_embeds=params["embed_tokens"][win],
        suffix_len=one(SPEC_WIDTH + 1), start=one(n), compute_dtype=f32,
        return_all_logits=True)[0][0]
    rel = rel_l2(verify, torch.stack(steps))
    accepted = int((verify.argmax(-1)[:SPEC_WIDTH] == win[0, 1:]).cumprod(
        0).sum())
    out["verify_window"] = {"max_rel_l2": max(rel), "accepted": accepted,
                            "of": SPEC_WIDTH}
    if max(rel) > PAGED_PREFILL_REL_L2 or accepted != SPEC_WIDTH:
        raise AssertionError(f"continuation f32 verify window: "
                             f"{out['verify_window']}")
    log(f"  continuation vs the cacheless forward, float32, first {depth} "
        f"layers, a 600-token row: {out}")
    return out


def phase_sessions(engine, cfg, dev, name, image, request=None):
    """The sessions phase over one engine of the slice phase: with the
    bf16 engine (a) to (e) and the float32 check, with the int8-cache
    engine (b)."""
    wrappers = kernel_wrappers()
    if name != "bf16":
        out = {"chat": phase_session_chat(
            engine, cfg, dev, wrappers, name, image, CONSISTENCY_REL_L2,
            "fused_decode_attention_q")}
        engine.reset_session()
        return out
    out = {"continue_f32": check_continue_f32(engine.llama_params,
                                              cfg.llama, dev),
           "chunked": phase_chunked(engine, cfg, dev, wrappers, request),
           "chat": phase_session_chat(engine, cfg, dev, wrappers, name,
                                      image, CONSISTENCY_REL_L2,
                                      "fused_decode_attention")}
    engine.reset_session()
    out["speculation"] = phase_speculation(engine, cfg, dev, wrappers)
    out["scheduler"] = phase_spec_scheduler(engine, cfg, dev, wrappers)
    out["cli"] = phase_cli(engine, cfg, dev, image)
    return out


# The frontend phase: sequential HTTP requests of FRONTEND_NEW greedy tokens,
# then 8 concurrent ones, a stream the client leaves after 2 tokens (of a
# budget of FRONTEND_LONG) and a corrupt image. The 2-image request's
# first-token logits through the scheduler are held to the engine's within
# CONSISTENCY_REL_L2 (the bf16 engine's schedulers), and the engine with
# the two images swapped must exceed it. The times are FRONTEND_REPS
# repetitions of the sequential requests, HTTP and direct in turn, after
# both schedulers served them once.
FRONTEND_NEW = 16
FRONTEND_LONG = 1024
FRONTEND_REPS = 2


def png_bytes(arr, filters=(0, 1, 2, 3, 4)):
    """A PNG of an (H, W, 3) uint8 array, written here with zlib: row y
    filtered with filters[y % len(filters)] (by default all five PNG
    filters, as an encoder such as PIL's mixes them)."""
    import struct
    import zlib

    h, w, _ = arr.shape

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    # the predictors read the unfiltered bytes: left (3 back), above,
    # above-left
    x = arr.reshape(h, -1).astype(np.int16)
    left, up, up_left = (np.zeros_like(x) for _ in range(3))
    left[:, 3:], up[1:], up_left[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    pa, pb = np.abs(up - up_left), np.abs(left - up_left)
    pc = np.abs(left + up - 2 * up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, up_left))
    kind = np.asarray(filters)[np.arange(h) % len(filters)]
    rows = np.empty((h, 1 + x.shape[1]), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = (x - np.choose(kind[:, None], (
        0, left, up, (left + up) >> 1, paeth))) & 0xFF
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def http_post(url, route, payload, timeout=600):
    """(status, JSON body, seconds) of a POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + route, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), \
                time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def http_stream(url, payload, timeout=600):
    """(token ids, the final record, seconds to the first token, seconds
    in all) of a /generate_stream request."""
    import urllib.request

    req = urllib.request.Request(url + "/generate_stream",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    toks, first, final = [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            rec = json.loads(raw)
            if "token" in rec:
                first = first or time.perf_counter() - t0
                toks.append(rec["token"])
            else:
                final = rec
    return toks, final, first, time.perf_counter() - t0


def http_health(url):
    import urllib.request

    with urllib.request.urlopen(url + "/health", timeout=60) as resp:
        return json.loads(resp.read())


def stream_and_leave(port, payload, n_tokens=2):
    """Start a /generate_stream on a raw socket, read until `n_tokens`
    tokens arrived, and close the connection."""
    import socket

    body = json.dumps(payload).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=300)
    s.sendall(b"POST /generate_stream HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    got = b""
    while got.count(b'"token"') < n_tokens:
        chunk = s.recv(4096)
        if not chunk:
            raise AssertionError("the stream ended before "
                                 f"{n_tokens} tokens: {got[-300:]!r}")
        got += chunk
    s.close()


def frontend_bodies(b64):
    """The sequential requests: (name, route, JSON body). The stream
    repeats the one-image request's body."""
    gen = {"max_new_tokens": FRONTEND_NEW, "temperature": 0.0}
    image = {"prompt": "What is in this remote sensing image?",
             "image_b64": b64[0], **gen}
    return [
        ("text", "/generate", {"prompt": "Describe a typical airport seen "
                               "from above and count its runways.", **gen}),
        ("image", "/generate", image),
        ("two_images", "/generate", {
            "prompt": "Compare <image> with <image>.",
            "images_b64": [b64[1], b64[2]], **gen}),
        ("chat", "/v1/chat/completions", {
            "max_tokens": FRONTEND_NEW, "temperature": 0.0, "messages": [
                {"role": "system",
                 "content": "You are a remote sensing assistant."},
                {"role": "user", "content": "Hello."},
                {"role": "assistant",
                 "content": "Hello! Send me an image to look at."},
                {"role": "user", "content": [
                    {"type": "text", "text": "How many buildings are there?"},
                    {"type": "image_url", "image_url": {
                        "url": "data:image/png;base64," + b64[1]}}]}]}),
        ("stream", "/generate_stream", image),
    ]


def frontend_request(frontend, body):
    """The Request the handler builds for `body`."""
    from lhrs_bot_tpu_torch.data.image_io import decode_b64

    if "messages" in body:
        return frontend.build_chat_request(body["messages"],
                                           body["max_tokens"],
                                           temperature=body["temperature"])
    image = ([decode_b64(b) for b in body["images_b64"]]
             if "images_b64" in body else
             decode_b64(body["image_b64"]) if "image_b64" in body else None)
    return frontend.build_request(body["prompt"], image,
                                  body["max_new_tokens"],
                                  temperature=body["temperature"])


def http_pass(url, b64, kind):
    """The sequential requests over HTTP, one at a time: {name: tokens,
    ms (and the stream's ttft_ms, the chat's text and completion_tokens),
    tok_s}."""
    seq = {}
    for name, route, body in frontend_bodies(b64):
        if route == "/generate_stream":
            toks, final, ttft, wall = http_stream(url, body)
            status, reason = 200, final["finish_reason"]
            seq[name] = {"tokens": toks, "ttft_ms": ttft * 1e3,
                         "ms": wall * 1e3}
        else:
            status, data, wall = http_post(url, route, body)
            seq[name] = {"ms": wall * 1e3}
            if route == "/generate":
                toks, reason = data.get("tokens"), data.get("finish_reason")
            else:  # the chat reply carries its text and token count
                toks = None
                reason = data["choices"][0]["finish_reason"] \
                    if status == 200 else data
                if status == 200:
                    seq[name]["text"] = data["choices"][0]["message"][
                        "content"]
                    seq[name]["completion_tokens"] = \
                        data["usage"]["completion_tokens"]
            seq[name]["tokens"] = toks
        if status != 200 or reason not in ("stop", "length"):
            raise AssertionError(f"frontend {kind} {name}: HTTP {status}, "
                                 f"{reason}: {seq[name]}")
        seq[name]["tok_s"] = (len(toks) / (seq[name]["ms"] / 1e3)
                              if toks else None)
    return seq


def check_http_ids(kind, http, direct, what):
    """Each sequential request's ids over HTTP equal the direct run's (the
    chat by its reply's text and token count)."""
    from lhrs_bot_tpu_torch.data.tokenizer import ByteTokenizer

    for name, d in direct.items():
        want = d["tokens"]
        if name == "chat":
            got = (http[name]["text"], http[name]["completion_tokens"])
            want = (ByteTokenizer().decode(want, skip_special_tokens=True),
                    len(want))
        else:
            got = http[name]["tokens"]
        if got != want:
            raise AssertionError(f"frontend {kind} {name} ({what}): over "
                                 f"HTTP {got} != the direct run's {want}")


def serve_http(kind, make_sched, cfg, b64, needed, direct):
    """Serve the frontend phase's traffic over HTTP from a ServingFrontend
    over `make_sched()`. After the warmup, `direct(requests)` runs the
    Requests the handler builds for the sequential bodies on a scheduler
    built alike, then they go over HTTP once (ids checked against the
    direct run's, launches counted), then FRONTEND_REPS times more, each
    time followed by `direct(requests)` (the timed readings, ids checked
    pairwise), then the concurrent, abandoned and corrupt requests.
    Returns the numbers, the Requests and the first direct run's
    results."""
    import threading
    from http.server import ThreadingHTTPServer

    import torch

    from lhrs_bot_tpu_torch.data.tokenizer import ByteTokenizer
    from lhrs_bot_tpu_torch.serve.api import ServingFrontend, make_handler

    vocab = cfg.llama.vocab_size
    sched = make_sched()
    frontend = ServingFrontend(sched, ByteTokenizer(),
                               image_size=cfg.vit.image_size)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(frontend))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    cancels = []
    cancel = frontend.cancel
    frontend.cancel = lambda uid: cancels.append(cancel(uid)) or cancels[-1]
    out = {}
    try:
        out["warmup_s"] = frontend.warmup()
        log(f"  [frontend {kind}] warmup {out['warmup_s']:.1f} s")
        requests = [frontend_request(frontend, body)
                    for _, _, body in frontend_bodies(b64)]
        first = direct(requests, capture=True)
        wrappers = kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        seq = http_pass(url, b64, kind)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        for k in needed:
            if launches[k] <= 0:
                raise AssertionError(f"frontend {kind}: {k} was not launched "
                                     "on the HTTP path")
        out["launches"] = launches
        check_http_ids(kind, seq, first, "first pass")
        if not 0 <= seq["chat"]["completion_tokens"] <= FRONTEND_NEW:
            raise AssertionError(f"frontend {kind}: chat reply {seq['chat']}")
        if seq["stream"]["tokens"] != seq["image"]["tokens"]:
            raise AssertionError(f"frontend {kind}: the stream's tokens "
                                 f"{seq['stream']['tokens']} differ from the "
                                 f"blocking call's {seq['image']['tokens']}")
        for name, r in seq.items():
            toks = r["tokens"]
            if toks is not None and (len(toks) > FRONTEND_NEW or any(
                    not 0 <= t < vocab for t in toks)):
                raise AssertionError(f"frontend {kind} {name}: bad {toks}")

        # the timed readings: both schedulers have served these requests
        # once, so each meets them alike (shapes seen, prefixes cached)
        reps = []
        for rep in range(FRONTEND_REPS):
            http = http_pass(url, b64, kind)
            dirs = direct(requests)
            check_http_ids(kind, http, dirs, f"repetition {rep}")
            reps.append({"http": http, "direct": dirs})
        out["reps"] = reps

        # 8 concurrent users
        results = [None] * 8

        def call(i):
            results[i] = http_post(url, "/generate", {
                "prompt": f"Query {i}: " + "list the objects you see. " * i,
                "max_new_tokens": FRONTEND_NEW, "temperature": 0.0})

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        out["concurrent_s"] = time.perf_counter() - t0
        for i, res in enumerate(results):
            if res is None or res[0] != 200 or \
                    res[1]["finish_reason"] != "stop" or \
                    not 1 <= len(res[1]["tokens"]) <= FRONTEND_NEW or \
                    any(not 0 <= t < vocab for t in res[1]["tokens"]):
                raise AssertionError(f"frontend {kind}: concurrent request "
                                     f"{i}: {res}")
        n_tok = sum(len(r[1]["tokens"]) for r in results)
        out["concurrent_tok_s"] = n_tok / out["concurrent_s"]

        # a client that leaves a long stream after 2 tokens frees its slot
        cancels.clear()
        t0 = time.perf_counter()
        stream_and_leave(httpd.server_port, {
            "prompt": "Write a long report.", "temperature": 0.0,
            "max_new_tokens": FRONTEND_LONG})
        while http_health(url)["active"] and \
                time.perf_counter() - t0 < 120:
            time.sleep(0.05)
        health = http_health(url)
        out["disconnect_freed_s"] = time.perf_counter() - t0
        if health["active"] != 0 or True not in cancels:
            raise AssertionError(f"frontend {kind}: the abandoned stream was "
                                 f"not cancelled: {health}, cancels "
                                 f"{cancels}")
        # a corrupt image is refused with 400
        raw = bytearray(png_bytes(np.zeros((16, 16, 3), np.uint8)))
        raw[-20] ^= 0xFF
        status, data, _ = http_post(url, "/generate", {
            "prompt": "x", "max_new_tokens": 2,
            "image_b64": base64.b64encode(bytes(raw)).decode()})
        if status != 400:
            raise AssertionError(f"frontend {kind}: a corrupt image gave "
                                 f"{status}: {data}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        frontend.shutdown()
    out["http"] = seq
    del frontend, sched, httpd
    gc.collect()
    torch.cuda.empty_cache()
    return out, requests, first


def spread(values):
    """(median, min, max) of a list of readings."""
    return (float(np.median(values)), float(min(values)), float(max(values)))


def host_image_times(images, size, reps=FRONTEND_REPS):
    """Host decode and resize of each (name, PNG bytes, array): the
    decoder must return the array; (median, min, max) ms of each over
    `reps` runs."""
    from lhrs_bot_tpu_torch.data.image_io import decode_png
    from lhrs_bot_tpu_torch.data.transforms import clip_preprocess_uint8

    out = []
    for name, raw, im in images:
        dec, res = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = decode_png(raw)
            t1 = time.perf_counter()
            clip_preprocess_uint8(got, size)
            dec.append((t1 - t0) * 1e3)
            res.append((time.perf_counter() - t1) * 1e3)
            if not np.array_equal(got, im):
                raise AssertionError(f"image_io does not return the encoded "
                                     f"array ({name})")
        out.append({"image": name, "decode_ms": spread(dec),
                    "resize_ms": spread(res)})
    return out


def phase_frontend(engine, cfg, dev, kind, make_sched, needed):
    """The HTTP serving frontend (serve/api.py) over a scheduler from
    `make_sched()` built from `engine`'s parameters, with the byte-level
    tokenizer: warmup; text, one image, two images, a chat with a system
    message, history and an image_url, and a stream, one at a time, each
    with the ids a scheduler built alike gives the same Request directly
    (in the same order, so the prefix cache holds the same pages); the
    stream with the blocking call's ids; the kernels of `needed` launched;
    FRONTEND_REPS timed repetitions, HTTP and direct in turn, ids equal;
    8 concurrent requests, a stream left after 2 tokens cancelled, a
    corrupt image refused; with the bf16 engine, the 2-image request's
    first-token logits through the scheduler within CONSISTENCY_REL_L2 of
    the engine's, the images swapped beyond it. Host PNG decode and resize
    times of the requests' images and of 1024 x 1024 ones."""
    import torch

    from lhrs_bot_tpu_torch.serve import paged as paged_mod
    from lhrs_bot_tpu_torch.serve import scheduler as sched_mod
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig
    from lhrs_bot_tpu_torch.serve.scheduler import Request

    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, shape).astype(np.uint8)
              for shape in ((256, 256, 3), (400, 600, 3), (300, 224, 3))]
    raws = [png_bytes(im) for im in images]
    b64 = [base64.b64encode(raw).decode() for raw in raws]
    big = rng.integers(0, 256, (1024, 1024, 3)).astype(np.uint8)
    host = host_image_times(
        [(f"{im.shape[1]}x{im.shape[0]}", raw, im)
         for im, raw in zip(images, raws)]
        + [("1024x1024", png_bytes(big), big),
           ("1024x1024 None/Sub rows", png_bytes(big, (0, 1)), big)],
        cfg.vit.image_size)
    names = [name for name, _, _ in frontend_bodies(b64)]

    # the direct runs share one scheduler: its first pass runs before the
    # HTTP traffic (which then meets no shape for the first time), its
    # later ones in turn with the HTTP repetitions
    direct_sched = make_sched()
    module = paged_mod if hasattr(direct_sched, "pool_stats") else sched_mod
    sample = module._sample_token_per_slot
    captured = []

    def keep(logits, *a):
        captured.append(logits.float())
        return sample(logits, *a)

    def direct_pass(requests, capture=False):
        """The Requests (fresh copies) straight through the direct
        scheduler, one at a time in order; `capture` collects the 2-image
        request's first-token logits."""
        res = {}
        for name, req in zip(names, requests):
            req = Request(uid=req.uid, input_ids=req.input_ids,
                          image=req.image,
                          max_new_tokens=req.max_new_tokens,
                          temperature=req.temperature, top_p=req.top_p)
            with patched(module, _sample_token_per_slot=keep if (
                    capture and name == "two_images") else sample):
                run = drive(direct_sched, [req])
            res[name] = {"tokens": req.output_ids,
                         "ttft_ms": run["ttft_ms"][0], "tok_s": run["tok_s"],
                         "ms": run["wall_s"] * 1e3}
        return res

    out, requests, first = serve_http(kind, make_sched, cfg, b64, needed,
                                      direct_pass)
    if hasattr(direct_sched, "pool_stats"):
        check_paged_pool(direct_sched, f"frontend {kind} direct")
    del direct_sched
    gc.collect()
    torch.cuda.empty_cache()
    out["host_image_ms"] = host
    out["direct"] = first

    # the 2-image request's first-token logits: scheduler vs engine
    req = requests[names.index("two_images")]
    ids = req.input_ids[None]
    lens = np.asarray([len(req.input_ids)], np.int32)
    gen = GenerationConfig(max_new_tokens=FRONTEND_NEW)
    eng = engine._start(ids, lens, req.image[None], gen)[0].float()
    swapped = engine._start(ids, lens, req.image[None, ::-1].copy(),
                            gen)[0].float()
    multi = {"rel_l2": rel_l2(captured[0], eng)[0],
             "swapped_rel_l2": rel_l2(swapped, eng)[0],
             "bound": CONSISTENCY_REL_L2,
             "top1_agree": bool(captured[0].argmax() == eng.argmax())}
    out["multi_image"] = multi
    log(f"  [frontend {kind}] 2-image first-token logits, scheduler vs "
        f"engine.generate: rel L2 {multi['rel_l2']:.4f} (bound "
        f"{CONSISTENCY_REL_L2}); images swapped {multi['swapped_rel_l2']:.4f}")
    if engine.cache_dtype != torch.int8:
        if multi["rel_l2"] > CONSISTENCY_REL_L2:
            raise AssertionError(f"frontend {kind}: 2-image logits {multi}")
        if multi["swapped_rel_l2"] <= CONSISTENCY_REL_L2:
            raise AssertionError(f"frontend {kind}: swapped images pass "
                                 f"{multi}")

    def fmt(t):
        return f"{t[0]:.1f} [{t[1]:.1f}-{t[2]:.1f}]"

    summary = {}
    for name in names:
        cols = {"http_ms": [r["http"][name]["ms"] for r in out["reps"]],
                "direct_ms": [r["direct"][name]["ms"] for r in out["reps"]],
                "direct_ttft_ms": [r["direct"][name]["ttft_ms"]
                                   for r in out["reps"]]}
        cols["overhead_ms"] = [h - d for h, d in zip(cols["http_ms"],
                                                     cols["direct_ms"])]
        if name == "stream":
            cols["http_ttft_ms"] = [r["http"][name]["ttft_ms"]
                                    for r in out["reps"]]
        summary[name] = {k: spread(v) for k, v in cols.items()}
        s = summary[name]
        log(f"  [frontend {kind}] {name}, median [min-max] of "
            f"{FRONTEND_REPS}: HTTP {fmt(s['http_ms'])} ms"
            + (f", TTFT {fmt(s['http_ttft_ms'])} ms" if name == "stream"
               else "")
            + f"; direct {fmt(s['direct_ms'])} ms, TTFT "
            f"{fmt(s['direct_ttft_ms'])} ms; HTTP - direct "
            f"{fmt(s['overhead_ms'])} ms; ids "
            f"{out['reps'][0]['direct'][name]['tokens'][:6]}...")
    out["summary"] = summary
    log(f"  [frontend {kind}] host PNG decode + resize ms, median [min-max] "
        f"of {FRONTEND_REPS}: " + ", ".join(
            f"{h['image']} {fmt(h['decode_ms'])} + {fmt(h['resize_ms'])}"
            for h in host))
    log(f"  [frontend {kind}] 8 concurrent: {out['concurrent_s']:.2f} s, "
        f"{out['concurrent_tok_s']:.1f} tokens/s; abandoned stream freed in "
        f"{out['disconnect_freed_s']:.2f} s; launches {out['launches']}")
    log(f"  [frontend {kind}] {smi_line()}")
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
# the decoder depth of the artifacts that the planted faults and the
# training-from-disk phase load (a full-depth load takes ~30 s)
CKPT_CUT_LAYERS = 4
# the decoder's depth of the phase's main artifacts, stages 2 and 3 and the
# eval load (LLaMA-2-7B has 32): cut to keep the whole script's time, with
# phase 8's context parallelism and the 336- and 504-px vision checks,
# inside the card's 1,200 s
CKPT_DEPTH = 8
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


def write_llama_dir(llama_dir, lc, dev):
    """An HF LLaMA directory at `lc`'s shapes under `llama_dir`, seeded by
    name: config.json and two fp16 safetensors shards with their index."""
    import torch

    from lhrs_bot_tpu_torch.core.safetensors_io import save_file

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
    write_llama_dir(os.path.join(root, "llama"), lc, dev)

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


def phase_checkpoint(dev, then=None):
    """The checkpoint formats and stages 2 and 3 at full width (ViT-L/14,
    the 144-query perceiver, LLaMA-2-7B's widths with the decoder cut to
    CKPT_DEPTH layers): (a) write the reference's
    artifacts from seeds, (b) load them at stage 0 bit for bit, with three
    planted faults, (c) serve the loaded tree (bf16 and W4A8 engines) bit
    for bit against the expected tree, (d) build_model + build_trainer at
    stage 2 (int8 base, live LoRA): the gradient check, six steps,
    save_final, (e) stage 3 from stage 2's output: the adapters bit for
    bit, two steps, save_final, (f) eval: stage 3's output loaded at stage
    0 and served bit for bit against the plainly merged tree. The planted
    faults of (b) load the artifacts written again at CKPT_CUT_LAYERS
    decoder layers. `then(paths, root)`, where given, runs last, over
    those cut artifacts (paths of the CLIP and LLaMA directories and
    FINAL.pt, with TextLoRA/ beside it) before they are deleted; its result
    is out["then"]."""
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
    from lhrs_bot_tpu_torch.core.convert import as_loaded
    from lhrs_bot_tpu_torch.core.torch_import import load_hf_clip_vision
    from lhrs_bot_tpu_torch.models import LoraConfig, VLMConfig
    from lhrs_bot_tpu_torch.train import HookBase
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {"seconds": {}}
    config0 = eval_config()
    config0["text"]["num_hidden_layers"] = CKPT_DEPTH
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

        # (b) the planted faults, each load differing from the expected,
        # over the artifacts written again with CKPT_CUT_LAYERS decoder
        # layers (each fault is one of structure, not of depth; a
        # full-depth load takes ~30 s), loaded bit for bit first
        del expected
        gc.collect()
        t0 = time.time()
        cut_root = os.path.join(root, "cut")
        os.makedirs(cut_root)
        cfg_cut = dataclasses.replace(cfg0, llama=dataclasses.replace(
            cfg0.llama, num_hidden_layers=CKPT_CUT_LAYERS))
        write_reference_checkpoint(cut_root, cfg_cut, dev)
        cut_paths = {"model_path": os.path.join(cut_root, "FINAL.pt"),
                     "vit_path": os.path.join(cut_root, "clip"),
                     "llama_path": os.path.join(cut_root, "llama")}
        expected = {
            "vit": expected_vit(cfg0.vit, dev, lambda k: "rgb:" + k),
            "pooler": expected_pooler(cfg0.pooler, dev),
            "llama": expected_llama(cfg_cut.llama, dev,
                                    lora=expected_lora(cfg_cut.llama, dev))}
        torch.cuda.empty_cache()
        bad = tree_mismatches(load_pretrained(cfg_cut, **cut_paths)[0],
                              expected)
        log(f"  (b) the artifacts at {CKPT_CUT_LAYERS} decoder layers, at "
            f"stage 0: mismatches {bad}")
        if bad:
            raise AssertionError(f"cut stage-0 load: {bad}")
        q = f"model.layers.{CKPT_SWAP_LAYER}.self_attn.q_proj.weight"
        k = q.replace("q_proj", "k_proj")
        with open(os.path.join(cut_paths["llama_path"],
                               "model.safetensors.index.json")) as fh:
            shard = os.path.join(cut_paths["llama_path"],
                                 json.load(fh)["weight_map"][q])
        lora_dir = os.path.join(cut_root, "TextLoRA")
        faults = {}

        def alpha_r_swapped():
            return load_pretrained(dataclasses.replace(
                cfg_cut, lora=LoraConfig(r=CKPT_LORA_ALPHA,
                                         alpha=CKPT_LORA_R)), **cut_paths)[0]

        def qk_swapped():
            swap_header_offsets(shard, q, k)
            try:
                return load_pretrained(cfg_cut, **cut_paths)[0]
            finally:
                swap_header_offsets(shard, q, k)

        def w_down_dropped():
            write_text_lora(lora_dir, cfg_cut.llama, dev,
                            skip=("down_proj",))
            try:
                return load_pretrained(cfg_cut, **cut_paths)[0]
            finally:
                write_text_lora(lora_dir, cfg_cut.llama, dev)

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
        config2["text"]["num_hidden_layers"] = CKPT_DEPTH
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
        config3["text"]["num_hidden_layers"] = CKPT_DEPTH
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
        # what save_final wrote: the frozen leaves as they were loaded
        written = as_loaded(trainer.params)
        final = {g: {p: torch.as_tensor(v).detach().float().cpu().clone()
                     for p, v in tree_paths(written[g])}
                 for g in ("vit", "pooler")}
        del written
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
        del plain
        gc.collect()
        out["eval"]["cls_protocol"] = cls_protocol(cfg0, evalp, config0, dev,
                                                   root, wrappers)
        del evalp
        gc.collect()
        out["seconds"]["f_eval"] = time.time() - t0
        if then is not None:
            torch.cuda.empty_cache()
            out["then"] = then(cut_paths, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"  seconds per part: {out['seconds']}")
    return out


def cls_protocol(cfg, params, config, dev, root, wrappers, n=16):
    """`eval.make_cls_eval_fn` (the zero-shot protocol of the training
    hooks) over `params` (phase 7 (f)'s loaded tree, CKPT_DEPTH layers): a
    bf16 engine, an ImageFolder of n PNG scenes in 4 classes under `root`, the
    byte tokenizer, batches of EVAL_BATCH (after one batch to warm up):
    images/s, the accuracy, and K1 and K2 launched; the whole function's
    seconds ("total_s": images written, engine built, warm-up, eval)."""
    import torch

    t_all = time.time()

    from lhrs_bot_tpu_torch.core import build_engine
    from lhrs_bot_tpu_torch.data.datasets import FolderClassificationDataset
    from lhrs_bot_tpu_torch.data.tokenizer import load_tokenizer
    from lhrs_bot_tpu_torch.eval import make_cls_eval_fn

    folder = os.path.join(root, "cls_protocol")
    rng = np.random.default_rng(44)
    for i in range(n):
        cls = os.path.join(folder, EVAL_CLASSES[i % len(EVAL_CLASSES)])
        os.makedirs(cls, exist_ok=True)
        h, w = (int(v) for v in rng.integers(224, 321, 2))
        with open(os.path.join(cls, f"s{i}.png"), "wb") as fh:
            fh.write(png_bytes(disk_image(rng, h, w)))
    t0 = time.time()
    engine = build_engine(cfg, params, config, dev)
    build_s = time.time() - t0
    ds = FolderClassificationDataset(folder, image_size=cfg.vit.image_size)
    tok = load_tokenizer(None, model_max_length=2048)
    make_cls_eval_fn(engine, tok, ds, ds.class_names, batch_size=EVAL_BATCH,
                     max_samples=EVAL_BATCH)()  # warm-up, not kept
    eval_fn = make_cls_eval_fn(engine, tok, ds, ds.class_names,
                               batch_size=EVAL_BATCH)
    set_launches(wrappers, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = eval_fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches(wrappers)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out = {"images": len(ds), "seconds": seconds,
           "images_s": len(ds) / seconds, "metrics": metrics,
           "launches": launches, "engine_build_s": build_s,
           "total_s": time.time() - t_all}
    log(f"  (f) make_cls_eval_fn at {cfg.llama.num_hidden_layers} decoder "
        f"layers, bf16, {len(ds)} PNG images "
        f"in batches of {EVAL_BATCH}: {out['images_s']:.2f} images/s "
        f"({seconds:.2f} s; the engine built in {build_s:.1f} s; "
        f"{out['total_s']:.1f} s in all), {metrics}, launches {launches}")
    if len(ds) != n or not 0.0 <= metrics["accuracy"] <= 1.0 or any(
            not launches.get(k) for k in ("flash_attention_fwd",
                                          "fused_decode_attention")):
        raise AssertionError(f"cls protocol: {out}")
    return out


# the training-from-disk phase: a synthetic stage-2 corpus and the stage-2
# entry point at full width over phase 7's artifacts at CKPT_CUT_LAYERS
# decoder layers, so that its four runs' checkpoints (every
# DISK_CKPT_PERIOD iterations) stay small
DISK_TASKS = ("osm_geo", "llava_rs", "scene_cls")
DISK_IMAGES = 32  # 4 iterations of 8
DISK_BATCH = 8
DISK_CKPT_PERIOD = 2
DISK_INTERRUPT = 2  # the interrupted run stops before this iteration


def disk_image(rng, h, w):
    """An (h, w, 3) uint8 scene: a few smooth gradients and bands with
    noise, so that it compresses as a photograph does, not as noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.002, 0.03, 2)
        img[..., c] = (96 + 60 * np.sin(fy * y + rng.uniform(0, 6))
                       + 60 * np.cos(fx * x + rng.uniform(0, 6)))
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_disk_corpus(root, rng, jpeg):
    """DISK_TASKS JSONs with their <task>_Image/ folders: DISK_IMAGES
    records of multi-turn llava_llama_2 conversations (1-4 rounds, the image
    in the first) over scenes of 256-800 pixels a side, PNG (all five row
    filters) and, with `jpeg`, every third image a JPEG (PIL's encoder).
    Returns the bytes written and the count of each format."""
    counts = {"png": 0, "jpeg": 0}
    written = 0
    for t, task in enumerate(DISK_TASKS):
        os.makedirs(os.path.join(root, f"{task}_Image"), exist_ok=True)
        recs = []
        for i in range(t, DISK_IMAGES, len(DISK_TASKS)):
            h, w = (int(v) for v in rng.integers(256, 801, 2))
            arr = disk_image(rng, h, w)
            if jpeg and i % 3 == 2:
                import io

                from PIL import Image

                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, format="JPEG", quality=90)
                name, data = f"scene{i}.jpg", buf.getvalue()
                counts["jpeg"] += 1
            else:
                name, data = f"scene{i}.png", png_bytes(arr)
                counts["png"] += 1
            with open(os.path.join(root, f"{task}_Image", name), "wb") as fh:
                fh.write(data)
            written += len(data)
            convs = []
            for r in range(1 + i % 4):
                q = (f"Question {r} about scene {i}: which land cover lies "
                     f"near the {['river', 'road', 'field', 'port'][r]}?")
                convs += [{"from": "human",
                           "value": ("<image>\n" if r == 0 else "") + q},
                          {"from": "gpt", "value": (
                              f"The area around it is mostly {['farmland', 'forest', 'buildings', 'water'][(i + r) % 4]}"
                              f", with {int(rng.integers(2, 9))} patches.")}]
            recs.append({"image": name, "conversations": convs})
        with open(os.path.join(root, f"{task}.json"), "w") as fh:
            json.dump(recs, fh)
    return written, counts


class DiskProbe:
    """Per iteration: the step's milliseconds (synchronised, from before
    the batch is drawn to after the update) and the trainer's data time;
    with `stop_at`, raises DiskInterrupt before that iteration (a run killed
    after the checkpoint of the iterations before it)."""

    def __init__(self, hook_base, stop_at=None):
        import torch

        probe = self

        class Hook(hook_base):
            def before_iter(self):
                if self.trainer.cur_iter == stop_at:
                    raise DiskInterrupt()
                torch.cuda.synchronize()
                probe.t0 = time.perf_counter()

            def after_iter(self):
                torch.cuda.synchronize()
                probe.ms.append((time.perf_counter() - probe.t0) * 1e3)

        self.ms = []
        self.hook = Hook()


class DiskInterrupt(Exception):
    pass


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_train_from_disk(dev, paths, root):
    """Training from data on disk at full width (ViT-L/14, the 144-query
    perceiver, LLaMA-2-7B's widths with the decoder cut to CKPT_CUT_LAYERS
    layers; int8 base, live LoRA at r 128): a synthetic stage-2 corpus
    under build/, then `main_pretrain_stage2_torch.main` four times over
    `Config/multi_modal_stage2.yaml` with phase 7's seeded artifacts at
    that depth (`paths`: model_path, vit_path, llama_path), batch
    8, a checkpoint every 2 iterations: (A) 4 workers, 4 iterations (the
    path whose launches are counted); (B) 1 worker, killed before iteration
    2 after its checkpoint; (C) a fresh run of B's config with
    --auto-resume to iteration 4; (D) 1 worker, uninterrupted, writing
    only its final checkpoint. C's losses,
    adapters, perceiver and optimizer state equal D's bit for bit. Prints
    data time against step time, each checkpoint write's and the resume's
    bytes and seconds, the JPEG decoder, peak device memory and the card.
    The corpus and the runs' outputs are deleted at the end."""
    import shutil

    import torch

    import main_pretrain_stage2_torch as stage2
    from lhrs_bot_tpu_torch.core import checkpoint as ckpt_lib
    from lhrs_bot_tpu_torch.core.config import load_yaml_config
    from lhrs_bot_tpu_torch.data import native
    from lhrs_bot_tpu_torch.train import HookBase

    t_phase = time.time()
    out = {"layers": CKPT_CUT_LAYERS}
    base = os.path.join(root, "disk")
    corpus = os.path.join(base, "corpus")
    try:
        decoder = native.jpeg_decoder()
        use_jpeg = decoder == "native"
        if not use_jpeg:
            try:
                lines = native.build_log_path().read_text().splitlines()
            except OSError:
                lines = []
            reason = next((ln for ln in lines if "error" in ln),
                          lines[-1] if lines else "no log")
            log(f"  the native JPEG library did not build here ({reason}; "
                f"{native.build_log_path()}): the corpus is PNG only (JPEG "
                f"decoder here: {decoder})")
        t0 = time.time()
        nbytes, counts = write_disk_corpus(
            corpus, np.random.default_rng(41), use_jpeg)
        out["corpus"] = {"bytes": nbytes, "counts": counts,
                         "jpeg_decoder": decoder if use_jpeg else None,
                         "seconds": time.time() - t0}
        log(f"  corpus: {sum(counts.values())} images ({counts}), "
            f"{nbytes / 1e6:.1f} MB, 256-800 px a side, in "
            f"{out['corpus']['seconds']:.1f} s; JPEGs read by "
            f"{decoder if use_jpeg else 'none (PNG only)'}")

        def config(name, workers, **kw):
            c = load_yaml_config("Config/multi_modal_stage2.yaml")
            c["rgb_vision"]["vit_name"] = paths["vit_path"]
            c["text"]["path"] = paths["llama_path"]
            c["text"]["num_hidden_layers"] = CKPT_CUT_LAYERS
            c.update({"model_path": paths["model_path"],
                      "data_path": corpus, "batch_size": DISK_BATCH,
                      "workers": workers, "output": os.path.join(base, name),
                      "seed": 322, "auto_resume": False,
                      "use_checkpoint": False, "dp": None, "tp": None,
                      "device": "cuda", "ckpt_period": DISK_CKPT_PERIOD,
                      **kw})
            return c

        saves, loads = [], []
        save_ckpt, load_ckpt = ckpt_lib.save_checkpoint, ckpt_lib.load_checkpoint

        def timed_save(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            path = save_ckpt(*a, **kw)
            saves.append({"step": a[1], "seconds": time.perf_counter() - t,
                          "bytes": dir_bytes(path)})
            return path

        def timed_load(path):
            t = time.perf_counter()
            got = load_ckpt(path)
            loads.append({"path": os.path.basename(path),
                          "bytes": dir_bytes(path),
                          "seconds": time.perf_counter() - t})
            return got

        wrappers = kernel_wrappers()

        def run(name, cfg, stop_at=None):
            probe = DiskProbe(HookBase, stop_at)
            n_saves = len(saves)
            t = time.time()
            trainer = None
            with patched(ckpt_lib, save_checkpoint=timed_save,
                         load_checkpoint=timed_load):
                try:
                    trainer = stage2.main(cfg, hooks=[probe.hook])
                except DiskInterrupt:
                    pass
            seconds = time.time() - t
            rec = {"seconds": seconds, "step_ms": probe.ms,
                   "saves": saves[n_saves:]}
            if trainer is not None:
                ms_ = trainer.metric_storage
                rec["data_ms"] = [v * 1e3 for v in ms_["data_time"].values]
                rec["loss"] = list(ms_["total_loss"].values)
                rec["start_iter"] = trainer.start_iter
            log(f"  ({name}) {seconds:.1f} s, iterations "
                f"{rec.get('start_iter', 0)}..{len(probe.ms) + rec.get('start_iter', 0)}"
                f"; step ms {[round(v, 1) for v in probe.ms]}; data ms "
                f"{[round(v, 1) for v in rec.get('data_ms', [])]}; losses "
                f"{rec.get('loss')}; checkpoint writes "
                + ", ".join(f"step {s['step']}: {s['bytes'] / 1e9:.3f} GB in "
                            f"{s['seconds']:.2f} s" for s in rec["saves"]))
            return trainer, rec

        torch.cuda.reset_peak_memory_stats()
        set_launches(wrappers, 0)
        trainer, out["A"] = run("A: 4 workers", config("A", 4))
        launches = read_launches(wrappers)
        out["launches"] = launches
        log(f"  (A) launches {launches}")
        if any(not launches.get(k) for k in TRAIN_KERNELS):
            raise AssertionError(f"run A launched {launches}")
        if not all(np.isfinite(out["A"]["loss"])) or len(out["A"]["loss"]) != 4:
            raise AssertionError(f"run A losses {out['A']['loss']}")
        kept = sorted(os.listdir(os.path.join(base, "A", "checkpoints")))
        if kept != ["checkpoint_4", "latest.txt"]:
            raise AssertionError(f"run A kept {kept}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()

        _, out["B"] = run("B: 1 worker, killed before iteration "
                          f"{DISK_INTERRUPT}", config("B", 1),
                          stop_at=DISK_INTERRUPT)
        kept = sorted(os.listdir(os.path.join(base, "B", "checkpoints")))
        if kept != [f"checkpoint_{DISK_INTERRUPT}", "latest.txt"]:
            raise AssertionError(f"run B kept {kept}")
        gc.collect()
        torch.cuda.empty_cache()
        n_loads = len(loads)
        resumed, out["C"] = run("C: B resumed", config("B", 1,
                                                       auto_resume=True))
        out["C"]["load"] = loads[n_loads:]
        if resumed.start_iter != DISK_INTERRUPT or len(loads) != n_loads + 1:
            raise AssertionError(f"run C started at {resumed.start_iter}")
        got = {"lora": resumed.params["lora"],
               "pooler": resumed.params["pooler"]}
        got = {k: [t.detach().clone() for t in _leaves(v)]
               for k, v in got.items()}
        got_opt = resumed.optimizer.state_dict()
        got_opt = {k: [t.detach().clone() for t in v]
                   for k, v in got_opt["slots"].items()}
        got_count = resumed.optimizer.count
        del resumed
        gc.collect()
        torch.cuda.empty_cache()
        # D, the reference, writes only its final checkpoint: the card's
        # machine caps what a run writes to its disk (45 GiB)
        full, out["D"] = run("D: 1 worker, uninterrupted",
                             config("D", 1, ckpt_period=10**9))
        want = {k: list(_leaves(full.params[k])) for k in ("lora", "pooler")}
        want_opt = full.optimizer.state_dict()["slots"]
        mismatch = {}
        for k in got:
            bad = [i for i, (g, w) in enumerate(zip(got[k], want[k]))
                   if not torch.equal(g, w)]
            if bad:
                mismatch[k] = {"leaves": len(bad), "max_abs": max(
                    float((got[k][i] - want[k][i]).abs().max())
                    for i in bad)}
        for k in want_opt:
            bad = [i for i, (g, w) in enumerate(zip(got_opt[k], want_opt[k]))
                   if not torch.equal(g, w)]
            if bad:
                mismatch["opt/" + k] = {"leaves": len(bad)}
        loss_c = out["C"]["loss"]
        loss_d = out["D"]["loss"][DISK_INTERRUPT:]
        if loss_c != loss_d:
            mismatch["loss"] = {"resumed": loss_c, "uninterrupted": loss_d}
        if got_count != full.optimizer.count:
            mismatch["count"] = (got_count, full.optimizer.count)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        out["resume_mismatch"] = mismatch
        log(f"  resumed (C) against uninterrupted (D) at iteration 4: "
            f"losses {loss_c} vs {loss_d}; adapters, perceiver and "
            f"optimizer state {'bit for bit' if not mismatch else mismatch}")
        if mismatch:
            raise AssertionError(f"the resumed run differs: {mismatch}")
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        data = out["A"]["data_ms"]
        step = out["A"]["step_ms"]
        log(f"  (A) data ms against step ms per iteration: "
            + ", ".join(f"{d:.1f} / {s:.1f}" for d, s in zip(data, step))
            + f"; checkpoint writes (all runs): "
            + ", ".join(f"{s['bytes'] / 1e9:.3f} GB in {s['seconds']:.2f} s"
                        for s in saves)
            + f"; resume load: {loads[-1]['bytes'] / 1e9:.3f} GB in "
            f"{loads[-1]['seconds']:.2f} s; peak device memory "
            f"{out['peak_gib']:.2f} GiB; {smi_line()}")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    log(f"  train_from_disk in {out['seconds']:.1f} s")
    return out


# the eval phase: the five eval entry points at full width over phase 7's
# artifacts at CKPT_CUT_LAYERS decoder layers, on PNG corpora written under
# build/
EVAL_BATCH = 8
EVAL_CLASSES = ("farmland", "forest", "harbor", "residential")
EVAL_ENTRIES = ("cls", "vqa", "vg", "bench_gen", "caption")
# a bf16 (and W4A8) entry's logits against its plain-kernel run's, where
# their inputs are the same: relative L2 a position (the prefill/decode
# consistency bound; the noise of kernels against their plain versions
# sits far below it)
EVAL_REL_L2 = CONSISTENCY_REL_L2
# timed runs of each entry in each mode (batched, scheduled), after its
# held runs have warmed its shapes in both
EVAL_REPEATS = 2


def write_eval_corpora(root, rng):
    """The five eval corpora, PNG scenes of 224-320 px a side (row filters
    of all five kinds): an ImageFolder of 4 classes x 4 (cls), RSVQA-LR's
    three JSONs over 4 images (3 questions kept an image; a count, an area
    and an inactive one left out), an RSVG-layout grounding JSON over 8
    images, an LHRS-Bench JSON over 4 images (10 questions), an RSICD
    caption JSON over 8 images. Returns {entry: (data_path, data_target)}
    and the images written."""
    n = 0

    def scene(path):
        nonlocal n
        h, w = (int(v) for v in rng.integers(224, 321, 2))
        with open(path, "wb") as fh:
            fh.write(png_bytes(disk_image(rng, h, w)))
        n += 1

    def dump(path, obj):
        with open(path, "w") as fh:
            json.dump(obj, fh)
        return path

    out = {}
    cls = os.path.join(root, "cls")
    for c in EVAL_CLASSES:
        os.makedirs(os.path.join(cls, c))
        for i in range(4):
            scene(os.path.join(cls, c, f"{c}{i}.png"))
    out["cls"] = (cls, None)
    vqa = os.path.join(root, "vqa")
    os.makedirs(os.path.join(vqa, "Images_LR"))
    qs, ans = [], []
    kinds = (("presence", "Is there a road?", "yes"),
             ("comp", "Are there more buildings than fields?", "no"),
             ("rural_urban", "Is it a rural or an urban area?", "rural"),
             ("count", "How many buildings are there?", "4"),
             ("area", "What is the area of the buildings?", "0m2"),
             ("presence", "Is there a harbor?", "no"))
    for img in range(4):
        scene(os.path.join(vqa, "Images_LR", f"{img}.tif"))
        for k, (qtype, text, answer) in enumerate(kinds):
            qid = len(qs)
            ans.append({"id": qid, "answer": answer})
            qs.append({"id": qid, "img_id": img, "type": qtype,
                       "question": text, "answers_ids": [qid],
                       "active": k < 5})
    for kind, data in (("questions", qs), ("answers", ans),
                       ("images", [{"id": i} for i in range(4)])):
        dump(os.path.join(vqa, f"LR_split_test_{kind}.json"), {kind: data})
    out["vqa"] = (vqa, "LR")
    vg = os.path.join(root, "vg")
    os.makedirs(vg)
    data = []
    for i in range(8):
        scene(os.path.join(vg, f"vg{i}.png"))
        x, y = (int(v) for v in rng.integers(0, 400, 2))
        data.append({"img": f"vg{i}.png", "question":
                     f"the {['storage tank', 'ship', 'bridge', 'vehicle'][i % 4]}"
                     " next to the road", "answer": [x, y, x + 80, y + 60]})
    out["vg"] = (vg, dump(os.path.join(vg, "RSVG_test.json"), {"data": data}))
    bench = os.path.join(root, "bench")
    os.makedirs(bench)
    data = []
    for i in range(4):
        scene(os.path.join(bench, f"b{i}.png"))
        data.append({"filename": f"b{i}.png", "qa_pairs": [
            {"question": f"What is the main land cover in part {k}?",
             "choices": "A. water B. forest C. buildings D. farmland",
             "answer": "ABCD"[(i + k) % 4] + ".", "type": [str(1 + k)]}
            for k in range(2 + i % 2)]})
    out["bench_gen"] = (bench, dump(os.path.join(bench, "bench.json"), {
        "data": data, "qtype": {"1 land_cover": "", "2 color": "",
                                "3 quantity": ""}}))
    cap = os.path.join(root, "cap")
    os.makedirs(cap)
    recs = []
    for i in range(8):
        scene(os.path.join(cap, f"c{i}.png"))
        recs.append({"filename": f"c{i}.png", "sentences": [
            {"raw": f"many buildings and {['a river', 'green trees'][i % 2]}"
                    " are near a road ."}]})
    out["caption"] = (cap, dump(os.path.join(cap, "dataset_rsicd.json"),
                                {"images": recs}))
    return out, n


@contextlib.contextmanager
def plain_kernels():
    """Every kernel of the eval path routed to its plain version, on CUDA
    tensors too, for as long as the block runs: the decoder's K1 and K2
    (`plain_attention`), K1 in the ViT and the perceiver, K4 (its plain
    decode attention), K3 (`w4a8_project` as the CPU path computes it: A's
    plain row quantization, then `w4a8_matmul_plain`) and A
    (`ln_quant_plain` in `quantize_activation`)."""
    import lhrs_bot_tpu_torch.models.llama as llama
    import lhrs_bot_tpu_torch.models.perceiver as perceiver
    import lhrs_bot_tpu_torch.models.vit as vit
    import lhrs_bot_tpu_torch.ops.quant as quant
    from lhrs_bot_tpu_torch.ops.fused_decode import \
        fused_decode_attention_q_plain
    from lhrs_bot_tpu_torch.ops.ln_quant import ln_quant_plain
    from lhrs_bot_tpu_torch.ops.w4_matmul import w4a8_matmul_plain

    def decode_q(*args, int8_dots=None, **kw):
        return fused_decode_attention_q_plain(*args, **kw)

    def w4a8(x, qt, layer):
        b, s, k = x.shape
        xq, xs = ln_quant_plain(x.reshape(b * s, k))
        return w4a8_matmul_plain(xq[:, :k // 2], xq[:, k // 2:], xs, qt.q,
                                 qt.scale, layer, out_dtype=x.dtype
                                 ).reshape(b, s, -1)

    with plain_attention(), \
            patched(llama, fused_decode_attention_q=decode_q,
                    w4a8_project=w4a8), \
            patched(vit, flash_attention=plain_flash), \
            patched(perceiver, flash_attention=plain_flash), \
            patched(quant, ln_quant=ln_quant_plain):
        yield


@contextlib.contextmanager
def k2_kv_swapped():
    """The planted fault of the eval phase: K2 called with the key and
    value operands exchanged (rows and caches), in every layer: each
    decode step scores against the values the prefill wrote and averages
    its keys."""
    import lhrs_bot_tpu_torch.models.llama as llama

    k2 = llama.fused_decode_attention

    def swapped(q, k, v, kc, vc, lengths, layer, **kw):
        return k2(q, v, k, vc, kc, lengths, layer, **kw)
    with patched(llama, fused_decode_attention=swapped):
        yield


def logit_spy(engine, calls):
    """Keep every prefill's and decode step's logits (B, V) of `engine`
    (float32 already: the lm_head is float32) in `calls`, one list a
    `generate` call; `del engine._prefill, engine._decode_step` removes
    it."""
    prefill, step = engine._prefill, engine._decode_step

    def spy_prefill(*a, **k):
        logits, cache = prefill(*a, **k)
        calls.append([logits])
        return logits, cache

    def spy_step(cache, tok):
        logits, cache = step(cache, tok)
        calls[-1].append(logits)
        return logits, cache
    engine._prefill, engine._decode_step = spy_prefill, spy_step


@contextlib.contextmanager
def scheduler_logit_spy(rows):
    """Keep, for every request a `ContinuousBatchingScheduler` serves while
    the block runs, the logits (V,) of each of its live positions in
    `rows[uid]`: its slot prefill's, then those of each decode step of a
    tick that emitted for it (the tick's live flags; a slot's steps after
    its end are not kept). Under a data axis a rank keeps the requests of
    its own group's slots."""
    import lhrs_bot_tpu_torch.serve.scheduler as sched_mod

    cls = sched_mod.ContinuousBatchingScheduler
    prefill, admit = sched_mod.llama_prefill, cls._admit_chunk
    decode, tick = cls._decode, cls._tick
    seen = {}

    def spy_prefill(*a, **k):
        logits, cache = prefill(*a, **k)
        seen["prefill"] = logits
        return logits, cache

    def own(self, slot):
        return 0 <= slot - self.slot0 < self.n_local

    def spy_admit(self, batch, slots):
        admit(self, batch, slots)
        mine = [req for req, slot in zip(batch, slots) if own(self, slot)]
        for i, req in enumerate(mine):  # the prefill ran over these rows
            rows[req.uid] = [seen["prefill"][i]]

    def spy_decode(self, cache, embeds):
        logits, cache = decode(self, cache, embeds)
        seen["steps"].append(logits)
        return logits, cache

    def spy_tick(self, k, sample):
        seen["steps"] = []
        toks, live = tick(self, k, sample)
        for i, logits in enumerate(seen["steps"]):
            for slot in np.flatnonzero(live[i]):
                if own(self, slot):
                    rows[self.slot_req[slot].uid].append(
                        logits[slot - self.slot0])
        return toks, live

    with patched(sched_mod, llama_prefill=spy_prefill), \
            patched(cls, _admit_chunk=spy_admit, _decode=spy_decode,
                    _tick=spy_tick):
        yield


def batched_rows(calls):
    """`logit_spy`'s calls (one list of (B, V) a `generate` call: the
    prefill's, then each decode step's) as one (T, V) tensor a row, in
    item order."""
    import torch

    return [row for call in calls for row in torch.stack(call).unbind(1)]


def hold_eval_ids(name, ids, ref_ids, ref_rows, rows, bound):
    """An eval run's greedy ids against its plain-kernel run's (ref_ids,
    whose logits are ref_rows), row by row, with this run's logits `rows`
    (one (T, V) a row). Each position up to a row's first parting p (all
    positions both runs kept logits for, without a parting; their inputs
    are the same) within `bound` relative L2 of the reference's; at p the
    reference's top-2 margin within that position's max abs deviation.
    Returns the readings; raises AssertionError."""
    if not len(ids) == len(rows) == len(ref_ids) == len(ref_rows):
        raise AssertionError(f"{name}: {len(ids)} rows ({len(rows)} with "
                             f"logits) against {len(ref_ids)} "
                             f"({len(ref_rows)})")
    out = {"rows": len(ids), "partings": [], "max_rel_l2": 0.0,
           "max_abs_dev": 0.0, "bound": bound}
    bad = []
    for r, (got, want, mine, ref) in enumerate(zip(ids, ref_ids, rows,
                                                   ref_rows)):
        p = first_difference(got, want)
        have = min(len(mine), len(ref))
        upto = have if p is None else p + 1
        if upto > have:
            bad.append(f"row {r}: parts at {p}, logits kept for {have} "
                       "positions")
            continue
        ref = ref[:upto].float()
        d = mine[:upto].float() - ref
        rel = d.norm(dim=-1) / ref.norm(dim=-1)
        dev = d.abs().amax(dim=-1)
        worst = float(rel.max())
        out["max_rel_l2"] = max(out["max_rel_l2"], worst)
        out["max_abs_dev"] = max(out["max_abs_dev"], float(dev.max()))
        out["max_first_rel_l2"] = max(out.get("max_first_rel_l2", 0.0),
                                      float(rel[0]))
        if not worst <= bound:
            bad.append(f"row {r}: rel L2 {worst:.3e} up to {upto - 1}")
        if p is None:
            continue
        top2 = ref[p].topk(2).values
        margin, allowed = float(top2[0] - top2[1]), float(dev[p])
        out["partings"].append({"row": r, "at": p, "margin": margin,
                                "deviation": allowed})
        if not margin <= allowed:
            bad.append(f"row {r}: parts at {p} with top-2 margin "
                       f"{margin:.3e} above the deviation {allowed:.3e}")
    out["violations"] = bad
    if bad:
        raise AssertionError(f"{name}: {bad[:4]}")
    return out


def phase_eval(dev, paths, root):
    """The eval surface at full width (ViT-L/14, the 144-query perceiver,
    LLaMA-2-7B's widths with the decoder cut to CKPT_CUT_LAYERS layers,
    bf16) over phase 7's seeded artifacts (`paths`): the five corpora
    written as PNG under `root`, then each `main_<entry>_torch.main` over
    `Config/multi_modal_eval.yaml` (stage 0, the byte tokenizer) batched
    (B = 8), with --scheduled-eval, and batched with every kernel patched
    to its plain version, each with its logits kept; `main_cls_torch`
    again with `bits: 4, quant_type: int4h, kv_bits: 8, lm_head_bits: 8`.
    Each run's launches: K1 and K2 (K3, K4 and A for W4A8) nonzero on the
    kernel runs, none on the plain ones. The batched and the scheduled
    run's ids and logits held to the plain run's by `hold_eval_ids`; a
    planted fault (K2's key and value operands swapped, `k2_kv_swapped`)
    must fail the rule, batched and scheduled. Then EVAL_REPEATS timed
    runs of each mode, alternating, at shapes the held runs warmed:
    images/s (median and range) of each protocol. The entries' load and
    engine build are shared: the first `build_model_and_tokenizer` is
    kept for every run, and one engine per precision. Also logs whether
    PIL and cv2 import here."""
    import shutil

    import torch

    from lhrs_bot_tpu_torch.core.config import load_yaml_config
    from lhrs_bot_tpu_torch.eval import entry as entry_lib

    t_phase = time.time()
    out = {"layers": CKPT_CUT_LAYERS, "entries": {}}
    for mod in ("PIL", "cv2"):
        try:
            m = __import__(mod)
            out[mod] = getattr(m, "__version__", "imported")
        except ImportError as exc:
            out[mod] = f"not importable: {exc}"
    log(f"  PIL: {out['PIL']}; cv2: {out['cv2']}")
    base = os.path.join(root, "eval")
    wrappers = kernel_wrappers()
    loaded, engines, spied = [], {}, {}
    build_model, build_engine = (entry_lib.build_model_and_tokenizer,
                                 entry_lib.build_engine)

    def shared_model(config, device):
        if not loaded:
            t = time.time()
            loaded.append(build_model(config, device))
            out["load_s"] = time.time() - t
        return loaded[0]

    def shared_engine(cfg, params, config, device):
        key = tuple(config.get(k) for k in ("bits", "kv_bits", "quant_type",
                                            "lm_head_bits"))
        if key not in engines:
            t = time.time()
            engines[key] = build_engine(cfg, params, config, device)
            out.setdefault("engine_s", {})[str(key)] = time.time() - t
        engine = engines[key]
        if "calls" in spied:
            logit_spy(engine, spied["calls"])
        spied["engine"] = engine
        return engine

    try:
        t0 = time.time()
        corpora, n_images = write_eval_corpora(base, np.random.default_rng(43))
        log(f"  corpora: {n_images} PNG images, 224-320 px a side, in "
            f"{time.time() - t0:.1f} s")

        def config(name, data_path, data_target, scheduled, **kw):
            c = load_yaml_config("Config/multi_modal_eval.yaml")
            c["rgb_vision"]["vit_name"] = paths["vit_path"]
            c["text"]["path"] = paths["llama_path"]
            c["text"]["num_hidden_layers"] = CKPT_CUT_LAYERS
            c.update({"model_path": paths["model_path"],
                      "data_path": data_path, "data_target": data_target,
                      "batch_size": EVAL_BATCH, "scheduled_eval": scheduled,
                      "output": os.path.join(base, "out", name),
                      "seed": 322, "device": "cuda", "dp": None, "tp": None,
                      "rank": 0, "world_size": 1, **kw})
            return c

        def run(name, cfg, keep_logits=False):
            """One entry run; with `keep_logits`, its logits (one (T, V)
            a row, in item order) under "rows"."""
            import importlib

            mod = importlib.import_module(f"main_{name}_torch")
            scheduled = cfg["scheduled_eval"]
            rows = {}
            if keep_logits and not scheduled:
                spied["calls"] = []
            set_launches(wrappers, 0)
            try:
                with (scheduler_logit_spy(rows) if keep_logits and scheduled
                      else contextlib.nullcontext()):
                    res = mod.main(cfg)
            finally:
                engine = spied.pop("engine", None)
                if "calls" in spied and engine is not None:
                    del engine._prefill, engine._decode_step
            torch.cuda.synchronize()
            res["launches"] = read_launches(wrappers)
            calls = spied.pop("calls", None)
            if keep_logits:
                res["rows"] = ([torch.stack(rows[u]) for u in sorted(rows)]
                               if scheduled else batched_rows(calls))
            return res

        def held(tag, name, knobs, needed, fault=False):
            data_path, target = corpora[name]

            def conf(suffix, scheduled):
                return config(f"{name}{tag}{suffix}", data_path, target,
                              scheduled, **knobs)

            kernel = run(name, conf("", False), keep_logits=True)
            sched = run(name, conf("_s", True), keep_logits=True)
            with plain_kernels():
                plain = run(name, conf("_p", False), keep_logits=True)
            for what, res in (("batched", kernel), ("scheduled", sched)):
                missing = [k for k in needed if not res["launches"].get(k)]
                if missing:
                    raise AssertionError(f"eval {name}{tag} ({what}): "
                                         f"{missing} not launched: "
                                         f"{res['launches']}")
            if any(plain["launches"].get(k) for k in needed):
                raise AssertionError(f"eval {name}{tag}: the plain run "
                                     f"launched {plain['launches']}")
            for res in (kernel, sched, plain):
                flat = [t for ids in res["ids"] for t in ids]
                if len(res["ids"]) != res["images"] or any(
                        not 0 <= t < 32000 for t in flat):
                    raise AssertionError(f"eval {name}{tag}: bad ids")
            bound = EVAL_REL_L2
            rec = {"images": kernel["images"], "metrics": kernel["metrics"],
                   "launches": {"batched": kernel["launches"],
                                "scheduled": sched["launches"]},
                   "plain_s": plain["seconds"], "held": {}}
            for what, res in (("batched", kernel), ("scheduled", sched)):
                rec["held"][what] = hold_eval_ids(
                    f"eval {name}{tag} {what}", res["ids"], plain["ids"],
                    plain["rows"], res["rows"], bound)
            rec["same_ids"] = sched["ids"] == kernel["ids"]
            if fault:
                rec["fault"] = {}
                for what, scheduled in (("batched", False),
                                        ("scheduled", True)):
                    with k2_kv_swapped():
                        bad = run(name, conf(f"_f{what[0]}", scheduled),
                                  keep_logits=True)
                    try:
                        hold_eval_ids(f"eval {name}{tag} planted fault "
                                      f"({what})", bad["ids"], plain["ids"],
                                      plain["rows"], bad["rows"], bound)
                    except AssertionError as exc:
                        rec["fault"][what] = str(exc)[:300]
                    else:
                        raise AssertionError(
                            f"eval {name}{tag}: the planted fault (K2's K "
                            f"and V swapped) passes, {what}")
                    del bad
            del kernel, sched, plain
            timed = {"batched": [], "scheduled": []}
            for rep in range(EVAL_REPEATS):
                for what in timed:
                    res = run(name, conf(f"_t{rep}{what[0]}",
                                         what == "scheduled"))
                    timed[what].append({"images_s": res["images"]
                                        / res["seconds"],
                                        "seconds": res["seconds"],
                                        "load_seconds": res["load_seconds"]})
            for what, runs in timed.items():
                ips = sorted(t["images_s"] for t in runs)
                rec[what] = {"images_s": float(np.median(ips)),
                             "images_s_range": [ips[0], ips[-1]],
                             "runs": runs}
            b, s = rec["batched"], rec["scheduled"]
            hb, hs = rec["held"]["batched"], rec["held"]["scheduled"]

            def spread(m):
                secs = [(round(t["seconds"], 3), round(t["load_seconds"], 3))
                        for t in m["runs"]]
                return (f"{m['images_s']:.2f} images/s (median; "
                        f"{m['images_s_range'][0]:.2f}-"
                        f"{m['images_s_range'][1]:.2f}; seconds and the "
                        f"items' loads {secs})")
            log(f"  [{name}{tag}] {rec['images']} images, {EVAL_REPEATS} "
                f"timed runs a mode: batched {spread(b)}, scheduled "
                f"{spread(s)}, "
                f"plain kernels {rec['plain_s']:.2f} s; launches "
                f"{rec['launches']['batched']} / "
                f"{rec['launches']['scheduled']}; held to plain (bound "
                f"{bound}): batched rel L2 <= {hb['max_rel_l2']:.3e}, max "
                f"abs dev {hb['max_abs_dev']:.3e}, partings "
                f"{hb['partings']}; scheduled rel L2 <= "
                f"{hs['max_rel_l2']:.3e}, max abs dev "
                f"{hs['max_abs_dev']:.3e}, partings {hs['partings']} (same "
                f"ids as batched: {rec['same_ids']}); metrics "
                f"{rec['metrics']}"
                + (f"; planted fault caught: {rec['fault']}" if fault
                   else ""))
            return rec

        bf16 = ("flash_attention_fwd", "fused_decode_attention")
        w4a8 = ("flash_attention_fwd", "fused_decode_attention_q",
                "w4a8_matmul", "ln_quant")
        with patched(entry_lib, build_model_and_tokenizer=shared_model,
                     build_engine=shared_engine):
            for name in EVAL_ENTRIES:
                out["entries"][name] = held("", name, {}, bf16,
                                            fault=name == "cls")
                gc.collect()
            out["entries"]["cls_w4a8"] = held(
                "_w4a8", "cls", {"bits": 4, "quant_type": "int4h",
                                 "kv_bits": 8, "lm_head_bits": 8}, w4a8)
    finally:
        engines.clear()
        loaded.clear()
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(base, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    log(f"  eval in {out['seconds']:.1f} s (load {out.get('load_s', 0):.1f} "
        f"s, engines {out.get('engine_s')}); {smi_line()}")
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


# -- phase 8: data and tensor parallelism -----------------------------------

# the decoder's depth in the parallel phase (full widths otherwise)
PARALLEL_LAYERS = 2
PARALLEL_NEW = 12  # tokens a request
PARALLEL_TIMEOUT = 420  # seconds the ranks may take
PARALLEL_RECIPES = (
    ("bf16", {}, ("flash_attention_fwd", "fused_decode_attention")),
    ("w4a8", {"bits": 4, "quant_type": "int4h", "kv_bits": 8,
              "lm_head_bits": 8},
     ("flash_attention_fwd", "fused_decode_attention_q", "w4a8_matmul",
      "ln_quant")),
)
# tp = 2 against tp = 1 on the same seeded weights: relative L2 of the
# first token's logits (the decode steps' are read where the ids part).
# On an H100 at 700 W the readings were 0.0090-0.0097 (bf16) and
# 0.0042-0.0071 (W4A8; its row-parallel products are the single rank's
# bits, the rest is bf16 rounding in another order) and the packed-axis
# fault 1.31: the bound sits 5x above the noise, 26x below the fault
TP_REL_L2 = {"bf16": 0.05, "w4a8": 0.05}
# dp = 2 against dp = 1 on the same global batch, one stage-2 step: the
# loss's and grad_norm's relative difference (read 1.1e-5 and 4.1e-4 on
# that card), and the relative L2 of the trainable leaves' updates. AdamW's
# first step is about lr * sign(g), so a gradient element near 0 whose sign
# moves with bf16 rounding moves its update by 2 lr: the updates read
# 0.117-0.118 against 1.01-1.04 with the skipped reduction
DP_METRIC_REL = 5e-3
DP_UPDATE_REL_L2 = 0.3
# the same step's first moments ((1 - b1) times the clipped, reduced
# gradient), leaf by leaf: linear in the gradient, so a leaf's bf16 noise
# stays small while a gradient scaled or left unreduced moves its leaf
DP_MOMENT_REL_L2 = 0.05
# leaves whose gradient is zero in exact arithmetic, so their relative L2
# is rounding against rounding (0.46 on the card): the perceiver's key
# bias adds q . bk to every key's logit of a query, which the softmax does
# not see. Each is held instead to a first moment whose RMS is at most
# DP_ZERO_GRAD_RMS of its query-bias partner's (same shape, not zero)
DP_ZERO_GRAD_LEAVES = {"pooler/layers/bk": "pooler/layers/bq"}
DP_ZERO_GRAD_RMS = 1e-2


def parallel_configs(tiny=False):
    """(serving config, stage-2 training config) of the parallel phase: the
    eval preset and Config/multi_modal_stage2.yaml at full widths with
    the decoder cut to PARALLEL_LAYERS layers (`tiny`: the tests' tiny
    sizes, for a rehearsal on the CPU)."""
    from lhrs_bot_tpu_torch.core import eval_config
    from lhrs_bot_tpu_torch.core.config import load_yaml_config

    serving = eval_config()
    train = load_yaml_config("Config/multi_modal_stage2.yaml")
    train["rgb_vision"]["vit_name"] = None
    train["text"]["path"] = None
    for c in (serving, train):
        c["text"]["num_hidden_layers"] = PARALLEL_LAYERS
        if tiny:
            c["rgb_vision"]["arch"] = "vit_tiny"
            c["rgb_vision"]["attn_pooler"].update(
                num_query=12, num_attn_heads=2, num_layers=2)
            c["text"].update(vocab_size=256, hidden_size=128,
                             intermediate_size=256, num_attention_heads=4,
                             max_position_embeddings=256)
    if tiny:
        train["lora"].update(lora_r=8, lora_alpha=16)
    return serving, train


def parallel_requests(cfg, tiny=False):
    """Two seeded image requests: B = 1 of 40 tokens, B = 2 of 300 and
    120 (the tiny sizes: 10, and 20 and 12)."""
    rng = np.random.default_rng(18)
    size = cfg.vit.image_size

    def batch(*lens):
        ids = np.zeros((len(lens), max(lens)), np.int32)
        for i, n in enumerate(lens):
            ids[i, :n] = rng.integers(3, cfg.llama.vocab_size, n)
            ids[i, 0] = cfg.llama.bos_token_id
            ids[i, 1] = -200
        imgs = rng.integers(0, 256, (len(lens), size, size, 3)).astype(
            np.uint8)
        return ids, np.asarray(lens, np.int32), imgs

    return [("short", batch(10 if tiny else 40)),
            ("batch2", batch(*((20, 12) if tiny else (300, 120))))]


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tp_serve(dev, config, mesh, wrappers, tiny=False):
    """The serving recipes over `mesh` (None: one rank) from the seeded
    weights: per request the first token's logits, the greedy ids with
    each decode step's logits (a spy on `_decode_step`), a timed run, and
    each kernel's launches in those runs; over a mesh also the planted
    fault's first logits (the W4 row-parallel weights sliced along the
    packed K/2 axis). Returns host numbers."""
    import torch

    from lhrs_bot_tpu_torch.core import build_engine
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.ops import w4_matmul
    from lhrs_bot_tpu_torch.ops.quant import QuantizedTensor
    from lhrs_bot_tpu_torch.parallel import partition
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    cfg = VLMConfig.from_config_dict(config)
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    requests = parallel_requests(cfg, tiny)
    kernel = w4_matmul.w4a8_matmul_kernel  # its mode (a) counted apart
    out = {}
    for name, knobs, _ in PARALLEL_RECIPES:
        engine = build_engine(cfg, params, {**config, **knobs}, dev,
                              mesh=mesh)
        steps = []
        plain_step = engine._decode_step

        def spy(cache, tokens):
            logits, cache = plain_step(cache, tokens)
            steps.append(logits.float().cpu().numpy())
            return logits, cache

        for w in wrappers.values():
            w.launches = 0
        kernel.mode_a_launches = 0
        res = []
        gcfg = GenerationConfig(max_new_tokens=PARALLEL_NEW)
        for rname, (ids, lens, imgs) in requests:
            first = engine._start(ids, lens, imgs, gcfg)[0]
            steps.clear()
            engine._decode_step = spy
            got = engine.generate(ids, lens, images=imgs, gen_cfg=gcfg)
            engine._decode_step = plain_step
            _sync(dev)
            t0 = time.perf_counter()
            engine.generate(ids, lens, images=imgs, gen_cfg=gcfg)
            _sync(dev)
            res.append({"request": rname, "ids": got,
                        "first": first.float().cpu().numpy(),
                        "steps": np.stack(steps) if steps else None,
                        "ms": (time.perf_counter() - t0) * 1e3})
        launches = {k: w.launches for k, w in wrappers.items()}
        launches["w4a8_matmul_mode_a"] = kernel.mode_a_launches
        entry = {"requests": res, "launches": launches}
        if mesh is not None and name == "w4a8":
            layers = engine.llama_params["layers"]
            keep = {k: layers[k] for k in ("wo", "w_down")}
            for k, qt in keep.items():  # the planted fault
                full = partition.gather_leaf(
                    qt, partition._LLAMA_LAYER_SPECS[k], mesh.model)
                k2 = full.q.shape[1] // mesh.tp
                i = mesh.model_index
                layers[k] = QuantizedTensor(
                    full.q[:, i * k2:(i + 1) * k2].contiguous(),
                    full.scale, full.bits)
            ids, lens, imgs = requests[0][1]
            entry["fault_first"] = engine._start(
                ids, lens, imgs, gcfg)[0].float().cpu().numpy()
            layers.update(keep)
        out[name] = entry
        del engine
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


# dp = 2 serving (phase 8 (d)): the engine's batch of 2 split over the data
# groups, and a contiguous wave of DP_WAVE requests (prompt tokens, image or
# not) over DP_SLOTS slots, max_batch / dp a group, DP_NEW tokens each
DP_SLOTS = 4
DP_NEW = 8
# dp 2 against one rank, every position up to a row's first parting. A
# data group computes B / dp rows where one rank computes B, and on one
# rank (`batch_invariance`) a row decoded alone or beside another on the
# same cache reads about 1e-7 (held to DP_INVARIANT_REL), as does the bf16
# decoder's prefill on the same spliced embeddings; the row counts move
# the vision tower's bf16 products and the W4A8 recipe's float32 prefill
# products (cuBLAS, whose summation order follows the row count), whose
# roundings part by about 1e-2 (tower) and 7e-3 (W4A8 prefill). On random
# weights any such nudge reads at the recipe's noise floor: a 1e-3 nudge
# of the spliced embeddings on one rank moved the next step's logits by
# 0.9% (bf16) and 4.3-5.4% (W4A8 + int8 KV) on an H100 at 700 W, where dp
# 2 read 1.1% and 5.2%. The bound sits 3x above the W4A8 floor, and the
# slots gathered out of order (relative L2 about 1.2) fail it
DP_REL_L2 = {"bf16": 0.05, "w4a8": 0.15}
DP_INVARIANT_REL = 1e-4
DP_NUDGE = 1e-3
DP_WAVE = ((40, True), (300, False), (120, True), (64, False), (200, True),
           (90, False))


def dp_wave(cfg, tiny=False):
    """The wave's seeded requests (the tiny sizes: a tenth of the
    tokens, at least 6)."""
    from lhrs_bot_tpu_torch.serve.scheduler import Request

    rng = np.random.default_rng(20)
    size = cfg.vit.image_size
    out = []
    for uid, (n, image) in enumerate(DP_WAVE):
        n = max(6, n // 10) if tiny else n
        ids = rng.integers(3, cfg.llama.vocab_size, n).astype(np.int32)
        ids[0] = cfg.llama.bos_token_id
        img = None
        if image:
            ids[1] = -200
            img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        out.append(Request(uid=uid, input_ids=ids, image=img,
                           max_new_tokens=DP_NEW))
    return out


def swapped_slot_gather(sched):
    """The planted fault of the dp wave: the tokens a tick gathers over
    the data axis come back in reverse group order (the live flags in
    order, so the host's bookkeeping holds and only the ids go wrong)."""
    import torch

    gather = sched._gather_slots

    def swapped(t, dim):
        t = gather(t, dim)  # (tokens, live flags) stacked on dim 0
        parts = t[0].chunk(sched.dp.size, dim=dim - 1)
        return torch.stack([torch.cat(parts[::-1], dim=dim - 1), t[1]])

    sched._gather_slots = swapped


def dp_serve(dev, config, mesh, wrappers, tiny=False):
    """The serving recipes over `mesh` (None: one rank) from the seeded
    weights, with the slots and rows split over its data axis: the
    engine's `generate` of the batch of 2 (ids, the logits of every
    position gathered over the data axis, the rows this group's prefill
    computed, a timed run) and a contiguous scheduler wave (ids, the logits of
    every live position of this group's requests by `scheduler_logit_spy`,
    the slots this group's cache held, a timed run), each with every
    kernel's launches; over a data axis also the wave with the planted
    fault (`swapped_slot_gather`) in the bf16 recipe. Returns host
    numbers."""
    import torch

    from lhrs_bot_tpu_torch.core import build_engine
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig
    from lhrs_bot_tpu_torch.serve.scheduler import \
        ContinuousBatchingScheduler

    cfg = VLMConfig.from_config_dict(config)
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    ids, lens, imgs = parallel_requests(cfg, tiny)[1][1]
    gcfg = GenerationConfig(max_new_tokens=PARALLEL_NEW)
    out = {}

    def host_rows(rows):
        return {u: [t.float().cpu().numpy() for t in r]
                for u, r in rows.items()}

    for name, knobs, _ in PARALLEL_RECIPES:
        engine = build_engine(cfg, params, {**config, **knobs}, dev,
                              mesh=mesh)
        calls = []
        logit_spy(engine, calls)
        set_launches(wrappers)
        got = engine.generate(ids, lens, images=imgs, gen_cfg=gcfg)
        _sync(dev)
        launches = read_launches(wrappers)
        del engine._prefill, engine._decode_step
        # (B, T, V): every position's logits, the groups' rows gathered
        steps = engine._gather_rows(torch.stack(calls[0], dim=1),
                                    ids.shape[0])
        t0 = time.perf_counter()
        engine.generate(ids, lens, images=imgs, gen_cfg=gcfg)
        _sync(dev)
        entry = {"engine": {
            "ids": got, "logits": steps.float().cpu().numpy(),
            "rows": calls[0][0].shape[0],  # the group's prefill rows
            "launches": launches,
            "ms": (time.perf_counter() - t0) * 1e3}}

        def wave(fault=False):
            sched = ContinuousBatchingScheduler(
                cfg, engine.params, engine.llama_params,
                max_batch=DP_SLOTS, max_seq_len=1024,
                compute_dtype=engine.compute_dtype,
                cache_dtype=engine.cache_dtype, tokens_per_tick=4,
                device=dev, mesh=mesh)
            if fault:
                swapped_slot_gather(sched)
            reqs, rows = dp_wave(cfg, tiny), {}
            set_launches(wrappers)
            _sync(dev)
            t0 = time.perf_counter()
            with scheduler_logit_spy(rows):
                sched.run(reqs)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            tokens = sum(len(r.output_ids) for r in reqs)
            return {"ids": [r.output_ids for r in reqs],
                    "rows": host_rows(rows), "slots": sched.cache.k.shape[1],
                    "launches": read_launches(wrappers), "ms": ms,
                    "tokens": tokens, "tokens_s": tokens / ms * 1e3}

        entry["wave"] = wave()
        if mesh is not None and mesh.dp > 1:
            entry["wave_fault"] = wave(fault=True)
        if mesh is None:
            entry["invariance"] = batch_invariance(engine, ids, lens, imgs,
                                                   gcfg)
        out[name] = entry
        del engine
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def batch_invariance(engine, ids, lens, imgs, gcfg):
    """Which of a row's numbers depend on the rows beside it, on one rank
    (`engine` without a mesh), for the batch of 2: each row through the
    vision tower alone and in the batch (relative L2 of its spliced
    embeddings), through the decoder's prefill alone and in the batch on
    the batch's spliced embeddings (first-token logits), and through one
    decode step alone and in the batch on the batch's cache (logits); and
    the recipe's noise floor, the batch's first-token and next-step
    logits with its spliced embeddings nudged by DP_NUDGE relative
    (seeded). Returns the largest reading of each over the rows."""
    import dataclasses

    import torch

    from lhrs_bot_tpu_torch.models.llama import llama_prefill

    seen = {}
    prefill = engine._prefill

    def spy(input_ids, images, seq_lens, *, batch, cache_len):
        seen.update(ids=input_ids, images=images, lens=seq_lens,
                    cache_len=cache_len)
        return prefill(input_ids, images, seq_lens, batch=batch,
                       cache_len=cache_len)

    engine._prefill = spy
    try:
        engine._start(ids, lens, imgs, gcfg)
    finally:
        del engine._prefill
    it, im, sl = seen["ids"], seen["images"], seen["lens"]

    def run_prefill(emb, spliced_len):
        return llama_prefill(
            engine.llama_params, engine.cfg.llama,
            engine._new_cache(emb.shape[0], seen["cache_len"]),
            inputs_embeds=emb, prompt_len=spliced_len,
            compute_dtype=engine.compute_dtype)

    def row_cache(cache, r):  # a copy of row r's cache
        def cut(t):
            return None if t is None else t[:, r:r + 1].contiguous()
        return dataclasses.replace(
            cache, k=cut(cache.k), v=cut(cache.v),
            length=cache.length[r:r + 1].clone(),
            k_scale=cut(cache.k_scale), v_scale=cut(cache.v_scale))

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    with torch.no_grad():
        emb, spl = engine._splice(it, im, sl)
        first, cache = run_prefill(emb, spl)
        tok = first.argmax(dim=-1).to(torch.int32)
        alone = [row_cache(cache, r) for r in range(emb.shape[0])]
        step, _ = engine._decode_step(cache, tok)
        out = {"tower": 0.0, "prefill": 0.0, "decode": 0.0}
        for r in range(emb.shape[0]):
            rows = slice(r, r + 1)
            out["tower"] = max(out["tower"], rel(
                engine._splice(it[rows], im[rows], sl[rows])[0][0], emb[r]))
            out["prefill"] = max(out["prefill"], rel(
                run_prefill(emb[rows], spl[rows])[0][0], first[r]))
            out["decode"] = max(out["decode"], rel(
                engine._decode_step(alone[r], tok[rows])[0][0], step[r]))
        gen = torch.Generator(emb.device).manual_seed(5)
        noise = torch.randn(emb.shape, generator=gen, device=emb.device)
        noise *= emb.float().norm(dim=-1, keepdim=True) / noise.norm(
            dim=-1, keepdim=True)
        nudged_first, nudged = run_prefill(
            (emb.float() + DP_NUDGE * noise).to(emb.dtype), spl)
        nudged_step, _ = engine._decode_step(nudged, tok)
        out["floor_first"] = max(rel(nudged_first[r], first[r])
                                 for r in range(emb.shape[0]))
        out["floor_step"] = max(rel(nudged_step[r], step[r])
                                for r in range(emb.shape[0]))
    return out


def hold_dp(ranks, ref, dp):
    """Phase 8 (d): each recipe's dp-split engine and wave against one
    rank's: the ranks' ids equal; the engine's rows and the wave's slots a
    group's share; ids and logits by `hold_eval_ids` at DP_REL_L2 (every
    position up to a row's first parting within the bound, ids equal or
    parting only where one rank's top-2 margin lies within the
    deviation), the first token's logits within TP_REL_L2 as tp 2's; the
    one rank's decode step batch-invariant within
    DP_INVARIANT_REL (`batch_invariance`); the planted fault must fail.
    Returns the readings."""
    import torch

    def tensors(rows):  # a request's (T, V) logits
        return torch.as_tensor(np.stack(rows))

    def merged(key, name):
        """The wave's logits a request, from the rank whose group held
        its slot."""
        rows = {}
        for rank in ranks:
            rows.update(rank["dp_serve"][name][key]["rows"])
        return [tensors(rows[u]) for u in sorted(rows)]

    out = {}
    for name, _, needed in PARALLEL_RECIPES:
        bound = DP_REL_L2[name]
        got = [r["dp_serve"][name] for r in ranks]
        want = ref[name]
        inv = want["invariance"]
        if not inv["decode"] <= DP_INVARIANT_REL:
            raise AssertionError(f"dp {name}: a row decoded alone reads "
                                 f"{inv['decode']:.3e} from the same row "
                                 f"in the batch (bound {DP_INVARIANT_REL})")
        for key in ("engine", "wave"):
            if any(g[key]["ids"] != got[0][key]["ids"] for g in got):
                raise AssertionError(f"dp {name} {key}: the ranks' ids "
                                     "differ")
        b = len(want["engine"]["ids"])
        if any(g["engine"]["rows"] != b // dp for g in got):
            raise AssertionError(f"dp {name} engine: a group's prefill ran "
                                 f"{[g['engine']['rows'] for g in got]} "
                                 f"rows of {b}")
        if any(g["wave"]["slots"] != DP_SLOTS // dp for g in got):
            raise AssertionError(f"dp {name} wave: a group's cache held "
                                 f"{[g['wave']['slots'] for g in got]} "
                                 f"slots of {DP_SLOTS}")
        reading = {
            "bound": bound,
            "engine": hold_eval_ids(
                f"dp {name} engine", got[0]["engine"]["ids"],
                want["engine"]["ids"],
                list(torch.as_tensor(want["engine"]["logits"])),
                list(torch.as_tensor(got[0]["engine"]["logits"])), bound),
            "wave": hold_eval_ids(
                f"dp {name} wave", got[0]["wave"]["ids"],
                want["wave"]["ids"],
                [tensors(want["wave"]["rows"][u])
                 for u in sorted(want["wave"]["rows"])],
                merged("wave", name), bound),
            "invariance": inv,
            "engine_ms": [g["engine"]["ms"] for g in got],
            "ref_engine_ms": want["engine"]["ms"],
            "wave_ms": [g["wave"]["ms"] for g in got],
            "wave_tokens_s": [g["wave"]["tokens_s"] for g in got],
            "ref_wave_ms": want["wave"]["ms"],
            "ref_wave_tokens_s": want["wave"]["tokens_s"],
            "engine_launches": [g["engine"]["launches"] for g in got],
            "ref_engine_launches": want["engine"]["launches"],
            "wave_launches": [g["wave"]["launches"] for g in got],
            "ref_wave_launches": want["wave"]["launches"]}
        for key in ("engine", "wave"):  # the first token as tp 2's
            first = reading[key]["max_first_rel_l2"]
            if not first <= TP_REL_L2[name]:
                raise AssertionError(f"dp {name} {key}: first-token logits "
                                     f"rel L2 {first:.3e} > "
                                     f"{TP_REL_L2[name]}")
        for r, g in enumerate(got):
            for key in ("engine", "wave"):
                missing = [k for k in needed
                           if not g[key]["launches"].get(k)]
                if ranks[r]["device"].startswith("cuda") and missing:
                    raise AssertionError(f"dp {name} {key}: rank {r} "
                                         f"launched no {missing}")
        if "wave_fault" in got[0]:
            try:
                hold_eval_ids(f"dp {name} wave, planted fault",
                              got[0]["wave_fault"]["ids"],
                              want["wave"]["ids"],
                              [tensors(want["wave"]["rows"][u])
                               for u in sorted(want["wave"]["rows"])],
                              merged("wave_fault", name), bound)
            except AssertionError as exc:
                reading["fault"] = str(exc)[:300]
            else:
                raise AssertionError(f"dp {name}: the slots gathered out "
                                     "of order pass")
        out[name] = reading
    return out


def parallel_batch(cfg):
    """The seeded global batch of the training part: 4 caption rows of one
    image, 40-160 text tokens (each data half holds another count of
    valid tokens)."""
    import types

    from lhrs_bot_tpu_torch.data import SupervisedCollator

    rng = np.random.default_rng(81)
    tok = types.SimpleNamespace(pad_token_id=cfg.llama.pad_token_id,
                                model_max_length=2048)
    size = cfg.vit.image_size
    samples = []
    for n in (160, 40, 100, 72):
        ids = rng.integers(3, cfg.llama.vocab_size, n)
        ids[0], ids[1] = cfg.llama.bos_token_id, -200
        labels = ids.copy()
        labels[:2] = -100
        samples.append({"input_ids": ids, "labels": labels,
                        "image": rng.integers(0, 256, (size, size, 3))
                        .astype(np.uint8)})
    return SupervisedCollator(tok, pad_multiple=8)(samples)


def dp_train(dev, config, mesh, fault=False):
    """One stage-2 step (int8 base, LoRA with non-zero B, the pooler
    trains; the recipe's AdamW and clipping) over `mesh` (None: one rank
    on the whole batch; else this data index's half) from seeded weights.
    Returns the metrics, the step's ms, the updates of the compared
    leaves, every trainable leaf's first moment (on the first rank) and a
    digest of every trainable leaf. `fault`: the last rank
    (whose ZeRO shard holds the end of the flat vector: the LoRA factors)
    keeps its unreduced gradients."""
    import hashlib
    import tempfile

    import torch

    from lhrs_bot_tpu_torch.core import build_trainer
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.ops.quant import (_QUANT_TARGETS,
                                              quantize_llama_layers)
    from lhrs_bot_tpu_torch.parallel.partition import gather_params
    from lhrs_bot_tpu_torch.train.optimizer import SLOTS

    cfg = VLMConfig.from_config_dict(config)
    params = init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for ab in params["lora"].values():
        ab["b"] = (torch.randn(ab["b"].shape, generator=gen, device=dev)
                   * 0.01).to(torch.bfloat16)
    layers = params["llama"]["layers"]
    for name in _QUANT_TARGETS:  # build_model's int8 base
        layers[name] = quantize_llama_layers({name: layers[name]},
                                             bits=8)[name]
    batch = parallel_batch(cfg)
    if mesh is not None:
        n = batch["input_ids"].shape[0] // mesh.dp
        batch = {k: v[mesh.data_index * n:(mesh.data_index + 1) * n]
                 for k, v in batch.items()}
    with tempfile.TemporaryDirectory(dir="build") as work:
        trainer = build_trainer(config, params, [batch], dev,
                                work_dir=work, mesh=mesh)
        del params
        if fault and mesh.rank == mesh.dp - 1:
            trainer.optimizer.reduce_grads = False

        def compared(p):
            return {"lora": {k: v for k, v in p["lora"].items()},
                    "pooler": {k: p["pooler"][k] for k in (
                        "query", "out_proj_w", "out_proj_b")}}

        def host(tree):
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree.detach().float().cpu().numpy().copy()

        full = trainer.params if mesh is None else gather_params(
            mesh, trainer.params)
        before = host(compared(full))
        _sync(dev)
        t0 = time.perf_counter()
        metrics = trainer._step_fn(trainer.params, trainer._put(batch))
        metrics = {k: float(v) for k, v in metrics.items()}
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        full = trainer.params if mesh is None else gather_params(
            mesh, trainer.params)
        after = host(compared(full))
        digest = hashlib.sha1()
        for t in trainer.optimizer.leaves:
            digest.update(t.detach().float().cpu().numpy().tobytes())
        # AdamW's first moments, (1 - b1) times the clipped gradient, leaf
        # by leaf in the single-rank layout (gathered over the data group)
        state = trainer.optimizer.state_dict()
        moments = None
        if mesh is None or mesh.rank == 0:
            moments = {p: t.detach().float().cpu().numpy() for p, t in zip(
                state["paths"], state["slots"][SLOTS[state["name"]][0]])}
    updates = {g: {k: {n: after[g][k][n] - before[g][k][n]
                       for n in after[g][k]}
                   if isinstance(after[g][k], dict)
                   else after[g][k] - before[g][k] for k in after[g]}
               for g in after}
    return {"metrics": metrics, "ms": ms, "updates": updates,
            "moments": moments, "digest": digest.hexdigest(),
            "valid_tokens": int((batch["labels"][:, 1:] != -100).sum())}


def check_collectives(mesh, dev):
    """The gloo collectives the port runs, on this device's tensors, over
    each axis of `mesh`: all_reduce (sum, max), all_gather, broadcast,
    broadcast_object_list."""
    import torch

    out = {}
    for axis in (mesh.data, mesh.model):
        if axis.size == 1:
            continue
        i = axis.index
        t = torch.full((3,), float(i + 1), device=dev)
        s = axis.all_reduce(t.clone())
        m = axis.all_reduce(t.clone(), "max")
        g = axis.all_gather(t[None], dim=0)
        b = axis.broadcast(torch.full((2,), float(7 + i), device=dev))
        o = axis.broadcast_object({"from": i})
        n = axis.size
        ok = (s.tolist() == [n * (n + 1) / 2] * 3 and m.tolist() == [n] * 3
              and g[:, 0].tolist() == [float(j + 1) for j in range(n)]
              and b.tolist() == [7.0, 7.0] and o == {"from": 0}
              and s.device == dev and g.device == dev)
        if not ok:
            raise AssertionError(f"gloo collectives on {dev} over "
                                 f"{axis.name}: {s}, {m}, {g}, {b}, {o}")
        out[axis.name] = "ok"
    return out


# -- phase 8 (c): context parallelism ----------------------------------------

# the ring's shapes: the decoder's width (H 32, D 128), B 2 of 8,192 rows
# (4,096 a rank at cp 2), causal, row 1 right-padded to CP_PAD_ROW; the
# tiny sizes are a rehearsal on the CPU
CP_RING = {"full": (2, 32, 8192, 128, 5000), "tiny": (2, 4, 64, 16, 40)}
CP_FAULTS = ("mask_stays", "owner_fixed")
# the context-parallel train step: one spliced sequence of this many rows
# (twice the reference's 2,048-token cap), the decoder cut to
# PARALLEL_LAYERS; held to cp = 1 by DP_METRIC_REL and DP_UPDATE_REL_L2
CP_TRAIN_ROWS = {"full": 4096, "tiny": 64}


def cp_config(tiny=False):
    """Config/multi_modal_stage1.yaml (the perceiver trains; its gradient
    crosses the whole decoder) at full widths with the decoder cut to
    PARALLEL_LAYERS layers and room for CP_TRAIN_ROWS positions."""
    from lhrs_bot_tpu_torch.core.config import load_yaml_config

    config = load_yaml_config("Config/multi_modal_stage1.yaml")
    config["rgb_vision"]["vit_name"] = None
    config["text"]["path"] = None
    rows = CP_TRAIN_ROWS["tiny" if tiny else "full"]
    config["text"].update(num_hidden_layers=PARALLEL_LAYERS,
                          max_position_embeddings=rows)
    if tiny:
        config["rgb_vision"]["arch"] = "vit_tiny"
        config["rgb_vision"]["attn_pooler"].update(
            num_query=12, num_attn_heads=2, num_layers=2)
        config["text"].update(vocab_size=256, hidden_size=128,
                              intermediate_size=256, num_attention_heads=4)
    return config


def _valid_rows(lens, seq_index, s_loc, dev):
    """(B, S_loc) bool: this chunk's rows that lie within each row's
    valid length."""
    import torch

    ids = seq_index * s_loc + torch.arange(s_loc, device=dev)
    return ids[None, :] < torch.as_tensor(lens, device=dev)[:, None]


def _off(got, ref, rows):
    """(elements past ATOL + RTOL * |ref|, max abs error) over the rows
    `rows` (B, S) of (B, H, S, D) tensors."""
    got, ref = got.float().transpose(1, 2)[rows], ref.float().transpose(
        1, 2)[rows]
    if not bool(got.isfinite().all()):
        raise AssertionError("non-finite ring output")
    err = (got - ref).abs()
    return int((err > ATOL + RTOL * ref.abs()).sum()), float(err.max())


def cp_ring(dev, mesh, tiny=False):
    """(a) The ring itself on this rank's chunks of seeded (B, H, S, D)
    bf16 q, k, v and dO (causal, row 1 right-padded): the K1 ring's output
    and its dQ / dK / dV against the plain ring's on the same rank (output
    on valid rows, gradients on every row, within ATOL + RTOL), each
    kernel's launches (rank + 1 each under the causal mask), the planted
    faults' elements past the bound, times of two ranks sharing the card
    (wall, synchronised) and the backward's run tables."""
    import torch

    from lhrs_bot_tpu_torch.ops import attention
    from lhrs_bot_tpu_torch.ops.ring_attention import ring_attention
    from lhrs_bot_tpu_torch.parallel.context import seq_chunk

    b, h, s, d, pad = CP_RING["tiny" if tiny else "full"]
    gen = torch.Generator(device=dev).manual_seed(19)
    whole = [torch.randn((b, h, s, d), generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(4)]
    q, k, v, do = (seq_chunk(t, mesh, 2).contiguous() for t in whole)
    del whole
    lens = [s, pad]
    mask = seq_chunk(_valid_rows(lens, 0, s, dev), mesh, 1).contiguous()
    rows = _valid_rows(lens, mesh.seq_index, s // mesh.cp, dev)
    counted = (attention.flash_attention_fwd,
               attention.flash_attention_bwd_dq,
               attention.flash_attention_bwd_dkv)

    def run(plain=False, fault=None, grad=True):
        args = [t.clone().requires_grad_(grad) for t in (q, k, v)]
        out = ring_attention(*args, mask, axis=mesh.seq, causal=True,
                             plain=plain, fault=fault)
        grads = (torch.autograd.grad(out, args, do) if grad else None)
        _sync(dev)
        return out.detach(), grads

    res = {"shape": [b, h, s, d], "cp": mesh.cp, "seq": mesh.seq_index,
           "valid_lengths": lens}
    run()  # warm: the first launches and the gloo pairs
    for w in counted:
        w.launches = 0
    t0 = time.perf_counter()
    out_k, g_k = run()
    res["fwd_bwd_ms"] = (time.perf_counter() - t0) * 1e3
    res["launches"] = {w.__name__: w.launches for w in counted}
    t0 = time.perf_counter()
    out_p, g_p = run(plain=True)
    res["plain_fwd_bwd_ms"] = (time.perf_counter() - t0) * 1e3
    res["out_off"], res["out_max_abs_err"] = _off(out_k, out_p, rows)
    every = torch.ones_like(rows)
    res["grads"] = {}
    for name, a, r in zip(("dq", "dk", "dv"), g_k, g_p):
        res["grads"][name] = dict(zip(("off", "max_abs_err"),
                                      _off(a, r, every)))
    res["faults"] = {f: dict(zip(("off", "max_abs_err"), _off(
        run(fault=f, grad=False)[0], out_p, rows))) for f in CP_FAULTS}
    t0 = time.perf_counter()
    run(grad=False)
    res["fwd_ms"] = (time.perf_counter() - t0) * 1e3
    if dev.type == "cuda":
        res["table_ms"] = cuda_ms(lambda: attention.bwd_tile_table(
            mask, None, b, s // mesh.cp, s // mesh.cp, True, dev))
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def cp_batch(cfg, tiny=False):
    """One seeded caption row whose spliced sequence is CP_TRAIN_ROWS
    long: the image marker at 1, every label after it valid."""
    rows = CP_TRAIN_ROWS["tiny" if tiny else "full"]
    rng = np.random.default_rng(91)
    n = rows - cfg.pooler.num_query + 1
    ids = rng.integers(3, cfg.llama.vocab_size, (1, n)).astype(np.int32)
    ids[0, 0], ids[0, 1] = cfg.llama.bos_token_id, -200
    labels = ids.copy()
    labels[0, :2] = -100
    size = cfg.vit.image_size
    return {"input_ids": ids, "labels": labels,
            "attention_mask": np.ones(ids.shape, bool),
            "images": rng.integers(0, 256, (1, size, size, 3)).astype(
                np.uint8)}


def cp_train(dev, config, mesh, fault=False, profile_dir=None, tiny=False):
    """(b) One stage-1 step (the recipe's optimizer and clipping at its lr)
    over `mesh` (a CpMesh; None: one rank, cp = 1) on `cp_batch` from
    seeded weights: the metrics, the step's ms and peak memory, the
    pooler's updates and first moments. `fault`: the seq-group gradient
    reduction skipped. `profile_dir`: then two more steps under
    `utils.profiler.ProfilerHook` (the trace's files and the card's
    memory stats)."""
    import types

    import torch

    from lhrs_bot_tpu_torch.core.convert import training_params_from_numpy
    from lhrs_bot_tpu_torch.models import VLMConfig, init_vlm_params
    from lhrs_bot_tpu_torch.models.vlm import trainable_mask
    from lhrs_bot_tpu_torch.train import build_optimizer, make_train_step
    from lhrs_bot_tpu_torch.train.optimizer import SLOTS
    from lhrs_bot_tpu_torch.utils import profiler

    cfg = VLMConfig.from_config_dict(config)
    params = training_params_from_numpy(
        init_vlm_params(cfg, seed=0, dtype=torch.bfloat16, device=dev), cfg,
        torch.bfloat16, dev)
    opt = build_optimizer(config, params, trainable_mask(params, cfg))
    step = make_train_step(cfg, opt, torch.bfloat16, cp_mesh=mesh)
    if mesh is not None:
        mesh.reduce_seq = not fault
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in cp_batch(cfg, tiny).items()}

    def pooler():
        return {k: v.detach().float().cpu().numpy().copy()
                for k, v in tree_paths(params["pooler"])}

    before = pooler()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _sync(dev)
    t0 = time.perf_counter()
    metrics = {k: float(v) for k, v in step(params, batch).items()}
    _sync(dev)
    out = {"metrics": metrics, "ms": (time.perf_counter() - t0) * 1e3,
           "rows": int(batch["input_ids"].shape[1])
           + cfg.pooler.num_query - 1}
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    after = pooler()
    out["updates"] = {k: after[k] - before[k] for k in after}
    state = opt.state_dict()
    out["moments"] = {p: t.detach().float().cpu().numpy() for p, t in zip(
        state["paths"], state["slots"][SLOTS[state["name"]][0]])}
    if mesh is not None:
        mesh.reduce_seq = True
    if profile_dir is not None:
        hook = profiler.ProfilerHook(profile_dir, start_step=1, num_steps=2)
        hook.trainer = types.SimpleNamespace(cur_iter=0)
        for it in (1, 2):
            hook.trainer.cur_iter = it
            if mesh is None or mesh.rank == 0:
                hook.before_iter()
            step(params, batch)
            if mesh is None or mesh.rank == 0:
                hook.after_iter()
        stats = profiler.device_memory_stats()
        out["profile"] = {
            "traces": [os.path.getsize(p) for p in hook.paths],
            "memory_stats": {k: v.get("allocated_bytes.all.peak")
                             for k, v in stats.items()}}
    return out


def cp_worker(dev, tiny):
    """The cp job of a rank: the ring (a) and the train step (b), its
    planted fault, and on rank 0 the profiler (d) over two more steps."""
    import shutil
    import tempfile

    import torch

    from lhrs_bot_tpu_torch.parallel.context import make_cp_mesh

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mesh = make_cp_mesh()
    t0 = time.perf_counter()
    out = {"ring": cp_ring(dev, mesh, tiny)}
    out["ring_s"] = time.perf_counter() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    config = cp_config(tiny)
    trace_dir = tempfile.mkdtemp(prefix="cp_trace_", dir="build")
    t0 = time.perf_counter()
    try:
        out["train"] = cp_train(dev, config, mesh, profile_dir=trace_dir,
                                tiny=tiny)
        gc.collect()
        out["train_fault"] = cp_train(dev, config, mesh, fault=True,
                                      tiny=tiny)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    out["train_s"] = time.perf_counter() - t0
    return out


def hold_cp(ranks, ref, dev):
    """Phase 8 (c) held: the ring's readings on every rank and the train
    step's against cp = 1 (`ref`). Returns the readings."""
    n = len(ranks)
    rings = [r["cp"]["ring"] for r in ranks]
    for r, ring in enumerate(rings):
        want = r + 1 if dev.type == "cuda" else 0  # rank r: r + 1 blocks
        if dev.type == "cuda" and any(v != want
                                      for v in ring["launches"].values()):
            raise AssertionError(f"cp ring rank {r}: launches "
                                 f"{ring['launches']}, want {want} each")
        if ring["out_off"]:
            raise AssertionError(f"cp ring rank {r}: {ring['out_off']} "
                                 "output elements past the bound")
        for g, reading in ring["grads"].items():
            if reading["off"]:
                raise AssertionError(f"cp ring rank {r}: {g} "
                                     f"{reading['off']} elements past the "
                                     "bound")
    for f in CP_FAULTS:
        if not any(ring["faults"][f]["off"] for ring in rings):
            raise AssertionError(f"cp ring: the planted fault {f} passes")
    tr = [r["cp"]["train"] for r in ranks]
    m_ref = ref["metrics"]
    reading = {"ring": rings, "ref_ms": ref["ms"],
               "ref_peak_gib": ref.get("peak_gib"),
               "ms": [t["ms"] for t in tr],
               "peak_gib": [t.get("peak_gib") for t in tr],
               "metrics": [t["metrics"] for t in tr], "ref": m_ref,
               "rows": ref["rows"], "profile": tr[0].get("profile"),
               "bounds": [DP_METRIC_REL, DP_UPDATE_REL_L2]}
    for k in ("total_loss", "grad_norm"):
        rel = abs(tr[0]["metrics"][k] - m_ref[k]) / abs(m_ref[k])
        reading[f"{k}_rel"] = rel
        if rel > DP_METRIC_REL or any(t["metrics"][k] != tr[0]["metrics"][k]
                                      for t in tr):
            raise AssertionError(f"cp {n} {k}: {[t['metrics'][k] for t in tr]}"
                                 f" vs {m_ref[k]}")
    reading["update_rel_l2"] = [_tree_rel(t["updates"], ref["updates"])
                                for t in tr]
    reading["fault_update_rel_l2"] = [
        _tree_rel(r["cp"]["train_fault"]["updates"], ref["updates"])
        for r in ranks]
    reading["moment_rel_l2"] = _leaf_summary(
        {p: _rel(tr[0]["moments"][p], ref["moments"][p])
         for p in ref["moments"] if p not in DP_ZERO_GRAD_LEAVES},
        DP_MOMENT_REL_L2)
    if max(reading["update_rel_l2"]) > DP_UPDATE_REL_L2:
        raise AssertionError(f"cp {n} updates: {reading['update_rel_l2']}")
    if max(reading["fault_update_rel_l2"]) <= DP_UPDATE_REL_L2:
        raise AssertionError(f"cp {n}: the skipped seq reduction passes: "
                             f"{reading['fault_update_rel_l2']}")
    prof = reading["profile"]
    if not prof or len(prof["traces"]) != 1 or not prof["traces"][0]:
        raise AssertionError(f"cp {n}: the profiler wrote no trace: {prof}")
    if dev.type == "cuda" and not any(prof["memory_stats"].values()):
        raise AssertionError("device_memory_stats reports no card")
    return reading


# -- phase 8 (d): ViT-B/16, float pixels, the in_proj perceiver --------------

# float pixel values against uint8 through the same normalisation, the
# ViT-B/16 embedding (patches, CLS, positions) in bf16: the two paths
# differ only in the patch product's summation order (cuBLAS bf16 against
# float32 sums of the same bf16 operands), at most a bf16 step an element;
# the H and W axes swapped (planted) moves them O(1). Through the 10-layer
# tower that step grows to bf16's noise (6.5e-3 on an H100 at 700 W, as
# the K1 tower against the plain attention), so the tower is not held
VIT_PIXEL_REL_L2 = 1e-2


def vit_base_params(dev, cfg, seed):
    """Seeded float32 ViT parameters of `cfg` (weights N(0, 0.02),
    LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.02))."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    w, f, n = cfg.width, cfg.width * cfg.mlp_ratio, cfg.layers

    def rand(*shape, scale=0.02, mean=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + mean

    layers = {"ln1_scale": rand(n, w, scale=0.1, mean=1.0),
              "ln1_bias": rand(n, w), "wq": rand(n, w, w), "bq": rand(n, w),
              "wk": rand(n, w, w), "bk": rand(n, w), "wv": rand(n, w, w),
              "bv": rand(n, w), "wo": rand(n, w, w), "bo": rand(n, w),
              "ln2_scale": rand(n, w, scale=0.1, mean=1.0),
              "ln2_bias": rand(n, w), "w_fc": rand(n, w, f),
              "b_fc": rand(n, f), "w_proj": rand(n, f, w),
              "b_proj": rand(n, w)}
    return {"patch_proj": rand(cfg.patch_size ** 2 * 3, w),
            "class_emb": rand(w), "pos_emb": rand(cfg.seq_len, w),
            "pre_ln": {"scale": torch.ones(w, device=dev),
                       "bias": torch.zeros(w, device=dev)},
            "layers": layers}


def vit_base_checks(dev, tiny=False, n_img=8):
    """ViT-B/16 at full width on 224² images: the bf16 tower on K1 against
    its plain attention, the fused W8A8 tower against the bf16 one (a
    block skipped must fail), float NCHW pixel values against uint8
    through the same normalisation (the embeddings held; H and W swapped
    must fail; the tower's features read), and a
    perceiver with an in_proj (768 -> 1024, 144 queries, 6 layers) over
    the tower's features, fused against its plain version (the in_proj's
    input rows rolled must fail), and the recipe's own bf16 perceiver (768
    wide, 16 heads: D 48, which K1 runs zero-padded to 64) against the
    plain attention; each part's launches."""
    import dataclasses

    import torch

    import lhrs_bot_tpu_torch.models.perceiver as perceiver
    import lhrs_bot_tpu_torch.models.vit as vit
    from lhrs_bot_tpu_torch.models.perceiver import (
        PerceiverConfig, perceiver_resample, perceiver_resample_fused)
    from lhrs_bot_tpu_torch.models.vlm import VLMConfig, param_specs
    from lhrs_bot_tpu_torch.models.vlm import draw_param
    from lhrs_bot_tpu_torch.ops.patch_embed import CLIP_MEAN, CLIP_STD
    from lhrs_bot_tpu_torch.ops.perceiver_block import \
        pack_perceiver_layers_fused
    from lhrs_bot_tpu_torch.ops.vit_block import pack_vit_layers_fused

    cfg = vit.ViTConfig.vit_base()
    if tiny:
        cfg = dataclasses.replace(cfg, layers=2, extract_stages=(1, 2, 2))
        n_img = 2
    wrappers = kernel_wrappers()
    p32 = vit_base_params(dev, cfg, seed=23)
    bf16 = {**{k: v.to(torch.bfloat16) for k, v in p32.items()
               if k not in ("pre_ln", "layers")}, "pre_ln": p32["pre_ln"],
            "layers": {k: v.to(torch.bfloat16)
                       for k, v in p32["layers"].items()}}
    packed = pack_vit_layers_fused(p32["layers"])
    gen = torch.Generator(device=dev).manual_seed(29)
    images = torch.randint(0, 256, (n_img, 224, 224, 3), generator=gen,
                           device=dev, dtype=torch.uint8)

    def rel(a, ref):
        return float((a.float() - ref.float()).norm() / ref.float().norm())

    def counted(fn):
        set_launches(wrappers)
        out = fn()
        _sync(dev)
        return out, {k: v for k, v in read_launches(wrappers).items() if v}

    out = {"images": n_img, "layers": cfg.extract_stages[-1]}
    with torch.no_grad():
        tower, out["tower_launches"] = counted(
            lambda: vit.vit_encode(bf16, images, cfg))
        with patched(vit, flash_attention=plain_flash):
            plain = vit.vit_encode(bf16, images, cfg)
        out["tower_vs_plain_rel_l2"] = rel(tower, plain)
        fused, out["fused_launches"] = counted(
            lambda: vit.vit_encode_fused(bf16, packed, images, cfg))
        out["fused_vs_bf16_rel_l2"] = rel(fused, tower)
        faulty = dict(packed)
        for k in ("wo", "bo", "w_proj", "b_proj"):
            faulty[k] = packed[k].clone()
            faulty[k][0] = 0
        out["fused_fault_rel_l2"] = rel(
            vit.vit_encode_fused(bf16, faulty, images, cfg), tower)
        del faulty
        mean = torch.tensor(CLIP_MEAN, device=dev)
        std = torch.tensor(CLIP_STD, device=dev)
        pv = (images.float() / 255.0 - mean) / std
        embed = vit.vit_embed(bf16, images, cfg, torch.bfloat16)
        out["pixels_rel_l2"] = rel(vit.vit_embed(
            bf16, pv.permute(0, 3, 1, 2).contiguous(), cfg, torch.bfloat16),
            embed)
        out["pixels_fault_rel_l2"] = rel(vit.vit_embed(
            bf16, pv.permute(0, 3, 2, 1).contiguous(), cfg, torch.bfloat16),
            embed)
        out["pixels_tower_rel_l2"] = rel(vit.vit_encode(
            bf16, pv.permute(0, 3, 1, 2).contiguous(), cfg), tower)
        pcfg = PerceiverConfig(
            num_query=144, num_layers=6, heads=16, hidden_size=1024,
            encoder_hidden_size=cfg.width, output_size=4096,
            stage_num=(64, 48, 32), split_part=(cfg.num_patches,) * 3)
        if tiny:
            pcfg = dataclasses.replace(pcfg, num_layers=2, hidden_size=128,
                                       heads=2, output_size=64)
        specs = param_specs(VLMConfig(vit=cfg, pooler=pcfg))["pooler"]
        pp = {k: draw_param(v, f"pooler/{k}", 31, torch.float32, dev)
              for k, v in specs.items() if k != "layers"}
        pp["layers"] = {k: draw_param(v, f"pooler/layers/{k}", 31,
                                      torch.float32, dev)
                        for k, v in specs["layers"].items()}
        pl = pack_perceiver_layers_fused(pp["layers"])
        got, out["perceiver_launches"] = counted(
            lambda: perceiver_resample_fused(pp, pl, tower, pcfg))
        ref = perceiver_resample_fused(pp, pl, tower, pcfg, plain=True)
        out["in_proj_fused_vs_plain_rel_l2"] = rel(got, ref)
        rolled = {**pp, "in_proj_w": pp["in_proj_w"].roll(1, dims=0)}
        out["in_proj_fault_rel_l2"] = rel(
            perceiver_resample_fused(rolled, pl, tower, pcfg), ref)
        # the vit_base recipe's own perceiver: 768 wide with the YAML's 16
        # heads, D 48, which K1 runs zero-padded to 64
        bcfg = dataclasses.replace(pcfg, hidden_size=cfg.width)
        if tiny:
            bcfg = dataclasses.replace(bcfg, heads=16, num_layers=2)
        specs = param_specs(VLMConfig(vit=cfg, pooler=bcfg))["pooler"]
        bp = {k: draw_param(v, f"pooler/{k}", 37, torch.bfloat16, dev)
              for k, v in specs.items() if k != "layers"}
        bp["layers"] = {k: draw_param(v, f"pooler/layers/{k}", 37,
                                      torch.bfloat16, dev)
                        for k, v in specs["layers"].items()}
        got, out["d48_launches"] = counted(
            lambda: perceiver_resample(bp, tower, bcfg))
        with patched(perceiver, flash_attention=plain_flash):
            ref = perceiver_resample(bp, tower, bcfg)
        out["d48_perceiver_vs_plain_rel_l2"] = rel(got, ref)
    checks = (("tower_vs_plain_rel_l2", TOWER_REL_L2, None),
              ("fused_vs_bf16_rel_l2", TOWER_REL_L2, "fused_fault_rel_l2"),
              ("pixels_rel_l2", VIT_PIXEL_REL_L2, "pixels_fault_rel_l2"),
              ("in_proj_fused_vs_plain_rel_l2", TOWER_REL_L2,
               "in_proj_fault_rel_l2"),
              ("d48_perceiver_vs_plain_rel_l2", TOWER_REL_L2, None))
    for key, bound, fault in checks:
        if not out[key] <= bound:
            raise AssertionError(f"vit_base {key} {out[key]} > {bound}")
        if fault and out[fault] <= bound:
            raise AssertionError(f"vit_base {fault} passes: {out[fault]}")
    if dev.type == "cuda":
        for key, need in (("tower_launches", ("flash_attention_fwd",)),
                          ("fused_launches",
                           ("ln_quant", "int8_gemm",
                            "flash_attention_fwd_normalized")),
                          ("perceiver_launches",
                           ("ln_quant", "int8_gemm",
                            "flash_attention_fwd_normalized")),
                          ("d48_launches", ("flash_attention_fwd",))):
            if any(not out[key].get(k) for k in need):
                raise AssertionError(f"vit_base {key}: {out[key]}")
    del packed, bf16, p32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# the decode batches of the phase's requests, at which each rank's W4A8
# products are held to the single rank's (`check_tp_w4a8`)
TP_W4A8_BATCHES = (1, 2)


def check_tp_w4a8(dev, mesh, config):
    """Each rank's W4A8 decode products at its per-rank shapes against the
    single rank's, on the same seeded whole weights (int4 halves, 2
    layers, layer 1 used) and bf16 rows, every rank taking its slice with
    `partition.shard_quantized`: q / gate (column slices, K3 mode (b))
    must equal their columns of the whole `w4a8_project` bit for bit; o /
    down (row slices, K = hidden and intermediate): `row_parallel_codes`
    must equal kernel A's codes and scale of the whole row (each row's
    maximum is planted in one rank's slice, so the others take it from
    the all-reduce), and `w4a8_project_row`
    (K3 mode (a) with unit scales, the sums all-reduced, the epilogue) the
    whole `w4a8_project` and the plain product of the whole operands, bit
    for bit. The planted fault: the last rank's mode (a) launch, in a
    cluster of 8, leaves out its last CTA's sums (at most 128 packed
    rows), which must change the product. On the card each per-rank product is also timed on rank
    0 while the others wait. Returns the readings: the phase raises on
    them, so no rank is left waiting in a collective."""
    import torch

    from lhrs_bot_tpu_torch.ops import w4_matmul
    from lhrs_bot_tpu_torch.ops.ln_quant import ln_quant_plain
    from lhrs_bot_tpu_torch.ops.quant import (QuantizedTensor,
                                              quantize_activation)
    from lhrs_bot_tpu_torch.parallel import distribute
    from lhrs_bot_tpu_torch.parallel.partition import shard_quantized

    axis, tp = mesh.model, mesh.tp
    h = int(config["text"]["hidden_size"])
    f = int(config["text"]["intermediate_size"])
    shapes = (("wq", h, h, -1), ("w_gate", h, f, -1),
              ("wo", h, h, -2), ("w_down", f, h, -2))
    gen = torch.Generator(device=dev).manual_seed(18)
    cuda = dev.type == "cuda"
    rows = []
    for name, k, n, split in shapes:
        whole = QuantizedTensor(
            torch.randint(-128, 128, (2, k // 2, n), generator=gen,
                          device=dev, dtype=torch.int8),
            torch.rand(2, 1, n, generator=gen, device=dev) * 4e-3 + 1e-3,
            "4h")
        local = shard_quantized(whole, split, axis)
        for b in TP_W4A8_BATCHES:
            x = torch.randn(b, k, generator=gen, device=dev).to(
                torch.bfloat16)
            lo, hi = axis.index * k // tp, (axis.index + 1) * k // tp
            for r in range(b):  # row r's maximum in rank (r + 1) % tp's
                x[r, ((r + 1) % tp) * (k // tp) + 3] = 40.0 * (-1) ** r
            ref = w4_matmul.w4a8_project(x[None], whole, 1)[0]
            xq, xs = ln_quant_plain(x)
            plain = w4_matmul.w4a8_matmul_plain(
                xq[:, :k // 2], xq[:, k // 2:], xs, whole.q, whole.scale, 1)
            row = {"name": name, "K": k, "N": n, "B": b,
                   "split": "columns" if split == -1 else "rows",
                   "K2_local": local.q.shape[1], "N_local": local.q.shape[2]}
            if split == -1:
                cols = slice(axis.index * n // tp, (axis.index + 1) * n // tp)
                got = w4_matmul.w4a8_project(x[None], local, 1)[0]
                ref, plain = ref[:, cols], plain[:, cols]
            else:
                codes, scale = w4_matmul.row_parallel_codes(x[:, lo:hi], axis)
                aq, as_ = quantize_activation(x)  # kernel A on the card
                row["codes_equal"] = bool(torch.equal(codes, aq[:, lo:hi])
                                          and torch.equal(scale, as_))
                got = w4_matmul.w4a8_project_row(x[:, lo:hi][None], local, 1,
                                                 axis)[0]
                if cuda:
                    stacked = w4_matmul.w4a8_matmul_stacked
                    last = axis.index == tp - 1

                    def faulty(lo_, hi_, xs_, w, ws, layer, out_dtype):
                        return w4_matmul.w4a8_matmul_kernel(
                            lo_, hi_, xs_, w, ws, layer, out_dtype,
                            cluster=8,
                            fault=w4_matmul.FAULT_PEER_SUMS if last else 0)

                    w4_matmul.w4a8_matmul_stacked = faulty
                    try:
                        bad = w4_matmul.w4a8_project_row(
                            x[:, lo:hi][None], local, 1, axis)[0]
                    finally:
                        w4_matmul.w4a8_matmul_stacked = stacked
                    row["fault_differs"] = not torch.equal(bad, ref)
                    row["fault_rel_l2"] = _rel(bad.float().cpu(),
                                               ref.float().cpu())
            row["equal"] = bool(torch.equal(got, ref))
            row["plain_equal"] = bool(torch.equal(got, plain))
            row["max_abs_err"] = float((got.float() - ref.float()).abs()
                                       .max())
            if cuda:  # each rank's product alone on the card
                distribute.barrier()
                if mesh.rank == 0:
                    row.update(time_tp_w4a8(x, whole, local, split,
                                            codes if split == -2 else None))
                distribute.barrier()
            rows.append(row)
    return rows


def time_tp_w4a8(x, whole, local, split, codes):
    """The card's time of one rank's W4A8 product (a column slice's fused
    mode (b) launch; a row slice's mode (a) launch on its codes, unit
    scales, float32 sums) beside the single rank's whole product, and the
    per-rank launch's bound."""
    import torch

    from lhrs_bot_tpu_torch.ops import w4_matmul

    b = x.shape[0]
    k2, n = local.q.shape[1], local.q.shape[2]
    if split == -1:
        ms = cuda_ms(lambda: w4_matmul.w4a8_project_kernel(
            x, local.q, local.scale, 1))
        io = 2 * b * 2 * k2 + 2 * b * n  # bf16 rows in, bf16 out
    else:
        ones_x = torch.ones(b, 1, device=x.device)
        ones_w = torch.ones_like(local.scale)
        ms = cuda_ms(lambda: w4_matmul.w4a8_matmul_kernel(
            codes[:, :k2], codes[:, k2:], ones_x, local.q, ones_w, 1,
            torch.float32))
        io = b * 2 * k2 + 4 * b + 4 * b * n  # int8 codes in, f32 sums out
    bound_ms, by = bound(k2 * n + 4 * n + io, 2.0 * b * 2 * k2 * n, "int8")
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": by,
            "tp1_ms": cuda_ms(lambda: w4_matmul.w4a8_project_kernel(
                x, whole.q, whole.scale, 1))}


def hold_tp_w4a8(ranks, cuda):
    """`check_tp_w4a8`'s readings of every rank: raises unless each is
    bit for bit, the codes equal and (on the card) the fault differs."""
    for r, rank in enumerate(ranks):
        for row in rank["w4a8_shapes"]:
            what = f"rank {r} {row['name']} B{row['B']}"
            if not (row["equal"] and row["plain_equal"]):
                raise AssertionError(f"{what}: the per-rank W4A8 product "
                                     "differs from the single rank's "
                                     f"({row})")
            if row["split"] == "rows":
                if not row["codes_equal"]:
                    raise AssertionError(f"{what}: the row-parallel codes "
                                         "differ from kernel A's")
                if cuda and not row["fault_differs"]:
                    raise AssertionError(f"{what}: a CTA's sums left out "
                                         "of the mode (a) launch passes")


def parallel_worker(workdir):
    """One of the phase's N ranks (`chip_smoke.py --parallel-worker DIR`,
    started by `phase_parallel` with torchrun's environment): the spec's
    backend (gloo: every rank on cuda:0; nccl: a card a rank), the
    collectives checked, then `tp_serve` over a dp 1 x tp N mesh and
    `dp_train` over a dp N x tp 1 mesh (and with the planted fault); the
    results pickled to DIR/rank<r>.pkl."""
    import pickle

    import torch

    from lhrs_bot_tpu_torch.parallel import distribute, make_mesh

    with open(os.path.join(workdir, "spec.json")) as fh:
        spec = json.load(fh)
    distribute.init_distributed(spec["backend"])
    n = distribute.get_world_size()
    if spec["device"] == "cuda":
        from lhrs_bot_tpu_torch.ops import cuda_lib

        cuda_lib.load_library()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    rank = distribute.get_rank()
    serving, train = parallel_configs(spec["tiny"])
    wrappers = kernel_wrappers()
    t0 = time.perf_counter()
    tp_mesh = make_mesh(dp=1, tp=n)
    dp_mesh = make_mesh(dp=n, tp=1)
    out = {"device": str(dev),
           "collectives": {**check_collectives(tp_mesh, dev),
                           **check_collectives(dp_mesh, dev)}}
    out["serve"] = tp_serve(dev, serving, tp_mesh, wrappers, spec["tiny"])
    out["serve_s"] = time.perf_counter() - t0
    # serving over a data axis: dp 2 (x tp n / 2 on more ranks)
    t0 = time.perf_counter()
    out["dp_serve"] = dp_serve(dev, serving, make_mesh(dp=2, tp=n // 2),
                               wrappers, spec["tiny"])
    out["dp_serve_s"] = time.perf_counter() - t0
    out["w4a8_shapes"] = check_tp_w4a8(dev, tp_mesh, serving)
    t0 = time.perf_counter()
    out["train"] = dp_train(dev, train, dp_mesh)
    out["train_fault"] = dp_train(dev, train, dp_mesh, fault=True)
    out["train_s"] = time.perf_counter() - t0
    out["cp"] = cp_worker(dev, spec["tiny"])
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    distribute.barrier()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(args, n=2, timeout=PARALLEL_TIMEOUT, env_extra=None):
    """`n` processes of `sys.executable args` with torchrun's environment
    (one port on localhost); every one is killed at `timeout` seconds.
    Returns (exit codes, the end of each one's output)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE")}
    here = os.path.dirname(os.path.abspath(__file__))
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               PYTHONPATH=here, **(env_extra or {}))
    procs = [subprocess.Popen([sys.executable] + list(args), cwd=here,
                              env={**env, "RANK": str(r),
                                   "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    deadline = time.time() + timeout
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=max(1.0, deadline -
                                                  time.time()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0] + "\n[killed at the timeout]")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return [p.returncode for p in procs], [o[-3000:] for o in outs]


def nccl_probe(mode):
    """`chip_smoke.py --nccl-probe port|torch`: two ranks of NCCL on the
    one card. "port": the port's init_distributed("nccl"), which must
    refuse (one card, two local ranks); "torch": torch's own NCCL group
    with both ranks on cuda:0 and an all_reduce."""
    import torch
    import torch.distributed as dist

    if mode == "port":
        from lhrs_bot_tpu_torch.parallel import distribute

        distribute.init_distributed("nccl")
        print("init_distributed('nccl') joined", flush=True)
        return
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://")
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(f"torch nccl all_reduce on one card: {t.tolist()}", flush=True)
    dist.destroy_process_group()


def gloo_p2p_probe():
    """`chip_smoke.py --gloo-p2p-probe`: two gloo ranks on cuda:0 pass a
    CUDA tensor to each other with batch_isend_irecv, as `Axis.shift`
    would without its host staging; prints what gloo does with it."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    r = dist.get_rank()
    t = torch.full((4,), float(r + 1), device="cuda")
    got = torch.empty_like(t)
    try:
        for req in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, t, 1 - r),
                 dist.P2POp(dist.irecv, got, 1 - r)]):
            req.wait()
        torch.cuda.synchronize()
        print(f"gloo p2p on CUDA tensors: rank {r} got {got.tolist()}",
              flush=True)
    except RuntimeError as exc:
        print(f"gloo p2p on CUDA tensors refused: {str(exc)[:160]}",
              flush=True)


def _first_divergence(ref_ids, got_ids):
    """(row, step) of the first token where two id lists part, or None."""
    for r, (a, b) in enumerate(zip(ref_ids, got_ids)):
        for j in range(min(len(a), len(b))):
            if a[j] != b[j]:
                return r, j
        if len(a) != len(b):
            return r, min(len(a), len(b))
    return None


def hold_tp_ids(name, ref, got, bound):
    """Greedy ids of a tp = 2 rank against tp = 1: equal, or parting at a
    step where tp = 1's top-2 margin lies within the two runs' largest
    logit deviation there (bf16 rounding may flip such a step). Returns
    the reading at the first parting step, or None."""
    part = _first_divergence(ref["ids"], got["ids"])
    if part is None:
        return None
    r, j = part
    logits = [ref["first"], got["first"]] if j == 0 else [
        ref["steps"][j - 1], got["steps"][j - 1]]
    a, b = (np.asarray(x[r], np.float64) for x in logits)
    top2 = np.sort(a)[-2:]
    margin = float(top2[1] - top2[0])
    dev = float(np.abs(a - b).max())
    if margin > dev:
        raise AssertionError(f"{name}: tp 2 ids part from tp 1's at row "
                             f"{r} step {j}, where tp 1's top-2 margin "
                             f"{margin:.4f} exceeds the deviation {dev:.4f}")
    return {"row": r, "step": j, "margin": margin, "max_abs_dev": dev}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree_rel(got, ref):
    """Relative L2 of two trees of arrays, over all their elements."""
    def flat(t):
        if isinstance(t, dict):
            return np.concatenate([flat(t[k]) for k in sorted(t)])
        return np.asarray(t, np.float64).reshape(-1)

    return _rel(flat(got), flat(ref))


def _leaf_summary(rels, bound):
    """A {leaf: relative L2} reading in brief: the leaves, the largest and
    its leaf, the median, and how many lie above `bound`."""
    worst = max(rels, key=rels.get)
    return {"leaves": len(rels), "max": rels[worst], "max_leaf": worst,
            "median": float(np.median(list(rels.values()))),
            "above_bound": sum(v > bound for v in rels.values())}


def phase_parallel(dev, tiny=False, backend="gloo", n=2):
    """Phase 8: data and tensor parallelism, two ranks sharing the one
    card over gloo (`parallel_worker`; `backend` "nccl" with `n` ranks
    puts each rank on a card of its own, for `--parallel-only` on a
    machine of n cards), held to one rank here on the same seeded
    weights: (a) tp = 2 serving through the bf16 engine and the
    W4A8 + int8 KV + int8 lm_head recipe (the first token's logits within
    TP_REL_L2, the ids by `hold_tp_ids`, the ranks' ids and logits
    equal, each rank's K1, K2 / K4, K3 (its mode (a) too) and A launches,
    the packed-axis fault past the bound; each rank's W4A8 products by
    `hold_tp_w4a8`); (b) a dp = 2 stage-2 step with ZeRO against dp = 1
    on the same global batch (loss and grad_norm within DP_METRIC_REL,
    the first moments leaf by leaf within DP_MOMENT_REL_L2, the updates
    within DP_UPDATE_REL_L2, every trainable leaf equal on both ranks, the
    skipped gradient reduction past both bounds); NCCL's handling of two ranks on one card. A rank that
    fails fails the phase. Times are two ranks sharing one card."""
    import pickle
    import shutil
    import tempfile

    import torch

    t_phase = time.time()
    serving, train = parallel_configs(tiny)
    wrappers = kernel_wrappers()
    t0 = time.time()
    ref_serve = tp_serve(dev, serving, None, wrappers, tiny)
    ref_dp = dp_serve(dev, serving, None, wrappers, tiny)
    ref_train = dp_train(dev, train, None)
    ref_s = time.time() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.time()
    ref_cp = cp_train(dev, cp_config(tiny), None, tiny=tiny)
    ref_cp_s = time.time() - t0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="parallel_", dir="build")
    try:
        with open(os.path.join(work, "spec.json"), "w") as fh:
            json.dump({"device": dev.type, "tiny": tiny,
                       "backend": backend}, fh)
        t0 = time.time()
        codes, logs = run_ranks([os.path.abspath(__file__),
                                 "--parallel-worker", work], n=n)
        ranks_s = time.time() - t0
        if codes != [0] * n:
            raise AssertionError(f"parallel ranks exited {codes}:\n"
                                 + "\n----\n".join(logs))
        ranks = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as fh:
                ranks.append(pickle.load(fh))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"ranks": n, "backend": backend, "ref_s": ref_s,
           "ranks_s": ranks_s,
           "collectives": ranks[0]["collectives"],
           "serve_s": [r["serve_s"] for r in ranks],
           "train_s": [r["train_s"] for r in ranks],
           "peak_gib": [r.get("peak_gib") for r in ranks]}
    # (a) tp = 2 serving
    for name, _, needed in PARALLEL_RECIPES:
        ref = ref_serve[name]
        bound = TP_REL_L2[name]
        reading = {"bound": bound, "rel_l2": [], "parted": [], "ms": [],
                   "ref_ms": [q["ms"] for q in ref["requests"]],
                   "launches": [r["serve"][name]["launches"]
                                for r in ranks],
                   "ref_launches": ref["launches"]}
        for q_ref, q0, *qs in zip(ref["requests"],
                                  *(r["serve"][name]["requests"]
                                    for r in ranks)):
            if any(q["ids"] != q0["ids"] or not np.array_equal(
                    q["first"], q0["first"]) for q in qs):
                raise AssertionError(f"tp {name} {q0['request']}: the "
                                     "ranks' ids or logits differ")
            rel = [_rel(a, b) for a, b in zip(q0["first"], q_ref["first"])]
            reading["rel_l2"].append(rel)
            reading["ms"].append([q["ms"] for q in [q0] + qs])
            if max(rel) > bound:
                raise AssertionError(f"tp {name} {q0['request']}: first "
                                     f"logits rel L2 {rel} > {bound}")
            reading["parted"].append(hold_tp_ids(
                f"tp {name} {q0['request']}", q_ref, q0, bound))
        for r, rank in enumerate(ranks):
            launches = rank["serve"][name]["launches"]
            for k in needed if dev.type == "cuda" else ():
                if launches[k] <= 0:
                    raise AssertionError(f"tp {name}: rank {r} launched no "
                                         f"{k}")
            if (name == "w4a8" and dev.type == "cuda"
                    and launches["w4a8_matmul_mode_a"] <= 0):
                raise AssertionError("tp w4a8: K3's mode (a) (the row-"
                                     "parallel products) never launched")
        if "fault_first" in ranks[0]["serve"][name]:
            fault = [_rel(a, b) for a, b in zip(
                ranks[0]["serve"][name]["fault_first"],
                ref["requests"][0]["first"])]
            reading["packed_axis_fault_rel_l2"] = fault
            if min(fault) <= bound:
                raise AssertionError(f"tp {name}: the packed-axis fault "
                                     f"passes ({fault} <= {bound})")
        out[f"tp_{name}"] = reading
        log(f"  tp {n} {name}: first logits rel L2 {reading['rel_l2']} "
            f"(bound {bound}), ids parted {reading['parted']}, packed-axis "
            f"fault {reading.get('packed_axis_fault_rel_l2')}; generate "
            f"ms (a rank each) {reading['ms']} vs one rank "
            f"{reading['ref_ms']}; launches a rank {reading['launches']} "
            f"vs one rank {ref['launches']}")
    # each rank's W4A8 products at its shapes against the single rank's
    hold_tp_w4a8(ranks, dev.type == "cuda")
    out["tp_w4a8_products"] = ranks[0]["w4a8_shapes"]
    out["tp_w4a8_faults"] = [row.get("fault_rel_l2") for rank in ranks
                             for row in rank["w4a8_shapes"]
                             if row["split"] == "rows"]
    log(f"  tp {n} W4A8 products a rank (rank 0; bit for bit the single "
        f"rank's, codes kernel A's): "
        + "; ".join(f"{r['name']} B{r['B']} K/2 {r['K2_local']} N "
                    f"{r['N_local']} {r.get('ms')} ms (tp 1 "
                    f"{r.get('tp1_ms')}, bound {r.get('bound_ms')})"
                    for r in ranks[0]["w4a8_shapes"])
        + f"; mode (a) fault rel L2 {out['tp_w4a8_faults']}")
    # (d) serving over a data axis: dp 2 (x tp n / 2)
    dps = out["dp_serve"] = hold_dp(ranks, ref_dp, 2)
    out["dp_serve_s"] = [r["dp_serve_s"] for r in ranks]
    for name, rd in dps.items():
        log(f"  dp 2 x tp {n // 2} {name}: engine (batch of 2, a row a "
            f"group) and a {len(DP_WAVE)}-request wave over {DP_SLOTS} "
            f"slots ({DP_SLOTS // 2} a group) vs one rank: first-token "
            f"logits rel L2 {rd['engine']['max_first_rel_l2']:.4f} / "
            f"{rd['wave']['max_first_rel_l2']:.4f} (bound {rd['bound']}; "
            f"every position up to a parting "
            f"{rd['engine']['max_rel_l2']:.4f} / "
            f"{rd['wave']['max_rel_l2']:.4f}), ids "
            f"parted {rd['engine']['partings']} / {rd['wave']['partings']}"
            f"; one rank, a row alone vs in the batch of 2: tower "
            f"{rd['invariance']['tower']:.2e}, prefill on the same "
            f"embeddings {rd['invariance']['prefill']:.2e}, decode step on "
            f"the same cache {rd['invariance']['decode']:.2e} (bound "
            f"{DP_INVARIANT_REL}); noise floor (embeddings nudged "
            f"{DP_NUDGE}): first token "
            f"{rd['invariance']['floor_first']:.4f}, next step "
            f"{rd['invariance']['floor_step']:.4f}"
            f"; generate ms a rank {[round(v, 1) for v in rd['engine_ms']]}"
            f" vs one rank {rd['ref_engine_ms']:.1f}; wave ms a rank "
            f"{[round(v, 1) for v in rd['wave_ms']]} vs "
            f"{rd['ref_wave_ms']:.1f}, tokens/s "
            f"{[round(v, 1) for v in rd['wave_tokens_s']]} vs "
            f"{rd['ref_wave_tokens_s']:.1f}; launches a rank, engine "
            f"{rd['engine_launches']} vs one rank "
            f"{rd['ref_engine_launches']}, wave {rd['wave_launches']} vs "
            f"{rd['ref_wave_launches']}; planted fault (tokens gathered in "
            f"reverse group order): {rd.get('fault', 'not run')}")
    # (b) dp = 2 stage-2 step
    tr = [r["train"] for r in ranks]
    if any(t["digest"] != tr[0]["digest"] for t in tr):
        raise AssertionError(f"dp {n}: the trainable leaves differ between "
                             "the ranks")
    if tr[0]["valid_tokens"] == tr[1]["valid_tokens"]:
        raise AssertionError(f"dp {n}: ranks 0 and 1 should hold different "
                             "token counts")
    m_ref = ref_train["metrics"]
    reading = {"metrics": [t["metrics"] for t in tr], "ref": m_ref,
               "ms": [t["ms"] for t in tr], "ref_ms": ref_train["ms"],
               "valid_tokens": [t["valid_tokens"] for t in tr],
               "bounds": [DP_METRIC_REL, DP_UPDATE_REL_L2]}
    for k in ("total_loss", "grad_norm"):
        rel = abs(tr[0]["metrics"][k] - m_ref[k]) / abs(m_ref[k])
        reading[f"{k}_rel"] = rel
        if rel > DP_METRIC_REL or any(t["metrics"][k] != tr[0]["metrics"][k]
                                      for t in tr):
            raise AssertionError(f"dp {n} {k}: {[t['metrics'][k] for t in tr]}"
                                 f" vs {m_ref[k]}")
    reading["update_rel_l2"] = {
        g: _tree_rel(tr[0]["updates"][g], ref_train["updates"][g])
        for g in ("lora", "pooler")}
    faulty = ranks[0]["train_fault"]
    reading["fault_update_rel_l2"] = {
        g: _tree_rel(faulty["updates"][g], ref_train["updates"][g])
        for g in ("lora", "pooler")}
    # leaf by leaf, the first moments (the reduced gradients): a leaf whose
    # gradient is scaled or left unreduced shows here whatever its size
    ref_m = ref_train["moments"]
    if set(tr[0]["moments"]) != set(ref_m):
        raise AssertionError(f"dp {n}: the optimizer's paths differ from one "
                             "rank's")
    rels = {p: _rel(tr[0]["moments"][p], ref_m[p]) for p in ref_m}
    fault_rels = {p: _rel(faulty["moments"][p], ref_m[p]) for p in ref_m}
    held = [p for p in ref_m if p not in DP_ZERO_GRAD_LEAVES]
    reading["moment_rel_l2"] = _leaf_summary(
        {p: rels[p] for p in held}, DP_MOMENT_REL_L2)
    reading["fault_moment_rel_l2"] = _leaf_summary(
        {p: fault_rels[p] for p in held}, DP_MOMENT_REL_L2)
    reading["moment_rel_l2_by_leaf"] = rels
    reading["fault_moment_rel_l2_by_leaf"] = fault_rels
    # a leaf whose gradient is zero but for rounding, held to be so
    reading["zero_grad_rms_ratio"] = {
        p: float(np.sqrt(np.mean(np.square(ref_m[p], dtype=np.float64)))
                 / np.sqrt(np.mean(np.square(ref_m[q], dtype=np.float64))))
        for p, q in DP_ZERO_GRAD_LEAVES.items() if p in ref_m}
    out["dp_stage2"] = reading
    log(f"  dp {n} stage-2 step: metrics {reading['metrics'][0]} vs one rank "
        f"{m_ref}; first moments leaf by leaf {reading['moment_rel_l2']} "
        f"(bound {DP_MOMENT_REL_L2}; every leaf {json.dumps(rels)}), skipped "
        f"reduction {reading['fault_moment_rel_l2']} (every leaf "
        f"{json.dumps(fault_rels)}); zero-gradient leaves' RMS against "
        f"their partner's {reading['zero_grad_rms_ratio']}; updates rel L2 "
        f"{reading['update_rel_l2']} (bound {DP_UPDATE_REL_L2}), skipped "
        f"reduction {reading['fault_update_rel_l2']}; step ms "
        f"{reading['ms']} vs {ref_train['ms']}; valid tokens a rank "
        f"{reading['valid_tokens']}")
    if max(reading["update_rel_l2"].values()) > DP_UPDATE_REL_L2:
        raise AssertionError(f"dp {n} updates: {reading['update_rel_l2']}")
    # the last rank's ZeRO shard (the end of the flat vector: the LoRA
    # factors) took its own gradients, so the fault shows there
    if max(reading["fault_update_rel_l2"].values()) <= DP_UPDATE_REL_L2:
        raise AssertionError(f"dp {n}: the skipped gradient reduction "
                             f"passes: {reading['fault_update_rel_l2']}")
    if reading["moment_rel_l2"]["max"] > DP_MOMENT_REL_L2:
        raise AssertionError(f"dp {n} first moments: "
                             f"{reading['moment_rel_l2']}")
    if reading["fault_moment_rel_l2"]["max"] <= DP_MOMENT_REL_L2:
        raise AssertionError(f"dp {n}: the skipped gradient reduction passes "
                             f"the first moments: "
                             f"{reading['fault_moment_rel_l2']}")
    for p, ratio in reading["zero_grad_rms_ratio"].items():
        if ratio > DP_ZERO_GRAD_RMS:
            raise AssertionError(f"dp {n}: {p}'s gradient is not zero: its "
                                 f"first moment's RMS is {ratio} of "
                                 f"{DP_ZERO_GRAD_LEAVES[p]}'s")
    # (c) context parallelism: the ring and the train step at cp = n
    cp = out["cp"] = hold_cp(ranks, ref_cp, dev)
    PHASE_SECONDS["parallel_cp"] = round(ref_cp_s + max(
        r["cp"]["ring_s"] + r["cp"]["train_s"] for r in ranks), 1)
    rings = cp["ring"]
    grads = [{g: v["max_abs_err"] for g, v in r["grads"].items()}
             for r in rings]
    faults = [{f: v["off"] for f, v in r["faults"].items()} for r in rings]
    where = (f"{n} ranks sharing one card over gloo" if backend == "gloo"
             else f"a card a rank over {backend}")
    log(f"  cp {n} ring (B H S D {rings[0]['shape']}, causal, valid "
        f"lengths {rings[0]['valid_lengths']}): K1 ring vs plain ring max "
        f"abs err a rank {[r['out_max_abs_err'] for r in rings]} (valid "
        f"rows), dQ / dK / dV {grads} (bound {ATOL} + {RTOL} |ref|); "
        f"launches a rank {[r['launches'] for r in rings]}; planted faults' "
        f"elements past the bound {faults}; ms a rank ({where}) forward "
        f"{[round(r['fwd_ms'], 1) for r in rings]}, forward + backward "
        f"{[round(r['fwd_bwd_ms'], 1) for r in rings]}, plain ring "
        f"{[round(r['plain_fwd_bwd_ms'], 1) for r in rings]}; run table "
        f"{[r.get('table_ms') for r in rings]} ms a call; peak "
        f"{[r.get('peak_gib') for r in rings]} GiB")
    log(f"  cp {n} stage-1 step ({cp['rows']} spliced rows, "
        f"{PARALLEL_LAYERS} layers): metrics {cp['metrics'][0]} vs cp 1 "
        f"{cp['ref']}; loss / grad_norm rel {cp['total_loss_rel']:.3e} / "
        f"{cp['grad_norm_rel']:.3e} (bound {DP_METRIC_REL}); updates rel L2 "
        f"a rank {cp['update_rel_l2']} (bound {DP_UPDATE_REL_L2}), the seq "
        f"reduction skipped {cp['fault_update_rel_l2']}; first moments "
        f"{cp['moment_rel_l2']}; step ms {cp['ms']} vs cp 1 "
        f"{cp['ref_ms']:.1f}; peak GiB a rank {cp['peak_gib']} vs cp 1 "
        f"{cp['ref_peak_gib']}; profiler trace bytes / memory stats "
        f"{cp['profile']}")
    vb = out["vit_base"] = phase("vit_base", vit_base_checks, dev, tiny)
    log(f"  ViT-B/16 ({vb['images']} images of 224², {vb['layers']} "
        f"layers, bf16): K1 tower vs plain rel L2 "
        f"{vb['tower_vs_plain_rel_l2']:.4f}, fused W8A8 vs bf16 "
        f"{vb['fused_vs_bf16_rel_l2']:.4f} (a block skipped "
        f"{vb['fused_fault_rel_l2']:.4f}; bound {TOWER_REL_L2}); float NCHW "
        f"pixels vs uint8, embeddings {vb['pixels_rel_l2']:.2e} (H and W "
        f"swapped {vb['pixels_fault_rel_l2']:.4f}; bound {VIT_PIXEL_REL_L2}),"
        f" tower {vb['pixels_tower_rel_l2']:.2e}; "
        f"in_proj perceiver fused vs plain "
        f"{vb['in_proj_fused_vs_plain_rel_l2']:.4f} (rows rolled "
        f"{vb['in_proj_fault_rel_l2']:.4f}); the recipe's perceiver (D 48 "
        f"padded to 64) vs plain {vb['d48_perceiver_vs_plain_rel_l2']:.4f}; "
        f"launches tower {vb['tower_launches']}, fused "
        f"{vb['fused_launches']}, perceiver {vb['perceiver_launches']}, "
        f"D 48 perceiver {vb['d48_launches']}")
    if dev.type == "cuda" and backend == "gloo":
        probes = {}
        for mode in ("port", "torch"):
            codes, logs = run_ranks([os.path.abspath(__file__),
                                     "--nccl-probe", mode], timeout=90)
            probes[mode] = {"exit": codes, "said": [
                [ln for ln in lg.splitlines() if ln.strip()][-3:]
                for lg in logs]}
        out["nccl_two_ranks_one_card"] = probes
        codes, logs = run_ranks([os.path.abspath(__file__),
                                 "--gloo-p2p-probe"], timeout=90)
        out["gloo_p2p_cuda"] = {"exit": codes, "said": [
            [ln for ln in lg.splitlines() if "gloo p2p" in ln]
            for lg in logs]}
        log(f"  gloo point-to-point on CUDA tensors (what Axis.shift's host "
            f"staging avoids): {json.dumps(out['gloo_p2p_cuda'])}")
        if 0 in probes["port"]["exit"]:
            raise AssertionError("init_distributed('nccl') joined two local "
                                 "ranks on one card")
        log(f"  NCCL, two ranks on one card: {json.dumps(probes)}")
    out["seconds"] = time.time() - t_phase
    log(f"  parallel phase {out['seconds']:.1f} s (one-rank reference "
        f"{ref_s:.1f} s, the {n} ranks {ranks_s:.1f} s over {backend}; "
        + ("times of ranks sharing one card)" if backend == "gloo"
           else "a card a rank)"))
    return out


# where a failing phase leaves its traceback, and a crash of the
# interpreter its stacks: the output directory a remote run copies back
# ---------------------------------------------------------------------------
# 9. start-up: the SentencePiece tokenizer, a real decoder directory, the
# converted checkpoint
# ---------------------------------------------------------------------------

SPM_FIXTURE = os.path.join("tests", "torch_spm_fixture")
STARTUP_LAYERS = 2  # the decoder's depth (LLaMA-2-7B's widths)
STARTUP_NEW = 12  # greedy tokens a request
STARTUP_PROMPT_TOKENS = 2000
STARTUP_REPS = 5
STARTUP_QUESTIONS = ("What is in this remote sensing image?",
                     "How many airplanes are parked on the apron?",
                     "Describe the land use around the river.")


def spm_fixture_mismatches(tok, rows, corpus):
    """The corpus strings whose ids or decode (special tokens skipped)
    differ from the fixture's expected.json rows (the slow class's values
    where it parts from the fast conversion)."""
    bad = []
    for text, row in zip(corpus, rows):
        ids = tok(text).input_ids
        want_ids = row.get("slow_ids", row["ids"])
        want_text = row.get("slow_decoded", row["decoded"])
        if ids != want_ids or tok.decode(
                want_ids, skip_special_tokens=True) != want_text:
            bad.append(text)
    return bad


def median_ms(fn, reps=STARTUP_REPS):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def startup_reader(out):
    """(a) The committed fixture through the port's reader: every corpus
    string's ids and decode under legacy true and false against
    expected.json; the host encode times of the fixture's own tokenizer
    (its config: legacy false); (d)'s swapped scores."""
    import dataclasses

    from lhrs_bot_tpu_torch.data import conversation as conv_lib
    from lhrs_bot_tpu_torch.data.preprocess import tokenizer_image_token
    from lhrs_bot_tpu_torch.data.sentencepiece import SentencePieceModel
    from lhrs_bot_tpu_torch.data.tokenizer import (LlamaTokenizer,
                                                   load_tokenizer)

    with open(os.path.join(SPM_FIXTURE, "expected.json")) as fh:
        expected = json.load(fh)
    corpus = expected["corpus"]
    t0 = time.perf_counter()
    model = SentencePieceModel.from_file(
        os.path.join(SPM_FIXTURE, "tokenizer.model"))
    out["parse_ms"] = (time.perf_counter() - t0) * 1e3
    for legacy in (True, False):
        tok = LlamaTokenizer(model, legacy=legacy)
        bad = spm_fixture_mismatches(
            tok, expected["legacy" if legacy else "non_legacy"], corpus)
        if bad:
            raise AssertionError(f"tokenizer (legacy {legacy}): ids or text "
                                 f"differ from expected.json on {bad}")
    tok = load_tokenizer(SPM_FIXTURE)
    conv = conv_lib.conv_templates["llava_llama_2"].copy()
    conv.append_message(conv.roles[0], "<image>\n" + STARTUP_QUESTIONS[0])
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()
    out["template_tokens"] = len(tokenizer_image_token(prompt, tok))
    out["template_encode_ms"] = median_ms(
        lambda: tokenizer_image_token(prompt, tok))
    long = ""
    for text in (corpus * 100):
        long += text + " "
        if len(tok(long).input_ids) >= STARTUP_PROMPT_TOKENS:
            break
    out["long_tokens"] = len(tok(long).input_ids)
    out["long_encode_ms"] = median_ms(lambda: tok(long))
    # (d) planted: two merged pieces' scores swapped must change the ids:
    # the last merged piece's with the first of the top-scoring ones whose
    # move to the end of the merge order changes a segmentation
    low = max(i for i, p in enumerate(model.pieces) if len(p) > 1
              and model.types[i] == 1)
    for top in range(259, 259 + 200):
        scores = list(model.scores)
        scores[top], scores[low] = scores[low], scores[top]
        swapped = LlamaTokenizer(dataclasses.replace(model, scores=scores),
                                 legacy=False)
        caught = spm_fixture_mismatches(swapped, expected["non_legacy"],
                                        corpus)
        if caught:
            break
    out["fault_scores_swapped"] = {
        "pieces": [model.pieces[top], model.pieces[low]],
        "strings_changed": len(caught)}
    if not caught:
        raise AssertionError("planted fault: two pieces' scores swapped "
                             "and no corpus string's ids changed")
    log(f"  (a) fixture {len(model)} pieces parsed in "
        f"{out['parse_ms']:.1f} ms; {len(corpus)} strings x legacy "
        f"true/false: ids and text as expected.json; host encode (median of "
        f"{STARTUP_REPS}): LLaMA-2 template with one question "
        f"{out['template_tokens']} tokens {out['template_encode_ms']:.2f} "
        f"ms, a {out['long_tokens']}-token prompt "
        f"{out['long_encode_ms']:.2f} ms; planted: scores of "
        f"{out['fault_scores_swapped']['pieces']} swapped changed "
        f"{len(caught)} strings (caught)")


def phase_startup(dev):
    """(a) The SentencePiece reader on the host (`startup_reader`); (b) a
    reference-format HF LLaMA directory at full width (STARTUP_LAYERS
    decoder layers) with the fixture's tokenizer files beside the weights,
    built through build_model_and_tokenizer -> build_engine from a config
    whose text.path is that directory, then three requests with images
    through serve.api's frontend over a one-slot contiguous scheduler (as
    lhrs_serve_torch.py builds it): each reply's ids bit for bit the direct
    `generate` call's on the same prompt and image, its text the reader's
    decode of them; (c) that stage-0 tree converted
    (save_converted_params), reloaded (load_converted_params), every leaf
    byte-equal to build_model's (load_pretrained's), and an engine over the
    reloaded tree
    giving the same greedy ids bit for bit; both load paths' seconds and
    GB/s (the page cache warm: the files were just written); (d) planted:
    one converted leaf with one element changed must show as that leaf,
    and the fixture with two pieces' scores swapped must change ids (in
    (a)). Writes the directory and the converted tree under build/ and
    deletes them."""
    import shutil
    import tempfile

    import torch

    from lhrs_bot_tpu_torch.core import (build_engine,
                                         build_model_and_tokenizer,
                                         eval_config, load_converted_params,
                                         save_converted_params)
    from lhrs_bot_tpu_torch.core.safetensors_io import read_header
    from lhrs_bot_tpu_torch.data.tokenizer import LlamaTokenizer
    from lhrs_bot_tpu_torch.serve.api import ServingFrontend
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig
    from lhrs_bot_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    out = {"seconds": {}}
    t_phase = time.time()
    t0 = time.time()
    startup_reader(out)
    out["seconds"]["a_reader"] = time.time() - t0

    config = eval_config()
    config["text"]["num_hidden_layers"] = STARTUP_LAYERS
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="startup_", dir="build")
    llama_dir = os.path.join(root, "llama")
    wrappers = kernel_wrappers()
    try:
        # (b) a real decoder directory through the entry point's calls
        t0 = time.time()
        from lhrs_bot_tpu_torch.models import VLMConfig

        write_llama_dir(llama_dir, VLMConfig.from_config_dict(config).llama,
                        dev)
        for f in ("tokenizer.model", "tokenizer_config.json",
                  "special_tokens_map.json"):
            shutil.copy(os.path.join(SPM_FIXTURE, f), llama_dir)
        written = dir_bytes(llama_dir)
        out["seconds"]["b_write"] = time.time() - t0
        config["text"]["path"] = llama_dir
        t0 = time.time()
        cfg, params, tok = build_model_and_tokenizer(config, dev)
        t_build_model = time.time() - t0
        if not isinstance(tok, LlamaTokenizer):
            raise AssertionError(f"text.path {llama_dir}: tokenizer "
                                 f"{type(tok).__name__}, not the reader")
        t0 = time.time()
        engine = build_engine(cfg, params, config, dev)
        t_engine = time.time() - t0
        gen_cfg = GenerationConfig(max_new_tokens=STARTUP_NEW,
                                   eos_token_id=tok.eos_token_id,
                                   pad_token_id=tok.pad_token_id)
        sched = ContinuousBatchingScheduler(
            cfg, engine.params, engine.llama_params, max_batch=1,
            max_seq_len=engine.max_seq_len,
            compute_dtype=engine.compute_dtype,
            cache_dtype=engine.cache_dtype, gen_cfg=gen_cfg, device=dev)
        frontend = ServingFrontend(sched, tok, image_size=cfg.vit.image_size,
                                   prompt_template="llava_llama_2")
        rng = np.random.default_rng(9)
        requests, replies = [], []
        set_launches(wrappers)
        t0 = time.time()
        try:
            for q in STARTUP_QUESTIONS:
                image = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
                req = frontend.build_request(q, image, STARTUP_NEW,
                                             temperature=0.0)
                requests.append((req.input_ids.copy(), req.image.copy()))
                replies.append(frontend.await_request(req, timeout=300))
        finally:
            frontend.shutdown()
        torch.cuda.synchronize()
        t_frontend = time.time() - t0
        launches = read_launches(wrappers)

        def direct(eng):
            return [eng.generate(ids[None], np.asarray([len(ids)], np.int32),
                                 images=img[None], gen_cfg=gen_cfg)[0]
                    for ids, img in requests]

        direct_ids = direct(engine)
        for k, (reply, want, (ids, _)) in enumerate(
                zip(replies, direct_ids, requests)):
            conv_text = tok.decode(reply["tokens"], skip_special_tokens=True)
            if reply["finish_reason"] != "stop" or reply["tokens"] != want \
                    or reply["text"] != conv_text:
                raise AssertionError(
                    f"(b) request {k}: frontend {reply} vs direct generate "
                    f"{want}, the reader's decode {conv_text!r}")
            if int((ids < 0).sum()) != 1:
                raise AssertionError(f"(b) request {k}: not one image "
                                     "marker in its prompt")
        for k in ("flash_attention_fwd", "fused_decode_attention"):
            if not launches.get(k):
                raise AssertionError(f"(b) the frontend's requests launched "
                                     f"no {k}: {launches}")
        out["b"] = {"llama_dir_bytes": written,
                    "build_model_and_tokenizer_s": t_build_model,
                    "build_engine_s": t_engine,
                    "frontend_s": t_frontend, "launches": launches,
                    "prompt_tokens": [len(i) for i, _ in requests],
                    "ids": direct_ids,
                    "texts": [r["text"] for r in replies]}
        log(f"  (b) {written / 1e9:.3f} GB LLaMA directory at "
            f"{STARTUP_LAYERS} layers written in "
            f"{out['seconds']['b_write']:.1f} s; build_model_and_tokenizer "
            f"{t_build_model:.1f} s (LlamaTokenizer), build_engine "
            f"{t_engine:.1f} s; 3 image requests through the frontend in "
            f"{t_frontend:.2f} s, prompts {out['b']['prompt_tokens']} "
            f"tokens, ids bit for bit the direct generate's, texts the "
            f"reader's decode {out['b']['texts']}; launches {launches}")

        # (c) the converted checkpoint of build_model's tree (its
        # load_pretrained, the tokenizer read first)
        t_pretrained = t_build_model
        nbytes = sum(np.asarray(v).nbytes for _, v in tree_paths(params))
        conv_dir = os.path.join(root, "converted")
        t0 = time.time()
        save_converted_params(conv_dir, params)
        t_save = time.time() - t0
        conv_bytes = dir_bytes(conv_dir)
        t0 = time.time()
        loaded = load_converted_params(conv_dir, cfg)
        t_load = time.time() - t0
        bad = tree_mismatches(loaded, params)  # reads every mapped byte
        t_read = time.time() - t0
        if bad:
            raise AssertionError(f"(c) converted tree mismatches {bad}")
        engine2 = build_engine(cfg, loaded, config, dev)
        conv_ids = direct(engine2)
        if conv_ids != direct_ids:
            raise AssertionError(f"(c) the engine over the reloaded tree: "
                                 f"{conv_ids} != {direct_ids}")
        del engine2
        out["c"] = {"tree_bytes": nbytes, "converted_bytes": conv_bytes,
                    "load_pretrained_s": t_pretrained,
                    "load_pretrained_gb_s": nbytes / t_pretrained / 1e9,
                    "convert_save_s": t_save,
                    "convert_save_gb_s": conv_bytes / t_save / 1e9,
                    "convert_load_s": t_load,
                    "convert_load_read_s": t_read,
                    "convert_load_read_gb_s": nbytes / t_read / 1e9,
                    "leaves": len(list(tree_paths(params)))}
        log(f"  (c) stage-0 tree {nbytes / 1e9:.3f} GB, "
            f"{out['c']['leaves']} leaves: build_model_and_tokenizer "
            f"(load_pretrained) {t_pretrained:.2f} s ({out['c']['load_pretrained_gb_s']:.2f} "
            f"GB/s of tree); save_converted_params {t_save:.2f} s "
            f"({out['c']['convert_save_gb_s']:.2f} GB/s); "
            f"load_converted_params {t_load:.3f} s, with every byte read "
            f"and compared {t_read:.2f} s "
            f"({out['c']['convert_load_read_gb_s']:.2f} GB/s; page cache "
            f"warm): byte-equal; the engine over it: greedy ids bit for bit")

        # (d) planted: one element of one converted leaf changed
        t0 = time.time()
        key = "llama/layers/wq"
        with open(os.path.join(conv_dir, "params.index.json")) as fh:
            shard = os.path.join(conv_dir, json.load(fh)["weight_map"][key])
        header, _, start = read_header(shard)
        begin = header[key]["data_offsets"][0]
        mm = np.memmap(shard, dtype=np.uint8, mode="r+")
        elem = mm[start + begin + 4096:start + begin + 4100].view(np.float32)
        elem[0] = elem[0] + 1.0
        mm.flush()
        del mm, elem
        faulty = tree_mismatches(load_converted_params(conv_dir), params)
        out["fault_leaf_changed"] = faulty
        if faulty != [key]:
            raise AssertionError(f"planted fault: one element of {key} "
                                 f"changed, mismatches {faulty}")
        out["seconds"]["d_fault"] = time.time() - t0
        log(f"  (d) planted: one element of {key} changed in its shard: "
            f"mismatches {faulty} (caught); the swapped scores: see (a)")
        out["bytes_written"] = written + conv_bytes
        del engine, params, loaded
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"]["phase"] = time.time() - t_phase
    log(f"  phase_startup {out['seconds']['phase']:.1f} s, "
        f"{out['bytes_written'] / 1e9:.2f} GB written")
    return out


OUT_DIR = "chiprun_out"


# each phase's wall seconds, in the order run (a nested phase counts in
# its caller's too)
PHASE_SECONDS = {}


def phase(name, fn, *args):
    """Run one phase; if it raises, keep the traceback in
    OUT_DIR/chip_smoke_<name>.err before passing the exception on. Its
    seconds go to PHASE_SECONDS."""
    t0 = time.time()
    try:
        return fn(*args)
    except BaseException:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, f"chip_smoke_{name}.err"), "w") as f:
            traceback.print_exc(file=f)
        raise
    finally:
        PHASE_SECONDS[name] = round(time.time() - t0, 1)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def eval_only(dev):
    """`chip_smoke.py --eval-only`: phase 7's eval part alone, a short
    check of the eval path on the card (not the full run): the artifacts
    written at CKPT_CUT_LAYERS decoder layers, `phase_eval` over them and
    `cls_protocol` over their loaded tree."""
    import shutil
    import tempfile

    from lhrs_bot_tpu_torch.core import eval_config, load_pretrained
    from lhrs_bot_tpu_torch.models import VLMConfig

    config = eval_config()
    config["text"]["num_hidden_layers"] = CKPT_CUT_LAYERS
    cfg = VLMConfig.from_config_dict(config)
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="eval_only_", dir="build")
    try:
        t0 = time.time()
        sizes = write_reference_checkpoint(root, cfg, dev)
        log(f"  artifacts {sizes} in {time.time() - t0:.1f} s")
        paths = {"model_path": os.path.join(root, "FINAL.pt"),
                 "vit_path": os.path.join(root, "clip"),
                 "llama_path": os.path.join(root, "llama")}
        out = phase("eval", phase_eval, dev, paths, root)
        params, _ = load_pretrained(cfg, **paths)
        out["cls_protocol"] = cls_protocol(cfg, params, config, dev, root,
                                           kernel_wrappers())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(json.dumps({"eval": out}, default=str))
    log(smi_line())


def main():
    import torch

    if sys.argv[1:2] == ["--parallel-worker"]:  # a rank of phase 8
        return parallel_worker(sys.argv[2])
    if sys.argv[1:2] == ["--nccl-probe"]:
        return nccl_probe(sys.argv[2])
    if sys.argv[1:2] == ["--gloo-p2p-probe"]:
        return gloo_p2p_probe()
    eval_part = sys.argv[1:] == ["--eval-only"]
    startup_part = sys.argv[1:] == ["--startup-only"]
    parallel_part = sys.argv[1:2] == ["--parallel-only"]
    parallel_args = {}
    if parallel_part and sys.argv[2:]:
        # --parallel-only --dist-backend nccl --ranks N: a card a rank
        if (len(sys.argv) != 6 or sys.argv[2] != "--dist-backend"
                or sys.argv[4] != "--ranks"):
            raise SystemExit("usage: chip_smoke.py --parallel-only "
                             "[--dist-backend nccl|gloo --ranks N]")
        parallel_args = {"backend": sys.argv[3], "n": int(sys.argv[5])}
    if sys.argv[1:] and not (eval_part or startup_part or parallel_part):
        raise SystemExit("usage: chip_smoke.py [--eval-only | --startup-only "
                         "| --parallel-only [--dist-backend B --ranks N]]")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this check "
                         "runs on the card")
    from lhrs_bot_tpu_torch.ops import cuda_lib

    os.makedirs(OUT_DIR, exist_ok=True)
    LOG_FILE.append(open(os.path.join(OUT_DIR, "chip_smoke.log"), "w"))
    faults = open(os.path.join(OUT_DIR, "chip_smoke_crash.txt"), "w")
    faulthandler.enable(faults)  # a segfault or abort leaves its stacks
    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[1/9 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
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
    log(f"[2/9 build] {so.relative_to(cuda_lib.BUILD_ROOT.parents[1])} in "
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
    if eval_part:
        return eval_only(dev)
    if startup_part:
        out = phase("startup", phase_startup, dev)
        log(json.dumps({"startup": out}, default=str))
        log(smi_line())
        return None
    if parallel_part:
        out = phase("parallel", lambda: phase_parallel(dev, **parallel_args))
        log(json.dumps({"parallel": out}, default=str))
        log(smi_line())
        return None

    log("[3/9 kernels vs plain]")
    k1, k2 = phase("kernels", phase_kernels, dev)
    train_k = phase("train_kernels", phase_train_kernels, dev)
    k3, k4 = phase("quant_kernels", phase_quant_kernels, dev)
    vision = phase("vision_kernels", phase_vision_kernels, dev)
    tower = phase("tower", phase_tower, dev)
    paged = phase("paged_kernels", phase_paged_kernels, dev)
    bench_k = phase("bench_kernels", phase_bench_kernels, dev)

    log("[4/9 serving slices at full width]")
    paths = phase("slice", phase_slice, dev)
    request_504 = phase("request_504", phase_request_504, dev)
    bf16, w4a8 = paths["bf16"]["launches"], paths["w4a8"]["launches"]
    int8 = paths["int8"]["launches"]

    log("[5/9 stage-1 training at full width]")
    train = phase("train", phase_train, dev)

    log("[6/9 the bench path]")
    bench = phase("bench", phase_bench, dev)

    log("[7/9 checkpoints at full width: load, serve, stage 2 -> 3 -> eval, "
        "then training from data on disk and the eval entry points]")
    ckpt = phase("checkpoint", phase_checkpoint, dev,
                 lambda paths, root: {
                     "train_from_disk": phase(
                         "train_from_disk", phase_train_from_disk, dev,
                         paths, root),
                     "eval": phase("eval", phase_eval, dev, paths, root)})

    log("[8/9 data and tensor parallelism: two ranks on the card over gloo]")
    parallel = phase("parallel", phase_parallel, dev)

    log("[9/9 start-up: the SentencePiece tokenizer, a LLaMA directory, the "
        "converted checkpoint]")
    startup = phase("startup", phase_startup, dev)

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
    cp_launches = [r["launches"] for r in parallel["cp"]["ring"]]
    fwd_row["note"] = ("also carries the LSE output and segment ids: "
                       f"{train['launches']['flash_attention_fwd']} launches "
                       "on the training path; times at the packed decoder "
                       "shape in train_kernels; context parallelism "
                       "(phase 8, cp = 2): one launch a ring block with its "
                       "LSE, a rank's launches a causal ring call "
                       f"{[c['flash_attention_fwd'] for c in cp_launches]} "
                       "(rank r: r + 1)")
    norm = vision["normalized"]
    norm_replaces = ("vit_block.py:111, vit_block.py:132, "
                     "perceiver_block.py:53")
    norm_row = row("flash_attention_fwd_normalized", "flash_fwd_norm.cu",
                   norm_replaces, int8, norm)
    norm_row["note"] = (
        "the normalize-first attention's resident path (rows of at most 320 "
        "keys): a CTA per (batch, head) holding its K and V in shared "
        "memory, Q K^T once a Q tile into registers, P = exp(s - m) / l "
        "rounded to bf16 before P V, the TPU vision kernels' rounding "
        "(LHRS_VIT_SOFTMAX jnn and exp2_pre); times at ViT B64 H16 S257 "
        "D64; by shape (this path, the two-pass path, plain K1, SDPA, "
        "bound) " + ", ".join(
            f"{n} ({v['path']}) {v['ms']:.4f} / "
            f"{v.get('two_pass_ms', v['ms']):.4f} / "
            f"{v['k1_ms']:.4f} / {v['library_ms']:.4f} / "
            f"{v['bound_ms']:.4f} ms" for n, v in norm["shapes"].items()))
    split_row = row("flash_attention_fwd_normalized_split",
                    "flash_fwd_norm.cu", norm_replaces, int8, norm["split"])
    split_row["note"] = (
        "the normalize-first attention's split path, for rows of 321-640 "
        "keys at D64 (ViT-L/14 at 336 px: 577 tokens, the block's 592, its "
        "perceiver's 640): a CTA per (batch, head) holding its K and V, two "
        "warpgroups splitting each Q tile's keys, their scores in "
        "registers, one exchange of row max and sum; times at ViT-L/14 336 "
        "px, B64 H16 S577 D64; no model of the main path (224 px) has such "
        "rows; the 336-px fused tower's launches "
        f"{tower['tower_336']['launches']}")
    cluster_row = row("flash_attention_fwd_normalized_cluster",
                      "flash_fwd_norm.cu", norm_replaces, int8,
                      norm["cluster"])
    cluster_row["note"] = (
        "the normalize-first attention's cluster path, for rows of 641-2,560 "
        "keys at D64 under more than one Q tile of 64 but those of 17, 21 "
        "and 26 key tiles (ViT-L/14 at 504 px: 1,297 tokens, the block's "
        "1,312, 21 tiles; the two-pass path runs them faster) and the "
        "perceiver's 64 queries over "
        "1,360 keys (the two-pass path, where the cluster path reads "
        f"{norm['shapes']['perceiver_504']['cluster_ms']:.4f} ms against "
        f"{norm['shapes']['perceiver_504']['ms']:.4f}): a thread-block "
        "cluster per (batch, head), "
        "each CTA holding a slice of its K and V, Q multicast, the row stats "
        "and the partial outputs exchanged through distributed shared "
        "memory; times at ViT-L/14 504 px, B64 H16 S1297 D64, called on "
        "this path; no model of "
        "the main path (224 px) has such rows; the 504-px fused tower's "
        f"launches {tower['tower_504']['launches']}, the 504-px W4A8 "
        "request's "
        f"{request_504['504px']['launches'].get(cluster_row['name'], 0)}")
    two_pass_row = row("flash_attention_fwd_normalized_two_pass",
                       "flash_fwd_norm.cu", norm_replaces, int8,
                       norm["two_pass"])
    d128 = norm["shapes"]["d128_577"]
    two_pass_row["note"] = (
        "the normalize-first attention's two-pass path, for rows past 2,560 "
        "keys at D64 and 256 at D128, of 17, 21 and 26 key tiles at D64 "
        "(ViT-L/14 at 504 px: 1,297 tokens, the block's 1,312, 21 tiles; "
        f"{norm['shapes']['vit_504']['ms']:.4f} ms, the cluster path "
        f"{norm['shapes']['vit_504']['cluster_ms']:.4f}; the 504-px fused "
        "tower's and W4A8 request's launches), and past 640 keys at D64 "
        "with one Q tile a head (the 504-px perceiver's fused block: 64 x "
        "1,360); no launch on the main path (224 px): two consumer "
        "warpgroups and a "
        "producer warp a CTA, two Q tiles of a head (a head's odd "
        "last tile and one-tile heads on a CTA whose warpgroups split the "
        "keys), K resident between the passes where it fits, a first pass "
        "for each row's max and sum, then P V; times at the 504-px "
        "perceiver's three groups, B192 H16 64 x 1,360 D64; D128 at 577 "
        f"keys {d128['ms']:.4f} ms (SDPA {d128['library_ms']:.4f})")
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
    tp_w4 = parallel["tp_w4a8"]["launches"][0]
    kernels[3]["note"] = (
        "one clustered launch a projection; times of the fused mode (b), "
        "which quantizes the bf16 activation itself, at B1 K4096 N11008 "
        f"(mode (a) {k3['mode_a_ms']:.4f} ms); a W4A8 decode "
        f"step launches it {step['w4a8_matmul']:.0f} times and kernel A "
        f"{step['ln_quant']:.0f} times (int8 cache), no epilogue kernel; "
        f"on phase 8's tp = 2 W4A8 path a rank launched it "
        f"{tp_w4['w4a8_matmul']} times, {tp_w4['w4a8_matmul_mode_a']} of "
        "them in mode (a) (the row-parallel o and down projections)")
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
                f"sets and skipped {packed['tile_pairs_skipped']}; context "
                "parallelism (phase 8, cp = 2): one launch a ring block in "
                "the backward, a rank's launches a causal ring call "
                f"{[c[k['name']] for c in cp_launches]} (rank r: r + 1)")
    # after the notes set by position
    kernels[1:1] = [norm_row, split_row, cluster_row, two_pass_row]
    log(json.dumps({"w4a8_shapes": k3["shapes"],
                    "ln_quant_shapes": vision["A"]["shapes"]}))
    log(json.dumps({"int8_gemm_shapes": vision["B"]["shapes"],
                    "vision_blocks": vision["blocks"], "tower": tower}))
    log(json.dumps({"paths": paths, "paged_kernels": paged,
                    "request_504": request_504}))
    log(json.dumps({"train_kernels": train_k, "train": train}))
    log(json.dumps({"bench_kernels": bench_k,
                    "bench_launches": bench["launches"]}))
    log(json.dumps({"checkpoint": ckpt}))
    log(json.dumps({"parallel": parallel}, default=str))
    log(json.dumps({"startup": startup}, default=str))
    log(json.dumps({"phase_seconds": PHASE_SECONDS,
                    "build_seconds": round(build_s, 1)}))
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
