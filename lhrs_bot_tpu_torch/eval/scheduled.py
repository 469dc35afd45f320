"""Continuous-batching generation for the eval protocols.

Counterpart of `lhrs_bot_tpu/eval/scheduled.py`: the eval items go through
a `ContinuousBatchingScheduler` built from the engine's parameters, so a
slot frees the moment its sequence ends and the next item is admitted
between ticks; ragged answer lengths then cost no worst-case decode.
Greedy ids equal the engine's. Items are pulled lazily, about 2 x
max_batch at a time, and a request's image is dropped once its prefill has
copied it, so an eval set of any size runs in bounded host memory.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np

from ..serve.scheduler import ContinuousBatchingScheduler, Request


def scheduler_generate(vlm_cfg, engine, items: Iterable[Dict], total: int,
                       *, gen_cfg, max_batch: int = 8,
                       tokens_per_tick: int = 8, log_every: int = 50,
                       logger=None) -> List[List[int]]:
    """Generate for `total` items (dicts with "input_ids" and optionally
    "image") through a continuous-batching scheduler on the engine's
    device; returns the output ids in item order."""
    sched = ContinuousBatchingScheduler(
        vlm_cfg, engine.params, engine.llama_params, max_batch=max_batch,
        max_seq_len=engine.max_seq_len, compute_dtype=engine.compute_dtype,
        cache_dtype=engine.cache_dtype, tokens_per_tick=tokens_per_tick,
        gen_cfg=gen_cfg, device=engine.device)
    it = iter(items)
    reqs: List[Request] = []
    buffer: List[Request] = []
    pulled = 0
    done = 0

    def pull():
        nonlocal pulled
        while len(buffer) < 2 * max_batch and pulled < total:
            item = next(it)
            img = item.get("image")
            buffer.append(Request(
                uid=pulled, input_ids=np.asarray(item["input_ids"], np.int32),
                image=None if img is None else np.asarray(img),
                max_new_tokens=gen_cfg.max_new_tokens))
            pulled += 1

    pull()
    while buffer or sched.active.any():
        if buffer:
            n = sched.admit(buffer)
            for r in buffer[:n]:
                r.image = None  # the prefill copied it
            reqs.extend(buffer[:n])
            buffer = buffer[n:]
        sched.step()
        finished = sum(1 for r in reqs if r.done)
        if logger is not None and finished // log_every > done // log_every:
            logger.info("eval %d/%d", finished, total)
        done = finished
        pull()
    if len(reqs) != total:
        raise RuntimeError(f"{len(reqs)} requests served for {total} items")
    return [r.output_ids for r in sorted(reqs, key=lambda r: r.uid)]
