"""Host-side distributed utilities on `torch.distributed`.

Counterpart of `lhrs_bot_tpu/parallel/distribute.py`: rank helpers,
host-object all-gather, metric dict reduction, seed sync and barriers. In a
single process (no process group) each degrades as the JAX one does: rank
0 of a world of 1, the object alone, the dict itself, the seed itself, no
wait. `init_distributed` joins the group that torchrun describes in the
environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


BACKENDS = ("nccl", "gloo")


def init_distributed(backend: Optional[str] = None) -> None:
    """Join the process group of torchrun's environment (init_method
    "env://"). A no-op when a group exists already or WORLD_SIZE is unset
    or 1.

    `backend` is the caller's choice, "nccl" or "gloo" (the entry points'
    `--dist-backend`, NCCL by default). NCCL takes one card a local rank
    (LOCAL_RANK's), and raises where fewer cards are visible than
    LOCAL_WORLD_SIZE (or WORLD_SIZE) local ranks: it is never switched to
    gloo here. Under gloo, ranks on a machine with cards share them
    (local rank r takes card r % count, so two ranks on one card both take
    cuda:0), and ranks without a card run on the CPU. None, for library
    callers that name none, is NCCL where a card is visible and gloo
    where none is. A failure to join raises."""
    if _up() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"--dist-backend {backend!r}: choose one of "
                         f"{BACKENDS}")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ.get("WORLD_SIZE", "1")))
        if cards < local:
            raise RuntimeError(
                f"--dist-backend nccl takes one card a local rank: {local} "
                f"local ranks, {cards} card(s) visible. Start fewer ranks, "
                "or pass --dist-backend gloo to share the cards (or to run "
                "on the CPU)")
        torch.cuda.set_device(local_rank)
    elif cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend=backend, init_method="env://")


def get_rank() -> int:
    return dist.get_rank() if _up() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _up() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def is_distributed() -> bool:
    return get_world_size() > 1


def barrier(name: str = "barrier") -> None:
    """Wait for every process (`name` labels the wait, as in JAX)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather_object(obj: Any) -> List[Any]:
    """Every process's picklable `obj`, in rank order."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def reduce_dict(metrics: Dict[str, float], average: bool = True
                ) -> Dict[str, float]:
    """The mean (or with average=False the sum) over processes of a dict
    of scalars, in float32 as JAX reduces it."""
    if get_world_size() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vec = np.asarray([float(metrics[k]) for k in keys], np.float32)
    allv = np.stack(all_gather_object(vec))
    red = allv.mean(axis=0) if average else allv.sum(axis=0)
    return {k: float(v) for k, v in zip(keys, red)}


def sync_random_seed(seed: int) -> int:
    """Process 0's seed (as an int32, as JAX broadcasts it) on every
    process."""
    if get_world_size() == 1:
        return seed
    box = [int(np.asarray([seed], np.int32)[0])]
    dist.broadcast_object_list(box, src=0)
    return int(box[0])
