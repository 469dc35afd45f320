"""Samplers and a threaded prefetching loader (host side, numpy).

Counterpart of `lhrs_bot_tpu/data/loader.py`; each index stream equals the
JAX package's, since both draw from `np.random.default_rng(seed + epoch)`:
  * `ShardedSampler`: the epoch's shuffle, padded to a multiple of the
    world size (or cut with `drop_last`), this rank's slice;
  * `WeightedShardedSampler`: weighted draws with replacement, this rank's
    contiguous share;
  * `InfiniteSampler`: endless epochs, each shuffled with its own seed;
  * `DataLoader`: batches of the sampler's indices read by a pool of
    worker threads and collated in a producer thread, ahead of the
    consumer by a bounded queue; a worker's error is raised in the
    consumer. Closing the iterator (or dropping it) stops the producer,
    and waits for it, so no worker runs on behind it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np


class ShardedSampler:
    """The epoch's shuffled indices (DistributedSampler's rule: padded to
    a multiple of world_size by repeating the first ones, or cut with
    `drop_last`), every world_size-th from `rank`."""

    def __init__(self, dataset_len: int, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        self.n = dataset_len
        self.rank = rank
        self.world = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.world
        return -(-self.n // self.world)

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if self.drop_last:
            order = order[:self.n // self.world * self.world]
        else:
            pad = (-len(order)) % self.world
            if pad:
                order = np.concatenate([order, order[:pad]])
        return iter(order[self.rank::self.world].tolist())


class WeightedShardedSampler(ShardedSampler):
    """`num_samples` indices drawn with replacement by `weights` (the
    epoch's generator), this rank's contiguous share of them."""

    def __init__(self, weights: Sequence[float], num_samples: int,
                 rank: int = 0, world_size: int = 1, seed: int = 0):
        super().__init__(num_samples, rank, world_size, True, seed)
        self.weights = np.asarray(weights, np.float64)
        self.weights /= self.weights.sum()

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        idx = rng.choice(len(self.weights), size=self.n, p=self.weights)
        per = self.n // self.world
        return iter(idx[self.rank * per:(self.rank + 1) * per].tolist())

    def __len__(self) -> int:
        return self.n // self.world


class InfiniteSampler:
    """Endless rank-sliced indices; epoch e shuffled with seed + e."""

    def __init__(self, dataset_len: int, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, seed: int = 0):
        self.n = dataset_len
        self.rank = rank
        self.world = world_size
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            order = np.arange(self.n)
            if self.shuffle:
                np.random.default_rng(self.seed + epoch).shuffle(order)
            yield from order[self.rank::self.world].tolist()
            epoch += 1


class DataLoader:
    """Map-style loader: the sampler's indices in batches of
    `batch_size`, each item read by one of `num_workers` threads, each
    batch collated by `collate_fn`, at most `prefetch` batches ahead."""

    def __init__(self, dataset, batch_size: int,
                 collate_fn: Callable[[List[Dict]], Dict], sampler=None,
                 num_workers: int = 4, prefetch: int = 2,
                 drop_last: bool = True, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler if sampler is not None else ShardedSampler(
            len(dataset), rank, world_size, shuffle, seed)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(
            -n // self.batch_size)

    def _batched_indices(self) -> Iterator[List[int]]:
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __iter__(self) -> Iterator[Dict]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for indices in self._batched_indices():
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__,
                                              indices))
                        out_q.put(self.collate_fn(items))
            except Exception as exc:  # noqa: BLE001 - handed to the consumer
                out_q.put(exc)
            finally:
                out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():  # unblock a put on the full queue
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
            thread.join()
