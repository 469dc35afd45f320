"""Loader factory of the training stages and of zero-shot classification.

Counterpart of `lhrs_bot_tpu/data/build_loader.py`: stage 1 reads captions
as random QA instructions (`CaptionDatasetVQA`), or a tar-shard stream
(`RS5MDataset`) when `data_path` names shards (".tar" or a brace range);
stages 2 and 3 read every `*.json` instruction file under `data_path` with
its `<name>_Image/` directory, weighted by source with `weight_sample`;
`pack_sequences` packs the samples into rows (`PackingCollator`). The
sampler, shuffle and drop_last policy are the JAX package's, and so is
every default. `config` is a ConfigDict (attribute access).
"""

from __future__ import annotations

import logging
import os
from typing import Tuple

from . import conversation as conversation_lib
from .collate import PackingCollator, SupervisedCollator
from .datasets import (CaptionDatasetVQA, FolderClassificationDataset,
                       InstructDataset, InstructDatasetWithTaskId)
from .loader import DataLoader, WeightedShardedSampler

logger = logging.getLogger("lhrs_torch")


def build_loader(config, tokenizer, mode: str = "pretrain", rank: int = 0,
                 world_size: int = 1):
    """The training loader of `config` (mode "pretrain" only)."""
    if mode == "pretrain":
        return _build_vlp_loader(config, tokenizer, rank, world_size)
    raise ValueError(f"unknown mode {mode!r}")


def _collator(config, tokenizer):
    if getattr(config, "pack_sequences", False):
        factor = max(1, int(getattr(config, "pack_factor", 2)))
        return PackingCollator(
            tokenizer,
            target_len=int(getattr(config, "pack_target_len", 0))
            or int(tokenizer.model_max_length),
            rows_per_batch=max(1, int(config.batch_size) // factor),
            max_images_per_row=int(getattr(config, "pack_max_images", 4)))
    return SupervisedCollator(tokenizer)


def _build_vlp_loader(config, tokenizer, rank, world_size):
    stage = int(getattr(config, "stage", 1))
    data_path = config.data_path
    prompt_type = getattr(config, "prompt_template", "plain")
    image_size = int(config.rgb_vision.input_size[0])

    if stage <= 1 and (".tar" in str(data_path) or "{" in str(data_path)):
        from .tario import RS5MDataset

        conversation_lib.set_default_conversation(prompt_type)
        dataset = RS5MDataset(data_path, tokenizer, image_size=image_size,
                              rank=rank, world_size=world_size,
                              seed=int(getattr(config, "seed", 0)))
        return _IterableLoader(dataset, batch_size=int(config.batch_size),
                               collate_fn=_collator(config, tokenizer))

    if stage <= 1:
        dataset = CaptionDatasetVQA(data_path, tokenizer,
                                    image_size=image_size,
                                    prompt_type=prompt_type)
        sampler = None
    else:
        jsons = sorted(os.path.join(data_path, f)
                       for f in os.listdir(data_path) if f.endswith(".json"))
        roots = [os.path.splitext(j)[0] + "_Image" for j in jsons]
        roots = [r if os.path.isdir(r) else data_path for r in roots]
        if getattr(config, "weight_sample", False):
            dataset = InstructDatasetWithTaskId(
                jsons, roots, tokenizer, image_size=image_size,
                prompt_type=prompt_type)
            sampler = WeightedShardedSampler(
                dataset.sample_weights, num_samples=len(dataset),
                rank=rank, world_size=world_size,
                seed=int(getattr(config, "seed", 0)))
        else:
            dataset = InstructDataset(jsons, roots, tokenizer,
                                      image_size=image_size,
                                      prompt_type=prompt_type)
            sampler = None
    return DataLoader(dataset, batch_size=int(config.batch_size),
                      collate_fn=_collator(config, tokenizer),
                      sampler=sampler,
                      num_workers=int(getattr(config, "workers", 4)),
                      rank=rank, world_size=world_size,
                      seed=int(getattr(config, "seed", 0)))


class _IterableLoader:
    """Batches of an iterable (tar-stream) dataset; its length from the
    dataset's sample count."""

    def __init__(self, dataset, batch_size: int, collate_fn):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return max(len(self.dataset) // self.batch_size, 1)

    def __iter__(self):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []


def build_zero_shot_loader(config, rank: int = 0,
                           world_size: int = 1) -> Tuple:
    """(dataset, class_names) of the classification eval folder
    `config.data_path`."""
    dataset = FolderClassificationDataset(
        config.data_path, image_size=int(config.rgb_vision.input_size[0]))
    return dataset, dataset.class_names
