"""Training batch collators.

Counterpart of `lhrs_bot_tpu/data/collate.py` `SupervisedCollator` (:67) and
`PackingCollator` (:104), copied so that the port needs nothing of the JAX
package (whose `data` modules import jax). They return numpy arrays, the
JAX package's batches; the trainer moves them to the card. The tokenizer is
read for `pad_token_id` (and `model_max_length` by `SupervisedCollator`
when no `max_length` is given).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..models.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


def _pad_to(arr: np.ndarray, length: int, value: int) -> np.ndarray:
    pad = length - len(arr)
    if pad <= 0:
        return arr[:length]
    return np.concatenate([arr, np.full((pad,), value, dtype=arr.dtype)])


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _stack_images(instances) -> "np.ndarray | None":
    """Stack per-sample images; text-only rows in a mixed batch get zero
    images (their prompts carry no image token, so the splice never reads
    them)."""
    imgs = [inst.get("image") for inst in instances]
    present = [im for im in imgs if im is not None]
    if not present:
        return None
    shape = np.asarray(present[0]).shape
    return np.stack([
        np.asarray(im) if im is not None else np.zeros(shape, np.uint8)
        for im in imgs
    ])


def _check_single_image(rows) -> None:
    """At most one image token per sample: the single-image splice's
    contract, checked at the host boundary."""
    for i, row in enumerate(rows):
        n = int(np.sum(np.asarray(row) == IMAGE_TOKEN_INDEX))
        if n > 1:
            raise ValueError(
                f"sample {i} contains {n} image tokens; at most one is "
                "supported per sequence")


class SupervisedCollator:
    """Training batches: ids right-padded with pad_token_id, labels with
    IGNORE_INDEX, to the longest sample rounded up to `pad_multiple`
    (default 64) and cut at `max_length`; attention_mask = ids != pad;
    images stacked."""

    def __init__(self, tokenizer, pad_multiple: int = 64,
                 max_length: Optional[int] = None):
        self.tokenizer = tokenizer
        self.pad_multiple = pad_multiple
        self.max_length = max_length or tokenizer.model_max_length

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        ids = [np.asarray(inst["input_ids"], np.int64)[:self.max_length]
               for inst in instances]
        _check_single_image(ids)
        labels = [np.asarray(inst["labels"], np.int64)[:self.max_length]
                  for inst in instances]
        width = min(_round_up(max(len(x) for x in ids), self.pad_multiple),
                    self.max_length)
        pad_id = self.tokenizer.pad_token_id
        input_ids = np.stack([_pad_to(x, width, pad_id) for x in ids])
        labels_arr = np.stack([_pad_to(x, width, IGNORE_INDEX)
                               for x in labels])
        batch = {
            "input_ids": input_ids.astype(np.int32),
            "labels": labels_arr.astype(np.int32),
            "attention_mask": input_ids != pad_id,
        }
        images = _stack_images(instances)
        if images is not None:
            batch["images"] = images
        return batch


class PackingCollator:
    """Sequence-packing batches: several samples share a row, told apart
    by segment ids (block-diagonal attention and per-segment RoPE in
    `models.llama.llama_apply`). Every batch is exactly (rows_per_batch,
    target_len), with a (rows_per_batch, max_images_per_row, H, W, 3) image
    stack when any row has an image. Stateful: rows that do not fill a
    batch carry over to the next call; each sample's first label becomes
    IGNORE_INDEX so the shifted loss never predicts across a boundary; a
    sample longer than target_len gets a truncated row of its own."""

    def __init__(self, tokenizer, target_len: int = 512,
                 rows_per_batch: int = 4, max_images_per_row: int = 4):
        self.tokenizer = tokenizer
        self.target_len = target_len
        self.rows_per_batch = rows_per_batch
        self.max_images_per_row = max_images_per_row
        self._open: list = []  # carryover rows between calls

    def _fit(self, inst: Dict) -> None:
        ids = np.asarray(inst["input_ids"], np.int64)
        labels = np.asarray(inst["labels"], np.int64).copy()
        n = len(ids)
        if n > self.target_len:
            ids, labels = ids[:self.target_len], labels[:self.target_len]
            n = self.target_len
        labels[0] = IGNORE_INDEX
        img = inst.get("image")
        home = None
        for row in self._open:
            if len(row["ids"]) + n > self.target_len:
                continue
            if img is not None and (len(row["images"])
                                    >= self.max_images_per_row):
                continue
            home = row
            break
        if home is None:
            home = {"ids": [], "labels": [], "segs": [], "images": []}
            self._open.append(home)
        seg = (home["segs"][-1] if home["segs"] else 0) + 1
        home["ids"].extend(ids.tolist())
        home["labels"].extend(labels.tolist())
        home["segs"].extend([seg] * n)
        if img is not None:
            home["images"].append(np.asarray(img))

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        for inst in instances:
            self._fit(inst)
        emit, self._open = (self._open[:self.rows_per_batch],
                            self._open[self.rows_per_batch:])
        b, width = self.rows_per_batch, self.target_len
        ids = np.full((b, width), self.tokenizer.pad_token_id, np.int32)
        labels = np.full((b, width), IGNORE_INDEX, np.int32)
        segs = np.zeros((b, width), np.int32)
        imgs = None
        for row_i, row in enumerate(emit):
            n = len(row["ids"])
            ids[row_i, :n] = row["ids"]
            labels[row_i, :n] = row["labels"]
            segs[row_i, :n] = row["segs"]
            if row["images"] and imgs is None:
                imgs = np.zeros((b, self.max_images_per_row)
                                + row["images"][0].shape, np.uint8)
            for k, im in enumerate(row["images"]):
                imgs[row_i, k] = im
        batch = {
            "input_ids": ids,
            "labels": labels,
            "attention_mask": segs != 0,
            "segment_ids": segs,
        }
        if imgs is not None:
            batch["images"] = imgs
        return batch
