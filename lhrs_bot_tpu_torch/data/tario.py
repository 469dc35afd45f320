"""Streaming tar-shard reader (no webdataset), host side.

Counterpart of `lhrs_bot_tpu/data/tario.py`: brace-expanded shard lists,
shard URLs opened as local files, `pipe:` commands, http(s) streams or
gs:// / s3:// through their CLIs (`url_opener`, as the JAX package opens
them), members grouped into samples by key with errors logged and skipped
(`_group_tar_samples`), a deterministic epoch-seeded shard shuffle, the
split of shards across ranks, a seeded sample shuffle buffer, and
`default_decoder` -> {"rgb", "text"} on the port's decoders in the JAX
order (JPEG through `data/native.py`, the rest through
`data/image_io.py`). `RS5MDataset` renders each sample as a caption-QA
record with a module-level `random` template choice, as JAX does.
"""

from __future__ import annotations

import functools
import logging
import os
import random
import re
import tarfile
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..models.constants import DEFAULT_IMAGE_TOKEN
from . import native
from .image_io import decode_image
from .preprocess import preprocess, preprocess_multimodal
from .transforms import clip_preprocess_uint8

logger = logging.getLogger("lhrs_torch")


def braceexpand(pattern: str) -> List[str]:
    """Expand one "{000..123}" (zero-padded numeric) range per call-site,
    recursively; plain strings pass through."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if not m:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    width = len(lo)
    out = []
    for i in range(int(lo), int(hi) + 1):
        expanded = pattern[:m.start()] + str(i).zfill(width) + pattern[m.end():]
        out.extend(braceexpand(expanded))
    return out


def log_and_continue(exn: Exception) -> bool:
    """Error handler: warn and keep streaming (cap_dataset.py:582-585)."""
    logger.warning("tar stream error (%r) — skipping", exn)
    return True


def url_opener(url: str):
    """Open a shard URL as a readable byte stream (cap_dataset.py:618
    `wds.tarfile_to_samples` over piped/remote URLs).

    Supported schemes:
      * plain local path — buffered file;
      * ``pipe:<command>`` — the command's stdout (webdataset `pipe:` parity;
        e.g. ``pipe:curl -s -L <url>``);
      * ``http(s)://`` — streamed urllib response (no full download);
      * ``gs://`` / ``s3://`` — delegated to a ``gsutil cat`` /
        ``aws s3 cp - `` subprocess pipe, matching how the reference's
        webdataset recipes stream cloud shards.

    Returns (fileobj, closer) — call closer() when done (it also reaps any
    subprocess)."""
    import subprocess

    if url.startswith("pipe:"):
        proc = subprocess.Popen(url[5:], shell=True, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, bufsize=1 << 20)

        def close():
            proc.stdout.close()
            proc.terminate()
            proc.wait()

        return proc.stdout, close
    if url.startswith(("http://", "https://")):
        import urllib.request

        resp = urllib.request.urlopen(url)  # noqa: S310 — shard URL by config
        return resp, resp.close
    if url.startswith("gs://"):
        return url_opener(f"pipe:gsutil cat {url}")
    if url.startswith("s3://"):
        return url_opener(f"pipe:aws s3 cp {url} -")
    fh = open(url, "rb")
    return fh, fh.close


def _group_tar_samples(tar_url: str,
                       handler: Callable = log_and_continue
                       ) -> Iterator[Dict[str, bytes]]:
    """Group tar members by key (basename up to the first dot)."""
    closer = None
    try:
        stream, closer = url_opener(tar_url)
        tf = tarfile.open(fileobj=stream, mode="r|*")
    except Exception as exn:  # noqa: BLE001
        if closer is not None:
            closer()
        if handler(exn):
            return
        raise
    current_key: Optional[str] = None
    sample: Dict[str, bytes] = {}
    try:
        for member in tf:
            if not member.isfile():
                continue
            name = os.path.basename(member.name)
            if "." not in name:
                continue
            key, ext = name.split(".", 1)
            try:
                data = tf.extractfile(member).read()
            except Exception as exn:  # noqa: BLE001
                if handler(exn):
                    continue
                raise
            if key != current_key:
                if sample:
                    yield sample
                current_key, sample = key, {"__key__": key.encode()}
            sample[ext.lower()] = data
        if sample:
            yield sample
    except Exception as exn:  # noqa: BLE001
        if not handler(exn):
            raise
    finally:
        tf.close()
        if closer is not None:
            closer()


def default_decoder(sample: Dict[str, bytes],
                    image_size: Optional[int] = None) -> Optional[Dict]:
    """{jpg/jpeg/png/webp, txt/text/caption} -> {"rgb": uint8 HWC, "text":
    str}, or None for a sample without both or whose image does not
    decode (logged, skipped). With `image_size`, "rgb" is (size, size, 3):
    a JPEG through the native decode + resize library where it built, any
    image otherwise through `data.image_io.decode_image` (PNG here, other
    formats through PIL) and the port's PIL-exact resize. A JPEG with
    neither the library nor PIL raises (`native.require_jpeg_decoder`)."""
    img_bytes = ext_found = None
    for ext in ("jpg", "jpeg", "png", "webp"):
        if ext in sample:
            img_bytes, ext_found = sample[ext], ext
            break
    text = None
    for ext in ("txt", "text", "caption"):
        if ext in sample:
            text = sample[ext].decode("utf-8", errors="replace")
            break
    if img_bytes is None or text is None:
        return None
    if ext_found in ("jpg", "jpeg"):
        native.require_jpeg_decoder()
        if image_size is not None and native.available():
            out, ok = native.decode_resize_batch([img_bytes],
                                                 size=image_size)
            if ok[0]:
                return {"rgb": out[0], "text": text}
            # on to the general decoder, as the JAX package falls through
            # to PIL: libjpeg rejects some colorspaces PIL accepts
    try:
        rgb = decode_image(img_bytes)
    except ValueError as exn:
        log_and_continue(exn)
        return None
    if image_size is not None:
        rgb = clip_preprocess_uint8(rgb, image_size)
    return {"rgb": rgb, "text": text}


class TarShardDataset:
    """Iterable over decoded samples from a brace-expanded shard list.

    Deterministic per-epoch shard shuffle; shards split across
    (process, worker) like webdataset's split_by_node/split_by_worker.
    """

    def __init__(
        self,
        urls: str | Sequence[str],
        *,
        decoder: Callable = default_decoder,
        shuffle_shards: bool = True,
        shuffle_buffer: int = 1000,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        transform: Optional[Callable] = None,
        handler: Callable = log_and_continue,
    ):
        if isinstance(urls, str):
            urls = braceexpand(urls)
        self.shards = list(urls)
        self.decoder = decoder
        self.shuffle_shards = shuffle_shards
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.rank = rank
        self.world = world_size
        self.transform = transform
        self.handler = handler
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_shards(self) -> List[str]:
        shards = list(self.shards)
        if self.shuffle_shards:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(shards)
        return shards[self.rank::self.world]

    def __iter__(self) -> Iterator[Dict]:
        buf: List[Dict] = []
        rng = random.Random(self.seed * 7919 + self.epoch)
        for shard in self._epoch_shards():
            for raw in _group_tar_samples(shard, self.handler):
                decoded = self.decoder(raw)
                if decoded is None:
                    continue
                if self.transform is not None:
                    decoded = self.transform(decoded)
                if self.shuffle_buffer > 1:
                    buf.append(decoded)
                    if len(buf) >= self.shuffle_buffer:
                        idx = rng.randrange(len(buf))
                        buf[idx], buf[-1] = buf[-1], buf[idx]
                        yield buf.pop()
                else:
                    yield decoded
        rng.shuffle(buf)
        yield from buf


class RS5MDataset(TarShardDataset):
    """RS5M caption pretraining stream: each sample becomes a tokenized
    caption-QA record (cap_dataset.py:685-772 semantics). num_samples drives
    the loader's epoch bookkeeping (with_epoch parity,
    build_loader.py:109-154)."""

    NUM_SAMPLES = 5_070_186

    def __init__(self, urls, tokenizer, image_size: int = 224,
                 num_samples: Optional[int] = None, **kw):
        # decode+resize fused (native fast path) unless the caller overrode
        # the decoder
        if "decoder" not in kw:
            kw["decoder"] = functools.partial(default_decoder,
                                              image_size=image_size)
        super().__init__(urls, **kw)
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.num_samples = num_samples or self.NUM_SAMPLES

    def __len__(self) -> int:
        return self.num_samples // max(self.world, 1)

    def __iter__(self) -> Iterator[Dict]:
        from .datasets import CAPTION_QA_TEMPLATES

        for sample in super().__iter__():
            rgb = sample["rgb"]
            image = (rgb if rgb.shape[:2] == (self.image_size,
                                              self.image_size)
                     else clip_preprocess_uint8(rgb, self.image_size))
            question = (DEFAULT_IMAGE_TOKEN + "\n"
                        + random.choice(CAPTION_QA_TEMPLATES))
            sources = preprocess_multimodal(
                [{"Question": question, "Answer": sample["text"]}])
            out = preprocess(sources, self.tokenizer, has_image=True)
            yield {"input_ids": np.asarray(out["input_ids"][0]),
                   "labels": np.asarray(out["labels"][0]),
                   "image": image}
