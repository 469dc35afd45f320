"""Synthetic training and eval corpora written into a test's directory,
shared by the port's data-pipeline, checkpoint and stage-entry tests:
seeded random images (PNG, JPEG, TIFF) in the layouts the datasets read.
"""

from __future__ import annotations

import io
import json
import os
import tarfile

import numpy as np


def save_image(path, rng, h, w, fmt=None):
    from PIL import Image

    arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    # smooth a little so JPEG has something to keep
    arr = ((arr.astype(np.int32) + np.roll(arr, 1, 0)) // 2).astype(np.uint8)
    img = Image.fromarray(arr)
    kw = {"quality": 90} if (fmt or "").upper() == "JPEG" else {}
    img.save(str(path), format=fmt, **kw)


def image_bytes(rng, h, w, fmt):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
        buf, format=fmt)
    return buf.getvalue()


def _turns(rng, n_pairs, image=True):
    convs = []
    for i in range(n_pairs):
        q = f"question {i} about the scene {int(rng.integers(100))}"
        if i == 0 and image:
            q = "<image>\n" + q
        convs.append({"from": "human", "value": q})
        convs.append({"from": "gpt",
                      "value": f"answer {i} with words {int(rng.integers(99))}"
                      f" and {int(rng.integers(99))}"})
    return convs


def write_instruct_corpus(root, seed=0, tasks=("osm_task", "llava_task"),
                          n_per_task=4, sizes=((40, 52), (64, 48)),
                          jpeg=True, long_record=True, text_only=True,
                          missing=True):
    """`<task>.json` + `<task>_Image/` per task: multi-turn conversations
    over PNG and (with `jpeg`) JPEG images of the given sizes, a record
    of 12 turns (more than the 10 sampled), a text-only record and a
    record whose image is missing (dropped by the dataset)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for t, task in enumerate(tasks):
        img_dir = os.path.join(root, f"{task}_Image")
        os.makedirs(img_dir, exist_ok=True)
        recs = []
        for i in range(n_per_task):
            h, w = sizes[(i + t) % len(sizes)]
            fmt = "JPEG" if jpeg and i % 2 else "PNG"
            name = f"img{i}.{'jpg' if fmt == 'JPEG' else 'png'}"
            save_image(os.path.join(img_dir, name), rng, h, w, fmt)
            n_pairs = 12 if long_record and i == 1 else 1 + i % 3
            recs.append({"image": name,
                         "conversations": _turns(rng, n_pairs)})
        if text_only:
            recs.append({"conversations": _turns(rng, 2, image=False)})
        if missing:
            recs.append({"image": "gone.png",
                         "conversations": _turns(rng, 1)})
        with open(os.path.join(root, f"{task}.json"), "w") as fh:
            json.dump(recs, fh)
    return root


def write_caption_corpus(root, seed=0, n=6, sizes=((40, 52), (64, 48)),
                         jpeg=True):
    """Stage-1 captions: `caps.json` (a list of {image, caption}) with
    `caps_Image/`, and `rsicd.json` in the RSICD layout (several
    sentences an image, one drawn at random) with `rsicd_Image/`."""
    rng = np.random.default_rng(seed)
    for name in ("caps", "rsicd"):
        os.makedirs(os.path.join(root, f"{name}_Image"), exist_ok=True)
    caps, rsicd = [], {"images": []}
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        fmt = "JPEG" if jpeg and i % 2 else "PNG"
        fname = f"c{i}.{'jpg' if fmt == 'JPEG' else 'png'}"
        save_image(os.path.join(root, "caps_Image", fname), rng, h, w, fmt)
        caps.append({"image": fname,
                     "caption": f"a scene number {i} with a road"})
        save_image(os.path.join(root, "rsicd_Image", fname), rng, w, h, fmt)
        rsicd["images"].append({"filename": fname, "sentences": [
            {"raw": f"sentence {j} of image {i}"} for j in range(3)]})
    caps.append({"image": "missing.png", "caption": "not there"})
    with open(os.path.join(root, "caps.json"), "w") as fh:
        json.dump(caps, fh)
    with open(os.path.join(root, "rsicd.json"), "w") as fh:
        json.dump(rsicd, fh)
    return root


def write_shard(path, seed, n=5, corrupt=(), fmt="JPEG", size=(40, 36)):
    """A tar shard of n samples (image + caption), the indices in
    `corrupt` holding bytes that are no image."""
    rng = np.random.default_rng(seed)
    ext = "jpg" if fmt == "JPEG" else "png"
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            data = image_bytes(rng, *size, fmt)
            if i in corrupt:
                data = b"not an image"
            for name, payload in ((f"s{seed}_{i:04d}.{ext}", data),
                                  (f"s{seed}_{i:04d}.txt",
                                   f"caption {seed} number {i}".encode())):
                info = tarfile.TarInfo(name)
                info.size = len(payload)
                tf.addfile(info, io.BytesIO(payload))
    return path
