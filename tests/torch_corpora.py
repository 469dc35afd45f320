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


# -- eval corpora: PNG images only (the card's machine decodes PNG without
# PIL), in the layouts the eval datasets read

EVAL_CLASSES = ("airport", "beach", "dense residential", "forest")


def write_cls_corpus(root, seed=0, per_class=3, sizes=((40, 52), (36, 30)),
                     classes=EVAL_CLASSES):
    """An ImageFolder: `<root>/<class>/img<i>.png`, `per_class` a class."""
    rng = np.random.default_rng(seed)
    for c, name in enumerate(classes):
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for i in range(per_class):
            save_image(os.path.join(root, name, f"img{i}.png"), rng,
                       *sizes[(c + i) % len(sizes)], "PNG")
    return root


def write_rsvqa_corpus(root, seed=0, n_images=4, prefix="LR", split="test",
                       sizes=((40, 52), (36, 30))):
    """RSVQA's `<prefix>_split_<split>_{questions,answers,images}.json` and
    `Images_LR/<id>.tif` (PNG bytes: the datasets sniff the format). Each
    image gets a presence, a comparison and a rural/urban question, one
    count and one area question (left out by the dataset), and one
    inactive question."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "Images_LR"), exist_ok=True)
    questions, answers, images = [], [], []
    kinds = (("presence", "Is there a road in the image?", "yes"),
             ("comp", "Are there more buildings than water areas?", "no"),
             ("rural_urban", "Is it a rural or an urban area?", "rural"),
             ("count", "How many buildings are there?", "4"),
             ("area", "What is the area covered by buildings?", "0m2"))
    for img_id in range(n_images):
        save_image(os.path.join(root, "Images_LR", f"{img_id}.tif"), rng,
                   *sizes[img_id % len(sizes)], "PNG")
        images.append({"id": img_id, "active": True})
        for k, (qtype, text, ans) in enumerate(kinds + (kinds[0],)):
            qid = len(questions)
            answers.append({"id": qid, "question_id": qid, "active": True,
                            "answer": ans if (img_id + k) % 2 else
                            {"yes": "no", "no": "yes"}.get(ans, ans)})
            questions.append({"id": qid, "img_id": img_id, "type": qtype,
                              "question": f"{text} ({img_id})",
                              "answers_ids": [qid],
                              "active": k < len(kinds)})
    for kind, data in (("questions", questions), ("answers", answers),
                       ("images", images)):
        with open(os.path.join(
                root, f"{prefix}_split_{split}_{kind}.json"), "w") as fh:
            json.dump({kind: data}, fh)
    return root


def write_vg_corpus(root, seed=0, n=6, sizes=((40, 52), (36, 30))):
    """Visual grounding in the DIOR-RSVG / RSVG layout: `RSVG_test.json`
    ({"data": [{img, question, answer box}]}) beside its PNG images, with
    one record whose image is missing (dropped by the dataset). Returns
    the JSON's path."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    data = []
    for i in range(n):
        name = f"vg{i}.png"
        save_image(os.path.join(root, name), rng, *sizes[i % len(sizes)],
                   "PNG")
        x, y = (int(v) for v in rng.integers(0, 60, 2))
        data.append({"img": name, "question": f"the vehicle number {i} "
                     "parked near the road",
                     "answer": [x, y, x + int(rng.integers(5, 40)),
                                y + int(rng.integers(5, 40))]})
    data.append({"img": "gone.png", "question": "nothing",
                 "answer": [0, 0, 1, 1]})
    path = os.path.join(root, "RSVG_test.json")
    with open(path, "w") as fh:
        json.dump({"data": data}, fh)
    return path


def write_bench_corpus(root, seed=0, n_images=3, sizes=((40, 52), (36, 30))):
    """LHRS-Bench: `bench.json` ({"data": [{filename, qa_pairs}], "qtype":
    {"<id> <name>": ...}}) beside its PNG images; two or three
    multiple-choice questions an image, each of one or two types, and a
    record whose image is missing. Returns the JSON's path."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    qtype = {"1 identity": "what it is", "2 color": "its color",
             "3 orientation": "where it faces", "4 quantity": "how many"}
    data = []
    for i in range(n_images):
        name = f"bench{i}.png"
        save_image(os.path.join(root, name), rng, *sizes[i % len(sizes)],
                   "PNG")
        pairs = []
        for k in range(2 + i % 2):
            types = [str(1 + (i + k) % 4)] + ([str(1 + (i + k + 1) % 4)]
                                              if k % 2 else [])
            pairs.append({"question": f"Question {k} about image {i}?",
                          "choices": "A. red B. green C. blue D. gray",
                          "answer": "ABCD"[int(rng.integers(4))] + ".",
                          "type": types})
        data.append({"filename": name, "qa_pairs": pairs})
    data.append({"filename": "gone.png", "qa_pairs": [
        {"question": "?", "choices": "A. x", "answer": "A.", "type": ["1"]}]})
    path = os.path.join(root, "bench.json")
    with open(path, "w") as fh:
        json.dump({"data": data, "qtype": qtype}, fh)
    return path


def write_caption_eval_corpus(root, seed=0, n=5, sizes=((40, 52), (36, 30))):
    """Caption eval in the RSICD layout: `dataset_rsicd.json` ({"images":
    [{filename, sentences: [{raw}]}]}) beside its PNG images, one record
    whose image is missing. Returns the JSON's path."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    recs = []
    for i in range(n):
        name = f"cap{i}.png"
        save_image(os.path.join(root, name), rng, *sizes[i % len(sizes)],
                   "PNG")
        recs.append({"filename": name, "sentences": [
            {"raw": f"many buildings and {['a road', 'some trees'][i % 2]} "
                    f"are in scene {i} ."}]})
    recs.append({"filename": "gone.png", "sentences": [{"raw": "none"}]})
    path = os.path.join(root, "dataset_rsicd.json")
    with open(path, "w") as fh:
        json.dump({"images": recs}, fh)
    return path
