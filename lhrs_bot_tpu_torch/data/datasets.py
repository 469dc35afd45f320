"""Datasets: caption and instruction JSON sets, RSVQA, visual grounding,
caption eval, LHRS-Bench and scene classification (host side, numpy).

Counterpart of `lhrs_bot_tpu/data/datasets.py`, item for item: the same
records, filters and module-level `random` draws (`sniff_annotations`'
RSICD caption choice, `CaptionDatasetVQA`'s template, `InstructDataset`'s
turn sample), so that under the same `random.seed` the items equal the
JAX package's. `_load_image` keeps the JAX order (JPEG through the native
library, `data/native.py`; the rest through `data/image_io.py` and the
port's resize), so no PIL is needed for JPEG (where the library builds)
or PNG.

  * CaptionDataset / CaptionDatasetVQA: `<name>_Image` directories beside
    JSON annotations (the public caption sets' formats sniffed);
  * InstructDataset / InstructDatasetWithTaskId: multi-turn conversations,
    "<image>" only in the first turn, at most `max_turns` turns sampled,
    per-source sampling weights;
  * RSVQA LR / HR / xBEN, VGEvalDataset, CapEvalDataset, LHRSBenchDataset;
  * FolderClassificationDataset, METERMLDataset, MillionAidEval,
    TxtSplitClassificationDataset.

Items are numpy arrays and token id lists; batching is the collators'.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.constants import DEFAULT_IMAGE_TOKEN
from . import conversation as conversation_lib
from . import native
from .image_io import decode_image
from .preprocess import (preprocess, preprocess_multimodal, preprocess_plain,
                         tokenizer_image_token)
from .transforms import clip_preprocess_uint8

logger = logging.getLogger("lhrs_torch")

# Reference QA templates for caption→VQA wrapping (cap_dataset.py:331-343
# behavior: a random "describe the image" instruction per sample).
CAPTION_QA_TEMPLATES = [
    "Describe the image concisely.",
    "Provide a brief description of the given image.",
    "Offer a succinct explanation of the picture presented.",
    "Summarize the visual content of the image.",
    "Give a short and clear explanation of the subsequent image.",
    "Share a concise interpretation of the image provided.",
    # NB: Unicode apostrophe, faithful to cap_dataset.py:337 ("photo’s") —
    # the ASCII variant tokenizes differently.
    "Present a compact description of the photo’s key features.",
    "Relay a brief, clear account of the picture shown.",
    "Render a clear and concise summary of the photo.",
    "Write a terse but informative summary of the picture.",
    "Create a compact narrative representing the image presented.",
]


def _load_image(path: str, image_size: int = 224) -> np.ndarray:
    """An image file -> (size, size, 3) uint8, CLIP geometry. JPEGs go
    through the native decode + resize library (within 1 LSB of the PIL
    path), else PIL, and a JPEG the library rejects through the general
    decoder; every other format through `data.image_io.decode_image` (PNG
    decoded here, other formats through PIL) and the port's PIL-exact
    resize, as the JAX package orders them."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if path.lower().endswith((".jpg", ".jpeg")):
        out, ok = native.decode_resize_batch([raw], size=image_size)
        if ok[0]:
            return out[0]
    return clip_preprocess_uint8(decode_image(raw), image_size)


def valid_path(root: str, entries: List[Dict], key: str = "image") -> List[Dict]:
    """Filter records whose image file is missing (cap_dataset.py:44-49)."""
    kept = []
    for e in entries:
        p = e.get(key)
        if p and os.path.exists(os.path.join(root, p)):
            kept.append(e)
    return kept


def sniff_annotations(json_path: str) -> List[Dict[str, str]]:
    """Normalize the assorted public annotation formats to
    [{"image": ..., "caption"/"conversations": ...}] (format sniffing per
    cap_dataset.py:108-162: TextRS/UAVICD/NWPU/OSM/LLAVA/RSICD variants)."""
    with open(json_path) as fh:
        data = json.load(fh)
    records: List[Dict[str, str]] = []
    if isinstance(data, dict):
        if "images" in data and isinstance(data["images"], list):
            # RSICD-style: {"images": [{"filename", "sentences": [{"raw"}]}]}
            for item in data["images"]:
                fname = item.get("filename") or item.get("image")
                sents = item.get("sentences", [])
                if fname and sents:
                    cap = random.choice(sents)
                    records.append({
                        "image": fname,
                        "caption": cap.get("raw", cap) if isinstance(cap, dict)
                        else cap})
            return records
        data = list(data.values())
    for item in data:
        if not isinstance(item, dict):
            continue
        if "conversations" in item:
            records.append(item)
        elif "caption" in item:
            records.append({"image": item.get("image") or item.get("filename"),
                            "caption": item["caption"]})
        elif "sentence" in item:
            records.append({"image": item.get("image") or item.get("filename"),
                            "caption": item["sentence"]})
    return records


class CaptionDataset:
    """Image-caption pairs from `<name>_Image` dirs + sibling JSON files."""

    def __init__(self, root: str, tokenizer, image_size: int = 224,
                 prompt_type: str = "plain"):
        self.root = root
        self.tokenizer = tokenizer
        self.image_size = image_size
        conversation_lib.set_default_conversation(prompt_type)
        self.records: List[Dict] = []
        for json_path in sorted(glob.glob(os.path.join(root, "*.json"))):
            name = os.path.splitext(os.path.basename(json_path))[0]
            img_dir = os.path.join(root, f"{name}_Image")
            if not os.path.isdir(img_dir):
                img_dir = root
            recs = sniff_annotations(json_path)
            for r in recs:
                r["_img_dir"] = img_dir
            self.records.extend(
                r for r in recs
                if r.get("image")
                and os.path.exists(os.path.join(img_dir, r["image"])))
        logger.info("CaptionDataset: %d samples from %s", len(self.records),
                    root)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict:
        rec = self.records[idx]
        image = _load_image(os.path.join(rec["_img_dir"], rec["image"]),
                            self.image_size)
        source = {"Question": DEFAULT_IMAGE_TOKEN, "Answer": rec["caption"]}
        out = preprocess_plain([source], self.tokenizer)
        return {"input_ids": out["input_ids"][0], "labels": out["labels"][0],
                "image": image}


class CaptionDatasetVQA(CaptionDataset):
    """Caption pairs rendered as random QA instructions
    (cap_dataset.py:331-372)."""

    def __getitem__(self, idx: int) -> Dict:
        rec = self.records[idx]
        image = _load_image(os.path.join(rec["_img_dir"], rec["image"]),
                            self.image_size)
        question = DEFAULT_IMAGE_TOKEN + "\n" + random.choice(
            CAPTION_QA_TEMPLATES)
        source = preprocess_multimodal(
            [{"Question": question, "Answer": rec["caption"]}])
        out = preprocess(source, self.tokenizer, has_image=True)
        return {"input_ids": np.asarray(out["input_ids"][0]),
                "labels": np.asarray(out["labels"][0]), "image": image}


class InstructDataset:
    """Multi-turn instruction data (LLaVA-style "conversations" JSON).

    Reference behavior (cap_dataset.py:401-487): ensure <image> appears only
    in the first turn, cap at max_turns sampled turns, llama_2 preprocessing.
    """

    def __init__(self, jsons: Sequence[str], image_roots: Sequence[str],
                 tokenizer, image_size: int = 224,
                 prompt_type: str = "llava_llama_2", max_turns: int = 10):
        assert len(jsons) == len(image_roots)
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.max_turns = max_turns
        conversation_lib.set_default_conversation(prompt_type)
        self.records: List[Dict] = []
        for jpath, iroot in zip(jsons, image_roots):
            with open(jpath) as fh:
                data = json.load(fh)
            # drop records whose image file is missing at build time
            # (valid_path parity, cap_dataset.py:44-49) — a missing file must
            # be a skipped record, not a mid-epoch crash
            n_before = len(data)
            data = [item for item in data
                    if "image" not in item
                    or os.path.exists(os.path.join(iroot, item["image"]))]
            if len(data) != n_before:
                logger.warning("InstructDataset: dropped %d record(s) with "
                               "missing images from %s",
                               n_before - len(data), jpath)
            for item in data:
                item["_img_dir"] = iroot
                item["_json"] = jpath
                self.records.append(item)
        logger.info("InstructDataset: %d conversations", len(self.records))

    def __len__(self) -> int:
        return len(self.records)

    def _to_sources(self, convs: List[Dict]) -> List[Dict]:
        """[{from: human/gpt, value}] → [{"Question","Answer"}] pairs, image
        token normalized to the first turn only."""
        pairs = []
        for i in range(0, len(convs) - 1, 2):
            q = convs[i]["value"]
            a = convs[i + 1]["value"]
            if i > 0:
                q = q.replace(DEFAULT_IMAGE_TOKEN, "").strip()
            pairs.append({"Question": q, "Answer": a})
        if len(pairs) > self.max_turns:
            start = 0  # keep first (image) turn, sample the rest
            rest = random.sample(range(1, len(pairs)), self.max_turns - 1)
            pairs = [pairs[0]] + [pairs[i] for i in sorted(rest)]
        return pairs

    def __getitem__(self, idx: int) -> Dict:
        rec = self.records[idx]
        has_image = "image" in rec and rec["image"]
        sources = self._to_sources(rec["conversations"])
        if has_image:
            if DEFAULT_IMAGE_TOKEN not in sources[0]["Question"]:
                sources[0]["Question"] = (
                    DEFAULT_IMAGE_TOKEN + "\n" + sources[0]["Question"])
            sources = preprocess_multimodal(sources)
            image = _load_image(os.path.join(rec["_img_dir"], rec["image"]),
                                self.image_size)
        else:
            image = None
        out = preprocess(sources, self.tokenizer, has_image=bool(has_image))
        item = {"input_ids": np.asarray(out["input_ids"][0]),
                "labels": np.asarray(out["labels"][0])}
        if image is not None:
            item["image"] = image
        return item


class InstructDatasetWithTaskId(InstructDataset):
    """Adds per-source sampling weights for WeightedRandomSampler mixing
    (cap_dataset.py:489-579; weights e.g. {OSM: 0.6, LLAVA: 1.0,
    geosignal: 0.5})."""

    DEFAULT_WEIGHTS = {"osm": 0.6, "llava": 1.0, "geosignal": 0.5}

    def __init__(self, *args, source_names: Optional[Sequence[str]] = None,
                 weights: Optional[Dict[str, float]] = None, **kwargs):
        jsons = args[0] if args else kwargs["jsons"]
        self.source_names = list(source_names or [
            os.path.splitext(os.path.basename(p))[0] for p in jsons])
        self.weight_table = {k.lower(): v for k, v in
                             (weights or self.DEFAULT_WEIGHTS).items()}
        super().__init__(*args, **kwargs)
        # one weight a kept record, by the file it came from (JAX counts the
        # records of each file before the missing images are dropped, so
        # its weights run past the records and fall out of step with them)
        name_of = dict(zip(jsons, self.source_names))
        self.sample_weights: List[float] = [
            self._weight_of(name_of[r["_json"]]) for r in self.records]

    def _weight_of(self, name: str) -> float:
        for key, val in self.weight_table.items():
            if key in name.lower():
                return val
        return 1.0


class RSVQADataset:
    """RSVQA LR/HR: {prefix}_split_{split}_{questions,answers,images}.json.

    Reference behavior (rsvqa.py:64-205): count/area question types filtered;
    each item yields the tokenized "<image>[VQA] question" prompt plus the
    target answer and question type for the soft-accuracy evaluator.
    """

    FILTERED_TYPES = ("count", "area")

    def __init__(self, root: str, tokenizer, prefix: str = "LR",
                 split: str = "test", image_size: int = 224,
                 prompt_type: str = "llava_llama_2",
                 task_prompt: str = "[VQA] "):
        self.root = root
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.task_prompt = task_prompt
        conversation_lib.set_default_conversation(prompt_type)

        def load(kind):
            with open(os.path.join(
                    root, f"{prefix}_split_{split}_{kind}.json")) as fh:
                return json.load(fh)[kind]

        questions = load("questions")
        answers = load("answers")
        self.items = []
        for q in questions:
            if not q.get("active", True):
                continue
            if q["type"].lower() in self.FILTERED_TYPES:
                continue
            ans = answers[q["answers_ids"][0]]["answer"]
            self.items.append({
                "image_id": q["img_id"],
                "question": q["question"],
                "answer": str(ans),
                "type": q["type"].lower(),
                "question_id": q["id"],
            })
        logger.info("RSVQA(%s/%s): %d questions", prefix, split,
                    len(self.items))

    def __len__(self) -> int:
        return len(self.items)

    def _prompt_ids(self, question: str) -> List[int]:
        conv = conversation_lib.default_conversation.copy()
        conv.append_message(
            conv.roles[0],
            DEFAULT_IMAGE_TOKEN + self.task_prompt + question)
        conv.append_message(conv.roles[1], None)
        return tokenizer_image_token(conv.get_prompt(), self.tokenizer)

    # Candidate image directories, searched in order; the reference keeps
    # one flat image_root of {id}.tif files (rsvqa.py:158) but the public
    # corpora unpack under different dir names per variant.
    IMAGE_DIRS = ("Images_LR", "Data", "Images", "")

    def _image_path(self, image_id) -> str:
        for d in self.IMAGE_DIRS:
            p = os.path.join(self.root, d, f"{image_id}.tif")
            if os.path.exists(p):
                return p
        return os.path.join(self.root, self.IMAGE_DIRS[0],
                            f"{image_id}.tif")

    def __getitem__(self, idx: int) -> Dict:
        item = self.items[idx]
        image = _load_image(self._image_path(item["image_id"]),
                            self.image_size)
        return {
            "input_ids": np.asarray(self._prompt_ids(item["question"])),
            "image": image,
            "target": item["answer"],
            "qtype": item["type"],
            "question_id": item["question_id"],
        }


class RSVQALR(RSVQADataset):
    """Low-resolution variant (reference rsvqa.py:189-193): file prefix LR."""

    def __init__(self, root: str, tokenizer, **kwargs):
        kwargs["prefix"] = "LR"
        super().__init__(root, tokenizer, **kwargs)


class RSVQAHR(RSVQADataset):
    """High-resolution variant (reference rsvqa.py:195-199): file prefix
    USGS (the HR corpus ships its JSONs as USGS_split_*)."""

    def __init__(self, root: str, tokenizer, **kwargs):
        kwargs["prefix"] = "USGS"
        super().__init__(root, tokenizer, **kwargs)


class RSVQAxBEN(RSVQADataset):
    """BigEarthNet variant (reference rsvqa.py:201-205): file prefix
    RSVQAxBEN, same JSON schema and count/area filtering."""

    def __init__(self, root: str, tokenizer, **kwargs):
        kwargs["prefix"] = "RSVQAxBEN"
        super().__init__(root, tokenizer, **kwargs)


# --data-target name → (dataset class, file prefix). HR answers ship under
# the USGS prefix; xBEN under its own name (reference rsvqa.py:189-205).
RSVQA_VARIANTS = {
    "LR": RSVQALR,
    "HR": RSVQAHR,
    "USGS": RSVQAHR,
    "XBEN": RSVQAxBEN,
    "RSVQAXBEN": RSVQAxBEN,
}


class VGEvalDataset:
    """Visual-grounding eval over DIOR-RSVG / RSVG JSON
    (cap_dataset.py:186-259): items carry a referring question and a target
    bbox; prompts are "<image>" + question, llama_2-rendered."""

    def __init__(self, root: str, target_json: str, tokenizer,
                 image_size: int = 224,
                 prompt_type: str = "llava_llama_2"):
        self.root = root
        self.tokenizer = tokenizer
        self.image_size = image_size
        conversation_lib.set_default_conversation(prompt_type)
        with open(target_json) as fh:
            data = json.load(fh)["data"]
        stem = os.path.splitext(os.path.basename(target_json))[0]
        self.items = []
        for item in data:
            if stem.endswith("DIOR_test"):
                img = item["img"] + ".jpg"
            elif stem.endswith("RSVG_test"):
                img = item["img"]
            else:
                img = item.get("name") or item.get("img")
            path = os.path.join(root, img)
            if os.path.exists(path):
                self.items.append({
                    "image_path": path,
                    "question": item["question"],
                    "answer": item["answer"],
                })
        logger.info("VGEvalDataset: %d samples", len(self.items))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        item = self.items[idx]
        sources = preprocess_multimodal(
            [{"Question": DEFAULT_IMAGE_TOKEN + item["question"],
              "Answer": None}])
        out = preprocess(sources, self.tokenizer, has_image=True)
        return {
            "input_ids": np.asarray(out["input_ids"][0]),
            "image": _load_image(item["image_path"], self.image_size),
            "target": item["answer"],
            "filename": os.path.basename(item["image_path"]),
        }


class CapEvalDataset:
    """Caption eval: images + gold captions for COCO-style metrics
    (cap_dataset.py:263-327 format sniffers)."""

    def __init__(self, root: str, target_json: str, tokenizer=None,
                 image_size: int = 224):
        self.root = root
        self.image_size = image_size
        with open(target_json) as fh:
            data = json.load(fh)
        self.items: List[Dict] = []
        stem = os.path.basename(root)
        if "TextRS" in stem and "TextRS" in data:
            for rec in data["TextRS"]:
                self._add(rec["image"] + ".png",
                          rec["annotation"]["caption"][0])
        elif "images" in data and data["images"] and "SubFolder" in data[
                "images"][0]:
            for rec in data["images"]:
                self._add(os.path.join(rec["SubFolder"], rec["ImageName"]),
                          rec["Caption"])
        elif "images" in data:
            for rec in data["images"]:
                cap = rec.get("sentences", [{}])[0].get("raw") or rec.get(
                    "Caption")
                self._add(rec["filename"], cap)
        else:  # NWPU: {subfolder: [{filename, raw}]}
            for sub, recs in data.items():
                for rec in recs:
                    self._add(os.path.join(sub, rec["filename"]), rec["raw"])

    def _add(self, rel: str, caption: Optional[str]) -> None:
        path = os.path.join(self.root, rel)
        if caption and os.path.exists(path):
            self.items.append({"image_path": path, "caption": caption})

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        item = self.items[idx]
        return {
            "image": _load_image(item["image_path"], self.image_size),
            "caption": item["caption"],
            "filename": os.path.basename(item["image_path"]),
        }


class LHRSBenchDataset:
    """LHRS-Bench multiple-choice QA: {data, qtype} JSON
    (main_bench_gen.py:186-215). Yields one record per qa_pair."""

    def __init__(self, image_root: str, target_json: str,
                 image_size: int = 224):
        self.image_root = image_root
        self.image_size = image_size
        with open(target_json) as fh:
            qa = json.load(fh)
        self.id_to_type = {}
        for key in qa.get("qtype", {}):
            parts = key.split(" ")
            self.id_to_type[parts[0]] = parts[1] if len(parts) > 1 else key
        self.items = []
        for rec in qa["data"]:
            path = os.path.join(image_root, rec["filename"])
            if not os.path.exists(path):
                continue
            for pair in rec["qa_pairs"]:
                self.items.append({
                    "image_path": path,
                    "question": pair["question"],
                    "choices": pair["choices"],
                    "answer": pair["answer"],
                    "type": pair["type"],
                })
        logger.info("LHRSBenchDataset: %d qa pairs", len(self.items))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int) -> Dict:
        item = dict(self.items[idx])
        item["image"] = _load_image(item.pop("image_path"), self.image_size)
        return item


class FolderClassificationDataset:
    """ImageFolder-style scene classification (AID/NWPU/…): class = subdir
    name (ImageFolderInstance.py:5-57)."""

    def __init__(self, root: str, image_size: int = 224,
                 class_names: Optional[Sequence[str]] = None):
        self.image_size = image_size
        self.samples: List = []
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_names = list(class_names or classes)
        name_to_idx = {c: i for i, c in enumerate(classes)}
        for cls in classes:
            for path in sorted(glob.glob(os.path.join(root, cls, "*"))):
                self.samples.append((path, name_to_idx[cls]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict:
        path, label = self.samples[idx]
        return {"image": _load_image(path, self.image_size), "label": label}


class METERMLDataset:
    """METER-ML 7-class methane-source dataset: a geojson of labeled sites
    with NAIP (or Sentinel-2) image chips (meterml.py:22-90 behavior,
    without the geopandas dependency — the geojson is parsed directly)."""

    CLASSES = ["CAFOs", "Landfills", "Mines", "Negative",
               "ProcessingPlants", "RefineriesTerminals", "WWTreatment"]

    def __init__(self, root: str, split: str = "test",
                 image_type: str = "naip", image_size: int = 224):
        self.image_size = image_size
        self.class_names = list(self.CLASSES)
        name_to_idx = {c: i for i, c in enumerate(self.CLASSES)}
        geojson = os.path.join(root, f"{split}_dataset.geojson")
        if not os.path.exists(geojson):
            geojson = os.path.join(root, f"{split}.geojson")
        with open(geojson) as fh:
            data = json.load(fh)
        self.samples = []
        for feat in data.get("features", []):
            props = feat.get("properties", {})
            label = props.get("Type") or props.get("class") or props.get(
                "label")
            folder = props.get("Image_Folder") or props.get("id")
            if label is None or folder is None:
                continue
            # multi-label entries use "A|B"; reference keeps the first
            label = str(label).split("|")[0]
            if label not in name_to_idx:
                continue
            img = os.path.join(root, str(folder), f"{image_type}.png")
            if os.path.exists(img):
                self.samples.append((img, name_to_idx[label]))
        logger.info("METERMLDataset(%s): %d samples", split,
                    len(self.samples))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Dict:
        path, label = self.samples[idx]
        return {"image": _load_image(path, self.image_size), "label": label}


class MillionAidEval(FolderClassificationDataset):
    """Million-AID test split: folder layout, class = leaf directory
    (millionaid_eval.py:8-54)."""

    def __init__(self, root: str, image_size: int = 224):
        super().__init__(root, image_size=image_size)


class TxtSplitClassificationDataset(FolderClassificationDataset):
    """UCM-style txt split files: lines "relative/path class_idx"
    (UCM.py:8-84)."""

    def __init__(self, root: str, split_file: str, image_size: int = 224,
                 class_names: Optional[Sequence[str]] = None):
        self.image_size = image_size
        self.samples = []
        with open(split_file) as fh:
            for line in fh:
                parts = line.strip().split()
                if len(parts) >= 2:
                    self.samples.append(
                        (os.path.join(root, parts[0]), int(parts[1])))
        self.class_names = list(class_names or [])
