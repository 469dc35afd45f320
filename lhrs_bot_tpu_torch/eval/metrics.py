"""Eval metric utilities shared by the cls/vqa/vg/bench protocols: a copy
of `lhrs_bot_tpu/eval/metrics.py` (numpy and the standard library), kept
here so that the port imports nothing of the JAX package.

Behavioral parity targets:
  * classification fuzzy match via longest-common-substring
    (main_cls.py:35-62) + balanced accuracy (mean per-class recall,
    main_cls.py:210-214);
  * EvalAI answer normalization + TextVQA soft accuracy
    (main_vqa.py:231-481) — standard VQAv2 evaluation tables;
  * visual-grounding bbox regex parse + IoU@0.5 accuracy with and without
    parse failures (main_vg.py:30-50, :229-287);
  * LHRS-Bench answer normalization (lower/strip articles+punct,
    main_bench_gen.py:41-57) and per-question-type accuracy.
"""

from __future__ import annotations

import re
import string
from collections import defaultdict
from difflib import SequenceMatcher
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

CLS_TEMPLATE = "[CLS] Choose the best categories describe the image from: {}"


def longest_common_substring_index(query: str, candidates: Sequence[str]) -> int:
    best_size, best_idx = 0, -1
    for i, cand in enumerate(candidates):
        size = (SequenceMatcher(None, query, cand)
                .find_longest_match(0, len(query), 0, len(cand)).size)
        if size > best_size:
            best_size, best_idx = size, i
    return best_idx


def classname_to_idx(preds: Sequence[str],
                     class_to_idx: Dict[str, int]) -> List[int]:
    classes = list(class_to_idx.keys())
    out = []
    for pred in preds:
        pred = pred.strip()
        if pred in class_to_idx:
            out.append(class_to_idx[pred])
        else:
            idx = longest_common_substring_index(pred, classes)
            out.append(class_to_idx[classes[idx]] if idx >= 0 else 0)
    return out


def balanced_accuracy(y_true: Sequence[int], y_pred: Sequence[int]) -> float:
    """Mean per-class recall (sklearn balanced_accuracy_score semantics)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    recalls = []
    for cls in np.unique(y_true):
        mask = y_true == cls
        recalls.append(float(np.mean(y_pred[mask] == cls)))
    return float(np.mean(recalls)) if recalls else 0.0


def classification_report_lines(
    y_true: Sequence[int], y_pred: Sequence[int],
    class_names: Sequence[str]) -> str:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    lines = [f"{'class':<24} {'prec':>6} {'recall':>6} {'f1':>6} {'n':>6}"]
    for idx, name in enumerate(class_names):
        t = y_true == idx
        p = y_pred == idx
        tp = float(np.sum(t & p))
        prec = tp / max(float(np.sum(p)), 1e-9)
        rec = tp / max(float(np.sum(t)), 1e-9)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        lines.append(
            f"{name:<24} {prec:6.3f} {rec:6.3f} {f1:6.3f} {int(np.sum(t)):6d}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# VQA (EvalAI / TextVQA protocol)
# ---------------------------------------------------------------------------

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve":
    "could've", "couldnt": "couldn't", "didnt": "didn't", "doesnt":
    "doesn't", "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hes": "he's", "howd": "how'd",
    "howll": "how'll", "hows": "how's", "im": "i'm", "ive": "i've",
    "isnt": "isn't", "itd": "it'd", "itll": "it'll", "lets": "let's",
    "maam": "ma'am", "mightve": "might've", "mustve": "must've", "shant":
    "shan't", "shed": "she'd", "shes": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "somebodyd": "somebody'd", "somebodyll":
    "somebody'll", "somebodys": "somebody's", "someoned": "someone'd",
    "someonell": "someone'll", "someones": "someone's", "somethingd":
    "something'd", "somethingll": "something'll", "thats": "that's",
    "thered": "there'd", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyll": "they'll", "theyre": "they're", "theyve":
    "they've", "twas": "'twas", "wasnt": "wasn't", "wed": "we'd", "weve":
    "we've", "werent": "weren't", "whatll": "what'll", "whatre":
    "what're", "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "wholl": "who'll", "whos": "who's", "whove":
    "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "yall": "y'all", "youd": "you'd", "youll": "you'll", "youre":
    "you're", "youve": "you've",
}

_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = {"a", "an", "the"}
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(?<=\d)(,)+(?=\d)")
_PUNCT = ";/[]\"{}()=+\\_-><@`,?!"


class EvalAIAnswerProcessor:
    """Standard VQAv2/EvalAI answer normalization (main_vqa.py:231-434)."""

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, text: str) -> str:
        out = text
        for p in _PUNCT:
            if (p + " " in text or " " + p in text) or (
                    re.search(_COMMA_STRIP, text) is not None):
                out = out.replace(p, "")
            else:
                out = out.replace(p, " ")
        out = _PERIOD_STRIP.sub("", out, re.UNICODE)
        return out

    def process_digit_article(self, text: str) -> str:
        out = []
        for word in text.lower().split():
            word = _NUMBER_MAP.setdefault(word, word)
            if word not in _ARTICLES:
                out.append(word)
        for i, word in enumerate(out):
            if word in _CONTRACTIONS:
                out[i] = _CONTRACTIONS[word]
        return " ".join(out)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


class TextVQAAccuracyEvaluator:
    """Soft VQA accuracy with per-type breakdown (main_vqa.py:437-481)."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def _compute_answer_scores(self, raw_answers):
        unique_answer_scores: Dict[str, float] = {}
        if isinstance(raw_answers, list):
            answers = [self.answer_processor(a) for a in raw_answers]
            gt_answers = list(enumerate(answers))
            for unique_answer in set(answers):
                accs = []
                for gt_answer in gt_answers:
                    others = [x for x in gt_answers if x != gt_answer]
                    matching = [x for x in others if x[1] == unique_answer]
                    accs.append(min(1.0, len(matching) / 3.0))
                unique_answer_scores[unique_answer] = sum(accs) / len(accs)
        else:
            unique_answer_scores[raw_answers] = 1.0
        return unique_answer_scores

    def eval_pred_list(self, pred_list: List[Dict]) -> Tuple[float, Dict]:
        scores = []
        per_type = defaultdict(list)
        for entry in pred_list:
            pred = self.answer_processor(entry["pred"])
            unique_scores = self._compute_answer_scores(entry["target"])
            score = unique_scores.get(pred, 0.0)
            if score == 0.0 and pred in entry["target"]:
                score = 1.0
            scores.append(score)
            per_type[entry["types"]].append(score)
        accuracy = sum(scores) / max(len(scores), 1)
        per_type_acc = {t: sum(v) / len(v) for t, v in per_type.items()}
        return accuracy, per_type_acc


# ---------------------------------------------------------------------------
# Visual grounding
# ---------------------------------------------------------------------------

_BBOX_RE = re.compile(r"\[([0-9., ]+)\]")


def parse_bbox(text: str) -> Optional[List[float]]:
    """Extract the first [x1, y1, x2, y2] from generated text
    (main_vg.py:229-236); >4 coords are truncated to 4, <4 is a failure."""
    m = _BBOX_RE.search(text)
    if not m:
        return None
    try:
        coords = [float(x) for x in m.group(1).replace(" ", "").split(",")
                  if x != ""]
    except ValueError:
        return None
    if len(coords) < 4:
        return None
    return coords[:4]


def calculate_iou(box1: Sequence[float], box2: Sequence[float]) -> float:
    x1 = max(box1[0], box2[0])
    y1 = max(box1[1], box2[1])
    x2 = min(box1[2], box2[2])
    y2 = min(box1[3], box2[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    a1 = max(0.0, box1[2] - box1[0]) * max(0.0, box1[3] - box1[1])
    a2 = max(0.0, box2[2] - box2[0]) * max(0.0, box2[3] - box2[1])
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def grounding_accuracy(
    preds: Sequence[str], targets: Sequence[Sequence[float]],
    iou_threshold: float = 0.5) -> Dict[str, float]:
    """Returns accuracy over parsed preds and over all preds (parse failures
    count as wrong) — both reported by the reference (main_vg.py:273-287)."""
    hits = 0
    parsed = 0
    for pred_text, target in zip(preds, targets):
        box = parse_bbox(pred_text)
        if box is None:
            continue
        parsed += 1
        if calculate_iou(box, target) > iou_threshold:
            hits += 1
    n = len(preds)
    return {
        "accuracy_parsed": hits / max(parsed, 1),
        "accuracy_all": hits / max(n, 1),
        "parse_failures": n - parsed,
    }


# ---------------------------------------------------------------------------
# LHRS-Bench
# ---------------------------------------------------------------------------


def normalize_answer(text: str) -> str:
    """lower, strip articles + punctuation + extra whitespace
    (main_bench_gen.py:41-57)."""
    text = text.lower()
    text = re.sub(r"\b(a|an|the)\b", " ", text)
    text = "".join(ch for ch in text if ch not in set(string.punctuation))
    return " ".join(text.split())


def bench_accuracy(records: List[Dict]) -> Tuple[float, Dict[str, float]]:
    """records: [{"pred", "answer", "qtype"}] → (total acc, per-type acc).
    A prediction is correct when the normalized gold answer equals the
    normalized prediction (choice letter), per main_bench_gen.py:258-278."""
    per_type = defaultdict(list)
    correct = []
    for rec in records:
        hit = float(
            normalize_answer(rec["pred"]) == normalize_answer(rec["answer"]))
        correct.append(hit)
        for qt in (rec["qtype"] if isinstance(rec["qtype"], (list, tuple))
                   else [rec["qtype"]]):
            per_type[qt].append(hit)
    total = sum(correct) / max(len(correct), 1)
    return total, {t: sum(v) / len(v) for t, v in per_type.items()}
