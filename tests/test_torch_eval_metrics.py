"""The port's eval metrics (`lhrs_bot_tpu_torch/eval/metrics.py`) and
caption scorer (`eval/caption.py`) against the JAX package's, exactly:
classification matching, balanced accuracy and the report, the EvalAI
answer normalization and soft VQA accuracy, bbox parsing, IoU and the
grounding accuracy, the LHRS-Bench normalization and accuracy, and every
caption metric (BLEU-1..4, CIDEr-D, ROUGE-L, the Porter stemmer, METEOR),
on seeded inputs and on hypothesis-drawn strings, boxes and labels.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from lhrs_bot_tpu.eval import caption as j_cap
from lhrs_bot_tpu.eval import metrics as j_met
from lhrs_bot_tpu_torch.eval import caption as t_cap
from lhrs_bot_tpu_torch.eval import metrics as t_met

WORDS = ("the", "a", "an", "two", "three", "none", "yes", "no", "road",
         "roads", "buildings", "building", "running", "runs", "generalized",
         "happiness", "caresses", "ponies", "relational", "hopeful",
         "rural", "urban", "isnt", "dont", "whats", "it's", "A.", "B.",
         "C.", "D.", "[10,", "20,", "30,", "40]", "3.5", "1,000", "e.g.",
         "x-ray", "(left)", "?", "!", "/", "@")
CLASSES = ["airport", "beach", "dense residential", "forest",
           "medium residential", "parking lot"]
SETTINGS = settings(max_examples=60, deadline=None)

text = st.lists(st.sampled_from(WORDS), min_size=0, max_size=12).map(
    " ".join)
free_text = st.text(alphabet=st.characters(min_codepoint=32,
                                           max_codepoint=126), max_size=40)
coord = st.floats(min_value=-5, max_value=120, allow_nan=False,
                  width=32)
box = st.lists(coord, min_size=4, max_size=4)


def _sentences(rng, n, lo=0, hi=10):
    return [" ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))
            for _ in range(n)]


def _same(a, b):
    """Equal values, with floats equal to the bit."""
    assert type(a) is type(b) or (isinstance(a, float)
                                  and isinstance(b, float)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)
    else:
        assert a == b


def test_the_port_keeps_its_own_copies():
    """The port's metrics are its own module, with the same template."""
    assert t_met is not j_met and t_cap is not j_cap
    assert t_met.CLS_TEMPLATE == j_met.CLS_TEMPLATE
    assert t_met.__file__.endswith("lhrs_bot_tpu_torch/eval/metrics.py")


@pytest.mark.parametrize("seed", range(4))
def test_classification_seeded(seed):
    rng = np.random.default_rng(seed)
    class_to_idx = {c: i for i, c in enumerate(CLASSES)}
    preds = [CLASSES[int(rng.integers(len(CLASSES)))] + " " * int(
        rng.integers(2)) if rng.random() < 0.4 else s
        for s in _sentences(rng, 30)]
    preds += ["parking", "residential area", "", "forests and beaches"]
    for fn in ("classname_to_idx",):
        _same(getattr(t_met, fn)(preds, class_to_idx),
              getattr(j_met, fn)(preds, class_to_idx))
    for query in preds:
        _same(t_met.longest_common_substring_index(query, CLASSES),
              j_met.longest_common_substring_index(query, CLASSES))
    y_true = rng.integers(0, len(CLASSES), 40).tolist()
    y_pred = rng.integers(0, len(CLASSES), 40).tolist()
    _same(t_met.balanced_accuracy(y_true, y_pred),
          j_met.balanced_accuracy(y_true, y_pred))
    _same(t_met.classification_report_lines(y_true, y_pred, CLASSES),
          j_met.classification_report_lines(y_true, y_pred, CLASSES))
    _same(t_met.balanced_accuracy([], []), j_met.balanced_accuracy([], []))


@SETTINGS
@given(preds=st.lists(free_text, max_size=8),
       labels=st.lists(st.integers(0, 5), min_size=1, max_size=20),
       guesses=st.lists(st.integers(0, 5), min_size=20, max_size=20))
def test_classification_drawn(preds, labels, guesses):
    class_to_idx = {c: i for i, c in enumerate(CLASSES)}
    _same(t_met.classname_to_idx(preds, class_to_idx),
          j_met.classname_to_idx(preds, class_to_idx))
    guesses = guesses[:len(labels)]
    _same(t_met.balanced_accuracy(labels, guesses),
          j_met.balanced_accuracy(labels, guesses))
    _same(t_met.classification_report_lines(labels, guesses, CLASSES),
          j_met.classification_report_lines(labels, guesses, CLASSES))


def _vqa_records(rng, n):
    recs = []
    for i in range(n):
        target = str(rng.choice(["yes", "no", "rural", "urban", "2",
                                 "two roads", "the building"]))
        if rng.random() < 0.3:  # a list of annotator answers
            target = [str(rng.choice(["yes", "no", "two", "2"]))
                      for _ in range(int(rng.integers(1, 6)))]
        recs.append({"pred": _sentences(rng, 1, 0, 4)[0],
                     "target": target,
                     "types": str(rng.choice(["presence", "comp",
                                              "rural_urban"]))})
    return recs


@pytest.mark.parametrize("seed", range(4))
def test_vqa_seeded(seed):
    rng = np.random.default_rng(seed)
    recs = _vqa_records(rng, 40)
    _same(t_met.TextVQAAccuracyEvaluator().eval_pred_list(recs),
          j_met.TextVQAAccuracyEvaluator().eval_pred_list(recs))
    tp, jp = t_met.EvalAIAnswerProcessor(), j_met.EvalAIAnswerProcessor()
    for s in _sentences(rng, 30) + ["Two, three!", "it's 1,000 m.",
                                    "(a) x-ray; y/z", "3.5 e.g. isnt"]:
        _same(tp(s), jp(s))


@SETTINGS
@given(answers=st.lists(st.tuples(text, text, st.booleans(),
                                  st.sampled_from(["a", "b"])),
                        min_size=1, max_size=10))
def test_vqa_drawn(answers):
    recs = [{"pred": p, "target": [t, p] if as_list else t, "types": ty}
            for p, t, as_list, ty in answers]
    _same(t_met.TextVQAAccuracyEvaluator().eval_pred_list(recs),
          j_met.TextVQAAccuracyEvaluator().eval_pred_list(recs))


@pytest.mark.parametrize("seed", range(3))
def test_grounding_seeded(seed):
    rng = np.random.default_rng(seed)
    targets, preds = [], []
    for _ in range(40):
        t = sorted(rng.integers(0, 100, 2).tolist())
        u = sorted(rng.integers(0, 100, 2).tolist())
        targets.append([t[0], u[0], t[1], u[1]])
        jitter = rng.integers(-8, 9, 4)
        form = int(rng.integers(5))
        box_ = [int(a + b) for a, b in zip(targets[-1], jitter)]
        preds.append([f"the car [{box_[0]}, {box_[1]}, {box_[2]}, "
                      f"{box_[3]}]", f"[{box_[0]},{box_[1]}]",
                      f"{box_} and [1,2,3,4,5,6]", "no box here",
                      f"[{box_[0] / 100:.2f}, 0.1, 0.5, 0.9] x"][form])
    _same(t_met.grounding_accuracy(preds, targets),
          j_met.grounding_accuracy(preds, targets))
    for p in preds:
        _same(t_met.parse_bbox(p), j_met.parse_bbox(p))


@SETTINGS
@given(a=box, b=box, pred=free_text)
def test_grounding_drawn(a, b, pred):
    _same(t_met.calculate_iou(a, b), j_met.calculate_iou(a, b))
    _same(t_met.parse_bbox(pred), j_met.parse_bbox(pred))
    shown = f"box [{a[0]}, {a[1]}, {a[2]}, {a[3]}] {pred}"
    for iou in (0.5, 0.1):
        _same(t_met.grounding_accuracy([shown, pred], [b, a], iou),
              j_met.grounding_accuracy([shown, pred], [b, a], iou))


@pytest.mark.parametrize("seed", range(3))
def test_bench_seeded(seed):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(40):
        ans = str(rng.choice(["A.", "B.", "C.", "D."]))
        pred = str(rng.choice([ans, ans.lower(), ans[0], "The " + ans,
                               "B", " c. ", "none"]))
        qtype = (str(rng.integers(1, 5)) if rng.random() < 0.5 else
                 [str(t) for t in rng.integers(1, 5, 2)])
        recs.append({"pred": pred, "answer": ans, "qtype": qtype})
    _same(t_met.bench_accuracy(recs), j_met.bench_accuracy(recs))
    for r in recs:
        _same(t_met.normalize_answer(r["pred"]),
              j_met.normalize_answer(r["pred"]))


@SETTINGS
@given(rows=st.lists(st.tuples(free_text, free_text,
                               st.sampled_from(["1", "2", ("1", "3")])),
                     min_size=1, max_size=10))
def test_bench_drawn(rows):
    recs = [{"pred": p, "answer": a,
             "qtype": list(t) if isinstance(t, tuple) else t}
            for p, a, t in rows]
    _same(t_met.bench_accuracy(recs), j_met.bench_accuracy(recs))


@pytest.mark.parametrize("fn", ["bleu", "cider_d", "rouge_l", "meteor",
                                "caption_eval"])
@pytest.mark.parametrize("seed", range(3))
def test_caption_seeded(fn, seed):
    rng = np.random.default_rng(seed)
    preds = _sentences(rng, 12, 0, 12)
    refs = [_sentences(rng, int(rng.integers(1, 4)), 1, 12)
            for _ in preds]
    refs[0] = [preds[0]]  # one exact match
    _same(getattr(t_cap, fn)(preds, refs), getattr(j_cap, fn)(preds, refs))


@SETTINGS
@given(rows=st.lists(st.tuples(text, st.lists(text, min_size=1,
                                              max_size=3)),
                     min_size=1, max_size=6))
def test_caption_drawn(rows):
    preds = [p for p, _ in rows]
    refs = [r for _, r in rows]
    _same(t_cap.caption_eval(preds, refs), j_cap.caption_eval(preds, refs))


@SETTINGS
@given(word=st.text(alphabet="abcdefghijklmnopqrstuvwxyz", max_size=14))
def test_porter_stem_drawn(word):
    _same(t_cap._porter_stem(word), j_cap._porter_stem(word))
    _same(t_cap._tokenize(word.upper() + ", " + word),
          j_cap._tokenize(word.upper() + ", " + word))
