"""Eval-protocol factories for training-time evaluation hooks.

Counterpart of `lhrs_bot_tpu/eval/protocols.py`: the zero-shot
classification protocol (`main_cls_torch.py`'s) and the COCO-style caption
protocol packaged as zero-argument callables returning metric dicts, for
`train.hooks.EvalHook` (which handles periodicity and best-checkpoint
tracking). They generate through `eval.entry`'s batched loop.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

from ..data.preprocess import wrap_image_token_for_generation
from ..models.constants import DEFAULT_IMAGE_TOKEN
from . import entry
from .caption import caption_eval
from .metrics import CLS_TEMPLATE, balanced_accuracy, classname_to_idx


def _greedy_over(engine, tokenizer, dataset, prompt, max_new_tokens,
                 batch_size, max_samples):
    """An eval_fn's pass: the first `max_samples` items of `dataset`
    (all without it), each asking `prompt`, batched through
    `engine.generate`; returns the items' fields and the decoded texts."""
    n = min(len(dataset), max_samples or len(dataset))
    metas, outs, _ = entry.generate(
        None, engine, dataset.__getitem__, list(range(n)),
        gen_cfg=entry.greedy(tokenizer, max_new_tokens),
        batch_size=batch_size, scheduled=False,
        batch=entry.shared_prompt(prompt))
    return metas, entry.decode_all(tokenizer, outs)


def make_cls_eval_fn(
    engine,
    tokenizer,
    dataset,
    class_names: Sequence[str],
    *,
    batch_size: int = 8,
    max_new_tokens: int = 20,
    max_samples: Optional[int] = None,
    prompt_template: str = "llava_llama_2",
) -> Callable[[], Dict[str, float]]:
    """Zero-shot scene classification (main_cls_torch.py's protocol) as an
    eval_fn."""
    class_to_idx = {c: i for i, c in enumerate(class_names)}
    prompt = entry.prompt_ids(
        tokenizer, DEFAULT_IMAGE_TOKEN + CLS_TEMPLATE.format(
            ", ".join(class_names)), prompt_template)

    def eval_fn() -> Dict[str, float]:
        metas, preds = _greedy_over(engine, tokenizer, dataset, prompt,
                                    max_new_tokens, batch_size, max_samples)
        pred_idx = classname_to_idx(preds, class_to_idx)
        return {"accuracy": balanced_accuracy([m["label"] for m in metas],
                                              pred_idx)}

    return eval_fn


def make_caption_eval_fn(
    engine,
    tokenizer,
    dataset,
    *,
    batch_size: int = 8,
    max_new_tokens: int = 48,
    max_samples: Optional[int] = None,
    prompt: str = "Describe the image concisely.",
    prompt_template: str = "llava_llama_2",
) -> Callable[[], Dict[str, float]]:
    """COCO-style caption eval (BLEU/CIDEr/ROUGE-L/METEOR) as an eval_fn,
    with "accuracy" = CIDEr-D for EvalHook's best checkpoint."""
    ids = entry.prompt_ids(
        tokenizer, wrap_image_token_for_generation(
            DEFAULT_IMAGE_TOKEN + "\n" + prompt), prompt_template)

    def eval_fn() -> Dict[str, float]:
        metas, preds = _greedy_over(engine, tokenizer, dataset, ids,
                                    max_new_tokens, batch_size, max_samples)
        metrics = caption_eval(preds, [[m["caption"]] for m in metas])
        metrics["accuracy"] = metrics["cider"]  # best-ckpt key for EvalHook
        return metrics

    return eval_fn
