"""What the five eval entry points (`main_{cls,vqa,vg,bench_gen,caption}
_torch.py`) share: the command line, the session (model, tokenizer and
engine on the config's device) and greedy generation over a rank's share
of a dataset, batched through `GenerationEngine.generate` or, with
`--scheduled-eval`, through `eval.scheduled.scheduler_generate`. The JAX
entries repeat this preamble and these two loops each; the port keeps one
copy.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.bootstrap import (add_eval_args, build_engine,
                              build_model_and_tokenizer, parse_config, setup)
from ..data import conversation as conv_lib
from ..data.preprocess import tokenizer_image_token
from ..device import resolve_device
from ..serve.engine import GenerationConfig
from .scheduled import scheduler_generate

# the keys of an item that go to the engine, not into its record
_INPUTS = ("input_ids", "image")


def parse_eval_config(description: str, args=None):
    """Parse the YAML and the common and eval flags, joining torchrun's
    process group (with `--dist-backend`) where the environment names one
    (rank and world size from the group)."""
    return parse_config(description, extra=add_eval_args, args=args)


def eval_session(config):
    """(logger, cfg, engine, tokenizer) of `config` on `config.device`
    (cuda unless it says cpu; a CUDA device with no card visible raises),
    with the config's prompt template made the default conversation.
    `--dp`, or `--tp` above 1, raises NotImplementedError: the eval
    entries run no mesh, as the JAX eval mains build none (under torchrun
    each rank takes its share of the items instead)."""
    if int(config.get("dp") or 1) > 1 or int(config.get("tp") or 1) > 1:
        raise NotImplementedError("--dp / --tp > 1: the eval entries run "
                                  "no mesh (as JAX's); under torchrun each "
                                  "rank evaluates its share of the items")
    device = resolve_device(config.get("device") or "cuda")
    config.setdefault("rank", 0)
    config.setdefault("world_size", 1)
    logger = setup(config)
    cfg, params, tokenizer = build_model_and_tokenizer(config, device)
    engine = build_engine(cfg, params, config, device)
    del params
    conv_lib.set_default_conversation(
        getattr(config, "prompt_template", "llava_llama_2"))
    return logger, cfg, engine, tokenizer


def greedy(tokenizer, max_new_tokens: int) -> GenerationConfig:
    return GenerationConfig(max_new_tokens=max_new_tokens, do_sample=False,
                            eos_token_id=tokenizer.eos_token_id,
                            pad_token_id=tokenizer.pad_token_id)


def prompt_ids(tokenizer, question: str,
               template: Optional[str] = None) -> List[int]:
    """One user turn of `question` (with its "<image>" marker) in the
    default conversation (which `eval_session` sets from the config), or
    in the named `template` (the protocols' own argument), and the open
    assistant turn, tokenized around the image marker."""
    conv = (conv_lib.conv_templates[template] if template
            else conv_lib.default_conversation).copy()
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], None)
    return tokenizer_image_token(conv.get_prompt(), tokenizer)


def shared_prompt(ids: Sequence[int]) -> Callable:
    """Batched inputs of items that all ask one prompt: the prompt tiled
    (unpadded), its length, the images stacked."""
    ids = np.asarray(ids, np.int32)

    def batch(items):
        b = len(items)
        return (np.tile(ids[None], (b, 1)), np.full((b,), len(ids), np.int32),
                np.stack([it["image"] for it in items]))
    return batch


def collated(collator) -> Callable:
    """Batched inputs of items with prompts of their own, through a
    `GenerationCollator`."""
    def batch(items):
        b = collator(items)
        return b["input_ids"], b["seq_lens"], b.get("images")
    return batch


def rank_indices(n: int, config) -> List[int]:
    """This process's share of n items: every world_size-th from rank."""
    return list(range(int(config.rank), n, int(config.world_size)))


def generate(cfg, engine, load: Callable[[int], Dict], indices: List[int],
             *, gen_cfg: GenerationConfig, batch_size: int, scheduled: bool,
             batch: Callable, logger=None
             ) -> Tuple[List[Dict], List[List[int]], Dict[str, float]]:
    """Greedy ids for the items `load(i)`, i in `indices` (dicts with
    "input_ids" and "image", and the fields of their records). Batched:
    `batch(items)` gives (ids, lengths, images) for `engine.generate`,
    `batch_size` items at a time. Scheduled: the items stream lazily into
    a continuous-batching scheduler of `batch_size` slots. Progress is
    logged to `logger` where one is given. Returns the
    items without their inputs (in index order), their ids, and the
    seconds of the whole loop ("seconds", ending when the last ids are on
    the host) and of the items' loads within it ("load_seconds": image
    decode and resize, prompt tokenization)."""
    metas: List[Dict] = []
    outs: List[List[int]] = []
    loading = [0.0]
    t0 = time.perf_counter()

    def loaded(i):
        t = time.perf_counter()
        item = load(i)
        loading[0] += time.perf_counter() - t
        metas.append({k: v for k, v in item.items() if k not in _INPUTS})
        return item

    if scheduled:
        outs = scheduler_generate(
            cfg, engine, (loaded(i) for i in indices), len(indices),
            gen_cfg=gen_cfg, max_batch=batch_size, logger=logger)
    else:
        for start in range(0, len(indices), batch_size):
            items = [loaded(i) for i in indices[start:start + batch_size]]
            ids, lens, images = batch(items)
            outs += engine.generate(ids, lens, images=images,
                                    gen_cfg=gen_cfg)
            if logger is not None and (start // batch_size) % 10 == 0:
                logger.info("eval %d/%d", start + len(items), len(indices))
    return metas, outs, {"seconds": time.perf_counter() - t0,
                         "load_seconds": loading[0]}


def decode_all(tokenizer, outs: List[List[int]]) -> List[str]:
    return [tokenizer.decode(ids, skip_special_tokens=True) for ids in outs]


def report(records, ids, metrics, timing, logger) -> Dict:
    """An entry's result: its records, the metrics it reported, this
    process's greedy ids, its images, and `generate`'s seconds and load
    seconds (also logged, with images/s)."""
    n, seconds = len(ids), timing["seconds"]
    logger.info("generated for %d images in %.3f s (%.2f images/s; "
                "loading the items %.3f s)", n, seconds,
                n / seconds if seconds else 0.0, timing["load_seconds"])
    return {"records": records, "metrics": metrics, "ids": ids,
            "images": n, **timing}
