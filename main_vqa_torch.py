"""RSVQA (LR / HR / xBEN) visual question answering on the PyTorch port
(counterpart of `main_vqa.py`): "<image>[VQA] question" prompts, greedy
generation of at most 50 new tokens, count and area questions left out by
the dataset, per-rank JSON shards merged by rank 0, EvalAI answer
normalization and the soft VQA accuracy per question type.

Run: python main_vqa_torch.py -c Config/multi_modal_eval.yaml \\
       --model-path <FINAL.pt> --data-path <RSVQA root> --data-target LR \\
       [--scheduled-eval] [--batch-size 8] [--device cpu]
"""

from __future__ import annotations

import json
import os


def save_result(records, output_dir: str, rank: int, world_size: int,
                filename: str = "vqa_result"):
    """Write this rank's records as `<filename>_rank<rank>.json`; after a
    barrier of every process, rank 0 merges the shards in rank order into
    `<filename>.json` and returns them (the other ranks None)."""
    from lhrs_bot_tpu_torch.parallel.distribute import barrier

    os.makedirs(output_dir, exist_ok=True)
    shard = os.path.join(output_dir, f"{filename}_rank{rank}.json")
    with open(shard, "w") as fh:
        json.dump(records, fh)
    if world_size > 1:
        barrier("vqa_save")
    if rank != 0:
        return None
    merged = []
    for r in range(world_size):
        with open(os.path.join(output_dir, f"{filename}_rank{r}.json")) as fh:
            merged.extend(json.load(fh))
    with open(os.path.join(output_dir, f"{filename}.json"), "w") as fh:
        json.dump(merged, fh)
    return merged


def main(config=None):
    """Answer `config.data_path`'s questions (`--data-target`: LR, HR,
    USGS, XBEN or a file prefix; config parsed from the command line when
    None). Returns, on rank 0, the merged records (pred, target, types,
    question_id), the metrics, this process's greedy ids, and its images
    and timings (`eval.entry.report`); None on the other ranks."""
    from lhrs_bot_tpu_torch.data.collate import GenerationCollator
    from lhrs_bot_tpu_torch.data.datasets import RSVQA_VARIANTS, RSVQADataset
    from lhrs_bot_tpu_torch.eval import entry
    from lhrs_bot_tpu_torch.eval.metrics import TextVQAAccuracyEvaluator

    if config is None:
        config = entry.parse_eval_config("LHRS-Bot RSVQA eval (PyTorch port)")
    logger, cfg, engine, tokenizer = entry.eval_session(config)

    target = (getattr(config, "data_target", None) or "LR").upper()
    variant = RSVQA_VARIANTS.get(target)
    common = dict(image_size=int(config.rgb_vision.input_size[0]),
                  prompt_type=getattr(config, "prompt_template",
                                      "llava_llama_2"))
    if variant is not None:
        dataset = variant(config.data_path, tokenizer, **common)
    else:  # an explicit file prefix
        dataset = RSVQADataset(config.data_path, tokenizer, prefix=target,
                               **common)
    collator = GenerationCollator(
        tokenizer, extra_keys=("target", "qtype", "question_id"))

    metas, outs, timing = entry.generate(
        cfg, engine, dataset.__getitem__,
        entry.rank_indices(len(dataset), config),
        gen_cfg=entry.greedy(tokenizer, 50),
        batch_size=int(config.batch_size),
        scheduled=bool(config.get("scheduled_eval")),
        batch=entry.collated(collator), logger=logger)
    records = [{"pred": pred, "target": m["target"], "types": m["qtype"],
                "question_id": int(m["question_id"])}
               for m, pred in zip(metas, entry.decode_all(tokenizer, outs))]
    merged = save_result(records, config.output, config.rank,
                         config.world_size)
    if merged is None:
        return None
    acc, per_type = TextVQAAccuracyEvaluator().eval_pred_list(merged)
    for qtype, score in sorted(per_type.items()):
        logger.info("%s: %.2f", qtype, 100.0 * score)
    logger.info("overall soft accuracy: %.4f", acc)
    return entry.report(merged, outs, {"accuracy": acc, "per_type": per_type},
                        timing, logger)


if __name__ == "__main__":
    main()
