"""LHRS-Bench multiple-choice eval on the PyTorch port (counterpart of
`main_bench_gen.py`): one question an item, the prompt "<image>\\n" +
question + "\\nChoices: " + choices + " Answer from the given choices with
A., B., C., D., etc.", greedy generation of at most 10 new tokens, every
rank's records gathered on rank 0, the normalized answer matched, accuracy
per question type (named by the file's `qtype` table) and in total.

Run: python main_bench_gen_torch.py -c Config/multi_modal_eval.yaml \\
       --model-path <FINAL.pt> --data-path <image dir> \\
       --data-target <bench.json> [--scheduled-eval] [--device cpu]
"""

from __future__ import annotations


def main(config=None):
    """Answer `--data-target`'s questions over the images of
    `--data-path` (config parsed from the command line when None).
    Returns, on rank 0, the records (pred, answer, qtype), the metrics,
    this process's greedy ids, and its images and timings
    (`eval.entry.report`); None on the other ranks."""
    import numpy as np

    from lhrs_bot_tpu_torch.data.collate import GenerationCollator
    from lhrs_bot_tpu_torch.data.datasets import LHRSBenchDataset
    from lhrs_bot_tpu_torch.eval import entry
    from lhrs_bot_tpu_torch.eval.metrics import bench_accuracy
    from lhrs_bot_tpu_torch.models.constants import DEFAULT_IMAGE_TOKEN
    from lhrs_bot_tpu_torch.parallel.distribute import all_gather_object

    if config is None:
        config = entry.parse_eval_config(
            "LHRS-Bot LHRS-Bench eval (PyTorch port)")
    logger, cfg, engine, tokenizer = entry.eval_session(config)

    dataset = LHRSBenchDataset(config.data_path, config.data_target,
                               image_size=int(config.rgb_vision.input_size[0]))
    collator = GenerationCollator(tokenizer, extra_keys=("answer", "type"))

    def load(i):
        item = dataset[i]
        item["input_ids"] = np.asarray(entry.prompt_ids(
            tokenizer, DEFAULT_IMAGE_TOKEN + "\n" + item["question"]
            + "\nChoices: " + item["choices"] + " Answer from the given "
            "choices with A., B., C., D., etc."))
        return item

    metas, outs, timing = entry.generate(
        cfg, engine, load, entry.rank_indices(len(dataset), config),
        gen_cfg=entry.greedy(tokenizer, 10),
        batch_size=int(config.batch_size),
        scheduled=bool(config.get("scheduled_eval")),
        batch=entry.collated(collator), logger=logger)
    records = [{"pred": pred.strip(), "answer": m["answer"],
                "qtype": m["type"]}
               for m, pred in zip(metas, entry.decode_all(tokenizer, outs))]
    gathered = all_gather_object(records)
    if config.rank != 0:
        return None
    records = [r for shard in gathered for r in shard]
    total, per_type = bench_accuracy(records)
    named = {}
    for qtype, score in sorted(per_type.items()):
        name = dataset.id_to_type.get(str(qtype), str(qtype))
        named[name] = score
        logger.info("%s: %.2f", name, 100.0 * score)
    logger.info("total accuracy: %.4f", total)
    return entry.report(records, outs, {"total": total, "per_type": named},
                        timing, logger)


if __name__ == "__main__":
    main()
