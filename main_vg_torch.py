"""Visual grounding (DIOR-RSVG / RSVG) on the PyTorch port (counterpart of
`main_vg.py`): greedy generation of at most 100 new tokens, "[x1, y1, x2,
y2]" parsed by the bbox regex, every rank's predictions gathered on rank
0, IoU@0.5 accuracy over the parsed predictions and over all of them
(parse failures as misses).

Run: python main_vg_torch.py -c Config/multi_modal_eval.yaml \\
       --model-path <FINAL.pt> --data-path <image dir> \\
       --data-target <DIOR_test.json> [--scheduled-eval] [--device cpu]
"""

from __future__ import annotations


def main(config=None):
    """Ground `--data-target`'s referring questions over the images of
    `--data-path` (config parsed from the command line when None).
    Returns, on rank 0, the records (pred, target), the metrics, this
    process's greedy ids, and its images and timings
    (`eval.entry.report`); None on the other ranks."""
    from lhrs_bot_tpu_torch.data.collate import GenerationCollator
    from lhrs_bot_tpu_torch.data.datasets import VGEvalDataset
    from lhrs_bot_tpu_torch.eval import entry
    from lhrs_bot_tpu_torch.eval.metrics import grounding_accuracy
    from lhrs_bot_tpu_torch.parallel.distribute import all_gather_object

    if config is None:
        config = entry.parse_eval_config(
            "LHRS-Bot visual grounding eval (PyTorch port)")
    logger, cfg, engine, tokenizer = entry.eval_session(config)

    dataset = VGEvalDataset(
        config.data_path, config.data_target, tokenizer,
        image_size=int(config.rgb_vision.input_size[0]),
        prompt_type=getattr(config, "prompt_template", "llava_llama_2"))
    collator = GenerationCollator(tokenizer, extra_keys=("target",))

    metas, outs, timing = entry.generate(
        cfg, engine, dataset.__getitem__,
        entry.rank_indices(len(dataset), config),
        gen_cfg=entry.greedy(tokenizer, 100),
        batch_size=int(config.batch_size),
        scheduled=bool(config.get("scheduled_eval")),
        batch=entry.collated(collator), logger=logger)
    records = [{"pred": pred, "target": m["target"]}
               for m, pred in zip(metas, entry.decode_all(tokenizer, outs))]
    gathered = all_gather_object(records)
    if config.rank != 0:
        return None
    records = [r for shard in gathered for r in shard]
    preds = [r["pred"] for r in records]
    res = grounding_accuracy(preds, [r["target"] for r in records])
    logger.info("IoU@0.5 accuracy (parsed preds): %.4f",
                res["accuracy_parsed"])
    logger.info("IoU@0.5 accuracy (all preds):    %.4f", res["accuracy_all"])
    logger.info("parse failures: %d / %d", res["parse_failures"], len(preds))
    return entry.report(records, outs, res, timing, logger)


if __name__ == "__main__":
    main()
