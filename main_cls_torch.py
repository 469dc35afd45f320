"""Zero-shot remote-sensing scene classification on the PyTorch port
(counterpart of `main_cls.py`): the prompt "[CLS] Choose the best
categories describe the image from: {classes}", greedy generation of at
most 20 new tokens (30 for METERML), predictions matched to class names by
longest common substring, the per-class report and the balanced accuracy.
Where processes share the eval (torchrun), rank 0 scores every rank's
predictions.

Run: python main_cls_torch.py -c Config/multi_modal_eval.yaml \\
       --model-path <FINAL.pt> --data-path <ImageFolder root> \\
       [--scheduled-eval] [--batch-size 8] [--device cpu]
"""

from __future__ import annotations


def main(config=None):
    """Classify `config.data_path`'s images (config parsed from the command
    line when None). Returns, on rank 0, the records (pred, label), the
    metrics, the greedy ids, and the images and timings
    (`eval.entry.report`); None on the other ranks."""
    from lhrs_bot_tpu_torch.data.build_loader import build_zero_shot_loader
    from lhrs_bot_tpu_torch.eval import entry
    from lhrs_bot_tpu_torch.eval.metrics import (
        CLS_TEMPLATE, balanced_accuracy, classification_report_lines,
        classname_to_idx)
    from lhrs_bot_tpu_torch.models.constants import DEFAULT_IMAGE_TOKEN
    from lhrs_bot_tpu_torch.parallel.distribute import all_gather_object

    if config is None:
        config = entry.parse_eval_config(
            "LHRS-Bot zero-shot classification (PyTorch port)")
    logger, cfg, engine, tokenizer = entry.eval_session(config)

    dataset, class_names = build_zero_shot_loader(config)
    class_to_idx = {c: i for i, c in enumerate(class_names)}
    prompt = entry.prompt_ids(tokenizer, DEFAULT_IMAGE_TOKEN
                              + CLS_TEMPLATE.format(", ".join(class_names)))
    dataset_name = getattr(config.get("eval") or {}, "dataset", "")
    gen_cfg = entry.greedy(tokenizer, 30 if dataset_name == "METERML" else 20)

    def load(i):
        it = dataset[i]
        return {"input_ids": prompt, "image": it["image"],
                "label": it["label"]}

    metas, outs, timing = entry.generate(
        cfg, engine, load, entry.rank_indices(len(dataset), config),
        gen_cfg=gen_cfg, batch_size=int(config.batch_size),
        scheduled=bool(config.get("scheduled_eval")),
        batch=entry.shared_prompt(prompt), logger=logger)
    records = [{"pred": p, "label": m["label"]}
               for m, p in zip(metas, entry.decode_all(tokenizer, outs))]
    gathered = all_gather_object(records)
    if config.rank != 0:
        return None
    records = [r for shard in gathered for r in shard]
    trues = [r["label"] for r in records]
    pred_idx = classname_to_idx([r["pred"] for r in records], class_to_idx)
    acc = balanced_accuracy(trues, pred_idx)
    logger.info("\n%s", classification_report_lines(
        trues, pred_idx, class_names))
    logger.info("balanced accuracy (mean per-class recall): %.4f", acc)
    return entry.report(records, outs, {"balanced_accuracy": acc}, timing,
                        logger)


if __name__ == "__main__":
    main()
