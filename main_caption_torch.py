"""Remote-sensing caption eval on the PyTorch port (counterpart of
`main_caption.py`; RSICD / UCM / Sydney / NWPU / TextRS annotation
formats): the shared instruction "Describe the image concisely.", greedy
generation of at most 60 new tokens, per-rank shards merged by rank 0 (the
RSVQA entry's `save_result`), BLEU-1..4, CIDEr-D, ROUGE-L and METEOR from
the port's own scorer (`eval/caption.py`).

Run: python main_caption_torch.py -c Config/multi_modal_eval.yaml \\
       --model-path <FINAL.pt> --data-path <image root> \\
       --data-target <annotation json> [--scheduled-eval] [--device cpu]
"""

from __future__ import annotations

from main_vqa_torch import save_result


def main(config=None):
    """Caption the images of `--data-target` under `--data-path` (config
    parsed from the command line when None). Returns, on rank 0, the
    merged records (pred, target, filename), the scores, this process's
    greedy ids, and its images and timings (`eval.entry.report`); None on
    the other ranks."""
    from lhrs_bot_tpu_torch.data.datasets import CapEvalDataset
    from lhrs_bot_tpu_torch.eval import entry
    from lhrs_bot_tpu_torch.eval.caption import caption_eval
    from lhrs_bot_tpu_torch.models.constants import DEFAULT_IMAGE_TOKEN

    if config is None:
        config = entry.parse_eval_config(
            "LHRS-Bot caption eval (PyTorch port)")
    logger, cfg, engine, tokenizer = entry.eval_session(config)

    dataset = CapEvalDataset(config.data_path, config.data_target, tokenizer,
                             image_size=int(config.rgb_vision.input_size[0]))
    prompt = entry.prompt_ids(
        tokenizer, DEFAULT_IMAGE_TOKEN + "\nDescribe the image concisely.")

    def load(i):
        it = dataset[i]
        return {"input_ids": prompt, "image": it["image"],
                "target": it["caption"], "filename": it["filename"]}

    metas, outs, timing = entry.generate(
        cfg, engine, load, entry.rank_indices(len(dataset), config),
        gen_cfg=entry.greedy(tokenizer, 60),
        batch_size=int(config.batch_size),
        scheduled=bool(config.get("scheduled_eval")),
        batch=entry.shared_prompt(prompt), logger=logger)
    records = [{"pred": pred, **m}
               for m, pred in zip(metas, entry.decode_all(tokenizer, outs))]
    merged = save_result(records, config.output, config.rank,
                         config.world_size, filename="caption_result")
    if merged is None:
        return None
    scores = caption_eval([r["pred"] for r in merged],
                          [[r["target"]] for r in merged])
    for name, val in sorted(scores.items()):
        logger.info("%s: %.4f", name, val)
    return entry.report(merged, outs, scores, timing, logger)


if __name__ == "__main__":
    main()
