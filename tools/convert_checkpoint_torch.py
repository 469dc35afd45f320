"""Convert reference-format checkpoints to the PyTorch port's converted
checkpoint (the port's counterpart of tools/convert_checkpoint.py, which
writes orbax for the JAX package).

Reading FINAL.pt + the HF shards + TextLoRA (and merging the adapters at
stage 0) is slow and host-memory heavy at 7B; a one-time conversion makes
a later start a mapped read:

    python tools/convert_checkpoint_torch.py -c Config/multi_modal_eval.yaml \
        --model-path FINAL.pt --output out/

with the YAML's `rgb_vision.vit_name` and `text.path` local directories
(or null). The tree goes to <output>/converted; it prints one JSON line
({"path", "load_s", "convert_save_s", "bytes", "leaves"}).

Loading back: lhrs_bot_tpu_torch.core.model_io.load_converted_params(path).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(args=None):
    from lhrs_bot_tpu_torch.core.bootstrap import parse_config, setup
    from lhrs_bot_tpu_torch.core.model_io import (load_pretrained,
                                                  save_converted_params)
    from lhrs_bot_tpu_torch.models.vlm import VLMConfig

    config = parse_config("Convert reference checkpoints to the port's "
                          "converted checkpoint", args=args)
    logger = setup(config)
    cfg = VLMConfig.from_config_dict(config)
    t0 = time.perf_counter()
    params, _ = load_pretrained(
        cfg, model_path=config.get("model_path"),
        vit_path=config["rgb_vision"].get("vit_name"),
        llama_path=config["text"].get("path"))
    load_s = time.perf_counter() - t0
    out = os.path.join(config.output, "converted")
    t0 = time.perf_counter()
    save_converted_params(out, params)
    save_s = time.perf_counter() - t0
    logger.info("wrote the converted checkpoint to %s", out)
    with open(os.path.join(out, "params.index.json")) as fh:
        index = json.load(fh)
    report = {"path": out, "load_s": load_s, "convert_save_s": save_s,
              "bytes": index["total_bytes"],
              "leaves": len(index["weight_map"])}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
