"""Full-7B-shape end-to-end rehearsal of the PyTorch port on one card (the
port's counterpart of tools/rehearse_full_scale.py).

Loads the full-scale random reference-format artifacts written by
tools/make_fake_reference_ckpt.py through the port's real load path
(`load_pretrained`: HF LLaMA + HF CLIP + FINAL.pt with resized
embed_tokens + the TextLoRA merge at stage 0), optionally converts the tree
once and reloads it (`--convert`: `save_converted_params` /
`load_converted_params`, the port's orbax step), builds the int8 engine
with the fused W8A8 vision tower and generates from an image prompt.

Usage:
    python tools/make_fake_reference_ckpt.py --output /tmp/fake7b
    python tools/rehearse_full_scale_torch.py --ckpt /tmp/fake7b [--convert]

The tokenizer is `load_tokenizer` of the decoder directory (<ckpt>/llama):
the SentencePiece LLaMA tokenizer where it holds a tokenizer.model, the
byte-level tokenizer otherwise. `-c YAML` takes the model's shapes from a
config (a reduced checkpoint); without it they are LHRS-Bot's (ViT-L/14,
LLaMA-2-7B, LoRA r 128) and the tree must hold more than 6.9e9 parameters.

Prints one JSON line: load_s, convert_save_s / convert_load_s (with
--convert), engine_init_s, the card's peak GiB, the first and the steady
generate's seconds and the steady tok/s.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--convert", action="store_true",
                    help="also convert the loaded tree once and reload it "
                         "from the converted checkpoint")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("-c", "--config", default=None,
                    help="a YAML with the model's shapes (default: the "
                         "full-scale LHRS-Bot model)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from lhrs_bot_tpu_torch.core.convert import params_from_numpy
    from lhrs_bot_tpu_torch.core.model_io import (load_converted_params,
                                                  load_pretrained,
                                                  save_converted_params)
    from lhrs_bot_tpu_torch.data.preprocess import tokenizer_image_token
    from lhrs_bot_tpu_torch.data.tokenizer import load_tokenizer
    from lhrs_bot_tpu_torch.device import resolve_device
    from lhrs_bot_tpu_torch.models.lora import LoraConfig
    from lhrs_bot_tpu_torch.models.vlm import VLMConfig
    from lhrs_bot_tpu_torch.serve.engine import (GenerationConfig,
                                                 GenerationEngine)

    device = resolve_device(args.device)
    if args.config:
        from lhrs_bot_tpu_torch.core.config import load_yaml_config

        cfg = VLMConfig.from_config_dict(load_yaml_config(args.config))
    else:
        cfg = VLMConfig(stage=0, lora=LoraConfig(r=128, alpha=256))
    llama_dir = os.path.join(args.ckpt, "llama")
    report = {}

    t0 = time.perf_counter()
    params, _ = load_pretrained(
        cfg, model_path=os.path.join(args.ckpt, "FINAL.pt"),
        vit_path=os.path.join(args.ckpt, "clip"), llama_path=llama_dir)
    report["load_s"] = time.perf_counter() - t0
    assert "lora" not in params, "stage 0 must merge LoRA"

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)

    n_params = sum(int(np.prod(x.shape)) for x in leaves(params))
    report["n_params"] = n_params
    if not args.config:
        assert n_params > 6.9e9, n_params

    if args.convert:
        path = os.path.join(args.ckpt, "converted")
        t0 = time.perf_counter()
        save_converted_params(path, params)
        report["convert_save_s"] = time.perf_counter() - t0
        del params
        t0 = time.perf_counter()
        params = load_converted_params(path, cfg)
        report["convert_load_s"] = time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    engine = GenerationEngine(
        cfg, params_from_numpy(params), device=device, max_seq_len=2304, quantize_bits=8,
        vision_w8a8=device.type == "cuda",
        compute_dtype=torch.bfloat16 if device.type == "cuda"
        else torch.float32)
    report["engine_init_s"] = time.perf_counter() - t0
    del params

    tok = load_tokenizer(llama_dir)
    report["tokenizer"] = type(tok).__name__
    prompt = "<image>\nDescribe the scene."
    ids = np.asarray([tokenizer_image_token(prompt, tok)], np.int32)
    size = cfg.vit.image_size
    img = np.random.default_rng(0).integers(
        0, 255, (1, size, size, 3)).astype(np.uint8)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           eos_token_id=tok.eos_token_id,
                           pad_token_id=tok.pad_token_id)
    lens = np.asarray([ids.shape[1]], np.int32)

    def run():
        t0 = time.perf_counter()
        out = engine.generate(ids, lens, images=img, gen_cfg=gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out, time.perf_counter() - t0

    out, report["first_generate_s"] = run()  # the kernels' build included
    out, dt = run()
    report["steady_generate_s"] = dt
    report["tokens"] = len(out[0])
    report["tok_s"] = len(out[0]) / max(dt, 1e-9)
    report["text"] = tok.decode(out[0], skip_special_tokens=True)
    report["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else None)
    report["ok"] = True
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
