"""Model, engine and trainer assembly from the config surface (counterpart
of lhrs_bot_tpu/core/bootstrap.py `build_model_and_tokenizer` without the
tokenizer, and `build_engine`, and of what `main_pretrain_stage1.py` /
`main_pretrain_stage3.py` compose around the trainer)."""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..serve.engine import GenerationEngine
from .convert import params_from_numpy


def build_model(config, device="cuda"):
    """(cfg, params, report) for `config` (a nested dict with the schema of
    `Config/*.yaml`): the VLMConfig, and `core.model_io.load_pretrained` of
    `model_path`, `rgb_vision.vit_name` and `text.path` (a key that is
    missing or None loads nothing; a path that does not exist raises, so a
    hub name such as the YAML's `openai/clip-vit-large-patch14` has to be
    replaced by a local directory). At a training stage (stage != 0) with
    `bits` 8 or 4 the decoder's projections are quantized on `device` as
    the JAX bootstrap quantizes them (`quantize_llama_layers` with the
    config's `quant_type` and `double_quant`; the LoRA then trains as the
    runtime side path, QLoRA); every other leaf stays a host numpy array.
    `report` is load_pretrained's: the artifacts loaded and the leaves left
    at their random init."""
    from ..models.vlm import VLMConfig
    from ..ops.quant import _QUANT_TARGETS, quantize_llama_layers
    from .model_io import load_pretrained

    cfg = VLMConfig.from_config_dict(config)
    params, report = load_pretrained(
        cfg, model_path=config.get("model_path"),
        vit_path=config["rgb_vision"].get("vit_name"),
        llama_path=config["text"].get("path"))
    bits = int(config.get("bits", 16) or 16)
    if bits in (4, 8) and cfg.stage != 0:
        device = resolve_device(device)
        quant_type = str(config.get("quant_type", "nf4") or "nf4")
        double_quant = bool(config.get("double_quant", True))
        layers = params["llama"]["layers"]
        for name in _QUANT_TARGETS:
            w = torch.from_numpy(layers[name]).to(device)
            layers[name] = quantize_llama_layers(
                {name: w}, bits=bits, quant_type=quant_type,
                double_quant=double_quant)[name]
    return cfg, params, report


def vision_w8a8_setting(cfg, config, bits: int, device) -> bool:
    """`vision_w8a8` where the config sets it; else the JAX default with a
    CUDA device in place of the TPU: int8 weights and a ViT head dim that
    the flash kernel takes."""
    if config.get("vision_w8a8") is not None:
        return bool(config["vision_w8a8"])
    return (bits == 8 and torch.device(device).type == "cuda"
            and cfg.vit.head_dim in (64, 128))


def build_engine(cfg, params, config, device) -> GenerationEngine:
    """A GenerationEngine for `config` (a nested dict with the schema of
    `Config/*.yaml`, e.g. `core.convert.eval_config()`) on `device`, over
    `params` as numpy leaves (`build_model`, `load_pretrained`) or tensors,
    with "lora" or without (the engine merges or attaches it).

    Maps the serving knobs as the JAX package does: `bits: 8` gives int8
    decoder weights, `bits: 4` NF4 (`quant_type: nf4`, the default, with
    `double_quant`) or halves-packed W4A8 (`quant_type: int4h`); `kv_bits: 8`
    an int8 KV cache; `lm_head_bits: 8` an int8 lm_head. max_seq_len is
    text.max_position_embeddings + 256. `vision_w8a8` (the fused W8A8
    vision tower) follows the config where it is set; otherwise it is on
    where the JAX rule puts it on, with a CUDA device in place of the TPU:
    `bits: 8` on a CUDA device, with a ViT head dim that the flash kernel
    takes (64 or 128). Off on the CPU, as the JAX default is off the TPU.
    `prefill_chunk` raises NotImplementedError. Other `bits`/`kv_bits`
    values raise ValueError."""
    bits = int(config.get("bits", 16) or 16)
    kv_bits = int(config.get("kv_bits", 16) or 16)
    if bits not in (4, 8, 16) or kv_bits not in (8, 16):
        raise ValueError(f"bits={bits} kv_bits={kv_bits}: bits must be 4, 8 "
                         "or 16 and kv_bits 8 or 16")
    if config.get("prefill_chunk"):
        raise NotImplementedError("prefill_chunk is not ported yet")
    return GenerationEngine(
        cfg, params_from_numpy(params), device=device,
        max_seq_len=int(config["text"]["max_position_embeddings"]) + 256,
        compute_dtype=torch.bfloat16,
        cache_dtype=torch.int8 if kv_bits == 8 else torch.bfloat16,
        quantize_bits=bits if bits in (4, 8) else None,
        quant_type=str(config.get("quant_type", "nf4") or "nf4"),
        double_quant=bool(config.get("double_quant", True)),
        lm_head_bits=int(config.get("lm_head_bits", 0) or 0) or None,
        vision_w8a8=vision_w8a8_setting(cfg, config, bits, device))


def build_trainer(config, params, loader, device="cuda", *,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  work_dir: str = "output", log_period: int = 50):
    """The trainer of `config` (a nested dict with the schema of
    `Config/*.yaml`, e.g. from `core.config.load_yaml_config`) over
    `params` (the JAX parameter pytree as numpy, or tensors) and `loader`
    (an iterable of collated batches) on `device`, composed as the JAX
    entry points compose it: the parameters for training
    (`training_params_from_numpy`), the schedule from the config, the
    optimizer over `trainable_mask` (stages 2 and 3: the "lora" leaves, and
    the pooler where `tune_rgb_pooler` says; a quantized base from
    `build_model` stays frozen in its codes), and an epoch-based trainer
    over `epochs` x len(loader) iterations (stages 1 and 2) or an
    iteration-based one over `epochs` iterations (stage 3, whose recipe
    treats epochs as iterations). `use_checkpoint` turns on remat. The
    trainer's parameters are `trainer.params`. Checkpoints are not ported:
    a config that sets `ckpt_period` raises NotImplementedError."""
    from ..models.vlm import VLMConfig, trainable_mask
    from ..train import (EpochBasedTrainer, IterBasedTrainer,
                         build_optimizer, build_schedule)
    from .convert import training_params_from_numpy

    cfg = VLMConfig.from_config_dict(config)
    params = training_params_from_numpy(params, cfg, compute_dtype, device)
    common = dict(work_dir=work_dir, compute_dtype=compute_dtype,
                  remat=bool(config.get("use_checkpoint", False)),
                  log_period=log_period,
                  ckpt_period=config.get("ckpt_period"))
    if int(config["stage"]) == 3:
        max_iters = int(config["epochs"])
        schedule = build_schedule(config, max_iters)
        optimizer = build_optimizer(config, params,
                                    trainable_mask(params, cfg), schedule)
        return IterBasedTrainer(cfg, params, optimizer, loader,
                                max_iters=max_iters, schedule=schedule,
                                **common)
    epochs = int(config["epochs"])
    schedule = build_schedule(config, epochs * len(loader))
    optimizer = build_optimizer(config, params, trainable_mask(params, cfg),
                                schedule)
    return EpochBasedTrainer(cfg, params, optimizer, loader, epochs=epochs,
                             schedule=schedule, **common)
