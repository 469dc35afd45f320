"""The entry points' common preamble, and model, engine and trainer
assembly from the config surface (counterpart of
lhrs_bot_tpu/core/bootstrap.py: `add_common_args`, `parse_config`,
`set_random_seed`, `setup`, `build_model_and_tokenizer`, `build_engine`,
and of what `main_pretrain_stage1.py` / `main_pretrain_stage3.py` compose
around the trainer). `parse_config` initialises nothing distributed and
keeps no compilation cache: rank 0 of a world of 1 unless
`torch.distributed` is already initialised."""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from ..device import resolve_device
from ..serve.engine import GenerationEngine
from ..utils.logger import setup_logger
from .config import ConfigArgumentParser, ConfigDict
from .convert import params_from_numpy


def add_common_args(parser: ConfigArgumentParser) -> None:
    """The common flags the port reads (the JAX trainer's others come with
    the entry points that read them, so argparse refuses them until
    then)."""
    parser.add_argument("--model-path", type=str, default=None,
                        help="path to FINAL.pt checkpoint")
    parser.add_argument("--output", type=str, default="output")
    parser.add_argument("--seed", type=int, default=322)
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor-parallel mesh size (the decoder's "
                             "heads and MLP width split over tp ranks)")
    parser.add_argument("--dist-backend", type=str, default="nccl",
                        choices=("nccl", "gloo"),
                        help="torch.distributed backend under torchrun: "
                             "nccl (one card a local rank) or gloo (ranks "
                             "may share a card, or run on the CPU)")


def add_train_args(parser: ConfigArgumentParser) -> None:
    """The JAX trainer's common flags that the stage entry points read,
    and `--device`. `--dp` / `--tp` set the mesh (`train_stage`)."""
    parser.add_argument("--data-path", type=str, default=None)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--auto-resume", action="store_true")
    parser.add_argument("--use-checkpoint", action="store_true",
                        help="gradient (re)materialization")
    parser.add_argument("--dp", type=int, default=None,
                        help="data-parallel mesh size (each data index "
                             "draws --batch-size rows a step)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")


def add_eval_args(parser: ConfigArgumentParser) -> None:
    """The JAX common flags that the eval entry points read, and
    `--device`. `--dp` above 1 (as `--tp` above 1) raises
    NotImplementedError in the entry points, which run no mesh (as JAX's
    eval mains). JAX's `--eval-path` has no reader in either package, so it
    is left out."""
    parser.add_argument("--data-path", type=str, default=None)
    parser.add_argument("--data-target", type=str, default=None)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--scheduled-eval", action="store_true",
                        help="route eval generation through the "
                             "continuous-batching scheduler (slots free "
                             "at EOS instead of stepping every row for "
                             "max_new_tokens)")
    parser.add_argument("--dp", type=int, default=None,
                        help="above 1 refused: the eval entries run no mesh")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default) or cpu")


def parse_config(description: str, extra=None, args=None) -> ConfigDict:
    """The YAML named by -c merged with the CLI flags (the common ones and
    those `extra(parser)` adds), with rank, world_size and is_distribute.
    Under torchrun (WORLD_SIZE above 1) it first joins the process group
    with `--dist-backend` (`parallel.distribute.init_distributed`)."""
    from ..parallel.distribute import init_distributed

    parser = ConfigArgumentParser(description=description)
    add_common_args(parser)
    if extra is not None:
        extra(parser)
    config = parser.parse_args(args)
    init_distributed(config.get("dist_backend") or "nccl")
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    config["rank"] = dist.get_rank() if up else 0
    config["world_size"] = dist.get_world_size() if up else 1
    config["is_distribute"] = config["world_size"] > 1
    return config


def set_random_seed(seed: int, rank: int = 0) -> None:
    """Per-process seeding of Python's and numpy's generators (seed +
    rank); torch's generators are passed explicitly where they are
    used."""
    random.seed(seed + rank)
    np.random.seed(seed + rank)


def setup(config, name: str = "lhrs_tpu"):
    """The logger, the seeds, the output directory with config.json, and
    the environment logged; returns the logger."""
    logger = setup_logger(name, output=config.output, rank=config.rank)
    set_random_seed(int(config.seed), int(config.rank))
    os.makedirs(config.output, exist_ok=True)
    from ..utils.misc import collect_env

    logger.info("environment:\n%s", collect_env())
    if config.rank == 0:
        with open(os.path.join(config.output, "config.json"), "w") as fh:
            fh.write(config.to_json(indent=2, default=str))
    return logger


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


def build_model_and_tokenizer(config, device="cuda"):
    """(cfg, params, tokenizer): `build_model(config, device)`'s VLMConfig
    and parameters, and `data.tokenizer.load_tokenizer(text.path,
    text.max_position_embeddings)`, loaded first so that a tokenizer the
    port cannot read fails before the weights load."""
    from ..data.tokenizer import load_tokenizer

    tokenizer = load_tokenizer(
        config["text"].get("path"),
        model_max_length=int(config["text"]["max_position_embeddings"]))
    cfg, params, _ = build_model(config, device)
    return cfg, params, tokenizer


def vision_w8a8_setting(cfg, config, bits: int, device) -> bool:
    """`vision_w8a8` where the config sets it; else the JAX default with a
    CUDA device in place of the TPU: int8 weights and a ViT head dim that
    the flash kernel takes."""
    if config.get("vision_w8a8") is not None:
        return bool(config["vision_w8a8"])
    return (bits == 8 and torch.device(device).type == "cuda"
            and cfg.vit.head_dim in (64, 128))


def build_engine(cfg, params, config, device, *,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 mesh=None) -> GenerationEngine:
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
    `prefill_chunk` (0 or missing: off) sets the engine's chunked prefill.
    Other `bits`/`kv_bits` values raise ValueError. The engine computes in
    `compute_dtype` (bf16, as JAX's; float32 for a comparison with JAX).
    `mesh` serves over a ("data", "model") mesh: the decoder tensor
    parallel, a batch's rows split over the data axis."""
    bits = int(config.get("bits", 16) or 16)
    kv_bits = int(config.get("kv_bits", 16) or 16)
    if bits not in (4, 8, 16) or kv_bits not in (8, 16):
        raise ValueError(f"bits={bits} kv_bits={kv_bits}: bits must be 4, 8 "
                         "or 16 and kv_bits 8 or 16")
    chunk = int(config.get("prefill_chunk", 0) or 0)
    return GenerationEngine(
        cfg, params_from_numpy(params), device=device,
        max_seq_len=int(config["text"]["max_position_embeddings"]) + 256,
        compute_dtype=compute_dtype,
        cache_dtype=torch.int8 if kv_bits == 8 else torch.bfloat16,
        quantize_bits=bits if bits in (4, 8) else None,
        quant_type=str(config.get("quant_type", "nf4") or "nf4"),
        double_quant=bool(config.get("double_quant", True)),
        lm_head_bits=int(config.get("lm_head_bits", 0) or 0) or None,
        vision_w8a8=vision_w8a8_setting(cfg, config, bits, device),
        prefill_chunk=chunk or None, mesh=mesh)


def make_config_mesh(config):
    """The mesh of `--dp` / `--tp` over the world's ranks, with JAX's
    defaults (`parallel.mesh.make_mesh`: with neither flag every rank on
    the model axis, with one the other takes the rest; ValueError where
    dp * tp is not the world size); None for one process that asks for
    no more."""
    from ..parallel.distribute import get_world_size
    from ..parallel.mesh import make_mesh

    dp = int(config.get("dp") or 0) or None
    tp = int(config.get("tp") or 0) or None
    if (dp or 1) == 1 and (tp or 1) == 1 and get_world_size() == 1:
        return None
    return make_mesh(dp=dp, tp=tp)


def build_trainer(config, params, loader, device="cuda", *,
                  compute_dtype: torch.dtype = torch.bfloat16,
                  work_dir: str = "output", log_period: int = 50,
                  max_to_keep: int = 1, hooks=None, mesh=None):
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
    treats epochs as iterations). `use_checkpoint` turns on remat;
    `ckpt_period` (where the config sets it) adds the CheckpointHook,
    which keeps `max_to_keep` checkpoints under work_dir/checkpoints;
    `hooks` run before the default ones. The trainer's parameters are
    `trainer.params`. With `mesh` the trainer trains this rank's slice
    (`parallel.partition.shard_params`) with a ZeRO-sharded optimizer."""
    from ..models.vlm import VLMConfig, trainable_mask
    from ..train import (EpochBasedTrainer, IterBasedTrainer,
                         build_optimizer, build_schedule)
    from .convert import training_params_from_numpy

    cfg = VLMConfig.from_config_dict(config)
    params = training_params_from_numpy(params, cfg, compute_dtype, device)
    if mesh is not None:
        from ..parallel.partition import shard_params

        params = shard_params(mesh, params)
    common = dict(work_dir=work_dir, compute_dtype=compute_dtype,
                  mesh=mesh,
                  remat=bool(config.get("use_checkpoint", False)),
                  log_period=log_period,
                  ckpt_period=config.get("ckpt_period"),
                  max_to_keep=max_to_keep, hooks=list(hooks or []))
    if int(config["stage"]) == 3:
        max_iters = int(config["epochs"])
        schedule = build_schedule(config, max_iters)
        optimizer = build_optimizer(config, params,
                                    trainable_mask(params, cfg), schedule,
                                    mesh=mesh)
        return IterBasedTrainer(cfg, params, optimizer, loader,
                                max_iters=max_iters, schedule=schedule,
                                **common)
    epochs = int(config["epochs"])
    schedule = build_schedule(config, epochs * len(loader))
    optimizer = build_optimizer(config, params, trainable_mask(params, cfg),
                                schedule, mesh=mesh)
    return EpochBasedTrainer(cfg, params, optimizer, loader, epochs=epochs,
                             schedule=schedule, **common)


def train_stage(config, default_ckpt_period: int, hooks=None):
    """What `main_pretrain_stage{1,2,3}.py` run, on `config` (the YAML
    merged with `add_common_args` / `add_train_args` flags): the model and
    tokenizer on `config.device`, `data.build_loader.build_loader`,
    `build_trainer` (checkpoints every `ckpt_period` iterations, the
    config's or `default_ckpt_period`, one kept, under `config.output`),
    `train(resume=auto_resume)` and `save_final` into `config.output`;
    `hooks` go to the trainer before its default ones. Returns the
    trainer. Under torchrun, `--dp` / `--tp` make the mesh
    (`make_config_mesh`; dp * tp must be the world size): each data index
    draws its own `--batch-size` rows (the loader's rank and world are
    the data index and dp, and Python's and numpy's generators are seeded
    with seed + data index, so a model group's ranks draw the same
    samples), the decoder splits over tp, and only rank 0 writes
    FINAL.pt."""
    from ..data.build_loader import build_loader
    from .model_io import save_final

    device = resolve_device(config.get("device") or "cuda")
    config.setdefault("rank", 0)
    config.setdefault("world_size", 1)
    mesh = make_config_mesh(config)
    logger = setup(config)
    if mesh is not None:  # the model group's ranks draw the same samples
        set_random_seed(int(config.seed), mesh.data_index)
    if config.get("ckpt_period") is None:
        config["ckpt_period"] = default_ckpt_period
    cfg, params, tokenizer = build_model_and_tokenizer(config, device)
    loader = build_loader(
        config, tokenizer, mode="pretrain",
        rank=config.rank if mesh is None else mesh.data_index,
        world_size=config.world_size if mesh is None else mesh.dp)
    trainer = build_trainer(config, params, loader, device,
                            work_dir=config.output, log_period=50,
                            max_to_keep=1, hooks=hooks, mesh=mesh)
    del params
    trainer.train(resume=bool(config.get("auto_resume")))
    final = trainer.params
    if mesh is not None:
        from ..core.convert import as_loaded
        from ..parallel.partition import gather_params

        final = as_loaded(gather_params(mesh, trainer.params))
    if config.rank == 0:
        save_final(config.output, final, cfg)
        logger.info("stage-%d training complete", int(config.stage))
    return trainer
