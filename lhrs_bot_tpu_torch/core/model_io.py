"""Model-level checkpoint loading and saving.

Counterpart of `lhrs_bot_tpu/core/model_io.py` `load_pretrained` and
`save_final`, after the reference's checkpoint protocol: FINAL.pt's
rgb_ckpt -> the vision tower, other_ckpt["rgb_pooler"] -> the perceiver;
a TextLoRA/ directory beside FINAL.pt is found and its adapters merged into
the base at eval (stage 0) or kept live for training (stages 2 and 3); a
DeepSpeed ZeRO shard directory restores the whole module; `save_final`
writes FINAL.pt (+ TextLoRA/ when adapters are live). The base HF weights
(CLIP ViT-L/14, LLaMA-2) load from the config's `rgb_vision.vit_name` and
`text.path`.

Everything happens on the host, as in the JAX package, and the result is a
tree of float32 numpy leaves (`core.convert.params_from_numpy` makes
tensors of it). Unlike the JAX loader, a path that is given but not found
raises FileNotFoundError instead of leaving the random init in place, and
the random init is drawn only for the leaves no artifact covers (seed 0,
each leaf from its own generator, `models.vlm.draw_param`, as
`init_vlm_params` draws it on the CPU), so a 7B tree that the artifacts
cover is never drawn. The orbax functions stay JAX-only.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.lora import LoraConfig, init_lora_params
from ..models.vlm import VLMConfig, draw_param, leaf_generator, param_specs
from . import torch_import as ti
from .zero_import import load_zero_checkpoint, looks_like_zero_checkpoint

logger = logging.getLogger("lhrs_torch")


def load_pretrained(cfg: VLMConfig, *, model_path: Optional[str] = None,
                    vit_path: Optional[str] = None,
                    llama_path: Optional[str] = None) -> Tuple[Dict, Dict]:
    """(params, report): the random init with every given artifact laid
    over it, as float32 numpy leaves.

    Order (the JAX loader's): the HF CLIP directory (`vit_path`), the HF
    LLaMA directory (`llama_path`), then `model_path`: a ZeRO shard
    directory (tower, perceiver, decoder, embed_tokens / lm_head, live
    adapters) or FINAL.pt (tower, perceiver, embed_tokens / lm_head) with
    the TextLoRA/ beside it. A tensor whose shape differs from the init's
    in its rows (or its columns) only fills the overlap, as the reference's
    resized embeddings require; another shape raises ValueError. Adapters
    are merged into the base at stage 0 (`(W + (A @ B) * alpha / r)` in
    float32, r and alpha from `cfg.lora`, 128 and 256 without one) and kept
    as params["lora"] at stages 2 and 3; stage 0 carries no "lora".

    report: {"artifacts": {"clip" | "llama" | "zero" | "final_pt" |
    "text_lora": path}, "random_init": [paths of the leaves left at their
    random init]}."""
    artifacts: Dict[str, str] = {}
    # leaves not loaded yet are their `param_specs` entries, (kind, shape)
    params = param_specs(cfg)

    def fit(a, ref, path):
        """`a` as float32 where it fits `ref` (an array or a spec), its
        overlap with the init where only rows or columns differ."""
        a = np.asarray(a)
        if a.dtype != np.float32:
            a = ti._convert(a, torch.float32)
        shape = ref[1] if isinstance(ref, tuple) else ref.shape
        if tuple(a.shape) == tuple(shape):
            return a
        ref = _draw(ref, path) if isinstance(ref, tuple) else ref
        if a.ndim == ref.ndim and a.shape[1:] == ref.shape[1:]:
            n = min(a.shape[0], ref.shape[0])
            logger.warning("%s: size mismatch %s vs %s, copying %d "
                           "overlapping rows", path, a.shape, ref.shape, n)
            ref[:n] = a[:n]
            return ref
        if a.ndim == ref.ndim and a.shape[:-1] == ref.shape[:-1]:
            n = min(a.shape[-1], ref.shape[-1])
            logger.warning("%s: size mismatch %s vs %s, copying %d "
                           "overlapping columns", path, a.shape, ref.shape,
                           n)
            ref[..., :n] = a[..., :n]
            return ref
        raise ValueError(f"{path}: incompatible shapes {a.shape} vs "
                         f"{ref.shape}")

    def as_tree(tree, like, path):
        if isinstance(like, dict):
            if not isinstance(tree, dict) or set(tree) != set(like):
                raise ValueError(f"{path}: the artifact's keys "
                                 f"{sorted(tree)} differ from {sorted(like)}")
            return {k: as_tree(tree[k], like[k], f"{path}/{k}")
                    for k in like}
        return fit(tree, like, path)

    def extras(loaded):
        llama = params["llama"]
        for key, val in loaded.get("extra", {}).items():
            if "embed_tokens" in key:
                llama["embed_tokens"] = fit(val, llama["embed_tokens"],
                                            "llama/embed_tokens")
            if "lm_head" in key:
                w = val.T if val.shape[0] != cfg.llama.hidden_size else val
                llama["lm_head"] = fit(w, llama["lm_head"], "llama/lm_head")

    if vit_path:
        _require(vit_path, directory=True)
        logger.info("loading the CLIP vision tower from %s", vit_path)
        params["vit"] = as_tree(
            ti.load_hf_clip_vision(vit_path, cfg.vit, torch.float32),
            params["vit"], "vit")
        artifacts["clip"] = vit_path
    if llama_path:
        _require(llama_path, directory=True)
        logger.info("loading the LLaMA decoder from %s", llama_path)
        params["llama"] = as_tree(
            ti.load_hf_llama(llama_path, cfg.llama, torch.float32),
            params["llama"], "llama")
        artifacts["llama"] = llama_path

    lora, lora_src = None, None
    if model_path:
        _require(model_path, directory=False)
        if looks_like_zero_checkpoint(model_path):
            logger.info("loading the DeepSpeed ZeRO shard dir %s",
                        model_path)
            loaded = load_zero_checkpoint(model_path, cfg.vit, cfg.pooler,
                                          cfg.llama)
            artifacts["zero"] = model_path
            groups = ("vit", "pooler", "llama")
            lora, lora_src = loaded.get("lora"), model_path
        else:
            logger.info("loading the FINAL checkpoint %s", model_path)
            loaded = ti.load_final_pt(model_path, cfg.vit, cfg.pooler,
                                      torch.float32)
            artifacts["final_pt"] = model_path
            groups = ("vit", "pooler")
            lora_dir = os.path.join(os.path.dirname(model_path), "TextLoRA")
            r, alpha = _lora_r_alpha(cfg)
            lora = ti.load_text_lora(lora_dir, cfg.llama, r, alpha)
            if lora is not None:
                logger.info("found TextLoRA adapters at %s", lora_dir)
                artifacts["text_lora"] = lora_dir
                lora_src = lora_dir
        for group in groups:
            if group in loaded:
                params[group] = as_tree(loaded[group], params[group], group)
        extras(loaded)
    if lora is not None:
        lora = {k: {n: ti._convert(np.asarray(x), torch.float32)
                    for n, x in ab.items()} for k, ab in lora.items()}
        if cfg.stage == 0:
            logger.info("merging the adapters of %s into the base",
                        lora_src)
            layers = params["llama"]["layers"]
            for name in lora:
                if isinstance(layers[name], tuple):
                    layers[name] = _draw(layers[name],
                                         f"llama/layers/{name}")
            _merge_into(layers, lora, _lora_config(cfg))
        else:
            params["lora"] = lora
    random_init = []
    if cfg.stage != 0 and cfg.lora is not None and "lora" not in params:
        params["lora"] = {
            k: {n: x.numpy() for n, x in ab.items()}
            for k, ab in init_lora_params(cfg.llama, cfg.lora,
                                          leaf_generator(0, "lora"),
                                          device="cpu").items()}
        random_init.append("lora")
    params = _materialize(params, "", random_init)
    for kind, path in artifacts.items():
        logger.info("loaded %s: %s", kind, path)
    if random_init:
        logger.info("left at their random init: %s", ", ".join(random_init))
    return params, {"artifacts": artifacts, "random_init": random_init}


def _require(path: str, directory: bool) -> None:
    ok = os.path.isdir(path) if directory else os.path.exists(path)
    if not ok:
        raise FileNotFoundError(f"{path}: no such "
                                f"{'directory' if directory else 'file'}")


def _lora_r_alpha(cfg: VLMConfig):
    return (cfg.lora.r, cfg.lora.alpha) if cfg.lora else (128, 256)


def _lora_config(cfg: VLMConfig) -> LoraConfig:
    return cfg.lora or LoraConfig(*_lora_r_alpha(cfg))


def _draw(spec, path: str) -> np.ndarray:
    return draw_param(spec, path, 0, torch.float32, "cpu").numpy()


def _materialize(tree, path, drawn):
    """`tree` with every spec left in it drawn; their paths go to
    `drawn`."""
    if isinstance(tree, dict):
        return {k: _materialize(v, f"{path}/{k}" if path else k, drawn)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        drawn.append(path)
        return _draw(tree, path)
    return tree


def _merge_into(layers: Dict, lora: Dict, lcfg: LoraConfig) -> None:
    """W += (A @ B) * scale for each adapter, in float32, in place (every
    array here was made by this load)."""
    for name, ab in lora.items():
        delta = torch.matmul(torch.from_numpy(ab["a"]),
                             torch.from_numpy(ab["b"]))
        torch.from_numpy(layers[name]).add_(delta.mul_(lcfg.scale))


def save_final(output_dir: str, params: Dict, cfg: VLMConfig) -> str:
    """FINAL.pt (+ TextLoRA/ when params holds "lora" and cfg.lora is
    set) in `output_dir`, from numpy leaves or tensors (on any device);
    returns FINAL.pt's path. A trainer's frozen leaves are written as they
    were loaded (`core.convert.as_loaded`), not as their compute-dtype
    copies."""
    from .convert import as_loaded

    params = as_loaded(params)
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "FINAL.pt")
    ti.export_final_pt(path, params, cfg.vit, cfg.pooler)
    if "lora" in params and cfg.lora is not None:
        ti.export_text_lora(os.path.join(output_dir, "TextLoRA"),
                            params["lora"], cfg.llama, cfg.lora.r,
                            cfg.lora.alpha)
    logger.info("saved the final checkpoint to %s", path)
    return path
