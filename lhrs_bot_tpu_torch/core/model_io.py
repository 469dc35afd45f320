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
cover is never drawn.

`save_converted_params` / `load_converted_params` are the counterparts of
the JAX package's `save_orbax_params` / `load_orbax_params`: the loaded
tree converted once (FINAL.pt + HF shards + TextLoRA through
`load_pretrained`) and written so that a later start is a mapped read.
Orbax is JAX's own format; the port writes the tree as `core.
safetensors_io` shards (a few GB each, every leaf in its own dtype, keys
the tree's paths) beside `params.index.json`, which records the tree's
structure, the shard of each key and the format tag. Loading maps the
shards copy-on-write and returns the same nested dict of numpy leaves,
with nothing placed on a device.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
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


# -- the converted checkpoint (orbax's place in the JAX package) -------------

CONVERTED_FORMAT = "lhrs_bot_tpu_torch.converted_params/1"
CONVERTED_INDEX = "params.index.json"
CONVERTED_SHARD_BYTES = 2 << 30


def _tree_leaves(tree, prefix=""):
    """(key, leaf) of a nested dict of arrays, keys the paths joined by
    "/", in the tree's order."""
    for name, value in tree.items():
        name = str(name)
        if "/" in name or not name:
            raise ValueError(f"tree key {prefix + name!r}: a key is a "
                             "non-empty name without '/'")
        key = prefix + name
        if isinstance(value, dict):
            yield from _tree_leaves(value, key + "/")
        elif isinstance(value, (np.ndarray, torch.Tensor)):
            yield key, value
        else:
            raise TypeError(f"tree leaf {key!r} is a "
                            f"{type(value).__name__}, not an array")


def _structure(tree, prefix=""):
    return {str(k): (_structure(v, f"{prefix}{k}/") if isinstance(v, dict)
                     else prefix + str(k)) for k, v in tree.items()}


def looks_like_converted(path: str) -> bool:
    """Whether `path` is a directory `save_converted_params` wrote (its
    index carries the format tag)."""
    index = os.path.join(path, CONVERTED_INDEX)
    if not os.path.isfile(index):
        return False
    try:
        with open(index) as fh:
            return json.load(fh).get("format") == CONVERTED_FORMAT
    except (OSError, ValueError, AttributeError):
        return False


def save_converted_params(path: str, params: Dict) -> str:
    """Write `params` (a nested dict of numpy arrays or CPU tensors, e.g.
    `load_pretrained`'s float32 tree) as a converted checkpoint at `path`
    (see the module docstring); returns its absolute path. Counterpart of
    `lhrs_bot_tpu/core/model_io.py` `save_orbax_params`: an existing `path`
    is replaced only if it is such a checkpoint (ValueError otherwise, so
    a mistyped output never deletes another directory). Leaves are packed
    in tree order into shards of at most CONVERTED_SHARD_BYTES (a larger
    leaf gets one to itself); the files go to a sibling `.tmp` directory
    that is renamed into place when complete."""
    from .safetensors_io import save_file

    path = os.path.abspath(path)
    if os.path.exists(path):
        if not (os.path.isdir(path) and looks_like_converted(path)):
            raise ValueError(
                f"refusing to overwrite {path!r}: it exists but is not a "
                f"converted checkpoint (no {CONVERTED_INDEX} with format "
                f"{CONVERTED_FORMAT!r}); remove it or pick another path")
    leaves = list(_tree_leaves(params))
    shards, size = [[]], 0
    for key, leaf in leaves:
        nbytes = leaf.nbytes if isinstance(leaf, np.ndarray) else \
            leaf.numel() * leaf.element_size()
        if shards[-1] and size + nbytes > CONVERTED_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append((key, leaf))
        size += nbytes
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    weight_map, total = {}, 0
    for i, shard in enumerate(shards):
        name = f"params-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        tensors = {}
        for key, leaf in shard:
            t = (torch.from_numpy(np.ascontiguousarray(leaf))
                 if isinstance(leaf, np.ndarray) else leaf.detach())
            if t.device.type != "cpu":
                raise ValueError(f"tree leaf {key!r} is on {t.device}: "
                                 "the converted checkpoint is written from "
                                 "the host tree")
            tensors[key] = t
            weight_map[key] = name
            total += t.numel() * t.element_size()
        save_file(tensors, os.path.join(tmp, name),
                  metadata={"format": CONVERTED_FORMAT})
    with open(os.path.join(tmp, CONVERTED_INDEX), "w") as fh:
        json.dump({"format": CONVERTED_FORMAT, "total_bytes": total,
                   "tree": _structure(params), "weight_map": weight_map},
                  fh)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    logger.info("wrote the converted checkpoint to %s (%d shards, %d "
                "bytes)", path, len(shards), total)
    return path


def load_converted_params(path: str, cfg: Optional[VLMConfig] = None
                          ) -> Dict:
    """The tree `save_converted_params` wrote at `path`: a nested dict of
    numpy leaves (bfloat16 leaves as CPU tensors, numpy having no such
    dtype), each a copy-on-write mapping of its shard, nothing read until
    it is touched and nothing placed on a device. Counterpart of
    `lhrs_bot_tpu/core/model_io.py` `load_orbax_params`; `cfg` is accepted
    and unused there too (the structure and dtypes come from the
    checkpoint). ValueError for a directory that is not one, or whose
    index and shards disagree."""
    from .safetensors_io import load_file

    del cfg
    path = os.path.abspath(path)
    if not looks_like_converted(path):
        raise ValueError(f"{path!r} is not a converted checkpoint (no "
                         f"{CONVERTED_INDEX} with format "
                         f"{CONVERTED_FORMAT!r})")
    with open(os.path.join(path, CONVERTED_INDEX)) as fh:
        index = json.load(fh)
    weight_map = index["weight_map"]
    tensors = {}
    for name in sorted(set(weight_map.values())):
        shard = load_file(os.path.join(path, name))
        extra = set(shard) - {k for k, v in weight_map.items() if v == name}
        if extra:
            raise ValueError(f"{path}/{name} holds tensors the index does "
                             f"not name: {sorted(extra)[:4]}")
        tensors.update(shard)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if node not in tensors:
            raise ValueError(f"{path}: leaf {node!r} is missing from its "
                             f"shard {weight_map.get(node)}")
        t = tensors[node]
        return t if t.dtype == torch.bfloat16 else t.numpy()

    return build(index["tree"])
