"""DeepSpeed ZeRO checkpoint directories -> the port's parameters.

Counterpart of `lhrs_bot_tpu/core/zero_import.py`, with numpy and
`torch.load` only. The reference's mid-training checkpoints are ZeRO shard
directories: a `latest` tag file and `global_step*/` holding one
`mp_rank_00_model_states.pt` and a `zero_pp_rank_{r}_mp_rank_00_optim_
states.pt` per rank. For ZeRO stages 1 and 2 (the published recipes train
with stage 2) the float32 values of every trainable parameter live in the
optimizer shards as flat, rank-partitioned, group-wise concatenated
vectors; frozen parameters and buffers live in the model-states file.
`get_fp32_state_dict_from_zero_checkpoint` rebuilds the module's state:
  1. for each param group, each rank's `single_partition_of_fp32_groups[g]`
     concatenated in rank order (ranks pad their share at the end);
  2. `param_shapes[g]` walked in insertion order, each parameter carved off
     the flat vector;
  3. frozen parameters from `frozen_param_fragments` when present, else
     from the `module` state dict;
  4. buffers from the `module` state dict (`buffer_names`).
ZeRO-3 directories raise NotImplementedError.

`load_zero_checkpoint` then splits the module as the reference's FINAL.pt
export does (rgb / rgb_pooler / embed_tokens, lm_head) and, because a shard
directory holds the whole module, also returns the text decoder ("llama")
and any live peft adapters ("lora").
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.llama import LlamaConfig
from ..models.perceiver import PerceiverConfig
from ..models.vit import ViTConfig
from .torch_import import (_np, llama_params_from_hf_state_dict,
                           pooler_params_from_torch_state_dict, stack_lora,
                           vit_params_from_hf_state_dict)

logger = logging.getLogger("lhrs_torch")

_MODEL_GLOB = "*_model_states.pt"
_OPTIM_GLOB = "*_optim_states.pt"


def looks_like_zero_checkpoint(path: str) -> bool:
    """True for a DeepSpeed checkpoint root (has `latest`) or a tag
    directory (has `*_model_states.pt`)."""
    if not os.path.isdir(path):
        return False
    if os.path.isfile(os.path.join(path, "latest")):
        return True
    return bool(glob.glob(os.path.join(path, _MODEL_GLOB)))


def _resolve_tag_dir(ckpt_dir: str, tag: Optional[str] = None) -> str:
    if tag is None:
        latest = os.path.join(ckpt_dir, "latest")
        if os.path.isfile(latest):
            with open(latest) as fh:
                tag = fh.read().strip()
    if tag:
        tagged = os.path.join(ckpt_dir, tag)
        if os.path.isdir(tagged):
            return tagged
        raise FileNotFoundError(
            f"tag directory {tagged!r} not found in ZeRO checkpoint")
    if glob.glob(os.path.join(ckpt_dir, _MODEL_GLOB)):
        return ckpt_dir
    raise FileNotFoundError(
        f"{ckpt_dir!r} has no 'latest' file and no *_model_states.pt")


def _rank_key(path: str) -> int:
    m = re.search(r"zero_pp_rank_(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def _f32(x) -> np.ndarray:
    return _np(x).astype(np.float32)


def get_fp32_state_dict_from_zero_checkpoint(
        ckpt_dir: str, tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """A ZeRO-1/2 shard directory -> {name: float32 numpy array}, for the
    data-parallel (one mp_rank_00) layouts the reference writes."""
    tag_dir = _resolve_tag_dir(ckpt_dir, tag)
    model_files = sorted(glob.glob(os.path.join(tag_dir, _MODEL_GLOB)))
    if not model_files:
        raise FileNotFoundError(f"no *_model_states.pt in {tag_dir!r}")
    if len(model_files) > 1:
        raise NotImplementedError(
            "model-parallel ZeRO checkpoints (several mp_rank model-states "
            "files) are not supported; the reference trains data-parallel "
            "ZeRO-2 (one mp_rank_00 file)")
    ms = torch.load(model_files[0], map_location="cpu", weights_only=False)

    optim_files = sorted(glob.glob(os.path.join(tag_dir, _OPTIM_GLOB)),
                         key=_rank_key)
    if not optim_files:
        raise FileNotFoundError(f"no *_optim_states.pt in {tag_dir!r}")
    osds = []
    for f in optim_files:
        sd = torch.load(f, map_location="cpu", weights_only=False)
        osds.append(sd.get("optimizer_state_dict", sd))
    zero_stage = int(osds[0].get("zero_stage", 2))
    if zero_stage not in (1, 2):
        raise NotImplementedError(
            f"ZeRO stage {zero_stage} consolidation is not supported (the "
            "reference recipes are ZeRO-2)")

    def flat_groups(osd) -> List[np.ndarray]:
        for key in ("single_partition_of_fp32_groups", "fp32_flat_groups"):
            if key in osd:
                groups = osd[key]
                break
        else:
            raise KeyError(
                "optimizer shard missing single_partition_of_fp32_groups")
        out = []
        for g in groups:
            if isinstance(g, (list, tuple)):  # fragments of one group
                out.append(np.concatenate([_f32(x).reshape(-1) for x in g]))
            else:
                out.append(_f32(g).reshape(-1))
        return out

    per_rank = [flat_groups(osd) for osd in osds]
    n_groups = len(per_rank[0])
    if any(len(r) != n_groups for r in per_rank):
        raise ValueError("optimizer shards disagree on param-group count")

    param_shapes = ms.get("param_shapes")
    if param_shapes is None:
        raise KeyError("model-states file missing param_shapes")
    if isinstance(param_shapes, dict):
        param_shapes = [param_shapes]
    if len(param_shapes) != n_groups:
        raise ValueError(
            f"param_shapes has {len(param_shapes)} groups but optimizer "
            f"shards carry {n_groups}")

    state: Dict[str, np.ndarray] = {}
    module_sd = ms.get("module", {}) or {}
    for name in ms.get("buffer_names", []) or []:
        if name in module_sd:
            state[name] = _f32(module_sd[name])

    frozen_shapes = ms.get("frozen_param_shapes") or {}
    frozen_frags = ms.get("frozen_param_fragments") or {}
    for name in frozen_shapes:
        src = frozen_frags.get(name, module_sd.get(name))
        if src is None:
            raise KeyError(f"frozen param {name!r} has no stored value")
        state[name] = _f32(src).reshape(tuple(frozen_shapes[name]))

    trainable_names = {n for g in param_shapes for n in g}
    for g in range(n_groups):
        full = np.concatenate([r[g] for r in per_rank])
        offset = 0
        for name, shape in param_shapes[g].items():
            shape = tuple(int(s) for s in shape)
            numel = int(np.prod(shape)) if shape else 1
            if offset + numel > full.size:
                raise ValueError(
                    f"group {g} flat vector exhausted at {name!r}: need "
                    f"{offset + numel}, have {full.size}")
            state[name] = full[offset:offset + numel].reshape(shape)
            offset += numel
        pad = full.size - offset
        if pad >= max(len(per_rank), 1) * 64:
            logger.warning(
                "ZeRO group %d leaves %d unconsumed elements (expected "
                "only alignment padding); shapes may be stale", g, pad)

    for name, val in module_sd.items():
        if name not in state and name not in trainable_names \
                and hasattr(val, "shape"):
            state[name] = _f32(val)
    return state


def _strip_text_prefix(key: str) -> str:
    k = key[len("text.text_encoder."):]
    if k.startswith("base_model.model."):  # peft wrapping
        k = k[len("base_model.model."):]
    return k.replace(".base_layer.", ".")


def split_unibind_state_dict(fp32_sd: Dict[str, np.ndarray]
                             ) -> Dict[str, Any]:
    """Module names -> {rgb, pooler, text, lora, extra} groups: rgb /
    rgb_pooler / embed_tokens and lm_head as the reference's FINAL.pt
    export groups them; text (the whole decoder) and lora (live peft
    adapters) exist only in shard directories."""
    rgb = {k[len("rgb."):]: v for k, v in fp32_sd.items()
           if k.startswith("rgb.")}
    pooler = {k.split("rgb_pooler.")[-1]: v for k, v in fp32_sd.items()
              if "rgb_pooler" in k}
    extra = {k: v for k, v in fp32_sd.items()
             if "embed_tokens" in k or ("lm_head" in k and "lora" not in k)}
    text: Dict[str, np.ndarray] = {}
    lora: Dict[str, np.ndarray] = {}
    for k, v in fp32_sd.items():
        if not k.startswith("text.text_encoder."):
            continue
        nk = _strip_text_prefix(k)
        if ".lora_A." in nk or ".lora_B." in nk:
            lora[nk] = v
        elif "lora" not in nk:
            text[nk] = v
    return {"rgb": rgb, "pooler": pooler, "text": text, "lora": lora,
            "extra": extra}


def load_zero_checkpoint(path: str, vit_cfg: ViTConfig,
                         pooler_cfg: PerceiverConfig,
                         llama_cfg: Optional[LlamaConfig] = None,
                         tag: Optional[str] = None) -> Dict[str, Any]:
    """A ZeRO shard directory -> the `load_final_pt` structure plus
    "llama" (the decoder, when llama_cfg is given and the module holds it)
    and "lora" (stacked live adapters; a target covering only some layers
    raises ValueError, as in `torch_import.stack_lora`)."""
    groups = split_unibind_state_dict(
        get_fp32_state_dict_from_zero_checkpoint(path, tag))
    out: Dict[str, Any] = {"extra": {}}
    if groups["rgb"]:
        rgb_sd = {k.replace("encoder.", "", 1) if k.startswith("encoder.")
                  else k: v for k, v in groups["rgb"].items()}
        out["vit"] = vit_params_from_hf_state_dict(rgb_sd, vit_cfg)
    if groups["pooler"]:
        out["pooler"] = pooler_params_from_torch_state_dict(
            groups["pooler"], pooler_cfg)
    out["extra"] = dict(groups["extra"])
    if llama_cfg is not None and groups["text"]:
        if ("model.layers.0.self_attn.q_proj.weight" in groups["text"]
                or "layers.0.self_attn.q_proj.weight" in groups["text"]):
            out["llama"] = llama_params_from_hf_state_dict(groups["text"],
                                                           llama_cfg)
        if groups["lora"]:
            stacked = stack_lora(groups["lora"], llama_cfg)
            if stacked:
                out["lora"] = stacked
    return out
