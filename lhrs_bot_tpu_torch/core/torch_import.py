"""Torch / HF checkpoint interop: import the reference's weights, export
them back.

Counterpart of `lhrs_bot_tpu/core/torch_import.py`, without JAX and
without the `safetensors` package (`core/safetensors_io.py` reads and
writes the format). The artifacts:
  * an HF LLaMA-2 directory (`LlamaForCausalLM` state dict, safetensors
    shards or `pytorch_model*.bin`) -> the stacked decoder parameters;
  * an HF CLIP vision directory (`CLIPVisionModel`) -> the ViT parameters;
  * FINAL.pt = {rgb_ckpt, other_ckpt{rgb_pooler, text_proj, embed_tokens,
    lm_head}} (the nested layout of the reference's
    `get_other_maybe_zero_3`; a flat `rgb_pooler.<param>` layout and a
    `{"model": ...}` envelope are taken too);
  * a peft TextLoRA/ directory -> stacked LoRA parameters {target: {a, b}};
  * the exports back to FINAL.pt, TextLoRA/ and an HF LLaMA state dict.

Every loader returns numpy leaves in the stored dtype (bf16 becomes
float32; numpy has no bf16), byte for byte what the JAX loaders return on
the same files, so `core.convert.params_from_numpy` and the engine take
them as they are. `dtype=` on the state-dict converters gives every leaf
in that dtype in the same pass as the stacking (`core.model_io` asks for
float32). Layouts: torch Linear stores (out, in), the port (in, out), so
every projection transposes; `nn.MultiheadAttention` packs q/k/v by rows in
`in_proj_weight`; the HF conv patch embed (W, 3, p, p) flattens to
(p * p * 3, W) in (row, col, channel) order.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.llama import LlamaConfig
from ..models.perceiver import PerceiverConfig
from ..models.vit import ViTConfig
from .safetensors_io import load_file

# peft module name -> the port's stacked projection name
LORA_NAMES = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}


def _np(tensor) -> np.ndarray:
    """A host numpy array in the stored dtype (bf16 becomes float32)."""
    if isinstance(tensor, np.ndarray):
        return tensor
    t = tensor.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _torch(x: np.ndarray) -> torch.Tensor:
    """A tensor over `x`'s memory (read only here, so a read-only array,
    such as a view of a mapped file, is taken without a copy)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(x)


def _convert(x: np.ndarray, dtype=None) -> np.ndarray:
    """`x` as is for dtype None, else a new C-contiguous array of `dtype`
    (a torch.dtype) written in one pass."""
    if dtype is None:
        return x
    out = torch.empty(x.shape, dtype=dtype)
    out.copy_(_torch(x))
    return out.numpy()


def _stack(layers, dtype=None) -> np.ndarray:
    """np.stack of the per-layer arrays (any strides), in their dtype or
    `dtype`, written by torch's parallel copy."""
    first = _torch(layers[0])
    out = torch.empty((len(layers),) + tuple(first.shape),
                      dtype=dtype or first.dtype)
    for i, x in enumerate(layers):
        out[i].copy_(_torch(x))
    return out.numpy()


# ---------------------------------------------------------------------------
# HF LLaMA
# ---------------------------------------------------------------------------


def llama_params_from_hf_state_dict(sd: Dict[str, Any], cfg: LlamaConfig,
                                    dtype=None) -> Dict:
    """Keys like model.layers.{i}.self_attn.q_proj.weight -> the stacked
    decoder parameters (the structure of `models.vlm.init_vlm_params`'s
    "llama")."""
    def get(key):
        for prefix in ("", "model."):
            if prefix + key in sd:
                return _np(sd[prefix + key])
        raise KeyError(key)

    layers = {k: [] for k in (
        "input_norm", "wq", "wk", "wv", "wo", "post_attn_norm", "w_gate",
        "w_up", "w_down")}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        layers["input_norm"].append(get(p + "input_layernorm.weight"))
        layers["wq"].append(get(p + "self_attn.q_proj.weight").T)
        layers["wk"].append(get(p + "self_attn.k_proj.weight").T)
        layers["wv"].append(get(p + "self_attn.v_proj.weight").T)
        layers["wo"].append(get(p + "self_attn.o_proj.weight").T)
        layers["post_attn_norm"].append(
            get(p + "post_attention_layernorm.weight"))
        layers["w_gate"].append(get(p + "mlp.gate_proj.weight").T)
        layers["w_up"].append(get(p + "mlp.up_proj.weight").T)
        layers["w_down"].append(get(p + "mlp.down_proj.weight").T)

    def get_top(key, alt):
        for k in (key, alt):
            for prefix in ("", "model."):
                if prefix + k in sd:
                    return _np(sd[prefix + k])
        raise KeyError(key)

    return {
        "embed_tokens": _convert(get_top("embed_tokens.weight",
                                         "model.embed_tokens.weight"), dtype),
        "layers": {k: _stack(v, dtype) for k, v in layers.items()},
        "final_norm": _convert(get_top("norm.weight", "model.norm.weight"),
                               dtype),
        "lm_head": _convert(get_top("lm_head.weight", "lm_head.weight").T,
                            dtype),
    }


def load_hf_llama(path: str, cfg: LlamaConfig, dtype=None) -> Dict:
    """The decoder from an HF model directory."""
    return llama_params_from_hf_state_dict(_load_hf_dir_state_dict(path),
                                           cfg, dtype)


def _load_hf_dir_state_dict(path: str) -> Dict[str, Any]:
    """Every `*.safetensors` file of the directory, in sorted order; with
    none, every `pytorch_model*.bin`. A directory with neither raises
    FileNotFoundError."""
    names = sorted(os.listdir(path))
    st_files = [f for f in names if f.endswith(".safetensors")]
    sd: Dict[str, Any] = {}
    if st_files:
        for f in st_files:
            sd.update(load_file(os.path.join(path, f)))
        return sd
    bin_files = [f for f in names
                 if f.endswith(".bin") and "pytorch_model" in f]
    if not bin_files:
        raise FileNotFoundError(f"{path}: no *.safetensors and no "
                                "pytorch_model*.bin")
    for f in bin_files:
        sd.update(torch.load(os.path.join(path, f), map_location="cpu",
                             weights_only=True))
    return sd


def _t(x) -> torch.Tensor:
    """A contiguous float32 CPU tensor with storage of its own (torch.save
    writes a view's whole storage)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).contiguous().clone()
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _T(x):
    """The transpose of the last two axes of a numpy array or tensor."""
    return x.transpose(-1, -2) if isinstance(x, torch.Tensor) \
        else np.asarray(x).T


def export_hf_llama_state_dict(params: Dict, cfg: LlamaConfig) -> Dict:
    """Decoder parameters -> an HF LlamaForCausalLM state dict (float32;
    the inverse of llama_params_from_hf_state_dict)."""
    sd = {
        "model.embed_tokens.weight": _t(params["embed_tokens"]),
        "model.norm.weight": _t(params["final_norm"]),
        "lm_head.weight": _t(_T(params["lm_head"])),
    }
    lyr = params["layers"]
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = _t(lyr["input_norm"][i])
        sd[p + "self_attn.q_proj.weight"] = _t(_T(lyr["wq"][i]))
        sd[p + "self_attn.k_proj.weight"] = _t(_T(lyr["wk"][i]))
        sd[p + "self_attn.v_proj.weight"] = _t(_T(lyr["wv"][i]))
        sd[p + "self_attn.o_proj.weight"] = _t(_T(lyr["wo"][i]))
        sd[p + "post_attention_layernorm.weight"] = _t(
            lyr["post_attn_norm"][i])
        sd[p + "mlp.gate_proj.weight"] = _t(_T(lyr["w_gate"][i]))
        sd[p + "mlp.up_proj.weight"] = _t(_T(lyr["w_up"][i]))
        sd[p + "mlp.down_proj.weight"] = _t(_T(lyr["w_down"][i]))
    return sd


# ---------------------------------------------------------------------------
# HF CLIP vision tower
# ---------------------------------------------------------------------------


def vit_params_from_hf_state_dict(sd: Dict[str, Any], cfg: ViTConfig,
                                  dtype=None) -> Dict:
    def get(key):
        for prefix in ("vision_model.", "vision_tower.vision_model.",
                       "model.vision_model.", ""):
            if prefix + key in sd:
                return _np(sd[prefix + key])
        raise KeyError(key)

    def top(key):
        return _convert(get(key), dtype)

    conv = get("embeddings.patch_embedding.weight")  # (W, 3, p, p)
    patch_proj = conv.transpose(2, 3, 1, 0).reshape(-1, conv.shape[0])

    layers = {k: [] for k in (
        "ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv", "bv",
        "wo", "bo", "ln2_scale", "ln2_bias", "w_fc", "b_fc", "w_proj",
        "b_proj")}
    for i in range(cfg.layers):
        p = f"encoder.layers.{i}."
        layers["ln1_scale"].append(get(p + "layer_norm1.weight"))
        layers["ln1_bias"].append(get(p + "layer_norm1.bias"))
        layers["wq"].append(get(p + "self_attn.q_proj.weight").T)
        layers["bq"].append(get(p + "self_attn.q_proj.bias"))
        layers["wk"].append(get(p + "self_attn.k_proj.weight").T)
        layers["bk"].append(get(p + "self_attn.k_proj.bias"))
        layers["wv"].append(get(p + "self_attn.v_proj.weight").T)
        layers["bv"].append(get(p + "self_attn.v_proj.bias"))
        layers["wo"].append(get(p + "self_attn.out_proj.weight").T)
        layers["bo"].append(get(p + "self_attn.out_proj.bias"))
        layers["ln2_scale"].append(get(p + "layer_norm2.weight"))
        layers["ln2_bias"].append(get(p + "layer_norm2.bias"))
        layers["w_fc"].append(get(p + "mlp.fc1.weight").T)
        layers["b_fc"].append(get(p + "mlp.fc1.bias"))
        layers["w_proj"].append(get(p + "mlp.fc2.weight").T)
        layers["b_proj"].append(get(p + "mlp.fc2.bias"))

    return {
        "patch_proj": _convert(patch_proj, dtype),
        "class_emb": top("embeddings.class_embedding"),
        "pos_emb": top("embeddings.position_embedding.weight"),
        "pre_ln": {"scale": top("pre_layrnorm.weight"),
                   "bias": top("pre_layrnorm.bias")},
        "post_ln": {"scale": top("post_layernorm.weight"),
                    "bias": top("post_layernorm.bias")},
        "layers": {k: _stack(v, dtype) for k, v in layers.items()},
    }


def load_hf_clip_vision(path: str, cfg: ViTConfig, dtype=None) -> Dict:
    return vit_params_from_hf_state_dict(_load_hf_dir_state_dict(path), cfg,
                                         dtype)


# ---------------------------------------------------------------------------
# Perceiver (the reference's AttnPooler state dict)
# ---------------------------------------------------------------------------


def pooler_params_from_torch_state_dict(sd: Dict[str, Any],
                                        cfg: PerceiverConfig,
                                        dtype=None) -> Dict:
    def get(key):
        for prefix in ("", "rgb_pooler."):
            if prefix + key in sd:
                return _np(sd[prefix + key])
        raise KeyError(key)

    h = cfg.hidden_size
    layers = {k: [] for k in (
        "ln1_scale", "ln1_bias", "ln_kv_scale", "ln_kv_bias",
        "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
        "ln2_scale", "ln2_bias", "w_fc", "b_fc", "w_proj", "b_proj")}
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        in_w = get(p + "attn.in_proj_weight")  # (3h, h) rows [q; k; v]
        in_b = get(p + "attn.in_proj_bias")
        layers["wq"].append(in_w[:h].T)
        layers["bq"].append(in_b[:h])
        layers["wk"].append(in_w[h:2 * h].T)
        layers["bk"].append(in_b[h:2 * h])
        layers["wv"].append(in_w[2 * h:].T)
        layers["bv"].append(in_b[2 * h:])
        layers["wo"].append(get(p + "attn.out_proj.weight").T)
        layers["bo"].append(get(p + "attn.out_proj.bias"))
        layers["ln1_scale"].append(get(p + "ln_1.weight"))
        layers["ln1_bias"].append(get(p + "ln_1.bias"))
        layers["ln_kv_scale"].append(get(p + "ln_1_kv.weight"))
        layers["ln_kv_bias"].append(get(p + "ln_1_kv.bias"))
        layers["ln2_scale"].append(get(p + "ln_2.weight"))
        layers["ln2_bias"].append(get(p + "ln_2.bias"))
        layers["w_fc"].append(get(p + "mlp.c_fc.weight").T)
        layers["b_fc"].append(get(p + "mlp.c_fc.bias"))
        layers["w_proj"].append(get(p + "mlp.c_proj.weight").T)
        layers["b_proj"].append(get(p + "mlp.c_proj.bias"))

    params = {
        "query": _convert(get("query")[0], dtype),  # stored (1, nq, h)
        "layers": {k: _stack(v, dtype) for k, v in layers.items()},
        "out_proj_w": _convert(get("out_proj.weight").T, dtype),
        "out_proj_b": _convert(get("out_proj.bias"), dtype),
    }
    if "in_proj.weight" in sd or "rgb_pooler.in_proj.weight" in sd:
        params["in_proj_w"] = _convert(get("in_proj.weight").T, dtype)
        params["in_proj_b"] = _convert(get("in_proj.bias"), dtype)
    return params


# ---------------------------------------------------------------------------
# FINAL.pt + TextLoRA
# ---------------------------------------------------------------------------


def load_final_pt(path: str, vit_cfg: ViTConfig, pooler_cfg: PerceiverConfig,
                  dtype=None) -> Dict[str, Dict]:
    """FINAL.pt -> {"vit": ..., "pooler": ..., "extra": {...}} ("vit" and
    "pooler" only where the file holds them). rgb_ckpt holds the CLIP
    tower (keys under "encoder."); other_ckpt is the reference's nested
    {"rgb_pooler": {...}, "text_proj": {}, "embed_tokens": {...},
    "lm_head": {...}} with the group prefix stripped from the sub-keys, or a
    flat {"rgb_pooler.<param>": ...} layout; "extra" holds the embed_tokens
    / lm_head tensors under "<group>.<param>" keys."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in ckpt and "rgb_ckpt" not in ckpt:
        ckpt = ckpt["model"]
    rgb_sd = ckpt.get("rgb_ckpt", {})
    other_sd = ckpt.get("other_ckpt", {})

    out: Dict[str, Any] = {"extra": {}}
    if rgb_sd:
        rgb_sd = {k.replace("encoder.", "", 1) if k.startswith("encoder.")
                  else k: v for k, v in rgb_sd.items()}
        out["vit"] = vit_params_from_hf_state_dict(rgb_sd, vit_cfg, dtype)

    if isinstance(other_sd.get("rgb_pooler"), dict):
        pooler_sd = other_sd["rgb_pooler"]
        extra_src: Dict[str, Any] = {}
        for group in ("embed_tokens", "lm_head"):
            sub = other_sd.get(group)
            if isinstance(sub, dict):
                extra_src.update({f"{group}.{k}": v for k, v in sub.items()})
    else:
        pooler_sd = {k[len("rgb_pooler."):]: v for k, v in other_sd.items()
                     if k.startswith("rgb_pooler.")}
        extra_src = {k: v for k, v in other_sd.items()
                     if not k.startswith("rgb_pooler.")
                     and ("embed_tokens" in k or "lm_head" in k)}
    if pooler_sd:
        out["pooler"] = pooler_params_from_torch_state_dict(
            pooler_sd, pooler_cfg, dtype)
    out["extra"] = {k: _np(v) for k, v in extra_src.items()
                    if hasattr(v, "detach")}
    return out


def stack_lora(sd: Dict[str, Any], llama_cfg: LlamaConfig
               ) -> Optional[Dict]:
    """peft lora_A / lora_B tensors -> {target: {"a": (L, d_in, r), "b":
    (L, r, d_out)}}. A target with no adapter in any layer is left out
    (peft adapters may cover a subset of the linears); a target with some
    layers but not all raises ValueError (the JAX loader drops such a
    target without a word). None when no target is found."""
    nl = llama_cfg.num_hidden_layers
    found: Dict[str, Dict[str, list]] = {
        ours: {"a": [None] * nl, "b": [None] * nl}
        for ours in LORA_NAMES.values()}
    for key, tensor in sd.items():
        if ".lora_A." not in key and ".lora_B." not in key:
            continue
        parts = key.split(".")
        layer = int(parts[parts.index("layers") + 1])
        proj = next(p for p in LORA_NAMES if p in parts)
        # (r, d_in) -> (d_in, r); (d_out, r) -> (r, d_out)
        found[LORA_NAMES[proj]]["a" if ".lora_A." in key else "b"][
            layer] = _np(tensor).T
    stacked = {}
    for ours, ab in found.items():
        have = [x is not None for x in ab["a"] + ab["b"]]
        if not any(have):
            continue
        if not all(have):
            missing = [i for i in range(nl) if ab["a"][i] is None
                       or ab["b"][i] is None]
            raise ValueError(f"LoRA target {ours}: no adapter in layers "
                             f"{missing}")
        stacked[ours] = {"a": _stack(ab["a"]), "b": _stack(ab["b"])}
    return stacked or None


def load_text_lora(lora_dir: str, llama_cfg: LlamaConfig, r: int,
                   alpha: int) -> Optional[Dict]:
    """A peft TextLoRA/ directory -> stacked LoRA parameters; None when
    the directory does not exist (the reference's detect-and-merge). A
    directory without `adapter_model.bin` or `adapter_model.safetensors`
    raises FileNotFoundError (the JAX loader returns None). `r` and `alpha`
    are the caller's, as in the JAX loader: the directory's
    adapter_config.json is not read."""
    del r, alpha
    if not os.path.isdir(lora_dir):
        return None
    for name in ("adapter_model.bin", "adapter_model.safetensors"):
        path = os.path.join(lora_dir, name)
        if os.path.exists(path):
            sd = (load_file(path) if name.endswith(".safetensors")
                  else torch.load(path, map_location="cpu",
                                  weights_only=True))
            return stack_lora(sd, llama_cfg)
    raise FileNotFoundError(f"{lora_dir}: no adapter_model.bin or "
                            "adapter_model.safetensors")


# ---------------------------------------------------------------------------
# Export: parameters -> FINAL.pt and TextLoRA/
# ---------------------------------------------------------------------------


def export_final_pt(path: str, params: Dict, vit_cfg: ViTConfig,
                    pooler_cfg: PerceiverConfig) -> None:
    """Write {rgb_ckpt, other_ckpt} (float32, the reference's nested
    other_ckpt) from parameters given as numpy arrays or tensors."""
    vit = params["vit"]
    p = vit_cfg.patch_size
    conv = _t(vit["patch_proj"])  # (p * p * 3, W)
    rgb_sd = {"vision_model.embeddings.patch_embedding.weight":
              conv.reshape(p, p, 3, -1).permute(3, 2, 0, 1).contiguous()}
    rgb_sd["vision_model.embeddings.class_embedding"] = _t(vit["class_emb"])
    rgb_sd["vision_model.embeddings.position_embedding.weight"] = _t(
        vit["pos_emb"])
    rgb_sd["vision_model.pre_layrnorm.weight"] = _t(vit["pre_ln"]["scale"])
    rgb_sd["vision_model.pre_layrnorm.bias"] = _t(vit["pre_ln"]["bias"])
    rgb_sd["vision_model.post_layernorm.weight"] = _t(
        vit["post_ln"]["scale"])
    rgb_sd["vision_model.post_layernorm.bias"] = _t(vit["post_ln"]["bias"])
    lyr = vit["layers"]
    for i in range(vit_cfg.layers):
        pref = f"vision_model.encoder.layers.{i}."
        for key, name in (("ln1_scale", "layer_norm1.weight"),
                          ("ln1_bias", "layer_norm1.bias"),
                          ("bq", "self_attn.q_proj.bias"),
                          ("bk", "self_attn.k_proj.bias"),
                          ("bv", "self_attn.v_proj.bias"),
                          ("bo", "self_attn.out_proj.bias"),
                          ("ln2_scale", "layer_norm2.weight"),
                          ("ln2_bias", "layer_norm2.bias"),
                          ("b_fc", "mlp.fc1.bias"),
                          ("b_proj", "mlp.fc2.bias")):
            rgb_sd[pref + name] = _t(lyr[key][i])
        for key, name in (("wq", "self_attn.q_proj.weight"),
                          ("wk", "self_attn.k_proj.weight"),
                          ("wv", "self_attn.v_proj.weight"),
                          ("wo", "self_attn.out_proj.weight"),
                          ("w_fc", "mlp.fc1.weight"),
                          ("w_proj", "mlp.fc2.weight")):
            rgb_sd[pref + name] = _t(_T(lyr[key][i]))

    pool = params["pooler"]
    pl = pool["layers"]
    pool_sd = {"query": _t(pool["query"])[None]}
    for i in range(pooler_cfg.num_layers):
        pref = f"layers.{i}."
        pool_sd[pref + "attn.in_proj_weight"] = torch.cat(
            [_t(_T(pl[k][i])) for k in ("wq", "wk", "wv")], dim=0)
        pool_sd[pref + "attn.in_proj_bias"] = torch.cat(
            [_t(pl[k][i]) for k in ("bq", "bk", "bv")], dim=0)
        pool_sd[pref + "attn.out_proj.weight"] = _t(_T(pl["wo"][i]))
        pool_sd[pref + "attn.out_proj.bias"] = _t(pl["bo"][i])
        for key, name in (("ln1_scale", "ln_1.weight"),
                          ("ln1_bias", "ln_1.bias"),
                          ("ln_kv_scale", "ln_1_kv.weight"),
                          ("ln_kv_bias", "ln_1_kv.bias"),
                          ("ln2_scale", "ln_2.weight"),
                          ("ln2_bias", "ln_2.bias"),
                          ("b_fc", "mlp.c_fc.bias"),
                          ("b_proj", "mlp.c_proj.bias")):
            pool_sd[pref + name] = _t(pl[key][i])
        pool_sd[pref + "mlp.c_fc.weight"] = _t(_T(pl["w_fc"][i]))
        pool_sd[pref + "mlp.c_proj.weight"] = _t(_T(pl["w_proj"][i]))
    pool_sd["out_proj.weight"] = _t(_T(pool["out_proj_w"]))
    pool_sd["out_proj.bias"] = _t(pool["out_proj_b"])
    if "in_proj_w" in pool:
        pool_sd["in_proj.weight"] = _t(_T(pool["in_proj_w"]))
        pool_sd["in_proj.bias"] = _t(pool["in_proj_b"])

    extra = params.get("extra", {})
    other_sd = {
        "rgb_pooler": pool_sd,
        "text_proj": {},
        "embed_tokens": {k.split("embed_tokens.")[-1]: _t(v)
                         for k, v in extra.items() if "embed_tokens" in k},
        "lm_head": {k.split("lm_head.")[-1]: _t(v)
                    for k, v in extra.items() if "lm_head" in k},
    }
    torch.save({"rgb_ckpt": rgb_sd, "other_ckpt": other_sd}, path)


def export_text_lora(lora_dir: str, lora_params: Dict,
                     llama_cfg: LlamaConfig, r: int, alpha: int) -> None:
    """Write a peft-layout TextLoRA/ directory: adapter_model.bin (float32
    lora_A (r, d_in) / lora_B (d_out, r) per layer) and
    adapter_config.json."""
    del llama_cfg
    os.makedirs(lora_dir, exist_ok=True)
    peft_names = {ours: peft for peft, ours in LORA_NAMES.items()}
    sd = {}
    for ours, ab in lora_params.items():
        peft = peft_names[ours]
        group = ("self_attn" if peft in ("q_proj", "k_proj", "v_proj",
                                         "o_proj") else "mlp")
        for i in range(ab["a"].shape[0]):
            base = f"base_model.model.model.layers.{i}.{group}.{peft}."
            sd[base + "lora_A.weight"] = _t(_T(ab["a"][i]))
            sd[base + "lora_B.weight"] = _t(_T(ab["b"][i]))
    torch.save(sd, os.path.join(lora_dir, "adapter_model.bin"))
    with open(os.path.join(lora_dir, "adapter_config.json"), "w") as fh:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": alpha,
                   "target_modules": list(LORA_NAMES)}, fh)
