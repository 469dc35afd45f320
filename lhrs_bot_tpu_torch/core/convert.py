"""The weight bridge from the JAX package, and the serving config preset.

`params_from_numpy` turns the JAX package's parameter pytree, given as numpy
arrays (`{"vit", "pooler", "llama", ["lora"]}` from `init_vlm_params`,
`core/torch_import.py` or `core/model_io.load_pretrained`), into the port's
parameters: the same nested dicts of tensors. A quantized base weight (the
JAX package's QuantizedTensor, or the port's) becomes the port's
`ops.quant.QuantizedTensor` with the same codes, scale and bits. The port
keeps the JAX layout, per-layer tensors stacked on a leading axis and
projection weights (in, out), so `x @ w` needs no transpose; a layout
change for a kernel belongs in this module and nowhere else.
`training_params_from_numpy` gives the parameters for training: float32
masters of the trainable leaves, the frozen ones in the compute dtype, each
of which remembers the leaf it was cast from (`as_loaded` gives that leaf
back, so what is written is what was loaded, not its rounded copy).

`eval_config()` holds the fields of `Config/multi_modal_eval.yaml` that the
serving slice reads, so the serving path needs no YAML parser.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quant import QuantizedTensor


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    arr = np.asarray(leaf)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C")  # torch wants a writable buffer
    return torch.from_numpy(arr)


def _quantized(leaf) -> bool:
    """A quantized weight: the port's QuantizedTensor or any object with
    its fields (the JAX package's, whose q and scale are arrays)."""
    return all(hasattr(leaf, a) for a in ("q", "scale", "bits"))


def params_from_numpy(tree):
    """numpy pytree -> nested dict of tensors with the same dtypes (a
    tensor stays where it is, a numpy array becomes a CPU tensor; a
    quantized weight a QuantizedTensor of such tensors). Casting to the
    compute dtype and placing on a device is the engine's job
    (`GenerationEngine.__init__`)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    if _quantized(tree):
        return QuantizedTensor(_tensor(tree.q), _tensor(tree.scale),
                               tree.bits)
    return _tensor(tree)


def _remember_source(t: torch.Tensor, src) -> None:
    """Keep on the cast copy `t` the leaf it was cast from."""
    t._loaded_from = src


def source_of(t):
    """The leaf `t` was cast from by `training_params_from_numpy` (the
    numpy array or the tensor that was given, not a copy), or `t` itself
    for any other leaf."""
    return getattr(t, "_loaded_from", t)


def as_loaded(tree):
    """`tree` with every frozen leaf replaced by the leaf it was cast from
    (`source_of`); the other leaves (trainable float32 masters, integer
    leaves, quantized weights) as they are. What `save_final` and
    `core.checkpoint` write (both widen a bf16 leaf to float32, exactly)."""
    if isinstance(tree, dict):
        return {k: as_loaded(v) for k, v in tree.items()}
    return source_of(tree)


def training_params_from_numpy(tree, cfg,
                               compute_dtype: torch.dtype = torch.bfloat16,
                               device="cuda"):
    """The JAX parameter pytree (numpy arrays, or tensors) -> the port's
    parameters for training on `device`, by `models.vlm.trainable_mask`:
    each trainable leaf a float32 master tensor with requires_grad (the JAX
    trainer keeps float32 parameters); each frozen float leaf cast once to
    the compute dtype, without grad (at 7B that saves 14 GB against float32
    copies, and it is the cast the JAX model functions make on every call),
    but the ViT's pre-LayerNorm, kept as given as the JAX tower uses it,
    and, over a dense base with live adapters (stages 2 and 3), the
    decoder projections the adapters merge into, kept in float32 so that
    the merge rounds once, as JAX's float32 base does. Each frozen float
    leaf remembers the leaf it came from (`source_of`, `as_loaded`), which
    stays alive while the trainer does: the JAX trainer keeps its frozen
    leaves in float32 and writes them so. Integer leaves move as they are;
    a quantized base weight (stages 2 and 3 at `bits` 8 / 4) moves as a
    QuantizedTensor with a float32 scale. The "lora" leaves train at stages
    2 and 3."""
    from ..models.vlm import trainable_mask

    device = resolve_device(device)
    f32 = _float32_base_paths(tree, cfg)

    def walk(t, mask, keep, path):
        if isinstance(t, dict):
            return {k: walk(v, mask[k], keep or k == "pre_ln", path + (k,))
                    for k, v in t.items()}
        if _quantized(t):
            return QuantizedTensor(_tensor(t.q), _tensor(t.scale),
                                   t.bits).to(device)
        x = _tensor(t)
        if not x.is_floating_point():
            return x.to(device)
        if mask:
            return x.to(device=device, dtype=torch.float32,
                        copy=True).requires_grad_(True)
        dtype = (None if keep else torch.float32 if path in f32
                 else compute_dtype)
        out = x.to(device=device, dtype=dtype)
        if out is not t and out is not x:
            _remember_source(out, t)
        return out

    return walk(tree, trainable_mask(tree, cfg), False, ())


def _float32_base_paths(tree, cfg):
    """The paths of the dense decoder projections that live adapters merge
    into (`models.lora.merge_lora`), which training keeps in float32."""
    from ..models.lora import TARGET_SHAPES

    if cfg.lora is None or "lora" not in tree or cfg.stage == 0:
        return set()
    layers = tree["llama"]["layers"]
    return {("llama", "layers", name) for name in tree["lora"]
            if name in TARGET_SHAPES and not _quantized(layers[name])}


def eval_config() -> dict:
    """The fields of `Config/multi_modal_eval.yaml` that the serving slice
    reads (model shapes, stage, precision), as a nested dict."""
    return {
        "stage": 0,
        "tune_rgb_bk": False,
        "tune_rgb_pooler": False,
        "rgb_vision": {
            "arch": "vit_large",
            "attn_pooler": {"num_query": 144, "num_attn_heads": 16,
                            "num_layers": 6},
        },
        "text": {
            "vocab_size": 32000,
            "hidden_size": 4096,
            "intermediate_size": 11008,
            "num_hidden_layers": 32,
            "num_attention_heads": 32,
            "max_position_embeddings": 2048,
            "rms_norm_eps": 1e-5,
            "pad_token_id": 0,
            "bos_token_id": 1,
            "eos_token_id": 2,
        },
        "lora": {"enable": False},
        "bits": 16,
        "kv_bits": 16,
    }
