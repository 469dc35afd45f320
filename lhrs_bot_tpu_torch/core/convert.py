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
masters of the trainable leaves, the frozen ones in the compute dtype.

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


def training_params_from_numpy(tree, cfg,
                               compute_dtype: torch.dtype = torch.bfloat16,
                               device="cuda"):
    """The JAX parameter pytree (numpy arrays, or tensors) -> the port's
    parameters for training on `device`, by `models.vlm.trainable_mask`:
    each trainable leaf a float32 master tensor with requires_grad (the JAX
    trainer keeps float32 parameters); each frozen float leaf cast once to
    the compute dtype, without grad (at 7B that saves 14 GB against float32
    copies, and it is the cast the JAX model functions make on every call),
    but the ViT's pre-LayerNorm, kept as given as the JAX tower uses it.
    Integer leaves move as they are; a quantized base weight (stages 2 and
    3 at `bits` 8 / 4) moves as a QuantizedTensor with a float32 scale.
    The "lora" leaves train at stages 2 and 3."""
    from ..models.vlm import trainable_mask

    device = resolve_device(device)

    def walk(t, mask, keep):
        if isinstance(t, dict):
            return {k: walk(v, mask[k], keep or k == "pre_ln")
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
        return x.to(device=device, dtype=None if keep else compute_dtype)

    return walk(tree, trainable_mask(tree, cfg), False)


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
