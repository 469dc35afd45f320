"""The weight bridge from the JAX package, and the serving config preset.

`params_from_numpy` turns the JAX package's parameter pytree, given as numpy
arrays (`{"vit", "pooler", "llama"}` from `init_vlm_params` or
`core/torch_import.py`), into the port's parameters: the same nested dicts
of tensors. The port keeps the JAX layout, per-layer tensors stacked on a
leading axis and projection weights (in, out), so `x @ w` needs no
transpose; a layout change for a kernel belongs in this module and nowhere
else.

`eval_config()` holds the fields of `Config/multi_modal_eval.yaml` that the
serving slice reads, so the serving path needs no YAML parser.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree):
    """numpy pytree -> nested dict of CPU tensors with the same dtypes.
    Casting to the compute dtype and placing on a device is the engine's
    job (`GenerationEngine.__init__`)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C")  # torch wants a writable buffer
    return torch.from_numpy(arr)


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
