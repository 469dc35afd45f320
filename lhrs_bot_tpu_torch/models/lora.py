"""LoRA adapters for the stacked-layer LLaMA decoder.

Counterpart of `lhrs_bot_tpu/models/lora.py`: adapters on every decoder
linear (q/k/v/o/gate/up/down, not the lm_head), r 128 and alpha 256 in the
published recipe, stored as stacked (L, d_in, r) "a" and (L, r, d_out) "b"
tensors beside the stacked base weights.

Two ways to apply them, as in the JAX package:
  * `merge_lora`: W + scale * A @ B in float32, cast back to W's dtype
    (a dense base; gradients reach A and B through the merge, the base is
    detached);
  * `attach_runtime_lora`: `<name>__lora_a` / `<name>__lora_b` (B with the
    scale folded in) beside a base that cannot be merged into (a quantized
    base, QLoRA), which `models.llama._proj` adds as the side path
    y = x W + (x A) B.

`lora_delta_stepwise` is A @ B summed over r one product at a time, each
product and each partial sum rounded to float32: numpy's einsum order, so
the engine's merge before quantization (`serve.engine`) gives the JAX
engine's `_host_merge_quantize` weights to the bit. peft's per-token LoRA
dropout has no merged form and is left out, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from ..device import resolve_device
from .llama import LlamaConfig

# stacked projection name -> (d_in attribute, d_out attribute)
TARGET_SHAPES = {
    "wq": ("hidden_size", "hidden_size"),
    "wk": ("hidden_size", "hidden_size"),
    "wv": ("hidden_size", "hidden_size"),
    "wo": ("hidden_size", "hidden_size"),
    "w_gate": ("hidden_size", "intermediate_size"),
    "w_up": ("hidden_size", "intermediate_size"),
    "w_down": ("intermediate_size", "hidden_size"),
}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 128
    alpha: int = 256
    dropout: float = 0.05  # recorded only (see the module docstring)
    targets: Tuple[str, ...] = tuple(TARGET_SHAPES)

    @property
    def scale(self) -> float:
        return self.alpha / self.r

    @classmethod
    def from_config_dict(cls, lora_cfg) -> "LoraConfig":
        """From the `lora` section of a config (a plain dict)."""
        return cls(r=int(lora_cfg["lora_r"]), alpha=int(lora_cfg["lora_alpha"]),
                   dropout=float(lora_cfg["lora_dropout"]))


def init_lora_params(llama_cfg: LlamaConfig, lora_cfg: LoraConfig,
                     generator: torch.Generator,
                     dtype: torch.dtype = torch.float32, device="cuda"):
    """A ~ N(0, 1) / sqrt(d_in), B = 0 (the adapter starts as a no-op),
    A drawn from `generator` on `device`, target by target. The draws
    differ from the JAX package's for any seed."""
    device = resolve_device(device)
    nl = llama_cfg.num_hidden_layers
    params = {}
    for name in lora_cfg.targets:
        d_in, d_out = (getattr(llama_cfg, a) for a in TARGET_SHAPES[name])
        a = torch.randn((nl, d_in, lora_cfg.r), generator=generator,
                        dtype=torch.float32, device=device)
        params[name] = {
            "a": (a * (1.0 / math.sqrt(d_in))).to(dtype),
            "b": torch.zeros((nl, lora_cfg.r, d_out), dtype=dtype,
                             device=device),
        }
    return params


def attach_runtime_lora(base_layers: Dict, lora_params,
                        lora_cfg: LoraConfig) -> Dict:
    """The base layers as they are (quantized or not) plus
    `<name>__lora_a` = A and `<name>__lora_b` = B * scale (in B's dtype) for
    each adapter."""
    out = dict(base_layers)
    for name, ab in lora_params.items():
        out[name + "__lora_a"] = ab["a"]
        out[name + "__lora_b"] = ab["b"] * lora_cfg.scale
    return out


def merge_lora(base_layers: Dict, lora_params,
               lora_cfg: LoraConfig) -> Dict:
    """The layers with W := (W_f32 + (A_f32 @ B_f32) * scale) in W's
    dtype for each adapter, W detached (the base is frozen)."""
    merged = dict(base_layers)
    for name, ab in lora_params.items():
        w = base_layers[name].detach()
        delta = torch.matmul(ab["a"].float(), ab["b"].float()) \
            * lora_cfg.scale
        merged[name] = (w.float() + delta).to(w.dtype)
    return merged


def lora_delta_stepwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L, d_in, r) @ (L, r, d_out) in float32, summed over r in order with
    every product and partial sum rounded (no fused multiply-add): the
    bits of numpy's `einsum("lir,lro->lio")`."""
    a, b = a.float(), b.float()
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                      device=a.device)
    prod = torch.empty_like(acc)
    for j in range(a.shape[-1]):
        acc.add_(torch.mul(a[..., j:j + 1], b[:, j:j + 1, :], out=prod))
    return acc
