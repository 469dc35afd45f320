"""CLIP ViT vision towers (ViT-L/14, ViT-B/16) with multi-level taps.

Counterpart of `lhrs_bot_tpu/models/vit.py` (`vit_embed`, `vit_encode`,
`vit_encode_fused`): hidden states are tapped after `extract_stages` layers
(7/15/22 for ViT-L), the CLS token is dropped from each tap, the taps are
concatenated along the token axis, and layers past the last tap are never
computed. Parameters use the JAX layout: per-layer tensors stacked on a
leading axis, (in, out) projection weights. Float layer parameters must
already be in the compute dtype (the engine casts them once). With int8
`QuantizedTensor` projections (`quantize_vision_layers`) `vit_encode` is the
XLA W8A8 tower of the JAX package (`dense_any`); `vit_encode_fused` is the
fused W8A8 tower (ops/vit_block.py) over `pack_vit_layers_fused` layers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.attention import flash_attention
from ..ops.mlp import dense_any, gelu_mlp
from ..ops.patch_embed import patch_embed, patchify
from ..ops.rmsnorm import layer_norm
from ..ops.vit_block import vit_layer_fused
from .llama import _layer


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    ln_eps: float = 1e-5
    quick_gelu: bool = True
    extract_stages: Tuple[int, ...] = (7, 15, 22)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @classmethod
    def vit_large(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def vit_base(cls) -> "ViTConfig":
        return cls(width=768, layers=12, heads=12, patch_size=16,
                   extract_stages=(3, 7, 10))

    @classmethod
    def tiny_test(cls) -> "ViTConfig":
        return cls(image_size=28, patch_size=14, width=32, layers=4, heads=2,
                   extract_stages=(1, 2, 3))


def _encoder_layer(x: torch.Tensor, lp, cfg: ViTConfig) -> torch.Tensor:
    """One pre-LN transformer block; x (B, S, W)."""
    b, s, w = x.shape
    h = layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], cfg.ln_eps)

    def proj(wm, bm):
        out = dense_any(h, wm, bm).to(x.dtype)
        return out.reshape(b, s, cfg.heads, cfg.head_dim).transpose(1, 2) \
            .contiguous()

    q, k, v = proj(lp["wq"], lp["bq"]), proj(lp["wk"], lp["bk"]), \
        proj(lp["wv"], lp["bv"])
    attn = flash_attention(q, k, v, causal=False)
    attn = attn.transpose(1, 2).reshape(b, s, w)
    x = x + dense_any(attn, lp["wo"], lp["bo"]).to(x.dtype)
    h2 = layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], cfg.ln_eps)
    return x + gelu_mlp(h2, lp["w_fc"], lp["b_fc"], lp["w_proj"],
                        lp["b_proj"], quick_gelu=cfg.quick_gelu)


def vit_embed(params, images: torch.Tensor, cfg: ViTConfig,
              compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Images -> (B, S, W) tokens: CLS + patches + positions. Raw uint8
    (B, H, W, 3) pixels are normalised in the patch embedding; float
    `pixel_values` (already normalised, as the reference's
    CLIPImageProcessor gives them; (B, 3, H, W) or (B, H, W, 3)) are
    patchified in the compute dtype and projected with float32
    accumulation, rounded once."""
    w_patch = params["patch_proj"]
    if images.dtype == torch.uint8:
        patches = patch_embed(images, w_patch, patch=cfg.patch_size,
                              compute_dtype=compute_dtype)
    else:
        if images.shape[1] == 3:  # NCHW -> NHWC
            images = images.permute(0, 2, 3, 1)
        flat = patchify(images.to(compute_dtype), cfg.patch_size)
        patches = torch.matmul(flat.float(), w_patch.to(compute_dtype)
                               .float()).to(compute_dtype)
    b = patches.shape[0]
    cls = params["class_emb"].to(compute_dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, patches], dim=1)
    return x + params["pos_emb"].to(compute_dtype)[None]


def vit_encode(params, images: torch.Tensor, cfg: ViTConfig,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Multi-level encode: (B, 3*num_patches, width)."""
    x = vit_embed(params, images, cfg, compute_dtype)
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                   cfg.ln_eps)
    taps = []
    prev = 0
    for stage in cfg.extract_stages:
        for li in range(prev, stage):
            x = _encoder_layer(x, _layer(params["layers"], li), cfg)
        taps.append(x[:, 1:, :])  # drop CLS
        prev = stage
    return torch.cat(taps, dim=1)


def vit_encode_fused(params, packed_layers, images: torch.Tensor,
                     cfg: ViTConfig, *, group: int = 8, attn_pair: int = 2,
                     split_attention: bool = False) -> torch.Tensor:
    """Multi-level encode through the fused W8A8 block
    (ops/vit_block.py), in bf16: (B, 3*num_patches, width). Same taps as
    `vit_encode`. split_attention=True runs each block in the JAX split
    form (attention output rounded to bf16 before its quantization).
    `group` and `attn_pair` are the TPU kernel's layout (images per grid
    step, images per attention matmul): the port computes each image's 257
    tokens unpadded, which gives the same result, and ignores them."""
    x = vit_embed(params, images, cfg, torch.bfloat16)
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                   cfg.ln_eps)
    taps = []
    prev = 0
    for stage in cfg.extract_stages:
        for li in range(prev, stage):
            x = vit_layer_fused(x, _layer(packed_layers, li), heads=cfg.heads,
                                ln_eps=cfg.ln_eps, quick_gelu=cfg.quick_gelu,
                                split_attention=split_attention)
        taps.append(x[:, 1:, :])  # drop CLS
        prev = stage
    return torch.cat(taps, dim=1)
