"""ViT patch embedding from raw uint8 pixels.

Counterpart of `lhrs_bot_tpu/ops/patch_embed.py`: CLIP normalisation
((x/255 - mean)/std), then the stride=kernel=patch convolution written as a
[num_patches, patch*patch*3] x [patch*patch*3, width] matmul.
"""

from __future__ import annotations

import torch

# CLIP's normalisation constants (HF CLIPImageProcessor defaults).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/p)*(W/p), p*p*C)."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def patch_embed(images_uint8: torch.Tensor, w_patch: torch.Tensor, *,
                patch: int = 14,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, num_patches, width) in compute_dtype."""
    dev = images_uint8.device
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=dev)
    x = (images_uint8.float() / 255.0 - mean) / std
    patches = patchify(x.to(compute_dtype), patch)
    return torch.matmul(patches, w_patch.to(compute_dtype))
