"""Multimodal embedding splice, one image per row.

Counterpart of `lhrs_bot_tpu/models/splice.py` `splice_image_embeddings`:
each row's IMAGE_TOKEN_INDEX (-200) placeholder expands to the perceiver's
image embeddings; labels at image positions become IGNORE_INDEX; rows without
an image keep their text; every row is right-padded (zero embeddings,
attention False) to the common width T + num_image_tokens - 1. Built from
gathers over broadcast position indices, with no per-row host loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX


class SplicedBatch(NamedTuple):
    inputs_embeds: torch.Tensor  # (B, T_out, D)
    attention_mask: torch.Tensor  # (B, T_out) bool
    labels: Optional[torch.Tensor]  # (B, T_out) or None
    seq_len: torch.Tensor  # (B,) int32 valid length per row


def splice_image_embeddings(
    input_ids: torch.Tensor,  # (B, T) integer, at most one -200 per row
    image_embeds: torch.Tensor,  # (B, N_img, D)
    embed_tokens: torch.Tensor,  # (V, D)
    attention_mask: Optional[torch.Tensor] = None,  # (B, T) bool
    labels: Optional[torch.Tensor] = None,  # (B, T) integer
) -> SplicedBatch:
    b, t = input_ids.shape
    n_img = image_embeds.shape[1]
    t_out = t + n_img - 1
    dev = input_ids.device

    is_img = input_ids == IMAGE_TOKEN_INDEX
    has_img = is_img.any(dim=1)
    # first -200 of each row; rows without one get a sentinel past the end
    img_pos = torch.where(has_img, is_img.int().argmax(dim=1),
                          torch.full_like(has_img, t_out + 1, dtype=torch.long))

    if attention_mask is None:
        attention_mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    valid_in = attention_mask.int().sum(dim=1)
    seq_len = torch.where(has_img, valid_in + n_img - 1, valid_in)

    out_pos = torch.arange(t_out, device=dev)[None, :]  # (1, T_out)
    ip = img_pos[:, None]
    before = out_pos < ip
    inside = (out_pos >= ip) & (out_pos < ip + n_img)
    text_idx = torch.where(before, out_pos, out_pos - (n_img - 1))
    text_valid = ~inside & (text_idx >= 0) & (text_idx < t)
    text_idx_safe = text_idx.clamp(0, t - 1)

    gathered_ids = torch.gather(input_ids, 1, text_idx_safe)
    # never index the embedding table with the -200 marker
    gathered_ids = torch.where(gathered_ids == IMAGE_TOKEN_INDEX,
                               torch.zeros_like(gathered_ids), gathered_ids)
    text_embeds = embed_tokens[gathered_ids.long()]

    img_idx = (out_pos - ip).clamp(0, n_img - 1)
    img_embeds_g = torch.gather(
        image_embeds, 1,
        img_idx[..., None].expand(b, t_out, image_embeds.shape[-1]))

    gathered_attn = torch.gather(attention_mask, 1, text_idx_safe)
    emb_valid = text_valid & gathered_attn
    embeds = torch.where(
        inside[..., None], img_embeds_g.to(text_embeds.dtype),
        torch.where(emb_valid[..., None], text_embeds,
                    torch.zeros((), dtype=text_embeds.dtype, device=dev)))
    attn_out = inside | emb_valid

    labels_out = None
    if labels is not None:
        gathered_labels = torch.gather(labels, 1, text_idx_safe)
        ignore = torch.full_like(gathered_labels, IGNORE_INDEX)
        labels_out = torch.where(inside | ~text_valid, ignore,
                                 torch.where(gathered_attn, gathered_labels,
                                             ignore))
    return SplicedBatch(embeds, attn_out, labels_out, seq_len.int())
