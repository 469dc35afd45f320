"""Multimodal embedding splice.

Counterpart of `lhrs_bot_tpu/models/splice.py`. `splice_image_embeddings`:
each row's IMAGE_TOKEN_INDEX (-200) placeholder expands to the perceiver's
image embeddings; labels at image positions become IGNORE_INDEX; rows without
an image keep their text; every row is right-padded (zero embeddings,
attention False) to the common width T + num_image_tokens - 1.
`splice_image_embeddings_multi`: up to K placeholders a row, marker k (in
reading order) expanding to image slot k, width T + K (N - 1), and packing
segment ids carried through (an image span takes its marker's segment,
padding is segment 0). Both are built from gathers over broadcast position
indices, with no per-row host loop.
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
    segment_ids: Optional[torch.Tensor] = None  # (B, T_out) int32, packing


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


def splice_image_embeddings_multi(
    input_ids: torch.Tensor,  # (B, T) integer, up to K -200 markers per row
    image_embeds: torch.Tensor,  # (B, K, N_img, D), slot k for marker k
    embed_tokens: torch.Tensor,  # (V, D)
    attention_mask: Optional[torch.Tensor] = None,  # (B, T) bool
    labels: Optional[torch.Tensor] = None,  # (B, T) integer
    segment_ids: Optional[torch.Tensor] = None,  # (B, T) int32, packing
) -> SplicedBatch:
    """The K-image splice: rows with fewer markers leave their trailing
    slots unused. Static output width T + K (N - 1)."""
    b, t = input_ids.shape
    k_max, n_img = image_embeds.shape[1:3]
    t_out = t + k_max * (n_img - 1)
    sentinel = t_out + n_img + 1
    dev = input_ids.device

    is_img = input_ids == IMAGE_TOKEN_INDEX
    pos = torch.where(is_img, torch.arange(t, device=dev)[None, :],
                      torch.full_like(input_ids, sentinel, dtype=torch.long))
    img_pos = pos.sort(dim=1).values[:, :k_max]  # (B, K) ascending
    # span k starts at its marker shifted by the expansion of spans before
    start = img_pos + (n_img - 1) * torch.arange(k_max, device=dev)[None, :]

    if attention_mask is None:
        attention_mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    valid_in = attention_mask.int().sum(dim=1)
    k_count = is_img.int().sum(dim=1).clamp(max=k_max)
    seq_len = valid_in + (n_img - 1) * k_count

    out_pos = torch.arange(t_out, device=dev)[None, :, None]  # (1, To, 1)
    st = start[:, None, :]  # (B, 1, K)
    inside_k = (out_pos >= st) & (out_pos < st + n_img)  # (B, To, K)
    inside = inside_k.any(dim=-1)
    which = inside_k.int().argmax(dim=-1)  # (B, To)
    start_w = torch.gather(start, 1, which)
    off = (out_pos[..., 0] - start_w).clamp(0, n_img - 1)
    flat_idx = which * n_img + off
    img_flat = image_embeds.reshape(b, k_max * n_img, -1)
    img_g = torch.gather(img_flat, 1, flat_idx[..., None].expand(
        b, t_out, img_flat.shape[-1]))

    full_before = (out_pos >= st + n_img).int().sum(dim=-1)
    text_idx = out_pos[..., 0] - (n_img - 1) * full_before
    text_valid = ~inside & (text_idx >= 0) & (text_idx < t)
    text_idx_safe = text_idx.clamp(0, t - 1)
    gathered_ids = torch.gather(input_ids, 1, text_idx_safe)
    gathered_ids = torch.where(gathered_ids == IMAGE_TOKEN_INDEX,
                               torch.zeros_like(gathered_ids), gathered_ids)
    text_embeds = embed_tokens[gathered_ids.long()]
    gathered_attn = torch.gather(attention_mask, 1, text_idx_safe)
    emb_valid = text_valid & gathered_attn
    embeds = torch.where(
        inside[..., None], img_g.to(text_embeds.dtype),
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

    seg_out = None
    if segment_ids is not None:
        seg_text = torch.gather(segment_ids, 1, text_idx_safe)
        marker_seg = torch.gather(segment_ids, 1, img_pos.clamp(0, t - 1))
        seg_img = torch.gather(marker_seg, 1, which)
        seg_out = torch.where(inside, seg_img,
                              torch.where(emb_valid, seg_text,
                                          torch.zeros_like(seg_text)))
        seg_out = seg_out.to(torch.int32)
    return SplicedBatch(embeds, attn_out, labels_out, seq_len.int(), seg_out)
