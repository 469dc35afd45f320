"""Prompt tokenization around image markers (host side).

Counterpart of the serving part of `lhrs_bot_tpu/data/preprocess.py`:
`tokenizer_image_token` (tokenize around each "<image>" and splice
IMAGE_TOKEN_INDEX between the chunks, keeping a single BOS) and
`wrap_image_token_for_generation` (the generation-side image-slot
wrapping). The training `preprocess_*` functions are not ported here.

The tokenizer is any object with `__call__(text).input_ids` and
`bos_token_id` (`data.tokenizer.ByteTokenizer`, an HF tokenizer).
"""

from __future__ import annotations

from typing import List

from ..models.constants import (DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN,
                                DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX)
from . import conversation as conversation_lib


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> List[int]:
    chunks = [tokenizer(c).input_ids
              for c in prompt.split(DEFAULT_IMAGE_TOKEN)]
    ids: List[int] = []
    offset = 0
    if chunks and chunks[0] and chunks[0][0] == tokenizer.bos_token_id:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    for i, chunk in enumerate(chunks):
        ids.extend(chunk[offset:])
        if i != len(chunks) - 1:
            ids.extend(sep[offset:])
    return ids


def wrap_image_token_for_generation(text: str,
                                    tune_im_start: bool = False) -> str:
    """Move "<image>" to the front, wrap it in <Image>...</Image> when the
    active template's version contains "mmtag", then in <im_start> /
    <im_end> with `tune_im_start`. Identity for non-mmtag templates without
    tune_im_start (the published recipes)."""
    if DEFAULT_IMAGE_TOKEN not in text:
        return text
    text = text.replace(DEFAULT_IMAGE_TOKEN, "").strip()
    text = (DEFAULT_IMAGE_TOKEN + "\n" + text).strip()
    if "mmtag" in conversation_lib.default_conversation.version:
        text = text.replace(DEFAULT_IMAGE_TOKEN,
                            "<Image>" + DEFAULT_IMAGE_TOKEN + "</Image>")
    if tune_im_start:
        text = text.replace(
            DEFAULT_IMAGE_TOKEN,
            DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
            + DEFAULT_IM_END_TOKEN)
    return text
