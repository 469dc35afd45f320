"""Prompt tokenization around image markers and the training loss masks
(host side, numpy).

Counterpart of `lhrs_bot_tpu/data/preprocess.py`: `tokenizer_image_token`
(tokenize around each "<image>" and splice IMAGE_TOKEN_INDEX between the
chunks, keeping a single BOS), `wrap_image_token_for_generation` (the
generation-side image-slot wrapping) and the training half:
`preprocess_multimodal` ("<image>" to the front of the first turn, the
mmtag and im_start wraps), `preprocess_plain` (stage-1 captions: the
question becomes "<image>" and is masked), `preprocess_llama_2` and
`preprocess_v1` (every token but the assistant's answers masked, split on
the template's separators with the reference's -2 instruction offset and
its mask-all safety check) and `preprocess` (the dispatch on the active
template).

The tokenizer is any object with `__call__(text).input_ids`,
`bos_token_id`, `pad_token_id` and `model_max_length`
(`data.tokenizer.ByteTokenizer`, an HF tokenizer).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.constants import (DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN,
                                DEFAULT_IMAGE_TOKEN, IGNORE_INDEX,
                                IMAGE_TOKEN_INDEX)
from . import conversation as conversation_lib
from .conversation import SeparatorStyle


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


def preprocess_multimodal(sources: List[Dict[str, Optional[str]]],
                          tune_im_start: bool = False
                          ) -> List[Dict[str, Optional[str]]]:
    """In place: each value holding "<image>" gets it once, at its front
    and on a line of its own, wrapped as `wrap_image_token_for_generation`
    wraps it."""
    if not isinstance(sources, list):
        sources = [sources]
    for source in sources:
        for key, value in source.items():
            if value is not None and DEFAULT_IMAGE_TOKEN in value:
                source[key] = wrap_image_token_for_generation(
                    value, tune_im_start)
    return sources


def _render_conversation(sources: Sequence[Dict], conv) -> str:
    roles = {"Question": conv.roles[0], "Answer": conv.roles[1],
             "value": conv.roles[1]}
    for source in sources:
        for j, key in enumerate(source):
            role = roles[key]
            assert role == conv.roles[j % 2], f"role order violation at {key}"
            conv.append_message(role, source[key])
    return conv.get_prompt()


def preprocess_plain(sources: Sequence[Dict], tokenizer) -> Dict:
    """Stage-1 captions: prompt "<image>" + answer + sep, the question's
    tokens masked. Sets each source's "Question" to "<image>"."""
    conv = conversation_lib.default_conversation
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source["Question"]
        source["Question"] = DEFAULT_IMAGE_TOKEN
        conversations.append(source["Question"] + source["Answer"]
                             + conv.sep)
    input_ids = [np.asarray(tokenizer_image_token(c, tokenizer), np.int64)
                 for c in conversations]
    labels = [ids.copy() for ids in input_ids]
    for lab, source in zip(labels, sources):
        q_len = len(tokenizer_image_token(source["Question"], tokenizer))
        lab[:q_len] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=labels)


def _mask_rounds(conversation: str, target: np.ndarray, tokenizer,
                 sep: str, sep2: str, has_image: bool) -> None:
    """In place: mask BOS and each round's instruction (up to and with
    `sep`, less the reference's 2 tokens), and everything after the last
    round; all of it where the rounds' lengths do not add up to the
    unpadded length (a tokenization mismatch drops the sample)."""
    total_len = int((target != tokenizer.pad_token_id).sum())
    cur_len = 1
    target[:cur_len] = IGNORE_INDEX
    for rou in conversation.split(sep2):
        if rou == "":
            break
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        parts[0] += sep
        if has_image:
            round_len = len(tokenizer_image_token(rou, tokenizer))
            instruction_len = len(tokenizer_image_token(parts[0],
                                                        tokenizer)) - 2
        else:
            round_len = len(tokenizer(rou).input_ids)
            instruction_len = len(tokenizer(parts[0]).input_ids) - 2
        target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len
    target[cur_len:] = IGNORE_INDEX
    if cur_len < tokenizer.model_max_length and cur_len != total_len:
        target[:] = IGNORE_INDEX


def _preprocess_rounds(sources, tokenizer, has_image: bool, style,
                       sep_of) -> Dict:
    conv = conversation_lib.default_conversation.copy()
    conversation = _render_conversation(sources, conv)
    assert conv.sep_style == style
    if has_image:
        ids = tokenizer_image_token(conversation, tokenizer)
    else:
        ids = tokenizer(conversation).input_ids[:tokenizer.model_max_length]
    input_ids = np.asarray([ids], np.int64)
    targets = input_ids.copy()
    _mask_rounds(conversation, targets[0], tokenizer, sep=sep_of(conv),
                 sep2=conv.sep2, has_image=has_image)
    return dict(input_ids=input_ids, labels=targets)


def preprocess_llama_2(sources, tokenizer, has_image: bool = False) -> Dict:
    """LLaMA-2 template: the rounds split on "</s>", instructions on
    "[/INST] "."""
    return _preprocess_rounds(sources, tokenizer, has_image,
                              SeparatorStyle.LLAMA_2,
                              lambda conv: "[/INST] ")


def preprocess_v1(sources, tokenizer, has_image: bool = False) -> Dict:
    """Vicuna v1 (TWO) template: instructions end at sep + the assistant's
    role + ": "."""
    return _preprocess_rounds(sources, tokenizer, has_image,
                              SeparatorStyle.TWO,
                              lambda conv: conv.sep + conv.roles[1] + ": ")


def preprocess(sources, tokenizer, has_image: bool = False) -> Dict:
    """{"input_ids", "labels"} of `sources` under the active template:
    plain (on a copy of the sources), LLaMA-2 or v1; other templates raise
    ValueError."""
    style = conversation_lib.default_conversation.sep_style
    if style == SeparatorStyle.PLAIN:
        return preprocess_plain(copy.deepcopy(sources), tokenizer)
    if style == SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image=has_image)
    if conversation_lib.default_conversation.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image=has_image)
    raise ValueError(f"unsupported separator style {style}")
