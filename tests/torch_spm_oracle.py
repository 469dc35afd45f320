"""Oracles for the port's SentencePiece reader (`tests/test_torch_tokenizer_
spm.py` and `tests/torch_spm_fixture/make_fixture.py` use them).

- `fast_oracle(model_file, legacy)`: the `tokenizers` conversion of a
  `tokenizer.model` that produced LLaMA's `tokenizer.json`:
  `transformers`' LlamaConverter, its SentencePiece extractor swapped for
  one that lists the pieces from the protobuf (no `sentencepiece` package
  is needed) and orders the merges by score with `generate_merges`,
  wrapped in `LlamaTokenizerFast`. It is independent of the port.
- `slow_llama_class()`: `transformers`' own slow LlamaTokenizer, the class
  the JAX package loads, imported with a `sentencepiece` module standing
  in whose processor is the port's `SentencePieceModel`: its special-token
  splits, `legacy` handling and decode spacing run as `transformers`
  wrote them, over the port's encoder. Where the fast oracle and the slow
  class part, the slow class is the JAX package's behaviour.
- `corpus()`: the strings the fixture's expected ids cover.
"""

from __future__ import annotations

import functools
import importlib
import importlib.machinery
import sys
import types
from types import SimpleNamespace

from lhrs_bot_tpu_torch.data.sentencepiece import SentencePieceModel


def _pb2():
    from transformers.convert_slow_tokenizer import import_protobuf

    return import_protobuf()


def read_proto(model_file: str):
    pb = _pb2()
    proto = pb.ModelProto()
    with open(model_file, "rb") as fh:
        proto.ParseFromString(fh.read())
    return proto


def fast_oracle(model_file: str, legacy: bool, add_bos_token: bool = True,
                add_eos_token: bool = False):
    """A LlamaTokenizerFast converted from `model_file`."""
    from transformers import LlamaTokenizerFast
    from transformers.convert_slow_tokenizer import (LlamaConverter,
                                                     generate_merges)

    proto = read_proto(model_file)
    pieces = [p.piece for p in proto.pieces]

    class ProtoExtractor:
        def __init__(self, model):
            self.vocab = {piece: i for i, piece in enumerate(pieces)}

        def extract(self, vocab_scores=None):
            return self.vocab, generate_merges(self.vocab, vocab_scores)

    class Converter(LlamaConverter):
        SpmExtractor = ProtoExtractor

    original = SimpleNamespace(vocab_file=model_file, legacy=legacy,
                               add_prefix_space=True,
                               convert_ids_to_tokens=pieces.__getitem__)
    converted = Converter(original).converted()
    return LlamaTokenizerFast(
        tokenizer_object=converted, legacy=legacy, bos_token="<s>",
        eos_token="</s>", unk_token="<unk>", add_bos_token=add_bos_token,
        add_eos_token=add_eos_token, clean_up_tokenization_spaces=False)


class _Processor:
    """The part of `sentencepiece.SentencePieceProcessor` that the slow
    LlamaTokenizer calls, over the port's SentencePieceModel."""

    def __init__(self, **kwargs):
        self.model = None

    def Load(self, path):  # noqa: N802 — sentencepiece's names
        self.model = SentencePieceModel.from_file(path)

    def LoadFromSerializedProto(self, data):  # noqa: N802
        self.model = SentencePieceModel.from_bytes(data)

    def encode(self, text, out_type=int, **kwargs):
        if out_type is str:
            return self.model.encode_as_pieces(text)
        return self.model.encode(text)

    def decode(self, items):
        if items and isinstance(items[0], str):
            return self.model.decode_pieces(items)
        return self.model.decode(items)

    def piece_to_id(self, piece):
        return self.model.piece_to_id(piece)

    def IdToPiece(self, i):  # noqa: N802
        return self.model.id_to_piece(i)

    id_to_piece = IdToPiece

    def get_piece_size(self):
        return len(self.model)

    GetPieceSize = get_piece_size


@functools.lru_cache(maxsize=None)
def slow_llama_class():
    """transformers' slow LlamaTokenizer, its module imported with the
    stand-in `sentencepiece` and then dropped from sys.modules and from its
    package again (a later import of transformers' llama tokenizer sees no
    sentencepiece, as before)."""
    name = "transformers.models.llama.tokenization_llama"
    stub = types.ModuleType("sentencepiece")
    stub.__spec__ = importlib.machinery.ModuleSpec("sentencepiece", None)
    stub.SentencePieceProcessor = _Processor
    parent = importlib.import_module("transformers.models.llama")
    had = "tokenization_llama" in vars(parent)
    saved = {k: sys.modules.pop(k) for k in ("sentencepiece", name)
             if k in sys.modules}
    sys.modules["sentencepiece"] = stub
    try:
        module = importlib.import_module(name)
        return module.LlamaTokenizer
    finally:
        sys.modules.pop("sentencepiece", None)
        sys.modules.pop(name, None)
        sys.modules.update(saved)
        if not had:  # nor is it reached as the package's attribute
            vars(parent).pop("tokenization_llama", None)


def slow_oracle(path: str, **kwargs):
    """The slow class loaded from a tokenizer directory as
    `from_pretrained` loads it (the JAX loader's call), pad bound to unk
    as the JAX loader binds it."""
    tok = slow_llama_class().from_pretrained(path, **kwargs)
    if tok.pad_token is None:
        tok.pad_token = tok.unk_token
    return tok


def render(template: str, turns, image: bool = True) -> str:
    """The prompt of `template` (the port's templates, equal to JAX's)
    over (user, assistant) turns; an assistant turn of None leaves the
    prompt open for generation."""
    from lhrs_bot_tpu_torch.data import conversation as conv_lib

    conv = conv_lib.conv_templates[template].copy()
    for k, (user, assistant) in enumerate(turns):
        if image and k == 0:
            user = "<image>\n" + user
        conv.append_message(conv.roles[0], user)
        conv.append_message(conv.roles[1], assistant)
    return conv.get_prompt()


QA = [("What is in this remote sensing image?",
       "An airport with two runways and several parked airplanes."),
      ("How many airplanes are there?", "There are 7 airplanes."),
      ("Is there any water?", "No, the scene shows no water body.")]


def corpus():
    """The fixture's strings: the LLaMA-2 and v1 templates rendered (one
    and several rounds, with <image>), whitespace runs, digits, CJK text
    and emoji (byte fallback), the empty string, and the special tokens
    written in the text."""
    return [
        render("llava_llama_2", [(QA[0][0], None)]),
        render("llava_llama_2", QA),
        render("llava_llama_2", QA[:2], image=False),
        render("v1", [(QA[0][0], None)]),
        render("v1", QA),
        "<image>An airport with two runways.\n",
        "Hello world",
        "",
        " ",
        "   leading spaces",
        "trailing spaces   ",
        "a  b   c    d     e",
        "tab\tseparated\tcolumns\t",
        "line one\nline two\n\n  indented line\n",
        "\n\n\t \n",
        "mixed \t whitespace \n here",
        "Pi is 3.14159, 2024-10-18 and 1,000,000 planes at 04:30.",
        "遥感图像中有多少架飞机？",
        "Satellite 🛰️ over the globe 🌍 at night 🌃.",
        "café naïve façade — “quotes” and ‘ticks’ … ",
        "<s>",
        "</s>",
        "<unk>",
        "Hello <s>.",
        "<s>Hello",
        " <s> spaced </s> tokens <unk> here ",
        "ASSISTANT: yes</s>USER: next question",
        "a</s>b<s>c",
        "x <unk>y",
        "▁literal▁escape▁marks ▁",
        "<im_start><Image></Image> [INST] <<SYS>>",
        "The_quick-brown fox's (jumped) over 12 dogs; didn't it?",
        "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa",
    ]
