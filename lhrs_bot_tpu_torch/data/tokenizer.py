"""Tokenizer loading without `transformers`, `tokenizers` or
`sentencepiece`.

Counterpart of `lhrs_bot_tpu/data/tokenizer.py`, whose `load_tokenizer`
gives the slow `transformers` LlamaTokenizer for a directory holding a
`tokenizer.model`, and a byte-level fallback without one.

`LlamaTokenizer` is that slow class over the port's own SentencePiece
reader (`data.sentencepiece`): the special and added tokens written in the
text split out whole (with their lstrip / rstrip / single_word flags), the
rest encoded by SentencePiece; `legacy` (True where the files do not set
it) decides whether the text after a special token takes the dummy prefix
(non-legacy: the model's `add_dummy_prefix` is off, a "▁" is prepended to
the whole text, and a chunk starting with a space is encoded behind the
unk token's text, whose pieces are then dropped); `add_bos_token` /
`add_eos_token` wrap `encode`. Decoding follows the slow class's
`_decode` and `convert_tokens_to_string`: the first token's leading "▁"
dropped, special tokens written as their text (legacy: behind a space)
unless skipped, the pieces between them decoded by SentencePiece,
non-special added tokens joined by a space (`spaces_between_special_
tokens`), and `clean_up_tokenization_spaces` applied where set.

`ByteTokenizer` gives the ids and the decoded text of the JAX package's
`make_fallback_tokenizer` (an HF byte-level BPE with no merges): pad 0,
bos 1, eos 2, unk 3, and byte b as 4 + the rank of GPT-2's
`bytes_to_unicode()[b]` in the sorted byte-level alphabet. "<pad>", "<s>",
"</s>" and "<unk>" written in the text are matched as the special tokens,
and `__call__` prepends BOS.

`load_tokenizer` gives a LlamaTokenizer for a `tokenizer.model` file or a
directory holding one (reading `tokenizer_config.json`,
`special_tokens_map.json` and `added_tokens.json` beside it, as
`from_pretrained` does, and binding pad to unk where they name no pad, as
the JAX loader does), the byte tokenizer for a path that is empty, missing
or a directory holding no tokenizer file (or FileNotFoundError when
`allow_fallback` is False), and raises ValueError for a directory with a
fast `tokenizer.json` but no `tokenizer.model` (the JAX loader falls back
to bytes there; the port does not serve a trained model with the wrong
vocabulary).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

from .sentencepiece import SPACE, SentencePieceModel

logger = logging.getLogger("lhrs_tpu")

SPECIAL_TOKENS = ("<pad>", "<s>", "</s>", "<unk>")  # ids 0-3
_SPECIAL_RE = re.compile("(" + "|".join(re.escape(t)
                                        for t in SPECIAL_TOKENS) + ")")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 byte values onto printable
    characters (the byte-level pre-tokenizer's alphabet)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    chars = list(keep)
    n = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + n)
            n += 1
    return dict(zip(keep, map(chr, chars)))


class ByteTokenizer:
    """Byte-level tokenizer with LLaMA's special ids (see the module
    docstring). Decoding joins the bytes of every id (a special token's
    text unless skipped; unknown ids dropped) and decodes them as UTF-8
    with U+FFFD for each invalid or truncated sequence."""

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    unk_token_id = 3
    pad_token, bos_token, eos_token, unk_token = SPECIAL_TOKENS
    padding_side = "right"

    def __init__(self, model_max_length: int = 2048):
        self.model_max_length = model_max_length
        alphabet = bytes_to_unicode()
        rank = {ch: i for i, ch in enumerate(sorted(alphabet.values()))}
        n = len(SPECIAL_TOKENS)
        self._byte_id = [n + rank[alphabet[b]] for b in range(256)]
        self._id_bytes = {i: t.encode() for i, t in enumerate(SPECIAL_TOKENS)}
        self._id_bytes.update(
            {i: bytes([b]) for b, i in enumerate(self._byte_id)})
        self.vocab_size = n + 256

    def __len__(self) -> int:
        return self.vocab_size

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        ids = [self.bos_token_id] if add_special_tokens else []
        for piece in _SPECIAL_RE.split(text):
            if piece in SPECIAL_TOKENS:
                ids.append(SPECIAL_TOKENS.index(piece))
            else:
                ids.extend(self._byte_id[b] for b in piece.encode("utf-8"))
        return ids

    def __call__(self, text, **kw):
        if isinstance(text, (list, tuple)):
            return SimpleNamespace(input_ids=[self.encode(t) for t in text])
        return SimpleNamespace(input_ids=self.encode(text))

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if skip_special_tokens and i < len(SPECIAL_TOKENS):
                continue
            out += self._id_bytes.get(i, b"")
        return out.decode("utf-8", errors="replace")

    def batch_decode(self, batch, skip_special_tokens: bool = False
                     ) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]


# -- the SentencePiece LLaMA tokenizer ---------------------------------------

SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "pad_token")


def _token_spec(token, special: bool) -> Optional[Dict]:
    """An added token as {"content", "lstrip", "rstrip", "single_word",
    "special", "object"}: from a string or from the files' AddedToken
    dict ("object": it was one, and so replaces an entry of the same
    text, as an AddedToken does in the slow class)."""
    if token is None:
        return None
    if isinstance(token, dict):
        return {"content": token["content"],
                "lstrip": bool(token.get("lstrip", False)),
                "rstrip": bool(token.get("rstrip", False)),
                "single_word": bool(token.get("single_word", False)),
                "special": bool(token.get("special", special)),
                "object": True}
    return {"content": str(token), "lstrip": False, "rstrip": False,
            "single_word": False, "special": special, "object": False}


def clean_up_tokenization(text: str) -> str:
    """The slow class's clean-up of spaces before punctuation and
    contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                 (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
                 (" 've", "'ve"), (" 're", "'re")):
        text = text.replace(a, b)
    return text


class LlamaTokenizer:
    """The slow `transformers` LlamaTokenizer over `data.sentencepiece`
    (see the module docstring). `model` is a SentencePieceModel or the
    path of a `tokenizer.model`; special tokens are strings or the files'
    AddedToken dicts; `added_tokens` maps ids to such dicts (the files'
    `added_tokens_decoder`)."""

    def __init__(self, model, *, bos_token="<s>", eos_token="</s>",
                 unk_token="<unk>", pad_token=None,
                 additional_special_tokens: Sequence = (),
                 added_tokens: Optional[Dict[int, Dict]] = None,
                 add_bos_token: bool = True, add_eos_token: bool = False,
                 legacy: Optional[bool] = None, add_prefix_space: bool = True,
                 clean_up_tokenization_spaces: bool = False,
                 model_max_length: int = 2048, padding_side: str = "right"):
        if not isinstance(model, SentencePieceModel):
            model = SentencePieceModel.from_file(model)
        self.legacy = True if legacy is None else bool(legacy)
        # non-legacy: SentencePiece without its dummy prefix, the class
        # adds the one "▁" itself
        self.sp_model = (model if self.legacy else
                         dataclasses.replace(model, add_dummy_prefix=False))
        self.add_bos_token = bool(add_bos_token)
        self.add_eos_token = bool(add_eos_token)
        self.add_prefix_space = bool(add_prefix_space)
        self.clean_up_tokenization_spaces = bool(clean_up_tokenization_spaces)
        self.model_max_length = int(model_max_length)
        self.padding_side = padding_side
        self.vocab_size = len(model)

        self._added: Dict[int, Dict] = {}
        for i, tok in (added_tokens or {}).items():
            self._added[int(i)] = _token_spec(tok, special=False)
        self._specials: Dict[str, Optional[Dict]] = {
            "bos_token": _token_spec(bos_token, True),
            "eos_token": _token_spec(eos_token, True),
            "unk_token": _token_spec(unk_token, True),
            "pad_token": _token_spec(pad_token, True)}
        self._additional = [_token_spec(t, True)
                            for t in additional_special_tokens]
        self._rebuild()
        for spec in [s for s in self._specials.values() if s] + \
                self._additional:
            self._add_token(spec)
        self.unk_token_length = len(self.sp_model.encode(self.unk_token))

    # -- added tokens --------------------------------------------------------

    def _rebuild(self) -> None:
        self._added_encoder = {t["content"]: i for i, t in
                               self._added.items()}
        self._split_re = (re.compile("(" + "|".join(
            re.escape(t) for t in sorted(self._added_encoder, key=len,
                                         reverse=True)) + ")")
            if self._added_encoder else None)
        self._len = len(set(self.sp_model.pieces) | set(self._added_encoder))

    def _add_token(self, spec: Dict) -> None:
        """PreTrainedTokenizer._add_tokens for one special token: a text
        already added stays as it is, an AddedToken replaces it; a new one
        takes its vocabulary id where SentencePiece has the piece, else the
        next free id."""
        content = spec["content"]
        if not content or (content in self._added_encoder
                           and not spec["object"]):
            return
        if content in self._added_encoder:
            pid = self._added_encoder[content]
        else:
            pid = self.sp_model.piece_to_id(content)
            if self.sp_model.pieces[pid] != content:
                pid = len(self)
        self._added[pid] = dict(spec, special=True)
        self._rebuild()

    def _special(self, name: str) -> Optional[str]:
        spec = self._specials[name]
        return spec["content"] if spec else None

    @property
    def bos_token(self):
        return self._special("bos_token")

    @property
    def eos_token(self):
        return self._special("eos_token")

    @property
    def unk_token(self):
        return self._special("unk_token")

    @property
    def pad_token(self):
        return self._special("pad_token")

    @pad_token.setter
    def pad_token(self, value):
        self._specials["pad_token"] = _token_spec(value, True)

    def _token_id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        if token in self._added_encoder:
            return self._added_encoder[token]
        return self.sp_model.piece_to_id(token)

    @property
    def bos_token_id(self):
        return self._token_id(self.bos_token)

    @property
    def eos_token_id(self):
        return self._token_id(self.eos_token)

    @property
    def unk_token_id(self):
        return self._token_id(self.unk_token)

    @property
    def pad_token_id(self):
        return self._token_id(self.pad_token)

    @property
    def all_special_tokens(self) -> List[str]:
        out: List[str] = []
        for t in [self._special(n) for n in SPECIAL_ATTRS] + [
                s["content"] for s in self._additional]:
            if t is not None and t not in out:
                out.append(t)
        return out

    @property
    def all_special_ids(self) -> List[int]:
        return [self._token_id(t) for t in self.all_special_tokens]

    def __len__(self) -> int:
        return self._len

    # -- encoding ------------------------------------------------------------

    def _sp_tokenize(self, text: str) -> List[str]:
        """LlamaTokenizer._tokenize: one chunk between added tokens."""
        if self.legacy or not text.startswith((SPACE, " ")):
            return self.sp_model.encode_as_pieces(text)
        pieces = self.sp_model.encode_as_pieces(self.unk_token + text)
        n = self.unk_token_length
        return pieces[n:] if len(pieces) >= n else pieces

    def _split_added(self, text: str) -> List[str]:
        """PreTrainedTokenizer.tokenize: split on the added tokens, apply
        their strip flags, and tokenize the chunks between them."""
        chunks = ([c for c in self._split_re.split(text) if c]
                  if self._split_re else [text])
        for i, chunk in enumerate(chunks):
            if chunk not in self._added_encoder:
                continue
            spec = self._added[self._added_encoder[chunk]]
            left = chunks[i - 1] if i > 0 else None
            right = chunks[i + 1] if i < len(chunks) - 1 else None
            if spec["rstrip"] and right:
                chunks[i + 1] = right.lstrip()
            if spec["lstrip"] and left:
                chunks[i - 1] = left.rstrip()
            if spec["single_word"] and left and left[-1] != " ":
                chunks[i - 1] += chunk
                chunks[i] = ""
            elif spec["single_word"] and right and right[0] != " ":
                chunks[i + 1] = chunk + chunks[i + 1]
                chunks[i] = ""
        tokens: List[str] = []
        for chunk in chunks:
            if not chunk:
                continue
            if chunk in self._added_encoder:
                tokens.append(chunk)
            else:
                tokens.extend(self._sp_tokenize(chunk))
        return tokens

    def tokenize(self, text: str) -> List[str]:
        """LlamaTokenizer.tokenize: the token strings of `text`."""
        if self.legacy or not text:
            return self._split_added(text)
        text = text.replace(SPACE, " ")
        if self.add_prefix_space:
            text = SPACE + text
        tokens = self._split_added(text)
        if len(tokens) > 1 and tokens[0] == SPACE and \
                tokens[1] in self.all_special_tokens:
            tokens = tokens[1:]
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self._token_id(t) for t in tokens]

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if add_special_tokens:
            ids = ([self.bos_token_id] if self.add_bos_token else []) + ids \
                + ([self.eos_token_id] if self.add_eos_token else [])
        return ids

    def __call__(self, text, add_special_tokens: bool = True, **kw):
        if isinstance(text, (list, tuple)):
            ids = [self.encode(t, add_special_tokens) for t in text]
            return SimpleNamespace(input_ids=ids,
                                   attention_mask=[[1] * len(i) for i in ids])
        ids = self.encode(text, add_special_tokens)
        return SimpleNamespace(input_ids=ids, attention_mask=[1] * len(ids))

    # -- decoding ------------------------------------------------------------

    def convert_ids_to_tokens(self, ids, skip_special_tokens: bool = False
                              ) -> List[str]:
        special = set(self.all_special_ids) if skip_special_tokens else ()
        tokens = []
        for i in ids:
            i = int(i)
            if i in special:
                continue
            tokens.append(self._added[i]["content"] if i in self._added
                          else self.sp_model.id_to_piece(i))
        return tokens

    def convert_tokens_to_string(self, tokens: List[str]) -> str:
        """LlamaTokenizer.convert_tokens_to_string."""
        tokens = list(tokens)
        if tokens[0].startswith(SPACE) and self.add_prefix_space:
            tokens[0] = tokens[0][1:]
        special = set(self.all_special_tokens)
        out, current, prev_is_special = "", [], False
        for i, token in enumerate(tokens):
            if token in special:
                if not prev_is_special and i != 0 and self.legacy:
                    out += " "
                out += self.sp_model.decode_pieces(current) + token
                prev_is_special, current = True, []
            else:
                if prev_is_special and i == 1 and self.add_prefix_space \
                        and not token.startswith(SPACE):
                    out += " "
                current.append(token)
                prev_is_special = False
        return out + self.sp_model.decode_pieces(current)

    def decode(self, ids, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None,
               spaces_between_special_tokens: bool = True) -> str:
        """PreTrainedTokenizer._decode: non-special added tokens stand
        apart, the rest goes through convert_tokens_to_string."""
        if isinstance(ids, int):
            ids = [ids]
        tokens = self.convert_ids_to_tokens(ids, skip_special_tokens)
        special = set(self.all_special_tokens)
        apart = {t for t in self._added_encoder if t not in special} | {
            s["content"] for s in self._additional
            if self._token_id(s["content"]) >= self.vocab_size}
        texts, current = [], []
        for token in tokens:
            if skip_special_tokens and token in special:
                continue
            if token in apart:
                if current:
                    text = self.convert_tokens_to_string(current)
                    if text:
                        texts.append(text)
                    current = []
                texts.append(token)
            else:
                current.append(token)
        if current:
            texts.append(self.convert_tokens_to_string(current))
        text = (" " if spaces_between_special_tokens else "").join(texts)
        if clean_up_tokenization_spaces is None:
            clean_up_tokenization_spaces = self.clean_up_tokenization_spaces
        return clean_up_tokenization(text) if clean_up_tokenization_spaces \
            else text

    def batch_decode(self, batch, skip_special_tokens: bool = False,
                     **kw) -> List[str]:
        return [self.decode(ids, skip_special_tokens, **kw) for ids in batch]

    # -- loading -------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str, **overrides) -> "LlamaTokenizer":
        """The tokenizer of `path`, a `tokenizer.model` file or a
        directory holding one with the optional `tokenizer_config.json`,
        `special_tokens_map.json` and `added_tokens.json`, read as
        `PreTrainedTokenizer.from_pretrained` reads them; `overrides`
        (model_max_length, padding_side, legacy, ...) win over the
        files."""
        directory = path if os.path.isdir(path) else os.path.dirname(path)
        model_file = (os.path.join(path, "tokenizer.model")
                      if os.path.isdir(path) else path)

        def read(name):
            f = os.path.join(directory, name) if os.path.isdir(path) \
                else None
            if f is None or not os.path.isfile(f):
                return None
            with open(f, encoding="utf-8") as fh:
                return json.load(fh)

        config = read("tokenizer_config.json") or {}
        kwargs = {k: config[k] for k in (
            "add_bos_token", "add_eos_token", "legacy", "add_prefix_space",
            "clean_up_tokenization_spaces", "model_max_length",
            "padding_side", "additional_special_tokens") + SPECIAL_ATTRS
            if config.get(k) is not None}
        if "added_tokens_decoder" in config:
            added = {int(i): t for i, t in
                     config["added_tokens_decoder"].items()}
        else:  # the files' older form
            added = {}
            for key, value in (read("special_tokens_map.json") or {}).items():
                if key in SPECIAL_ATTRS or key == "additional_special_tokens":
                    kwargs[key] = value
            specials = [str(v["content"] if isinstance(v, dict) else v)
                        for k, v in kwargs.items() if k in SPECIAL_ATTRS]
            specials += [str(v["content"] if isinstance(v, dict) else v)
                         for v in kwargs.get("additional_special_tokens",
                                             ())]
            for content, i in (read("added_tokens.json") or {}).items():
                added[int(i)] = {"content": content,
                                 "special": content in specials}
        # a special token named by text takes the added token's flags
        by_content = {t["content"]: t for t in added.values()}
        for key in SPECIAL_ATTRS:
            value = kwargs.get(key)
            if isinstance(value, str) and value in by_content:
                kwargs[key] = dict(by_content[value], special=True)
        # model_max_length in the files may be the 1e30 "unset" value
        if "model_max_length" in kwargs:
            kwargs["model_max_length"] = int(min(kwargs["model_max_length"],
                                                 2 ** 62))
        kwargs.update(overrides)
        return cls(SentencePieceModel.from_file(model_file),
                   added_tokens=added, **kwargs)


# the files a directory holding a tokenizer has (SentencePiece, HF fast)
TOKENIZER_FILES = ("tokenizer.model", "tokenizer.json",
                   "tokenizer_config.json", "spiece.model")


def load_tokenizer(path, model_max_length: int = 2048,
                   padding_side: str = "right",
                   allow_fallback: bool = True):
    """A LlamaTokenizer for a `tokenizer.model` file or a directory
    holding one, pad bound to unk where the files name no pad (as the JAX
    loader binds it); the byte tokenizer for a `path` that is empty, does
    not exist, or is a directory holding no tokenizer file (a weights-only
    export, which the JAX loader also answers with it), FileNotFoundError
    there when `allow_fallback` is False; ValueError for a directory whose
    tokenizer files lack `tokenizer.model` (a fast tokenizer.json alone)
    and for a `tokenizer.model` that does not parse."""
    if path and (os.path.isfile(path) or os.path.isfile(
            os.path.join(path, "tokenizer.model"))):
        tok = LlamaTokenizer.from_pretrained(
            path, model_max_length=model_max_length,
            padding_side=padding_side)
        if tok.pad_token is None:
            tok.pad_token = tok.unk_token
        return tok
    if path and os.path.isdir(path) and any(
            os.path.exists(os.path.join(path, f)) for f in TOKENIZER_FILES):
        raise ValueError(
            f"tokenizer at {path!r}: the directory holds tokenizer files but "
            "no tokenizer.model, the SentencePiece model that LLaMA's "
            "tokenizer is read from (a fast tokenizer.json alone is not "
            "read)")
    if not allow_fallback:
        raise FileNotFoundError(path)
    logger.warning(
        "no tokenizer at %r (missing, or a directory without tokenizer "
        "files) — using the byte-level fallback tokenizer (smoke runs only; "
        "point text.path at a real LLaMA tokenizer for trained "
        "checkpoints)", path)
    tok = ByteTokenizer(model_max_length=model_max_length)
    tok.padding_side = padding_side
    return tok
