"""Tokenizer loading without `transformers` or `tokenizers`.

Counterpart of `lhrs_bot_tpu/data/tokenizer.py`. `ByteTokenizer` gives the
ids and the decoded text of the JAX package's `make_fallback_tokenizer`
(an HF byte-level BPE with no merges): pad 0, bos 1, eos 2, unk 3, and byte
b as 4 + the rank of GPT-2's `bytes_to_unicode()[b]` in the sorted
byte-level alphabet. "<pad>", "<s>", "</s>" and "<unk>" written in the text
are matched as the special tokens, and `__call__` prepends BOS.

`load_tokenizer` gives the byte tokenizer for a path that does not exist
(or raises FileNotFoundError when `allow_fallback` is False). A path that
exists holds a real tokenizer, which needs the SentencePiece
`tokenizer.model` reader that is not ported: it raises NotImplementedError
rather than serve with the wrong vocabulary.
"""

from __future__ import annotations

import logging
import os
import re
from types import SimpleNamespace
from typing import Dict, List

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


# the files a directory holding a tokenizer has (SentencePiece, HF fast)
TOKENIZER_FILES = ("tokenizer.model", "tokenizer.json",
                   "tokenizer_config.json", "spiece.model")


def load_tokenizer(path, model_max_length: int = 2048,
                   padding_side: str = "right",
                   allow_fallback: bool = True) -> ByteTokenizer:
    """The byte tokenizer for a `path` that is empty, does not exist, or is
    a directory holding no tokenizer file (a weights-only export, which
    the JAX loader also answers with this tokenizer) (FileNotFoundError
    when `allow_fallback` is False); NotImplementedError for a tokenizer
    file or a directory holding one (the SentencePiece reader is not
    ported)."""
    if path and (os.path.isfile(path) or (os.path.isdir(path) and any(
            os.path.exists(os.path.join(path, f)) for f in TOKENIZER_FILES))):
        raise NotImplementedError(
            f"tokenizer at {path!r}: reading a SentencePiece tokenizer.model "
            "is not ported to lhrs_bot_tpu_torch yet (point text.path at a "
            "missing path for the byte-level tokenizer)")
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
