"""A reader of SentencePiece's `tokenizer.model`, without `sentencepiece` or
`protobuf`.

`tokenizer.model` is a serialized `ModelProto` (sentencepiece_model.proto).
`parse_model_proto` walks its wire format by hand: varints, fixed32 floats,
length-delimited strings and sub-messages; fields it does not read are
skipped, and a truncated or malformed message raises ValueError. It reads
each piece's text, score and type, the trainer spec's `model_type`,
`byte_fallback`, `treat_whitespace_as_suffix` and unk / bos / eos / pad ids,
and the normalizer spec's `name`, `precompiled_charsmap`,
`add_dummy_prefix`, `remove_extra_whitespaces` and `escape_whitespaces`
(absent fields take the proto's defaults).

`SentencePieceModel` encodes and decodes as SentencePiece's BPE model does
(`normalizer.cc`, `bpe_model.cc`, `sentencepiece_processor.cc`), which is
LLaMA's tokenizer:

- normalize: the identity normalization (a model with a precompiled
  charsmap is refused), spaces escaped to U+2581, U+2581 prepended per
  `add_dummy_prefix`, runs of spaces folded and the ends trimmed per
  `remove_extra_whitespaces`; user-defined pieces pass through whole;
- split into characters, user-defined pieces matched whole (longest first)
  and never merged;
- merge: repeatedly the adjacent pair whose concatenation is a piece with
  the highest score, the leftmost on a tie, from a heap over a linked list
  of symbols (stale heap entries are skipped by their length), so a merge
  costs O(log n), not a rescan;
- an UNUSED piece left at the end is split back into the two it was merged
  from; a symbol outside the vocabulary becomes its UTF-8 bytes as
  `<0xXX>` pieces with `byte_fallback`, else the unk id.

Decoding joins the pieces, U+2581 read as a space, control pieces as
nothing, the unk piece as its surface " ⁇ ", runs of byte pieces
decoded as UTF-8 with U+FFFD for each byte that does not start a valid
character; the first piece's leading U+2581 is dropped while nothing has
been written yet, when `add_dummy_prefix` or `remove_extra_whitespaces` is
set. A Unigram model, a model with a charsmap or with
`treat_whitespace_as_suffix` raise ValueError naming the field.
"""

from __future__ import annotations

import dataclasses
import heapq
import struct
from typing import Dict, Iterator, List, Sequence, Tuple

SPACE = "▁"  # SentencePiece's escaped space
REPLACEMENT = "�"

# ModelProto.SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
# TrainerSpec.ModelType
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4
MODEL_TYPES = {UNIGRAM: "UNIGRAM", BPE: "BPE", WORD: "WORD", CHAR: "CHAR"}

# wire types
_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5

# (message, field number) -> (name, wire type, kind) of the fields read;
# kind: "str", "bytes", "float", "int32", "enum", "bool", "msg"
_MODEL_FIELDS = {1: ("pieces", _LEN, "msg"), 2: ("trainer_spec", _LEN, "msg"),
                 3: ("normalizer_spec", _LEN, "msg")}
_PIECE_FIELDS = {1: ("piece", _LEN, "str"), 2: ("score", _FIXED32, "float"),
                 3: ("type", _VARINT, "enum")}
_TRAINER_FIELDS = {3: ("model_type", _VARINT, "enum"),
                   24: ("treat_whitespace_as_suffix", _VARINT, "bool"),
                   35: ("byte_fallback", _VARINT, "bool"),
                   40: ("unk_id", _VARINT, "int32"),
                   41: ("bos_id", _VARINT, "int32"),
                   42: ("eos_id", _VARINT, "int32"),
                   43: ("pad_id", _VARINT, "int32"),
                   44: ("unk_surface", _LEN, "str")}
_NORMALIZER_FIELDS = {1: ("name", _LEN, "str"),
                      2: ("precompiled_charsmap", _LEN, "bytes"),
                      3: ("add_dummy_prefix", _VARINT, "bool"),
                      4: ("remove_extra_whitespaces", _VARINT, "bool"),
                      5: ("escape_whitespaces", _VARINT, "bool")}
_PIECE_DEFAULTS = {"piece": "", "score": 0.0, "type": NORMAL}
_TRAINER_DEFAULTS = {"model_type": UNIGRAM, "treat_whitespace_as_suffix":
                     False, "byte_fallback": False, "unk_id": 0, "bos_id": 1,
                     "eos_id": 2, "pad_id": -1, "unk_surface": " ⁇ "}
_NORMALIZER_DEFAULTS = {"name": "", "precompiled_charsmap": b"",
                        "add_dummy_prefix": True,
                        "remove_extra_whitespaces": True,
                        "escape_whitespaces": True}


def _varint(buf: memoryview, i: int, what: str) -> Tuple[int, int]:
    value, shift = 0, 0
    while True:
        if i >= len(buf):
            raise ValueError(f"{what}: truncated varint")
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, i
        shift += 7
        if shift > 63:
            raise ValueError(f"{what}: varint longer than 10 bytes")


def _wire_fields(buf: memoryview, what: str
                 ) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of one message: an
    int for varints, bytes (a memoryview) for the others."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _varint(buf, i, what)
        field, wire = key >> 3, key & 7
        if field == 0:
            raise ValueError(f"{what}: field number 0 at byte {i}")
        if wire == _VARINT:
            value, i = _varint(buf, i, what)
        elif wire in (_FIXED64, _FIXED32):
            size = 8 if wire == _FIXED64 else 4
            if i + size > n:
                raise ValueError(f"{what}: truncated fixed{size * 8} field "
                                 f"{field}")
            value, i = buf[i:i + size], i + size
        elif wire == _LEN:
            size, i = _varint(buf, i, what)
            if i + size > n:
                raise ValueError(f"{what}: field {field} of {size} bytes "
                                 f"runs past the message's {n}")
            value, i = buf[i:i + size], i + size
        else:  # 3 / 4 are the deprecated groups, 6 / 7 do not exist
            raise ValueError(f"{what}: field {field} has wire type {wire}")
        yield field, wire, value


def _read_message(buf: memoryview, fields: Dict, defaults: Dict,
                  what: str) -> Dict:
    """The fields of `fields` in one message (a later occurrence of a
    field overrides an earlier one, as protobuf merges scalars), the
    others skipped; `defaults` fills the absent ones."""
    out = dict(defaults)
    for number, wire, value in _wire_fields(buf, what):
        if number not in fields:
            continue
        name, want, kind = fields[number]
        if wire != want:
            raise ValueError(f"{what}.{name}: wire type {wire}, expected "
                             f"{want}")
        if kind == "str":
            try:
                out[name] = bytes(value).decode("utf-8")
            except UnicodeDecodeError as e:
                raise ValueError(f"{what}.{name}: not UTF-8 ({e})") from None
        elif kind == "bytes":
            out[name] = bytes(value)
        elif kind == "float":
            out[name] = struct.unpack("<f", value)[0]
        elif kind == "int32":
            out[name] = value - (1 << 64) if value >= 1 << 63 else value
        elif kind == "bool":
            out[name] = bool(value)
        else:  # enum
            out[name] = value
    return out


def parse_model_proto(data: bytes) -> Dict:
    """{"pieces": [{"piece", "score", "type"}], "trainer_spec": {...},
    "normalizer_spec": {...}} of a serialized ModelProto (the fields this
    module reads, see the module docstring)."""
    buf = memoryview(data)
    pieces: List[Dict] = []
    trainer: List[memoryview] = []
    normalizer: List[memoryview] = []
    for number, wire, value in _wire_fields(buf, "ModelProto"):
        if number not in _MODEL_FIELDS:
            continue
        name = _MODEL_FIELDS[number][0]
        if wire != _LEN:
            raise ValueError(f"ModelProto.{name}: wire type {wire}, "
                             f"expected {_LEN}")
        if number == 1:
            pieces.append(_read_message(
                value, _PIECE_FIELDS, _PIECE_DEFAULTS,
                f"ModelProto.pieces[{len(pieces)}]"))
        else:  # a sub-message given twice is merged, as protobuf does
            (trainer if number == 2 else normalizer).append(value)
    trainer_spec = dict(_TRAINER_DEFAULTS)
    for buf in trainer:
        trainer_spec.update(_read_message(buf, _TRAINER_FIELDS, {},
                                          "TrainerSpec"))
    normalizer_spec = dict(_NORMALIZER_DEFAULTS)
    for buf in normalizer:
        normalizer_spec.update(_read_message(buf, _NORMALIZER_FIELDS, {},
                                             "NormalizerSpec"))
    return {"pieces": pieces, "trainer_spec": trainer_spec,
            "normalizer_spec": normalizer_spec}


def byte_piece(b: int) -> str:
    return f"<0x{b:02X}>"


def _utf8_char_len(lead: int) -> int:
    """The length of the UTF-8 sequence `lead` starts (SentencePiece's
    DecodeUTF8 masks), 0 for a byte that starts none."""
    if lead < 0x80:
        return 1
    if lead & 0xE0 == 0xC0:
        return 2
    if lead & 0xF0 == 0xE0:
        return 3
    if lead & 0xF8 == 0xF0:
        return 4
    return 0


def decode_utf8_bytes(data: bytes) -> str:
    """`data` as UTF-8 with U+FFFD for each byte that does not start a
    valid character (a truncated, overlong or surrogate sequence gives one
    U+FFFD a byte, as SentencePiece's ProcessBytePieces does)."""
    out, i, n = [], 0, len(data)
    while i < n:
        size = _utf8_char_len(data[i])
        if size and i + size <= n:
            try:
                out.append(data[i:i + size].decode("utf-8"))
                i += size
                continue
            except UnicodeDecodeError:
                pass
        out.append(REPLACEMENT)
        i += 1
    return "".join(out)


@dataclasses.dataclass
class SentencePieceModel:
    """A SentencePiece BPE model (see the module docstring). Build it with
    `from_file` / `from_bytes`; `dataclasses.replace(model, ...)` gives a
    variant (the LLaMA tokenizer's non-legacy mode turns the dummy prefix
    off, a check swaps scores)."""

    pieces: Sequence[str]
    scores: Sequence[float]
    types: Sequence[int]
    model_type: int = BPE
    byte_fallback: bool = False
    treat_whitespace_as_suffix: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    unk_surface: str = " ⁇ "
    normalizer_name: str = ""
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True

    def __post_init__(self):
        self.pieces = tuple(self.pieces)
        self.scores = tuple(float(s) for s in self.scores)
        self.types = tuple(int(t) for t in self.types)
        if not len(self.pieces) == len(self.scores) == len(self.types):
            raise ValueError("pieces, scores and types differ in length")
        if self.model_type != BPE:
            raise ValueError(
                f"TrainerSpec.model_type is "
                f"{MODEL_TYPES.get(self.model_type, self.model_type)}: only "
                "the BPE model (LLaMA's) is read")
        if self.precompiled_charsmap:
            raise ValueError(
                f"NormalizerSpec.precompiled_charsmap is set (normalizer "
                f"{self.normalizer_name!r}): only the identity "
                "normalization (LLaMA's) is read")
        if self.treat_whitespace_as_suffix:
            raise ValueError("TrainerSpec.treat_whitespace_as_suffix is set: "
                             "only the prefix form (LLaMA's) is read")
        # NORMAL, USER_DEFINED and UNUSED pieces can be merged into; the
        # others are found only by id or by their exact text
        self._normal: Dict[str, int] = {}
        self._reserved: Dict[str, int] = {}
        user: List[str] = []
        unk = None
        for i, (piece, kind) in enumerate(zip(self.pieces, self.types)):
            if not piece:
                raise ValueError(f"ModelProto.pieces[{i}] is empty")
            if kind not in (NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED,
                            BYTE):
                raise ValueError(f"ModelProto.pieces[{i}].type is {kind}")
            table = (self._normal if kind in (NORMAL, USER_DEFINED, UNUSED)
                     else self._reserved)
            if piece in self._normal or piece in self._reserved:
                raise ValueError(f"ModelProto.pieces[{i}] {piece!r} is a "
                                 "duplicate")
            table[piece] = i
            if kind == USER_DEFINED:
                user.append(piece)
            if kind == UNKNOWN:
                if unk is not None:
                    raise ValueError("ModelProto.pieces holds two UNKNOWN "
                                     "pieces")
                unk = i
        if unk is None:
            raise ValueError("ModelProto.pieces holds no UNKNOWN piece")
        self._unk = unk
        # user-defined pieces by first character, longest first
        self._user: Dict[str, List[str]] = {}
        for piece in sorted(user, key=len, reverse=True):
            self._user.setdefault(piece[0], []).append(piece)
        self._byte_ids = [self._reserved.get(byte_piece(b)) for b in
                          range(256)]
        if self.byte_fallback and None in self._byte_ids:
            missing = byte_piece(self._byte_ids.index(None))
            raise ValueError(f"TrainerSpec.byte_fallback is set but the "
                             f"byte piece {missing} is missing")

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        proto = parse_model_proto(data)
        ts, ns = proto["trainer_spec"], proto["normalizer_spec"]
        return cls(
            pieces=[p["piece"] for p in proto["pieces"]],
            scores=[p["score"] for p in proto["pieces"]],
            types=[p["type"] for p in proto["pieces"]],
            model_type=ts["model_type"], byte_fallback=ts["byte_fallback"],
            treat_whitespace_as_suffix=ts["treat_whitespace_as_suffix"],
            unk_id=ts["unk_id"], bos_id=ts["bos_id"], eos_id=ts["eos_id"],
            pad_id=ts["pad_id"], unk_surface=ts["unk_surface"],
            normalizer_name=ns["name"],
            precompiled_charsmap=ns["precompiled_charsmap"],
            add_dummy_prefix=ns["add_dummy_prefix"],
            remove_extra_whitespaces=ns["remove_extra_whitespaces"],
            escape_whitespaces=ns["escape_whitespaces"])

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as fh:
            data = fh.read()
        try:
            return cls.from_bytes(data)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None

    # -- the vocabulary ----------------------------------------------------

    def __len__(self) -> int:
        return len(self.pieces)

    def piece_to_id(self, piece: str) -> int:
        """The id of `piece`, the unk id for a text that is no piece."""
        i = self._reserved.get(piece)
        if i is None:
            i = self._normal.get(piece, self._unk)
        return i

    def id_to_piece(self, i: int) -> str:
        if not 0 <= i < len(self.pieces):
            raise IndexError(f"piece id {i} is out of range "
                             f"[0, {len(self.pieces)})")
        return self.pieces[i]

    # -- encoding ------------------------------------------------------------

    def _user_match(self, text: str, i: int) -> int:
        """The length of the longest user-defined piece at text[i:], 0 for
        none."""
        for piece in self._user.get(text[i], ()):
            if text.startswith(piece, i):
                return len(piece)
        return 0

    def normalize(self, text: str) -> str:
        """normalizer.cc's Normalize with the identity rules."""
        if not text:
            return ""
        extra = self.remove_extra_whitespaces
        if extra:
            text = text.lstrip(" ")
            if not text:
                return ""
        space = SPACE if self.escape_whitespaces else " "
        if not self._user and not extra:
            body = text.replace(" ", SPACE) if self.escape_whitespaces \
                else text
            return (SPACE if self.add_dummy_prefix else "") + body
        out = [SPACE] if self.add_dummy_prefix else []
        prev_space = extra
        i, n = 0, len(text)
        while i < n:
            size = (self._user_match(text, i) if self._user else 0) or 1
            chunk = text[i:i + size]
            i += size
            if prev_space:
                chunk = chunk.lstrip(" ")
            if chunk:
                out.append(chunk.replace(" ", space))
                prev_space = extra and chunk.endswith(" ")
        normalized = "".join(out)
        return normalized.rstrip(space) if extra else normalized

    def _bpe(self, normalized: str) -> List[str]:
        """bpe_model.cc's Encode: the final symbols of the merges."""
        syms: List[str] = []
        frozen: List[bool] = []
        i, n = 0, len(normalized)
        while i < n:
            size = self._user_match(normalized, i) if self._user else 0
            frozen.append(size > 0)
            size = size or 1
            syms.append(normalized[i:i + size])
            i += size
        count = len(syms)
        prev = list(range(-1, count - 1))
        nxt = list(range(1, count + 1))
        if count:
            nxt[-1] = -1
        heap: List[Tuple[float, int, int, int]] = []
        rev_merge: Dict[str, Tuple[str, str]] = {}
        normal, scores, types = self._normal, self.scores, self.types

        def push(left: int, right: int) -> None:
            if left < 0 or right < 0 or frozen[left] or frozen[right]:
                return
            merged = syms[left] + syms[right]
            pid = normal.get(merged)
            if pid is None:
                return
            # highest score first, then the leftmost pair
            heapq.heappush(heap, (-scores[pid], left, right, len(merged)))
            if types[pid] == UNUSED:
                rev_merge[merged] = (syms[left], syms[right])

        for right in range(1, count):
            push(right - 1, right)
        while heap:
            _, left, right, size = heapq.heappop(heap)
            a, b = syms[left], syms[right]
            # a stale entry: either side merged since it was pushed
            if not a or not b or len(a) + len(b) != size:
                continue
            syms[left], syms[right] = a + b, ""
            nxt[left] = nxt[right]
            if nxt[right] >= 0:
                prev[nxt[right]] = left
            push(prev[left], left)
            push(left, nxt[left])

        out: List[str] = []

        def resegment(w: str) -> None:
            pid = self.piece_to_id(w)
            if types[pid] == UNUSED and w in rev_merge:
                left, right = rev_merge[w]
                resegment(left)
                resegment(right)
            else:
                out.append(w)

        i = 0 if count else -1
        while i != -1:
            resegment(syms[i])
            i = nxt[i]
        return out

    def encode_pieces(self, text: str) -> List[Tuple[str, int]]:
        """(piece, id) of `text` as SentencePiece encodes it: a symbol
        outside the vocabulary gives its bytes' pieces with byte_fallback,
        else (its text, the unk id)."""
        out: List[Tuple[str, int]] = []
        for w in self._bpe(self.normalize(text)):
            pid = self.piece_to_id(w)
            if pid == self._unk and self.byte_fallback:
                out.extend((byte_piece(b), self._byte_ids[b])
                           for b in w.encode("utf-8"))
            else:
                out.append((w, pid))
        return out

    def encode(self, text: str) -> List[int]:
        return [pid for _, pid in self.encode_pieces(text)]

    def encode_as_pieces(self, text: str) -> List[str]:
        return [piece for piece, _ in self.encode_pieces(text)]

    # -- decoding ------------------------------------------------------------

    def _decode_pairs(self, pairs: Sequence[Tuple[str, int]]) -> str:
        strip_bos_ws = self.add_dummy_prefix or self.remove_extra_whitespaces
        text: List[str] = []
        run = bytearray()
        # a leading U+2581 is dropped until something was written or a
        # piece's leading U+2581 was
        is_bos_ws, bos_ws_seen = True, False

        def flush():
            if run:
                text.append(decode_utf8_bytes(bytes(run)))
                run.clear()
            return bool(text) and bool(text[-1])

        for piece, pid in pairs:
            kind = self.types[pid]
            if kind == BYTE:
                run.append(int(self.pieces[pid][3:5], 16))
                continue
            if flush() or bos_ws_seen:
                is_bos_ws = False
            if kind == CONTROL:
                surface = ""
            elif pid == self._unk:
                surface = (self.unk_surface if piece == self.pieces[pid]
                           else piece)
            else:
                surface = piece
                if is_bos_ws and strip_bos_ws and surface.startswith(SPACE):
                    surface = surface[1:]
                surface = surface.replace(SPACE, " ")
            if is_bos_ws and piece.startswith(SPACE):
                bos_ws_seen = True
            if surface:
                text.append(surface)
        flush()
        return "".join(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._decode_pairs([(self.id_to_piece(int(i)), int(i))
                                   for i in ids])

    def decode_pieces(self, pieces: Sequence[str]) -> str:
        return self._decode_pairs([(p, self.piece_to_id(p)) for p in pieces])
