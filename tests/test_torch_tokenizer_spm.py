"""The port's SentencePiece reader and LLaMA tokenizer against their
oracles (`tests/torch_spm_oracle.py`), on the committed fixture
`tests/torch_spm_fixture/` (written by `tests/torch_spm_fixture/make_fixture.py`: a BPE
`tokenizer.model` of 32,000 pieces in LLaMA-2's layout).

- The reader's wire-format parse equals protobuf's on every field it
  reads; malformed messages and models it does not read raise ValueError
  naming the field.
- Its SentencePiece encode equals the fast conversion's (`tokenizers`) on
  the corpus and on seeded random strings, ids exactly.
- `LlamaTokenizer` equals transformers' slow LlamaTokenizer (the JAX
  package's class, over the reader) on every corpus string under `legacy`
  True and False, ids and decodes, and the fast conversion wherever the two
  agree; the cases where they part are listed in PARTING with the slow
  class's value (read from `tokenization_llama.py` / `sentencepiece`).
- JAX's `tokenizer_image_token`, `preprocess_llama_2`, `preprocess_v1` and
  `preprocess_plain` over the fast oracle (and over the slow class) give
  the port's input_ids and labels exactly.
- `load_tokenizer` dispatches on what the path holds, and
  `build_model_and_tokenizer` / `lhrs_serve_torch.py` start from a tiny HF
  LLaMA directory holding the fixture.
"""

import copy
import importlib.util
import json
import re
import runpy
import shutil
from pathlib import Path

import numpy as np
import pytest

from lhrs_bot_tpu.data import conversation as j_conv
from lhrs_bot_tpu.data import preprocess as j_pre
from lhrs_bot_tpu_torch.data import conversation as t_conv
from lhrs_bot_tpu_torch.data import preprocess as t_pre
from lhrs_bot_tpu_torch.data import sentencepiece as spm
from lhrs_bot_tpu_torch.data import tokenizer as t_tok

from . import torch_spm_oracle as oracle

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "torch_spm_fixture"
MODEL = str(FIXTURE / "tokenizer.model")
LEGACY = [True, False]


@pytest.fixture(scope="module")
def expected():
    return json.loads((FIXTURE / "expected.json").read_text())


@pytest.fixture(scope="module")
def model():
    return spm.SentencePieceModel.from_file(MODEL)


def port(legacy):
    return t_tok.load_tokenizer(str(FIXTURE)) if legacy is None else \
        _bound(t_tok.LlamaTokenizer.from_pretrained(str(FIXTURE),
                                                    legacy=legacy))


def _bound(tok):
    tok.pad_token = tok.unk_token
    return tok


# -- the wire format ---------------------------------------------------------

def test_parse_matches_protobuf(model):
    proto = oracle.read_proto(MODEL)
    assert len(model) == len(proto.pieces) == 32000
    assert list(model.pieces) == [p.piece for p in proto.pieces]
    assert list(model.scores) == [p.score for p in proto.pieces]
    assert list(model.types) == [p.type for p in proto.pieces]
    ts, ns = proto.trainer_spec, proto.normalizer_spec
    assert (model.model_type, model.byte_fallback, model.unk_id,
            model.bos_id, model.eos_id, model.pad_id) == (
        ts.model_type, ts.byte_fallback, ts.unk_id, ts.bos_id, ts.eos_id,
        ts.pad_id) == (spm.BPE, True, 0, 1, 2, -1)
    assert (model.normalizer_name, model.add_dummy_prefix,
            model.remove_extra_whitespaces, model.escape_whitespaces) == (
        ns.name, ns.add_dummy_prefix, ns.remove_extra_whitespaces,
        ns.escape_whitespaces) == ("identity", True, False, True)
    # LLaMA-2's layout: <unk>, <s>, </s>, 256 bytes, merges by falling score
    assert model.pieces[:3] == ("<unk>", "<s>", "</s>")
    assert model.types[:3] == (spm.UNKNOWN, spm.CONTROL, spm.CONTROL)
    assert model.pieces[3:259] == tuple(spm.byte_piece(b) for b in
                                        range(256))
    scores = model.scores[259:]
    assert all(a > b for a, b in zip(scores, scores[1:]))


def _proto_bytes(**edits):
    """The fixture's header fields re-serialized by protobuf with `edits`
    ("trainer_spec.x" / "normalizer_spec.x" / "pieces" -> value)."""
    proto = oracle.read_proto(MODEL)
    for key, value in edits.items():
        if key == "pieces":
            value(proto.pieces)
            continue
        msg, field = key.split(".")
        setattr(getattr(proto, msg), field, value)
    return proto.SerializeToString()


def test_parse_defaults_unknown_fields_and_merges():
    """Absent fields take the proto's defaults, fields the reader does not
    read (self_test_data, denormalizer_spec, unknown numbers) are skipped,
    a sub-message given twice is merged, and a negative pad id survives
    its ten-byte varint."""
    pb = oracle._pb2()
    m = pb.ModelProto()
    for piece, kind in (("<unk>", 2), ("a", 1), ("b", 1), ("ab", 1)):
        p = m.pieces.add()
        p.piece, p.type = piece, kind
    m.pieces[3].score = -0.5
    m.trainer_spec.model_type = pb.TrainerSpec.BPE
    m.self_test_data.samples.add(input="ab", expected="▁ab")
    m.denormalizer_spec.name = "x"
    data = m.SerializeToString()
    # an unknown field (number 99, length-delimited) and a second
    # trainer_spec that sets pad_id = -7 (byte_fallback stays false)
    data += bytes([0x9A, 0x06, 3]) + b"xyz"
    extra = pb.TrainerSpec()
    extra.pad_id, extra.unk_id = -7, 0
    blob = extra.SerializeToString()
    data += bytes([0x12, len(blob)]) + blob
    got = spm.parse_model_proto(data)
    assert [p["piece"] for p in got["pieces"]] == ["<unk>", "a", "b", "ab"]
    assert got["pieces"][3]["score"] == -0.5
    assert got["pieces"][1]["score"] == 0.0
    assert got["trainer_spec"]["model_type"] == spm.BPE
    assert got["trainer_spec"]["pad_id"] == -7
    assert got["trainer_spec"]["byte_fallback"] is False
    assert got["normalizer_spec"] == {
        "name": "", "precompiled_charsmap": b"", "add_dummy_prefix": True,
        "remove_extra_whitespaces": True, "escape_whitespaces": True}
    model = spm.SentencePieceModel.from_bytes(data)
    # "▁" (the dummy prefix and the escaped space) is no piece: unk
    assert model.encode("ab ab") == [0, 3, 0, 3]


def _drop_byte_piece(pieces):
    del pieces[3 + 0x41]


MALFORMED = {
    "truncated": (lambda: open(MODEL, "rb").read()[:1000], "runs past"),
    "truncated varint": (lambda: b"\x08\xff", "truncated varint"),
    "field 0": (lambda: b"\x00\x01", "field number 0"),
    "group wire type": (lambda: b"\x0b", "wire type 3"),
    "piece type wire": (lambda: bytes([0x0A, 4, 0x1D, 0, 0, 0]),
                        "truncated fixed32"),
    "unigram": (lambda: _proto_bytes(**{"trainer_spec.model_type": 1}),
                "model_type is UNIGRAM"),
    "charsmap": (lambda: _proto_bytes(**{
        "normalizer_spec.name": "nmt_nfkc",
        "normalizer_spec.precompiled_charsmap": b"\x00\x01"}),
        "precompiled_charsmap"),
    "suffix": (lambda: _proto_bytes(**{
        "trainer_spec.treat_whitespace_as_suffix": True}),
        "treat_whitespace_as_suffix"),
    "byte piece missing": (lambda: _proto_bytes(pieces=_drop_byte_piece),
                           "byte piece <0x41> is missing"),
    "no unk": (lambda: _proto_bytes(pieces=lambda p: p[0].__setattr__(
        "type", 1)), "no UNKNOWN piece"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_models_raise(case):
    make, match = MALFORMED[case]
    with pytest.raises(ValueError, match=match):
        spm.SentencePieceModel.from_bytes(make())


def test_wrong_wire_type_names_the_field():
    # piece 0 with its score (field 2) sent as a varint
    data = bytes([0x0A, 5, 0x0A, 1, ord("a"), 0x10, 0x01])
    with pytest.raises(ValueError, match=r"pieces\[0\]\.score: wire type 0"):
        spm.parse_model_proto(data)


# -- SentencePiece encode and decode ----------------------------------------

def _random_strings(n=300, seed=0):
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz     ETAOINSHR.,;:!?'\"()"
                    "[]{}-_=+/0123456789\n\t") + ["遥", "感", "🌍", "é",
                                                  "▁", "ß", "́"]
    return ["".join(rng.choice(alphabet, size=int(rng.integers(0, 120))))
            for _ in range(n)]


def test_encode_matches_the_fast_conversion(model):
    """SentencePiece's BPE (no special-token splitting) against the
    converted `tokenizers` model with the dummy prefix (the legacy
    normalizer) on the corpus's text without special tokens and on seeded
    random strings."""
    backend = oracle.fast_oracle(MODEL, legacy=True).backend_tokenizer
    texts = [t for t in oracle.corpus() if "<s>" not in t
             and "</s>" not in t and "<unk>" not in t] + _random_strings()
    for text in texts:
        assert model.encode(text) == backend.encode(
            text, add_special_tokens=False).ids, text
        # and back: "▁" in the text reads as a space, the dummy prefix
        # comes off again
        assert model.decode(model.encode(text)) == text.replace("▁", " ")


def test_encode_merge_order_and_ties():
    """The highest-scoring pair merges first, the leftmost on a tie, and
    the result does not depend on where the scan starts: "abc" with ab
    scoring above bc gives ab c; with bc above ab, a bc; "aaaa" with aa
    gives aa aa (leftmost first), not a aa a."""
    def model_of(scores, pieces=("a", "b", "c", "ab", "bc", "aa")):
        return spm.SentencePieceModel(
            pieces=("<unk>",) + pieces, scores=(0.0,) + scores,
            types=(spm.UNKNOWN,) + (spm.NORMAL,) * len(pieces),
            add_dummy_prefix=False, remove_extra_whitespaces=False)

    m = model_of((-5, -5, -5, -1, -2, -3))
    assert m.encode_as_pieces("abc") == ["ab", "c"]
    m = model_of((-5, -5, -5, -2, -1, -3))
    assert m.encode_as_pieces("abc") == ["a", "bc"]
    assert m.encode_as_pieces("aaaa") == ["aa", "aa"]
    assert m.encode_as_pieces("aaa") == ["aa", "a"]
    # tied scores: the leftmost pair first
    m = model_of((-5, -5, -5, -1, -1, -3))
    assert m.encode_as_pieces("abc") == ["ab", "c"]


def test_unused_pieces_are_resegmented():
    """An UNUSED piece the merges reach is split back into the two it was
    merged from (bpe_model.cc's resegment)."""
    pieces = ("a", "b", "c", "ab", "abc")
    m = spm.SentencePieceModel(
        pieces=("<unk>",) + pieces, scores=(0.0, -9, -9, -9, -1, -2),
        types=(spm.UNKNOWN, 1, 1, 1, spm.UNUSED, 1),
        add_dummy_prefix=False, remove_extra_whitespaces=False)
    assert m.encode_as_pieces("ab") == ["a", "b"]
    assert m.encode_as_pieces("abc") == ["abc"]


def test_user_defined_pieces_and_whitespace_removal():
    """User-defined pieces match whole (longest first) and never merge;
    remove_extra_whitespaces folds runs of spaces and trims both ends
    (normalizer.cc), and the unk id stands for text outside a vocabulary
    without byte pieces."""
    pieces = ("▁", "a", "b", "▁a", "<x>", "<xy>", "ab")
    m = spm.SentencePieceModel(
        pieces=("<unk>",) + pieces, scores=(0.0, -9, -9, -9, -1, 0, 0, -2),
        types=(spm.UNKNOWN, 1, 1, 1, 1, spm.USER_DEFINED, spm.USER_DEFINED,
               1), remove_extra_whitespaces=True)
    assert m.normalize("  a   b  ") == "▁a▁b"
    assert m.encode_as_pieces("a<xy>b") == ["▁a", "<xy>", "b"]
    assert m.encode_as_pieces("a<x>b") == ["▁a", "<x>", "b"]
    assert m.encode("z") == [1, 0]  # "▁" then z outside the vocabulary
    assert m.encode_pieces("z")[-1] == ("z", 0)
    assert m.decode([0]) == " ⁇ "
    assert m.normalize("   ") == ""


# decode cases read from sentencepiece_processor.cc: (ids as pieces, text)
DECODE_CASES = [
    # one U+FFFD for each byte that starts no valid character, valid ones
    # around it decoded
    (["<0xE4>", "<0xBD>"], "��"),
    (["<0xE4>", "<0x41>"], "�A"),
    (["<0xE4>", "<0xBD>", "<0xA0>"], "你"),
    (["<0xC0>", "<0x80>"], "��"),  # overlong
    (["<0xED>", "<0xA0>", "<0x80>"], "���"),  # surrogate
    (["<0xEF>", "<0xBF>", "<0xBD>"], "�"),  # U+FFFD itself
    # the first piece's leading "▁" goes, also behind control pieces, and
    # only once
    (["<s>", "▁the", "▁the"], "the the"),
    (["▁", "▁the"], " the"),
    (["<0x41>", "▁the"], "A the"),
    (["<unk>", "▁the"], " ⁇  the"),
]


@pytest.mark.parametrize("pieces,text", DECODE_CASES)
def test_decode_cases(model, pieces, text):
    assert model.decode([model.piece_to_id(p) for p in pieces]) == text


def test_decode_parts_from_the_fast_byte_fallback(model):
    """Where the fast decoder parts: `tokenizers`' ByteFallback gives one
    U+FFFD a byte for a whole run that is not valid UTF-8; SentencePiece
    keeps the valid characters of the run."""
    fast = oracle.fast_oracle(MODEL, legacy=True)
    ids = [model.piece_to_id(p) for p in ("<0xE4>", "<0x41>")]
    assert fast.decode(ids) == "��"
    assert model.decode(ids) == "�A"


# -- the LLaMA tokenizer -----------------------------------------------------

# Where transformers' slow LlamaTokenizer (the JAX package's) and the fast
# conversion part on the corpus: (legacy, text) -> the slow class's ids as
# pieces and its decode with special tokens skipped. Non-legacy, the slow
# class prepends "▁" to every text and encodes a chunk that starts with a
# space behind "<unk>" (tokenize / _tokenize), while the fast Metaspace
# pre-tokenizer prepends nothing to a text that already starts with one;
# legacy, the slow decode drops the first token's "▁" and then
# SentencePiece drops the next one too (its dummy-prefix decode rule),
# where the fast decoder strips one space.
PARTING = {
    (True, " "): (["<s>", "▁", "▁"], ""),
    (True, "   leading spaces"): (
        ["<s>", "▁", "▁", "▁", "▁leading", "▁spaces"], "  leading spaces"),
    (True, " <s> spaced </s> tokens <unk> here "): (
        ["<s>", "▁", "▁", "<s>", "▁", "▁spac", "ed", "▁", "</s>", "▁",
         "▁tokens", "▁", "<unk>", "▁", "▁here", "▁"],
        "  spaced   tokens   here "),
    (True, "▁literal▁escape▁marks ▁"): (
        ["<s>", "▁", "▁l", "iter", "al", "▁", "escape", "▁mark", "s", "▁",
         "▁"], "literal escape marks  "),
    (False, " "): (["<s>", "▁", "▁"], " "),
    (False, "   leading spaces"): (
        ["<s>", "▁", "▁", "▁", "▁leading", "▁spaces"], "   leading spaces"),
    (False, " <s> spaced </s> tokens <unk> here "): (
        ["<s>", "▁", "▁", "<s>", "▁spac", "ed", "▁", "</s>", "▁tokens", "▁",
         "<unk>", "▁here", "▁"], "  spaced  tokens  here "),
    (False, "▁literal▁escape▁marks ▁"): (
        ["<s>", "▁", "▁l", "iter", "al", "▁", "escape", "▁mark", "s", "▁",
         "▁"], " literal escape marks  "),
}


@pytest.mark.parametrize("legacy", LEGACY)
def test_tokenizer_matches_the_oracles(legacy):
    tok = port(legacy)
    slow = oracle.slow_oracle(str(FIXTURE), legacy=legacy)
    fast = oracle.fast_oracle(MODEL, legacy)
    parted = set()
    for text in oracle.corpus():
        ids = tok(text).input_ids
        assert ids == slow(text).input_ids, text
        assert tok.tokenize(text) == slow.tokenize(text), text
        for skip in (True, False):
            got = tok.decode(ids, skip_special_tokens=skip)
            assert got == slow.decode(ids, skip_special_tokens=skip), text
        want_ids = fast(text).input_ids
        want_text = fast.decode(want_ids, skip_special_tokens=True)
        if ids != want_ids or tok.decode(ids, True) != want_text:
            parted.add(text)
            pieces, slow_text = PARTING[legacy, text]
            assert tok.convert_ids_to_tokens(ids) == pieces
            assert tok.decode(ids, skip_special_tokens=True) == slow_text
    assert parted == {text for (lg, text) in PARTING if lg == legacy}


@pytest.mark.parametrize("legacy", LEGACY)
def test_expected_json_is_the_oracles(expected, legacy):
    """The committed ids and texts are the fast oracle's, and the slow
    class's where they part (what `chip_smoke.py` holds the port to)."""
    assert expected["pieces"] == 32000
    assert expected["corpus"] == oracle.corpus()
    fast = oracle.fast_oracle(MODEL, legacy)
    tok = port(legacy)
    rows = expected["legacy" if legacy else "non_legacy"]
    for text, row in zip(expected["corpus"], rows):
        assert row["ids"] == fast(text).input_ids, text
        assert row["decoded"] == fast.decode(row["ids"],
                                             skip_special_tokens=True)
        ids = row.get("slow_ids", row["ids"])
        assert tok(text).input_ids == ids
        assert tok.decode(ids, skip_special_tokens=True) == \
            row.get("slow_decoded", row["decoded"])


def test_tokenizer_surface():
    tok = port(None)  # the fixture's own tokenizer_config: legacy false
    assert isinstance(tok, t_tok.LlamaTokenizer) and tok.legacy is False
    assert (tok.bos_token, tok.eos_token, tok.unk_token, tok.pad_token) == (
        "<s>", "</s>", "<unk>", "<unk>")
    assert (tok.bos_token_id, tok.eos_token_id, tok.unk_token_id,
            tok.pad_token_id) == (1, 2, 0, 0)
    assert tok.vocab_size == len(tok) == 32000
    assert tok.model_max_length == 2048 and tok.padding_side == "right"
    assert tok.encode("hi", add_special_tokens=False) == \
        tok("hi").input_ids[1:]
    batch = tok(["hi", "a b"])
    assert batch.input_ids == [tok("hi").input_ids, tok("a b").input_ids]
    assert tok.batch_decode(batch.input_ids, skip_special_tokens=True) == \
        ["hi", "a b"]
    eos = t_tok.LlamaTokenizer.from_pretrained(str(FIXTURE),
                                               add_eos_token=True)
    assert eos("hi").input_ids == tok("hi").input_ids + [2]
    nobos = t_tok.LlamaTokenizer.from_pretrained(str(FIXTURE),
                                                 add_bos_token=False)
    assert nobos("hi").input_ids == tok("hi").input_ids[1:]


def test_added_tokens_and_cleanup_match_the_slow_class(tmp_path):
    """Files in the older form (special_tokens_map.json, added_tokens.json
    with a non-special token past the vocabulary and a special one with
    rstrip), the slow class's decode spacing around the added token and
    clean_up_tokenization_spaces."""
    shutil.copy(MODEL, tmp_path / "tokenizer.model")
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "legacy": True, "clean_up_tokenization_spaces": True}))
    (tmp_path / "special_tokens_map.json").write_text(json.dumps({
        "bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
        "pad_token": "<unk>", "additional_special_tokens": [
            {"content": "<im_end>", "rstrip": True, "lstrip": False,
             "normalized": False, "single_word": False}]}))
    (tmp_path / "added_tokens.json").write_text(json.dumps({
        "<image>": 32000, "<im_end>": 32001}))
    tok = t_tok.load_tokenizer(str(tmp_path))
    slow = oracle.slow_oracle(str(tmp_path))
    # the fixture's vocabulary has a piece "<image>": 32,001 texts
    assert len(tok) == len(slow) == 32001
    texts = ["a <image> b", "x<image>y <im_end>   z", "It 's here .",
             "no , really ?", "<image><image>", "<im_end> <s> q"]
    for text in texts:
        ids = tok(text).input_ids
        assert ids == slow(text).input_ids, text
        for skip in (True, False):
            assert tok.decode(ids, skip) == slow.decode(
                ids, skip_special_tokens=skip), text
            for spaces in (True, False):
                assert tok.decode(
                    ids, skip, spaces_between_special_tokens=spaces) == \
                    slow.decode(ids, skip_special_tokens=skip,
                                spaces_between_special_tokens=spaces), text
    assert tok.pad_token_id == slow.pad_token_id == 0
    assert tok.all_special_ids == slow.all_special_ids


# -- training masks: JAX's preprocess over the oracle ------------------------

@pytest.fixture
def default_conversation():
    saved = (j_conv.default_conversation, t_conv.default_conversation)

    def set_both(name):
        j_conv.set_default_conversation(name)
        t_conv.set_default_conversation(name)

    yield set_both
    j_conv.default_conversation, t_conv.default_conversation = saved


def _sources(k, image=True):
    """k rounds in the data's form, one {"Question", "Answer"} a round."""
    rounds = [{"Question": q, "Answer": a} for q, a in oracle.QA[:k]]
    if image:
        rounds[0]["Question"] = "<image>\n" + rounds[0]["Question"]
    return rounds


def _tokenizers(legacy):
    fast = oracle.fast_oracle(MODEL, legacy)
    fast.pad_token = fast.unk_token
    fast.model_max_length = 2048
    return {"fast": fast,
            "slow": oracle.slow_oracle(str(FIXTURE), legacy=legacy,
                                       model_max_length=2048)}


@pytest.mark.parametrize("legacy", LEGACY)
@pytest.mark.parametrize("template", ["llava_llama_2", "v1", "plain"])
def test_preprocess_matches_jax(default_conversation, template, legacy):
    """input_ids and labels of JAX's preprocess over the fast oracle and
    over the slow class against the port's over its tokenizer, one and
    three rounds, with and without an image; and tokenizer_image_token on
    the rendered prompts. A sample whose round lengths disagree with the
    whole is masked out entirely, in both packages: v1 rounds after the
    first under a non-legacy tokenizer, where the text after "</s>" takes
    no dummy prefix in the whole prompt but does in the round tokenized
    alone (the reference's own mismatch; LLaVA later subtracts one token a
    round there)."""
    default_conversation(template)
    tok = port(legacy)
    for name, ref in _tokenizers(legacy).items():
        for k in (1, 3):
            if template == "plain":
                sources = [{"Question": "<image>\nDescribe.",
                            "Answer": oracle.QA[k - 1][1]}]
                want = j_pre.preprocess_plain(copy.deepcopy(sources), ref)
                got = t_pre.preprocess_plain(copy.deepcopy(sources), tok)
                pairs = zip(want["input_ids"] + want["labels"],
                            got["input_ids"] + got["labels"])
            else:
                pairs = []
                for image in (True, False):
                    sources = _sources(k, image)
                    fn = "preprocess_llama_2" if template != "v1" \
                        else "preprocess_v1"
                    want = getattr(j_pre, fn)(copy.deepcopy(sources), ref,
                                              has_image=image)
                    got = getattr(t_pre, fn)(copy.deepcopy(sources), tok,
                                             has_image=image)
                    pairs += [(want["input_ids"], got["input_ids"]),
                              (want["labels"], got["labels"])]
                    kept = (np.asarray(got["labels"])
                            != j_pre.IGNORE_INDEX).any()
                    assert kept == (k == 1 or template != "v1" or legacy), (
                        name, k, image)
            for w, g in pairs:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                              err_msg=f"{name} k={k}")
    for prompt in oracle.corpus()[:5]:
        ref = _tokenizers(legacy)["fast"]
        assert t_pre.tokenizer_image_token(prompt, tok) == \
            j_pre.tokenizer_image_token(prompt, ref)


# -- loading -----------------------------------------------------------------

def test_load_tokenizer_dispatch(tmp_path, caplog):
    shutil.copy(MODEL, tmp_path / "tokenizer.model")
    for path in (tmp_path, tmp_path / "tokenizer.model"):
        tok = t_tok.load_tokenizer(str(path), model_max_length=77,
                                   padding_side="left")
        assert isinstance(tok, t_tok.LlamaTokenizer)
        assert tok.model_max_length == 77 and tok.padding_side == "left"
        assert tok.pad_token == "<unk>" and tok.legacy is True
    fast_only = tmp_path / "fast_only"
    fast_only.mkdir()
    (fast_only / "tokenizer.json").write_text("{}")
    for fallback in (True, False):
        with pytest.raises(ValueError, match="no tokenizer.model"):
            t_tok.load_tokenizer(str(fast_only), allow_fallback=fallback)
    weights_only = tmp_path / "weights_only"
    weights_only.mkdir()
    (weights_only / "config.json").write_text("{}")
    assert isinstance(t_tok.load_tokenizer(str(weights_only)),
                      t_tok.ByteTokenizer)
    assert isinstance(t_tok.load_tokenizer(str(tmp_path / "absent")),
                      t_tok.ByteTokenizer)
    assert "byte-level fallback" in caplog.text
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "tokenizer.model").write_bytes(b"\x0a\x05\x0a")
    with pytest.raises(ValueError, match="bad/tokenizer.model"):
        t_tok.load_tokenizer(str(bad))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_fake_reference_ckpt",
        REPO / "tools" / "make_fake_reference_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    """A tiny HF LLaMA directory (tests/fixtures/tiny_eval.yaml's widths,
    LLaMA-2's 32,000-row vocabulary) with the fixture's tokenizer files."""
    out = tmp_path_factory.mktemp("llama_spm")
    _tool().write_llama(str(out), d=64, ffn=128, L=2, heads=4, V=32000)
    for f in ("tokenizer.model", "tokenizer_config.json",
              "special_tokens_map.json"):
        shutil.copy(FIXTURE / f, out / f)
    return out


def _config_yaml(tmp_path, llama_dir):
    import yaml

    cfg = yaml.safe_load((REPO / "tests" / "fixtures" /
                          "tiny_eval.yaml").read_text())
    cfg["rgb_vision"]["vit_name"] = None
    cfg["text"]["path"] = str(llama_dir)
    cfg["text"]["vocab_size"] = 32000
    path = tmp_path / "tiny_llama_dir.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


def test_build_model_and_tokenizer_from_a_llama_dir(tmp_path, llama_dir):
    import torch

    from lhrs_bot_tpu_torch.core import build_model_and_tokenizer
    from lhrs_bot_tpu_torch.core.safetensors_io import load_file

    _, config = _config_yaml(tmp_path, llama_dir)
    cfg, params, tok = build_model_and_tokenizer(config, "cpu")
    assert isinstance(tok, t_tok.LlamaTokenizer)
    assert tok.model_max_length == 512 and tok.pad_token_id == 0
    emb = load_file(str(llama_dir / "model-00001-of-00002.safetensors"))[
        "model.embed_tokens.weight"]
    np.testing.assert_array_equal(params["llama"]["embed_tokens"],
                                  emb.to(torch.float32).numpy())


def test_serve_entry_starts_from_a_llama_dir(tmp_path, llama_dir):
    """lhrs_serve_torch.py's frontend over the directory: a request with
    an image is tokenized by the SentencePiece tokenizer and its reply's
    text is the tokenizer's decode of its ids."""
    serve = runpy.run_path(str(REPO / "lhrs_serve_torch.py"),
                           run_name="lhrs_serve_torch")
    path, _ = _config_yaml(tmp_path, llama_dir)
    frontend, _ = serve["build_frontend"](
        ["-c", path, "--device", "cpu", "--slots", "2", "--output",
         str(tmp_path / "out")])
    try:
        tok = frontend.tokenizer
        assert isinstance(tok, t_tok.LlamaTokenizer)
        image = np.random.default_rng(0).integers(0, 255, (40, 52, 3),
                                                  dtype=np.uint8)
        req = frontend.build_request("How many planes?", image, 6,
                                     temperature=0.0)
        prompt = t_conv.conv_templates["llava_llama_2"].copy()
        prompt.append_message(prompt.roles[0], "<image>\nHow many planes?")
        prompt.append_message(prompt.roles[1], None)
        assert req.input_ids.tolist() == t_pre.tokenizer_image_token(
            prompt.get_prompt(), tok)
        out = frontend.await_request(req)
        assert out["finish_reason"] == "stop" and 1 <= len(out["tokens"])
        assert out["text"] == tok.decode(out["tokens"],
                                         skip_special_tokens=True)
    finally:
        frontend.shutdown()


def test_port_imports_none_of_the_oracles():
    """The port, its two new tools and chip_smoke.py import neither JAX
    nor the packages the card's machine lacks (protobuf, sentencepiece,
    tokenizers, transformers, safetensors); only the tests do."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|lhrs_bot_tpu|google|protobuf|"
        r"sentencepiece|tokenizers|transformers|safetensors)\b", re.M)
    files = sorted((REPO / "lhrs_bot_tpu_torch").rglob("*.py"))
    files += [REPO / "tools" / "convert_checkpoint_torch.py",
              REPO / "tools" / "rehearse_full_scale_torch.py",
              REPO / "chip_smoke.py"]
    for f in files:
        assert not pattern.findall(f.read_text()), f
