"""The port's host-side serving pipeline against the JAX package's, on the
CPU: conversation templates, image-marker tokenization, the byte-level
tokenizer, the CLIP resize and the PNG decoder. Every comparison is exact.

The oracles are the JAX package's functions, which use PIL (the resize and
the image decode), `tokenizers` and `transformers` (the fallback
tokenizer): this machine has them, the card's machine need not, and the
port uses none of them.
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest

from lhrs_bot_tpu.data import conversation as j_conv
from lhrs_bot_tpu.data import preprocess as j_pre
from lhrs_bot_tpu.data import tokenizer as j_tok
from lhrs_bot_tpu.data import transforms as j_tf
from lhrs_bot_tpu_torch.data import conversation as t_conv
from lhrs_bot_tpu_torch.data import image_io
from lhrs_bot_tpu_torch.data import preprocess as t_pre
from lhrs_bot_tpu_torch.data import tokenizer as t_tok
from lhrs_bot_tpu_torch.data import transforms as t_tf

from .fake_tokenizer import FakeTokenizer

# -- conversations -----------------------------------------------------------

# (name, messages after the template's own, system override or None)
PATTERNS = {
    "text": ([("user", "what is in the scene?"), ("assistant", None)],
             None),
    "image": ([("user", "<image>\ndescribe the image"), ("assistant", None)],
              None),
    "image_tuple": ([("user", ("<image> count the planes", None, "Crop")),
                     ("assistant", None)], None),
    "multi_turn": ([("user", "<image>\nwhat is this?"),
                    ("assistant", "an airport"), ("user", "how many runways?"),
                    ("assistant", None)], None),
    "system": ([("user", "hello"), ("assistant", "hi"), ("user", "and now?"),
                ("assistant", None)], "you are a remote sensing bot"),
    "empty_first": ([("user", ""), ("assistant", None)], None),
}


def _render(mod, name, pattern):
    messages, system = PATTERNS[pattern]
    conv = mod.get_conversation(name)
    if system is not None:
        conv.system = system
    for role, msg in messages:
        conv.append_message(conv.roles[0 if role == "user" else 1], msg)
    try:
        return conv.get_prompt()
    except Exception as exc:  # noqa: BLE001 - the same failure is the check
        return f"raised {type(exc).__name__}: {exc}"


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("name", sorted(j_conv.conv_templates))
def test_get_prompt_matches_jax(name, pattern):
    assert _render(t_conv, name, pattern) == _render(j_conv, name, pattern)


def test_templates_match_jax():
    assert sorted(t_conv.conv_templates) == sorted(j_conv.conv_templates)
    for name, j in j_conv.conv_templates.items():
        t = t_conv.conv_templates[name]
        for field in ("system", "roles", "messages", "offset", "sep", "sep2",
                      "version"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert t.sep_style.name == j.sep_style.name
    copy = t_conv.get_conversation("llava_llama_2")
    copy.append_message("USER", "x")
    assert t_conv.conv_templates["llava_llama_2"].messages == []


@pytest.fixture
def default_conversation():
    """Set both packages' default template; restore it afterwards."""
    saved = (j_conv.default_conversation, t_conv.default_conversation)

    def set_both(name):
        j_conv.set_default_conversation(name)
        t_conv.set_default_conversation(name)

    yield set_both
    j_conv.default_conversation, t_conv.default_conversation = saved


TEXTS = ["describe this", "<image>\nwhat is it", "a <image> b",
         "<image> x <image> y", "  <image>  ", "no image at all", ""]


@pytest.mark.parametrize("template", ["llava_llama_2", "v1_mmtag",
                                      "v0_mmtag", "plain"])
def test_wrap_image_token_matches_jax(default_conversation, template):
    default_conversation(template)
    for text in TEXTS:
        for im_start in (False, True):
            assert t_pre.wrap_image_token_for_generation(text, im_start) == \
                j_pre.wrap_image_token_for_generation(text, im_start)


@pytest.fixture(scope="module")
def jax_byte_tokenizer():
    return j_tok.make_fallback_tokenizer()


PROMPTS = ["<image>\ndescribe the image", "describe <image> and <image>",
           "<s>[INST] <<SYS>>\nsys\n<</SYS>>\n\n<image>\nq [/INST]",
           "no marker", "<image>", "<image><image>", "end <image>", ""]


@pytest.mark.parametrize("which", ["byte", "fake"])
def test_tokenizer_image_token_matches_jax(jax_byte_tokenizer, which):
    """The same tokenizer through both packages' functions, and the
    port's byte tokenizer against JAX's fallback tokenizer."""
    for prompt in PROMPTS:
        if which == "fake":
            tok = FakeTokenizer(320)
            want = j_pre.tokenizer_image_token(prompt, tok)
            got = t_pre.tokenizer_image_token(prompt, tok)
        else:
            want = j_pre.tokenizer_image_token(prompt, jax_byte_tokenizer)
            got = t_pre.tokenizer_image_token(prompt,
                                              t_tok.ByteTokenizer())
        assert got == want, prompt
        for idx in (-200, -7):
            assert t_pre.tokenizer_image_token(
                prompt, FakeTokenizer(320), idx) == \
                j_pre.tokenizer_image_token(prompt, FakeTokenizer(320), idx)


# -- the byte tokenizer ------------------------------------------------------

STRINGS = [
    "hello world", "Hello, World!", "a", " ", "  ", "\n", "\n\n\t", "",
    "don't stop . , ! ?", "multiple   spaces   here", "tabs\tand\nlines\r\n",
    "ümlaut", "café", "naïve résumé", "€100", "日本語のテキスト", "中文",
    "한국어", "Ελληνικά", "русский текст", "עברית", "العربية", "हिन्दी",
    "😀", "👍🏽", "👨‍👩‍👧", "🇯🇵 flag", "mixed 😀 text ü and 中",
    "<s>", "</s>", "<pad>", "<unk>", "<s>hello</s>", "a<s>b</s>c",
    " <s> spaced </s> ", "<s><s></s></s>", "<image>", "x <image> y",
    "<image>\n<image>", "< s>", "<s", "s>", "</s", "<<s>>", "<unk><pad>x",
    "[INST] <<SYS>>\nyou are a bot\n<</SYS>>\n\nhi [/INST]",
    "USER: hi ASSISTANT:", "###Human: hi###", "\x00\x01\x7f",
    " nbsp", "zero​width", "a" * 300, "line\n" * 20,
    "tail space ", " lead space", "Ġ Ċ", "� replacement",
]


def test_enough_strings():
    assert len(STRINGS) >= 50


@pytest.mark.parametrize("text", STRINGS, ids=range(len(STRINGS)))
def test_byte_tokenizer_matches_jax(jax_byte_tokenizer, text):
    tok = t_tok.ByteTokenizer()
    ids = tok(text).input_ids
    assert ids == jax_byte_tokenizer(text).input_ids
    assert tok([text, text]).input_ids == [ids, ids]
    for skip in (False, True):
        assert tok.decode(ids, skip_special_tokens=skip) == \
            jax_byte_tokenizer.decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("text", ["€😀日本", "naïve résumé 👨‍👩‍👧",
                                  "<s>é</s>中\n🇯🇵"])
def test_byte_tokenizer_decodes_every_prefix_as_jax(jax_byte_tokenizer,
                                                    text):
    """The streaming endpoints decode a growing id list: every prefix,
    truncated UTF-8 included, decodes as JAX's tokenizer decodes it."""
    tok = t_tok.ByteTokenizer()
    ids = tok(text).input_ids
    for n in range(len(ids) + 1):
        for skip in (False, True):
            assert tok.decode(ids[:n], skip_special_tokens=skip) == \
                jax_byte_tokenizer.decode(ids[:n],
                                          skip_special_tokens=skip), n
    # suffixes too (a stream that starts mid-character)
    for n in range(len(ids)):
        assert tok.decode(ids[n:], skip_special_tokens=True) == \
            jax_byte_tokenizer.decode(ids[n:], skip_special_tokens=True)
    assert tok.batch_decode([ids, ids[:3]], skip_special_tokens=True) == \
        jax_byte_tokenizer.batch_decode([ids, ids[:3]],
                                        skip_special_tokens=True)


def test_byte_tokenizer_surface(jax_byte_tokenizer):
    tok = t_tok.ByteTokenizer(model_max_length=777)
    for attr in ("bos_token_id", "eos_token_id", "pad_token_id",
                 "unk_token_id"):
        assert getattr(tok, attr) == getattr(jax_byte_tokenizer, attr)
    assert (tok.bos_token_id, tok.eos_token_id, tok.pad_token_id) == (1, 2, 0)
    assert tok.model_max_length == 777
    assert len(tok) == tok.vocab_size == len(jax_byte_tokenizer) == 260
    # every byte value: 4 + its rank in the byte-level alphabet, not 4 + b
    raw = bytes(range(256))
    text = raw.decode("latin-1")
    assert tok(text).input_ids == jax_byte_tokenizer(text).input_ids
    assert tok.encode("A", add_special_tokens=False) != [4 + ord("A")]
    # ids the vocabulary lacks decode to nothing, as in JAX's
    assert tok.decode([9999, 72, -1]) == \
        jax_byte_tokenizer.decode([9999, 72])


def test_load_tokenizer(tmp_path, caplog):
    tok = t_tok.load_tokenizer(str(tmp_path / "absent"), model_max_length=64,
                               padding_side="left")
    assert isinstance(tok, t_tok.ByteTokenizer)
    assert tok.model_max_length == 64 and tok.padding_side == "left"
    assert "byte-level fallback" in caplog.text
    assert isinstance(t_tok.load_tokenizer(None), t_tok.ByteTokenizer)
    with pytest.raises(FileNotFoundError):
        t_tok.load_tokenizer(str(tmp_path / "absent"), allow_fallback=False)
    # a path that exists is a real tokenizer: read (a corrupt one raises),
    # never a fallback
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    for path in (tmp_path, tmp_path / "tokenizer.model"):
        for fallback in (True, False):
            with pytest.raises(ValueError, match="field number 0"):
                t_tok.load_tokenizer(str(path), allow_fallback=fallback)


# -- the CLIP resize ---------------------------------------------------------

def _resize_cases():
    """(shape, size): downscales, upscales, non-square, sides of 1-3
    pixels, and sides where side * size / short lands on .5 (Python's
    round takes the even neighbour)."""
    rng = np.random.default_rng(0)
    cases = [((375, 500), 224), ((500, 375), 224), ((224, 224), 224),
             ((32, 32), 224), ((28, 40), 28), ((640, 480), 224),
             ((1, 1), 5), ((1, 7), 4), ((3, 2), 224), ((2, 300), 28),
             ((300, 3), 28), ((257, 999), 224), ((13, 9), 28),
             ((100, 301), 224), ((16, 4), 8),
             # w * size / short = 10.5 and 31.5 and 12.5: ties to even
             ((4, 21), 2), ((4, 63), 2), ((8, 50), 2)]
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(1, 420, 2))
        cases.append(((h, w), int(rng.choice([5, 28, 224]))))
    return cases


RESIZE_CASES = _resize_cases()


def test_resize_cases_cover_half_ties():
    assert len(RESIZE_CASES) >= 20
    ties = [(s, n) for s, n in RESIZE_CASES
            if (max(s) * n / min(s)) % 1 == 0.5]
    assert len(ties) >= 3


@pytest.mark.parametrize("shape,size", RESIZE_CASES,
                         ids=[f"{h}x{w}-{n}" for (h, w), n in RESIZE_CASES])
def test_clip_preprocess_matches_pil(shape, size):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + size)
    img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    want = j_tf.clip_preprocess_uint8(img, size)
    got = t_tf.clip_preprocess_uint8(img, size)
    assert got.shape == want.shape == (size, size, 3)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(300, 200), (64, 64), (256, 256),
                                   (7, 500)])
def test_eval_resize_crop_matches_pil(shape):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(t_tf.eval_resize_crop_uint8(img),
                                  j_tf.eval_resize_crop_uint8(img))


def test_clip_preprocess_gray_and_rgba_match_pil():
    rng = np.random.default_rng(9)
    for img in (rng.integers(0, 256, (50, 70)).astype(np.uint8),
                rng.integers(0, 256, (50, 70, 4)).astype(np.uint8)):
        np.testing.assert_array_equal(t_tf.clip_preprocess_uint8(img, 28),
                                      j_tf.clip_preprocess_uint8(img, 28))
    with pytest.raises(ValueError):
        t_tf.clip_preprocess_uint8(np.zeros((4, 4, 3), np.float32), 2)


def test_clip_preprocess_fault_is_seen():
    """A one-ulp change of the filter's constant moves some output byte:
    the byte-for-byte check can fail."""
    img = np.random.default_rng(1).integers(0, 256, (333, 517, 3)).astype(
        np.uint8)
    want = j_tf.clip_preprocess_uint8(img, 224)
    saved = t_tf._BICUBIC_A
    try:
        t_tf._BICUBIC_A = -0.5 * (1 + 1e-3)
        assert (t_tf.clip_preprocess_uint8(img, 224) != want).any()
    finally:
        t_tf._BICUBIC_A = saved


# -- PNG ---------------------------------------------------------------------

def _pil_decode(raw):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


def _pil_png(img, mode, colors=None):
    from PIL import Image

    im = Image.fromarray(img)
    im = (im.convert("P", palette=Image.ADAPTIVE, colors=colors)
          if mode == "P" else im.convert(mode))
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _hand_png(pixels, color, filters, depth=8, palette=None, interlace=0):
    """A PNG written here: `pixels` (H, W, samples) uint8 (palette indices
    for color 3, packed at `depth` bits), row y filtered with
    filters[y % len(filters)]."""
    h, w = pixels.shape[:2]
    if depth < 8:
        bits = np.unpackbits(pixels.reshape(h, w, 1).astype(np.uint8),
                             axis=2)[:, :, 8 - depth:]
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    else:
        rows = pixels.reshape(h, -1)
    bpp = max(1, pixels.shape[2] * depth // 8) if pixels.ndim == 3 else 1
    out, prev = bytearray(), [0] * rows.shape[1]
    for y in range(h):
        f = filters[y % len(filters)]
        line = [int(v) for v in rows[y]]
        enc = []
        for x, v in enumerate(line):
            a = line[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            enc.append((v - pred) & 0xFF)
        out += bytes([f] + enc)
        prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    body = _chunk(b"IHDR", ihdr)
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    half = len(out) // 2  # two IDAT chunks: the stream spans them
    z = zlib.compress(bytes(out))
    body += _chunk(b"IDAT", z[:half]) + _chunk(b"IDAT", z[half:])
    return image_io.PNG_SIGNATURE + body + _chunk(b"IEND", b"")


PIL_MODES = [("L", None), ("LA", None), ("RGB", None), ("RGBA", None),
             ("P", 256), ("P", 16), ("P", 4), ("P", 2)]


@pytest.mark.parametrize("mode,colors", PIL_MODES,
                         ids=[f"{m}{c or ''}" for m, c in PIL_MODES])
@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (61, 33)])
def test_png_decode_matches_pil(mode, colors, shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    img = rng.integers(0, 256, shape + (4,)).astype(np.uint8)
    img[..., :3] = img[..., :3] // 4 + np.arange(shape[1])[None, :, None]
    raw = _pil_png(img, mode, colors)
    got = image_io.decode_image(raw)
    assert got.dtype == np.uint8 and got.shape == shape + (3,)
    np.testing.assert_array_equal(got, _pil_decode(raw))


COLOR_SAMPLES = {0: 1, 2: 3, 4: 2, 6: 4}


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("color", [0, 2, 3, 4, 6])
def test_png_row_filters_match_pil(filt, color):
    """Hand-written PNGs with every row in one filter (PIL's encoder
    picks its own), in every color type; the file PIL reads must be the
    one written (its pixels) and the port must decode it as PIL does."""
    rng = np.random.default_rng(10 * filt + color)
    h, w = 9, 13
    palette = None
    if color == 3:
        palette = rng.integers(0, 256, (37, 3)).astype(np.uint8)
        pixels = rng.integers(0, 37, (h, w, 1)).astype(np.uint8)
        want = palette[pixels[..., 0]]
    else:
        pixels = rng.integers(0, 256, (h, w, COLOR_SAMPLES[color])).astype(
            np.uint8)
        want = (np.repeat(pixels[..., :1], 3, 2) if color in (0, 4)
                else pixels[..., :3])
    raw = _hand_png(pixels, color, [filt], palette=palette)
    np.testing.assert_array_equal(_pil_decode(raw), want)
    np.testing.assert_array_equal(image_io.decode_png(raw), want)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_png_low_depth_palette_mixed_filters(depth):
    rng = np.random.default_rng(depth)
    n = 1 << depth
    palette = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    pixels = rng.integers(0, n, (11, 19, 1)).astype(np.uint8)
    raw = _hand_png(pixels, 3, [0, 1, 2, 3, 4], depth=depth,
                    palette=palette)
    np.testing.assert_array_equal(image_io.decode_png(raw),
                                  palette[pixels[..., 0]])
    np.testing.assert_array_equal(image_io.decode_png(raw), _pil_decode(raw))


FILTER_RUNS = {
    "simple only": [0, 1, 2, 1, 0, 2, 2, 1, 0, 1, 2],
    "chained in the middle": [0, 1, 2, 3, 0, 4, 1, 2, 4, 2, 1],
    "chained first and last": [4, 1, 2, 0, 2, 1, 0, 3],
    "chained only": [3, 4, 4, 3, 3, 4],
    "one chained row": [2, 2, 1, 0, 4, 1, 1],
}


@pytest.mark.parametrize("filters", list(FILTER_RUNS.values()),
                         ids=list(FILTER_RUNS))
@pytest.mark.parametrize("color", [2, 6])
def test_png_filter_runs_match_pil(filters, color):
    """Row-wise rows (None, Sub, Up) before, between and after the rows
    the wavefront reconstructs (from the first Average or Paeth row to
    the last), against the pixels written and PIL's decode."""
    rng = np.random.default_rng(len(filters) + color)
    h = len(filters)
    pixels = rng.integers(0, 256, (h, 17, COLOR_SAMPLES[color])).astype(
        np.uint8)
    raw = _hand_png(pixels, color, filters)
    np.testing.assert_array_equal(image_io.decode_png(raw),
                                  pixels[..., :3])
    np.testing.assert_array_equal(image_io.decode_png(raw), _pil_decode(raw))


def test_png_refuses_a_bomb_sized_header():
    """More pixels than PIL accepts (2 x Image.MAX_IMAGE_PIXELS) is
    refused from IHDR, before any image data is inflated."""
    from PIL import Image

    assert image_io.MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS
    for w, h in ((20000, 10000), (image_io.MAX_PIXELS + 1, 1)):
        ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
        raw = (image_io.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
               + _chunk(b"IDAT", zlib.compress(bytes(64)))
               + _chunk(b"IEND", b""))
        with pytest.raises(ValueError, match="pixels"):
            image_io.decode_png(raw)
    ihdr = struct.pack(">IIBBBBB", image_io.MAX_PIXELS, 1, 8, 0, 0, 0, 0)
    raw = (image_io.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", zlib.compress(bytes(64)))
           + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="bytes, expected"):
        image_io.decode_png(raw)  # at the limit: read, then too short


def test_png_refuses_surplus_image_data():
    """Image data that inflates past what IHDR's image holds (here 10 MB
    for a 4 x 4 image) is refused, inflated no further than one byte past
    the image."""
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)
    raw = (image_io.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
           + _chunk(b"IDAT", zlib.compress(bytes(10 ** 7)))
           + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="more image data than the 52"):
        image_io.decode_png(raw)


def _good_png():
    pixels = np.random.default_rng(3).integers(0, 256, (6, 8, 3)).astype(
        np.uint8)
    return _hand_png(pixels, 2, [4, 1])


def test_png_rejects_what_it_cannot_decode():
    good = _good_png()
    image_io.decode_png(good)
    rgb = np.zeros((4, 4, 3), np.uint8)
    bad = {
        "interlaced": _hand_png(rgb, 2, [0], interlace=1),
        "16-bit": _hand_png(np.zeros((4, 4, 6), np.uint8), 2, [0],
                            depth=16),
        "truncated": good[:len(good) // 2],
        "truncated header": good[:12],
        "no IEND": good[:-12],
        "bad CRC": good[:40] + bytes([good[40] ^ 0xFF]) + good[41:],
        "bad filter": _bad_filter_png(),
        "not an image": b"hello",
    }
    for name, raw in bad.items():
        with pytest.raises(ValueError):
            image_io.decode_image(raw)
        assert name


def _bad_filter_png():
    rows = bytes([7] + [0] * 12) * 4  # filter type 7 does not exist
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 0)
    return (image_io.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


def test_other_formats_go_through_pil(monkeypatch):
    from PIL import Image

    img = np.random.default_rng(4).integers(0, 256, (20, 30, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    raw = buf.getvalue()
    np.testing.assert_array_equal(image_io.decode_image(raw),
                                  _pil_decode(raw))
    # without PIL, a JPEG is refused with the reason; a PNG still decodes
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="only PNG"):
        image_io.decode_image(raw)
    png = _good_png()
    assert image_io.decode_image(png).shape == (6, 8, 3)


def test_data_urls_and_base64():
    import base64

    png = _good_png()
    b64 = base64.b64encode(png).decode()
    want = image_io.decode_png(png)
    np.testing.assert_array_equal(image_io.decode_b64(b64), want)
    np.testing.assert_array_equal(
        image_io.decode_data_url("data:image/png;base64," + b64), want)
    for url in ("http://example.invalid/x.png", "data:image/png;base64"):
        with pytest.raises(ValueError):
            image_io.decode_data_url(url)
    with pytest.raises(ValueError):
        image_io.decode_b64("!!not base64!!")
