"""The port's web UI (`lhrs_webui_torch.py`) against the JAX one
(`lhrs_webui.py`) on the CPU: the helpers (the `tests/test_webui.py` cases
on the port's, and each helper against JAX's on seeded inputs), the bbox
drawing's image and HTML byte for byte, WebUIDemo's prompt ids, history
images and greedy stream over the same weight files in float32 (one and
two images, [Identify], the 2,000-token truncation), the conversation's
`get_images` / `to_gradio_chatbot`, and `launch_demo` without gradio.
"""

import base64
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lhrs_webui as j_ui
import lhrs_webui_torch as t_ui

from .test_torch_eval_entries import (  # noqa: F401 (the fixture)
    weights, write_config)


class TestPortHelpers:
    """tests/test_webui.py's helper cases, on the port's module."""

    def test_mask2bbox(self):
        assert t_ui.mask2bbox(None) == ""
        assert t_ui.mask2bbox(np.zeros((10, 10), np.uint8)) == ""
        mask = np.zeros((100, 200), np.uint8)
        mask[20:40, 50:150] = 1
        x1, y1, x2, y2 = [float(v) for v in
                          t_ui.mask2bbox(mask).strip("[]").split(",")]
        assert 24 <= x1 <= 26 and 74 <= x2 <= 76
        assert 19 <= y1 <= 21 and 38 <= y2 <= 40

    def test_extract_bboxes(self):
        boxes = t_ui.extract_bboxes(
            "a plane [10,20,30,40] and a ship [50,60,70,80] docked")
        assert len(boxes) == 2 and boxes[0][0] == [10, 20, 30, 40]
        assert t_ui.extract_bboxes("no boxes [a,b] here") == []

    def test_visualize(self):
        img = np.zeros((100, 100, 3), np.uint8)
        out, colored = t_ui.visualize_all_bbox_together(
            img, "[10,10,90,90] object")
        assert out.shape == img.shape and out.sum() > 0 and img.sum() == 0
        assert "<span" in colored
        assert t_ui.visualize_all_bbox_together(img, "no boxes") == (None,
                                                                       "")
        assert t_ui.visualize_all_bbox_together(None, "[1,2,3,4]") == (None,
                                                                       "")
        _, colored = t_ui.visualize_all_bbox_together(
            img, "a ship [10,10,40,40] and a dock [50,50,90,90]")
        assert f"rgb{t_ui.BBOX_COLORS[0]}" in colored
        assert f"rgb{t_ui.BBOX_COLORS[1]}" in colored

    def test_extract_substrings(self):
        f = t_ui.extract_substrings
        assert f("box [1,2,3,4] {<5><6><7") == [[1.0, 2.0, 3.0, 4.0]]
        assert f("{<ok>} then [1,2,3,4]") == []
        assert f("[1,2,3,4] tail {<x>}") == [[1.0, 2.0, 3.0, 4.0]]
        assert f("[1,2,3,4,5,6]") == [[1.0, 2.0, 3.0, 4.0]]


TEXTS = ("a plane [10,20,30,40] and a ship [50,60,70,80] docked",
         "[0.1,0.1,0.9,0.9] field", "[10,30,60,60] a [10,30,70,70] b "
         "[10,30,80,80] c", "x [1,2] y [1,2,3,4,5,6] {<a>} [5,5,9,9]",
         "[5, 95, 99, 99.5] edge &amp; [120,4,300,40] px",
         "no boxes [a,b] here", "")


@pytest.mark.parametrize("seed", range(3))
def test_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    for text in TEXTS:
        assert t_ui.extract_bboxes(text) == j_ui.extract_bboxes(text)
        assert t_ui.extract_substrings(text) == j_ui.extract_substrings(text)
    for _ in range(20):
        a, b = rng.integers(0, 100, (2, 4)).tolist()
        assert t_ui.is_overlapping(a, b) == j_ui.is_overlapping(a, b)
        box = (rng.random(4) * rng.choice([1.2, 90.0, 400.0])).tolist()
        w, h = (int(v) for v in rng.integers(20, 300, 2))
        assert t_ui._denorm(box, w, h) == j_ui._denorm(box, w, h)
        mask = (rng.random((int(rng.integers(5, 40)),
                            int(rng.integers(5, 40)))) > 0.97).astype(
            np.uint8)
        if rng.random() < 0.5:
            mask = np.repeat(mask[..., None], 3, axis=2)
        assert t_ui.mask2bbox(mask) == j_ui.mask2bbox(mask)
    assert (t_ui.BBOX_COLORS, t_ui.COLOR_MAP, t_ui.TASK_TAGS,
            t_ui.TAG_EXAMPLES, t_ui.INTRODUCTION) == (
        j_ui.BBOX_COLORS, j_ui.COLOR_MAP, j_ui.TASK_TAGS,
        j_ui.TAG_EXAMPLES, j_ui.INTRODUCTION)


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("shape", [(100, 100, 3), (60, 140, 3)])
def test_visualize_byte_equal_to_jax(text, shape):
    """The overlay (boxes, numbered labels on blended backplates, shifted
    off each other) and the colored HTML, byte for byte."""
    rng = np.random.default_rng(len(text) + shape[1])
    img = rng.integers(0, 256, shape).astype(np.uint8)
    got, got_html = t_ui.visualize_all_bbox_together(img, text)
    want, want_html = j_ui.visualize_all_bbox_together(img, text)
    assert got_html == want_html
    assert (got is None) == (want is None)
    if want is not None:
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _image_conversation(conv_lib, rng):
    from PIL import Image

    conv = conv_lib.conv_templates["llava_llama_2"].copy()
    for i, (mode, hw) in enumerate((("Crop", (60, 90)), ("Pad", (80, 50)),
                                    ("Resize", (30, 30)),
                                    ("Pad", (900, 500)))):
        img = Image.fromarray(rng.integers(0, 256, hw + (3,)).astype(
            np.uint8))
        conv.append_message(conv.roles[0],
                            (f"<image>\nquestion {i}", img, mode))
        conv.append_message(conv.roles[1], f"answer {i}")
    conv.append_message(conv.roles[0], "a text-only turn")
    conv.append_message(conv.roles[1], None)
    return conv


def test_conversation_images_match_jax():
    """get_images (PIL and base64 PNG) and to_gradio_chatbot over image
    turns of each mode; the prompt of a tupled first turn; a bad mode
    raises in both."""
    from PIL import Image

    from lhrs_bot_tpu.data import conversation as j_conv
    from lhrs_bot_tpu_torch.data import conversation as t_conv

    convs = [_image_conversation(lib, np.random.default_rng(3))
             for lib in (j_conv, t_conv)]
    want, got = convs
    assert got.get_images() == want.get_images()
    for g, w in zip(got.get_images(return_pil=True),
                    want.get_images(return_pil=True)):
        assert g.size == w.size and g.tobytes() == w.tobytes()
    assert got.to_gradio_chatbot() == want.to_gradio_chatbot()
    assert got.get_prompt() == want.get_prompt()
    shown = base64.b64decode(got.get_images()[3])
    assert max(Image.open(io.BytesIO(shown)).size) <= 800
    for conv in convs:
        conv.messages[0][1] = ("<image>\nx", conv.messages[0][1][1], "Zoom")
        with pytest.raises(ValueError, match="Invalid image_process_mode"):
            conv.get_images()


@pytest.fixture(scope="module")
def demos(weights, tmp_path_factory):
    """A JAX and a port WebUIDemo over the same weight files, both in
    float32 (the KV caches bf16, as each builds them)."""
    from lhrs_bot_tpu.core import bootstrap as jb
    from lhrs_bot_tpu.core.config import ConfigDict as JConfig
    from lhrs_bot_tpu.serve import engine as j_engine
    from lhrs_bot_tpu_torch.core import bootstrap as tb
    from lhrs_bot_tpu_torch.core.config import load_yaml_config

    config = load_yaml_config(write_config(
        tmp_path_factory.mktemp("cfg") / "ui.yaml", weights))
    mp = pytest.MonkeyPatch()
    mp.setitem(j_engine.GenerationEngine.__init__.__kwdefaults__,
               "compute_dtype", jnp.float32)
    mp.setitem(tb.build_engine.__kwdefaults__, "compute_dtype",
               torch.float32)
    try:
        jconfig = JConfig(dict(config))
        jcfg, jparams, jtok = jb.build_model_and_tokenizer(jconfig)
        jdemo = j_ui.WebUIDemo(jcfg, jparams, jtok, jconfig)
        tcfg, tparams, ttok = tb.build_model_and_tokenizer(config, "cpu")
        tdemo = t_ui.WebUIDemo(tcfg, tparams, ttok, config, device="cpu")
    finally:
        mp.undo()
    yield jdemo, tdemo


def _both(demos, fn):
    return [fn(d) for d in demos]


def test_demo_matches_jax(demos):
    """Upload, ask, stream at temperature 0 (greedy in both), a second
    image added mid-chat, [Identify] with a sketch mask: the prompt ids,
    the history images and every streamed text equal JAX's."""
    from PIL import Image

    rng = np.random.default_rng(11)
    first = rng.integers(0, 256, (40, 52, 3)).astype(np.uint8)
    second = Image.fromarray(rng.integers(0, 256, (36, 30, 3)).astype(
        np.uint8))
    mask = np.zeros((40, 52), np.uint8)
    mask[8:20, 10:33] = 1
    j, t = demos
    for d in demos:
        d.upload_image(first)
        d.ask("what is this?")
    assert t.answer_prepare() == j.answer_prepare()
    assert t.image_np.tobytes() == j.image_np.tobytes()
    streams = _both(demos, lambda d: list(d.stream_answer(
        temperature=0.0, max_new_tokens=6)))
    assert streams[1] == streams[0] and streams[0]
    assert t.conv.messages[-1][1] == j.conv.messages[-1][1] == streams[0][-1]
    for d in demos:
        d.add_image(second)
        d.ask("[Identify] compare this region", mask=mask)
    ids = _both(demos, lambda d: d.answer_prepare())
    assert ids[1] == ids[0] and ids[0].count(-200) == 2
    hist = _both(demos, lambda d: d._history_images())
    assert hist[1].shape == (1, 2, 28, 28, 3) and \
        hist[1].tobytes() == hist[0].tobytes()
    streams = _both(demos, lambda d: list(d.stream_answer(
        temperature=0.0, max_new_tokens=5)))
    assert streams[1] == streams[0] and streams[0]
    assert t.conv.to_gradio_chatbot() == j.conv.to_gradio_chatbot()
    assert t.visualize("at [10,10,50,50]")[1] == \
        j.visualize("at [10,10,50,50]")[1]
    # the 2,000-token truncation: the first id and the last 1,999
    for d in demos:
        d.reset()
        d.ask("word " * 700)
    ids = _both(demos, lambda d: d.answer_prepare())
    assert ids[1] == ids[0]
    assert len(ids[0]) == t_ui.WebUIDemo.MAX_CONTEXT_TOKENS


def test_launch_demo_without_gradio_exits(demos, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_gradio(name, *a, **k):
        if name == "gradio":
            raise ImportError("No module named 'gradio'")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_gradio)
    for mod, demo in ((j_ui, demos[0]), (t_ui, demos[1])):
        with pytest.raises(SystemExit, match="gradio is not installed"):
            mod.launch_demo(demo)
