"""Web UI of the PyTorch port: multi-turn chat over an uploaded remote-
sensing image with streaming generation, task tags ([VG] / [CLS] / [VQA] /
[Identify]) and bbox visualization (counterpart of `lhrs_webui.py`).

The UI logic (prompt assembly, streaming, bbox parsing and drawing) lives
in WebUIDemo and the helpers, importable and testable without gradio;
`launch_demo` imports gradio and exits without it. cv2 is imported where a
box is drawn and PIL where the conversation carries an image, so the
module imports without either. Generation streams from the port's
`GenerationEngine.stream(session=True)`: a later turn prefills only what
the engine's cache does not hold yet.

Run: python lhrs_webui_torch.py -c Config/multi_modal_eval.yaml \
       --model-path <FINAL.pt> [--port 7860] [--device cpu]
"""

from __future__ import annotations

import itertools
import re
from typing import Iterator, List, Optional, Tuple

import numpy as np

TASK_TAGS = ["[VG]", "[CLS]", "[VQA]", "[Identify]"]

# reference color table (lhrs_webui.py:629-652) — bbox outlines and the
# matching colored spans in the answer text share these, in order
BBOX_COLORS = [
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (210, 210, 0),
    (255, 0, 255), (0, 255, 255), (114, 128, 250), (0, 165, 255),
    (0, 128, 0), (144, 238, 144), (238, 238, 175), (255, 191, 0),
    (0, 128, 0), (226, 43, 138), (255, 0, 255), (0, 215, 255),
]
COLOR_MAP = {str(i): "#{:02x}{:02x}{:02x}".format(*c)
             for i, c in enumerate(BBOX_COLORS)}

# per-tag example prompts shown in the UI (reference instruction panel +
# examples, lhrs_webui.py:32-41 and the task-tag workflow)
TAG_EXAMPLES = [
    ("[VG]", "the red-roofed building next to the playground"),
    ("[CLS]", "airport, beach, farmland, forest, harbor, residential"),
    ("[VQA]", "How many airplanes are parked near the terminal?"),
    ("[Identify]", "What is in this region? (sketch a box on the image)"),
    ("", "Describe the image in detail."),
]

INTRODUCTION = """Using Instruction:
1. Visual Grounding: Input a description about the referring object (then choose [VG]) and CLICK **Send**.
2. Classification: Input the given categories (then choose [CLS]), and CLICK **Send**.
3. VQA: Input a visual question (then choose [VQA]) and CLICK **Send**.
4. No Tag: Input whatever you want and CLICK **Send** without any tagging
5. Identify: Input a bounding box (then choose [Identify]) and CLICK **Send**.

You can also simply chat in free form!
"""


def mask2bbox(mask: Optional[np.ndarray]) -> str:
    """Sketch mask → "[x1,y1,x2,y2]" in 0-100 normalized coords
    (lhrs_webui.py:609-626)."""
    if mask is None:
        return ""
    if mask.ndim == 3:
        mask = mask[..., 0]
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return ""
    h, w = mask.shape
    x1, x2 = xs.min() / w * 100, xs.max() / w * 100
    y1, y2 = ys.min() / h * 100, ys.max() / h * 100
    return f"[{x1:.0f},{y1:.0f},{x2:.0f},{y2:.0f}]"


def extract_bboxes(text: str) -> List[Tuple[List[float], str]]:
    """All "[x1,y1,x2,y2]" groups with trailing label text."""
    out = []
    for m in re.finditer(r"\[([0-9., ]+)\]\s*([^\[\]]*)", text):
        try:
            coords = [float(x) for x in m.group(1).replace(" ", "").split(",")
                      if x != ""]
        except ValueError:
            continue
        if len(coords) >= 4:
            out.append((coords[:4], m.group(2).strip()))
    return out


def extract_substrings(string: str) -> List[List[float]]:
    """All bracketed coordinate groups, trimmed to 4 floats each; text after
    an unfinished "{" block is dropped first (lhrs_webui.py:567-576)."""
    index = string.rfind("}")
    if index != -1:
        string = string[:index + 1]
    matches = re.findall(r"\[([0-9., ]+)\]", string)
    out = []
    for match in matches:
        if not match:
            continue
        try:
            coords = [float(x) for x in match.replace(" ", "").split(",")
                      if x != ""]
        except ValueError:
            continue
        if len(coords) >= 4:
            out.append(coords[:4])  # >4 coords: keep the first box
    return out


def is_overlapping(rect1, rect2) -> bool:
    """Axis-aligned rect overlap (lhrs_webui.py:579-582)."""
    x1, y1, x2, y2 = rect1
    x3, y3, x4, y4 = rect2
    return not (x2 < x3 or x1 > x4 or y2 < y3 or y1 > y4)


def _denorm(box: List[float], w: int, h: int) -> Tuple[int, int, int, int]:
    """Model bbox → pixel coords. The reference webui multiplies 0-1 floats
    by the image size (lhrs_webui.py:666-701); the Identify flow uses 0-100
    ints — auto-detect the scale so both render."""
    top = max(box)
    if top <= 1.5:
        sx, sy = w, h
    elif top <= 100.0:
        sx, sy = w / 100.0, h / 100.0
    else:
        sx = sy = 1.0
    return (int(box[0] * sx), int(box[1] * sy),
            int(box[2] * sx), int(box[3] * sy))


def visualize_all_bbox_together(
        image: Optional[np.ndarray],
        generation: str) -> Tuple[Optional[np.ndarray], str]:
    """Reference rendering (lhrs_webui.py:656-906): draw every predicted
    bbox in its entity color with a numbered label on an alpha-blended
    backplate (labels shifted down when they'd overlap an earlier one), and
    return the answer text with each bracketed group replaced by a
    color-matched "<span>" so the prose is visually tied to its box.

    Returns (overlay image | None, colored-HTML answer)."""
    import html as html_lib

    import cv2

    if image is None:
        return None, ""
    generation = html_lib.unescape(generation)
    entities = extract_substrings(generation)
    if not entities:
        return None, ""

    img = np.ascontiguousarray(image.copy())
    h, w = img.shape[:2]
    text_size, text_line, box_line = 0.5, 1, 2
    (c_width, text_height), _ = cv2.getTextSize(
        "F", cv2.FONT_HERSHEY_COMPLEX, text_size, text_line)
    pad = text_height + 2 * 2  # text_spaces=2 parity
    previous_labels: List[Tuple[int, int, int, int]] = []

    for idx, box in enumerate(entities):
        color = BBOX_COLORS[idx % len(BBOX_COLORS)]
        x1, y1, x2, y2 = _denorm(box, w, h)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, box_line)

        # numbered label "  {idx}" above the box, pushed inside/down when
        # it would leave the image or overlap an earlier label
        label = f"  {idx}"
        (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_COMPLEX,
                                      text_size, text_line)
        lx, ly = x1, y1 - 2
        if ly - th < 0:
            ly = y1 + th + 4
        bg = [lx, ly - th - 2, lx + tw, ly + 2]
        guard = 0
        while any(is_overlapping(bg, p) for p in previous_labels):
            shift = th + 4
            ly += shift
            bg[1] += shift
            bg[3] += shift
            guard += 1
            if bg[3] >= h or guard > 16:
                break
        previous_labels.append(tuple(bg))
        # alpha-blended backplate: color swatch strip + white text area
        # (lhrs_webui.py:853-876)
        y_lo, y_hi = max(bg[1], 0), min(bg[3], h)
        x_lo, x_hi = max(bg[0], 0), min(bg[2], w)
        if y_hi > y_lo and x_hi > x_lo:
            region = img[y_lo:y_hi, x_lo:x_hi].astype(np.float32)
            backplate = np.full_like(region, 255.0)
            swatch_w = min(int(1.35 * c_width), region.shape[1])
            backplate[:, :swatch_w] = np.asarray(color, np.float32)
            img[y_lo:y_hi, x_lo:x_hi] = (
                0.5 * region + 0.5 * backplate).astype(np.uint8)
        cv2.putText(img, label, (lx, ly), cv2.FONT_HERSHEY_COMPLEX,
                    text_size, (0, 0, 0), text_line, cv2.LINE_AA)

    # color-coded answer text: each bracketed group becomes a span in the
    # matching bbox color (lhrs_webui.py:886-903). Unbounded counter: the
    # pattern can match more bracketed groups than extracted entities
    # (<4-coord groups, text past the last '}'), and running out of colors
    # must never abort the re.sub mid-stream.
    counter = itertools.count()

    def colored_phrase(match):
        i = next(counter)
        color = BBOX_COLORS[i % len(BBOX_COLORS)]
        return (f'<span style="color:rgb{color}">'
                f'[{match.group(1)}]</span>')

    generation_colored = re.sub(r"\[([0-9., ]+)\]", colored_phrase,
                                generation)
    return img, generation_colored


def _rgb(image) -> np.ndarray:
    """A PIL image or an array as an RGB uint8 array."""
    if hasattr(image, "convert"):
        image = image.convert("RGB")
    return np.asarray(image)


class WebUIDemo:
    """UI-framework-independent chat session logic."""

    MAX_CONTEXT_TOKENS = 2000  # the reference's context truncation

    def __init__(self, cfg, params, tokenizer, config, device=None):
        """The engine of `config` over `params` on `device` (the config's
        `device` when None: cuda unless it says cpu)."""
        from lhrs_bot_tpu_torch.core import build_engine
        from lhrs_bot_tpu_torch.data import conversation as conv_lib
        from lhrs_bot_tpu_torch.device import resolve_device

        self.cfg = cfg
        self.config = config
        self.tokenizer = tokenizer
        device = resolve_device(device or config.get("device") or "cuda")
        self.engine = build_engine(cfg, params, config, device)
        self.conv_lib = conv_lib
        conv_lib.set_default_conversation(
            getattr(config, "prompt_template", "llava_llama_2"))
        self.reset()

    def _preprocess(self, image) -> np.ndarray:
        from lhrs_bot_tpu_torch.data.transforms import clip_preprocess_uint8

        return clip_preprocess_uint8(
            _rgb(image), int(self.config.rgb_vision.input_size[0]))

    def reset(self):
        self.conv = self.conv_lib.default_conversation.copy()
        self.image_np: Optional[np.ndarray] = None
        self.raw_image: Optional[np.ndarray] = None
        self.first_turn = True
        self.engine.reset_session()

    def upload_image(self, image) -> None:
        """A new session over `image` (a PIL image or an array)."""
        self.reset()
        self.raw_image = np.asarray(image)
        self.image_np = self._preprocess(image)[None]

    def ask(self, text: str, mask: Optional[np.ndarray] = None) -> None:
        """Append a user turn (an [Identify] question gets the sketch
        mask's box); the first turn after an image carries it as a
        (text, PIL image, "Crop") tuple."""
        if text.startswith("[Identify]"):
            bbox = mask2bbox(mask)
            text = text + " " + bbox if bbox else text
        if self.first_turn and self.image_np is not None:
            from PIL import Image

            self.conv.append_message(
                self.conv.roles[0],
                ("<image>\n" + text, Image.fromarray(self.raw_image),
                 "Crop"))
            self.first_turn = False
        else:
            self.conv.append_message(self.conv.roles[0], text)
        self.conv.append_message(self.conv.roles[1], None)

    def add_image(self, image) -> None:
        """Attach another image mid-chat (a multi-image conversation): the
        next question's turn carries it, and generation splices every
        history image in order. `upload_image` resets the session
        instead."""
        self.raw_image = np.asarray(image)
        self.image_np = self._preprocess(image)[None]
        self.first_turn = True  # next ask() wraps <image> + tuple turn

    def _history_images(self) -> Optional[np.ndarray]:
        """All conversation-held images, preprocessed and stacked
        (1, K, H, W, 3); K == 1 collapses to the single-image path."""
        pil_images = self.conv.get_images(return_pil=True)
        if not pil_images:
            return self.image_np
        arrs = [self._preprocess(im) for im in pil_images]
        if len(arrs) == 1:
            return arrs[0][None]
        return np.stack(arrs)[None]

    def answer_prepare(self) -> List[int]:
        """The prompt's ids, the first and the last MAX_CONTEXT_TOKENS - 1
        kept when it is longer."""
        from lhrs_bot_tpu_torch.data.preprocess import tokenizer_image_token

        ids = tokenizer_image_token(self.conv.get_prompt(), self.tokenizer)
        if len(ids) > self.MAX_CONTEXT_TOKENS:
            ids = ids[:1] + ids[-(self.MAX_CONTEXT_TOKENS - 1):]
        return ids

    def stream_answer(self, temperature: float = 0.4,
                      max_new_tokens: int = 512) -> Iterator[str]:
        """The answer's text after each new token (greedy at temperature
        0, else top-p 0.9); the last one becomes the assistant turn."""
        from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

        ids = self.answer_prepare()
        gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens, do_sample=temperature > 0,
            temperature=max(temperature, 1e-4), top_p=0.9,
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id)
        emitted: List[int] = []
        for tok in self.engine.stream(
                np.asarray([ids], np.int32), len(ids),
                images=self._history_images(), gen_cfg=gen_cfg,
                session=True):
            emitted.append(tok)
            yield self.tokenizer.decode(emitted, skip_special_tokens=True)
        if emitted:
            self.conv.messages[-1][1] = self.tokenizer.decode(
                emitted, skip_special_tokens=True)

    def visualize(self, answer: str) -> Tuple[Optional[np.ndarray], str]:
        """(bbox overlay | None, color-coded answer HTML) of a chat
        turn."""
        if self.raw_image is None or "[" not in answer:
            return None, answer
        img, colored = visualize_all_bbox_together(self.raw_image, answer)
        return img, (colored or answer)


def launch_demo(demo: WebUIDemo, server_port: int = 7860):
    try:
        import gradio as gr
    except ImportError as exc:  # pragma: no cover
        raise SystemExit(
            "gradio is not installed in this environment; the chat logic is "
            "available programmatically via WebUIDemo, or use "
            "cli_qa_torch.py"
        ) from exc

    with gr.Blocks(title="LHRS-Bot") as ui:
        gr.Markdown('<h1 align="center">LHRS-Bot\U0001f6f0</h1>')
        gr.Markdown(
            '<h3 align="center">Welcome to the LHRS-Bot demo!</h3>')
        with gr.Row():
            with gr.Column(scale=1):
                gr.Markdown(INTRODUCTION)
                image_in = gr.Image(type="pil", label="RS image")
                tag = gr.Radio([t for t, _ in TAG_EXAMPLES],
                               value="", label="task tag")
                temp = gr.Slider(0.0, 1.5, value=0.4, label="temperature")
            with gr.Column(scale=2):
                chatbot = gr.Chatbot(render_markdown=True)
                textbox = gr.Textbox(
                    placeholder="Ask about the image — task tags: "
                    + " ".join(TASK_TAGS))
                gr.Examples(
                    examples=[[f"{t} {e}".strip()] for t, e in TAG_EXAMPLES],
                    inputs=[textbox], label="per-tag example prompts")
                vis_out = gr.Image(label="grounding overlay")

        state = {"demo": demo}

        def on_upload(img, history):
            d = state["demo"]
            if history and d.conv.messages:
                # mid-chat upload ADDS an image to the conversation
                # (multi-image chat); a fresh upload starts a new session
                d.add_image(img)
                return history
            d.upload_image(img)
            return []

        def on_ask(text, task_tag, history, temperature):
            d = state["demo"]
            if task_tag and not text.startswith(task_tag):
                text = f"{task_tag} {text}"
            d.ask(text)
            history = history + [[text, ""]]
            for partial in d.stream_answer(temperature=temperature):
                img, colored = d.visualize(partial)
                history[-1][1] = colored
                yield history, img

        image_in.upload(on_upload, [image_in, chatbot], [chatbot])
        textbox.submit(on_ask, [textbox, tag, chatbot, temp],
                       [chatbot, vis_out])
    ui.queue().launch(server_port=server_port, share=False)


def main(config=None):
    """Parse the command line (when `config` is None), load the model on
    `--device` and serve the UI on `--port`."""
    from lhrs_bot_tpu_torch.core import (build_model_and_tokenizer,
                                         parse_config, setup)
    from lhrs_bot_tpu_torch.device import resolve_device

    def extra(p):
        p.add_argument("--port", type=int, default=7860)
        p.add_argument("--device", type=str, default="cuda",
                       help="cuda (the default) or cpu")

    if config is None:
        config = parse_config("LHRS-Bot web UI (PyTorch port)", extra=extra)
    device = resolve_device(config.get("device") or "cuda")
    config.setdefault("rank", 0)
    setup(config)
    cfg, params, tokenizer = build_model_and_tokenizer(config, device)
    demo = WebUIDemo(cfg, params, tokenizer, config, device)
    del params
    launch_demo(demo, server_port=int(config.get("port") or 7860))


if __name__ == "__main__":
    main()
