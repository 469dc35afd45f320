"""Conversation prompt templates.

Counterpart of `lhrs_bot_tpu/data/conversation.py`, copied so that the port
needs nothing of the JAX package (whose `data` modules import jax): the
separator styles, every entry of `conv_templates`, `get_prompt` with the
LLaMA-2 [INST] / <<SYS>> wrapping and the <image>-to-front normalization of
a tupled first message, `get_conversation` and `set_default_conversation`.
The rendered strings define every serving prompt. The web UI's image turns
(`get_images`, `to_gradio_chatbot` and their bounded resize) use PIL,
imported inside them, so the module imports without it.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    MPT = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=tuple(self.roles),
            messages=[list(m) for m in self.messages], offset=self.offset,
            sep_style=self.sep_style, sep=self.sep, sep2=self.sep2,
            version=self.version)

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    # -- conversation-held images (conversation.py:112-203 parity) ---------
    # A user turn may be a tuple (text, PIL image, process_mode); the
    # conversation itself carries the images, so multi-image chat history
    # round-trips through get_prompt/get_images/to_gradio_chatbot.

    @staticmethod
    def _bounded_resize(image):
        """Aspect-preserving bound: shortest edge =
        min(800/aspect, 400, current shortest)."""
        max_hw, min_hw = max(image.size), min(image.size)
        aspect = max_hw / min_hw
        shortest = int(min(800 / aspect, 400, min_hw))
        longest = int(shortest * aspect)
        w, h = image.size
        if h > w:
            return image.resize((shortest, longest))
        return image.resize((longest, shortest))

    def _image_turns(self):
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0 and isinstance(msg, tuple):
                yield msg

    def get_images(self, return_pil: bool = False) -> List:
        """Images carried in user turns, processed per their mode:
        Pad → square on (122, 116, 104); Crop → untouched; Resize →
        336x336; then the bounded resize. Returns PIL images or base64
        PNG strings."""
        import base64
        from io import BytesIO

        from PIL import Image

        out: List = []
        for msg in self._image_turns():
            _, image, mode = msg
            if mode == "Pad":
                w, h = image.size
                if w != h:
                    side = max(w, h)
                    sq = Image.new(image.mode, (side, side),
                                   (122, 116, 104))
                    sq.paste(image, ((side - w) // 2, (side - h) // 2))
                    image = sq
            elif mode == "Resize":
                image = image.resize((336, 336))
            elif mode != "Crop":
                raise ValueError(f"Invalid image_process_mode: {mode}")
            image = self._bounded_resize(image)
            if return_pil:
                out.append(image)
            else:
                buf = BytesIO()
                image.save(buf, format="PNG")
                out.append(base64.b64encode(buf.getvalue()).decode())
        return out

    def to_gradio_chatbot(self) -> List:
        """Chat history as [user, assistant] pairs; image turns render as
        an inline base64 <img> row followed by the stripped text row.
        (Bytes are JPEG inside a data:image/png URI — the reference's own
        byte-level behavior, conversation.py:194-197; browsers sniff.)"""
        import base64
        from io import BytesIO

        ret: List = []
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 1:
                if ret:
                    ret[-1][-1] = msg
                continue
            if isinstance(msg, tuple):
                text, image, _ = msg
                image = self._bounded_resize(image)
                buf = BytesIO()
                image.save(buf, format="JPEG")
                b64 = base64.b64encode(buf.getvalue()).decode()
                ret.append([f'<img src="data:image/png;base64,{b64}" '
                            'alt="user upload image" />', None])
                text = text.replace("<image>", "").strip()
                if text:
                    ret.append([text, None])
            else:
                ret.append([msg, None])
        return ret

    def _normalized_messages(self):
        """First message may be (text, image, ...) tuples in the web UI.

        Non-mmtag templates move <image> to the front of the text; mmtag
        templates instead insert a dedicated image turn —
        ``<Image><image></Image>`` answered by "Received." — before the
        stripped first message (reference conversation.py:33-41)."""
        messages = self.messages
        if messages and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in messages]
            role, msg = messages[0]
            text = msg[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = [role, text]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [role, "<image>\n" + text]
        return messages

    def get_prompt(self) -> str:
        messages = self._normalized_messages()
        style = self.sep_style

        if style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    out += role + ": " + message + self.sep
                else:
                    out += role + ":"
            return out

        if style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            out = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    out += role + ": " + message + seps[i % 2]
                else:
                    out += role + ":"
            return out

        if style == SeparatorStyle.MPT:
            out = self.system + self.sep
            for role, message in messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    out += role + message + self.sep
                else:
                    out += role
            return out

        if style == SeparatorStyle.LLAMA_2:
            sys_wrapped = f"<<SYS>>\n{self.system}\n<</SYS>>\n\n"
            out = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], "first message must be user"
                if not message:
                    continue
                if isinstance(message, tuple):
                    message = message[0]
                if i == 0:
                    message = sys_wrapped + message
                if i % 2 == 0:
                    out += self.sep + f"[INST] {message} [/INST]"
                else:
                    out += " " + message + " " + self.sep2
            return out.lstrip(self.sep)

        if style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2 or ""]
            out = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    out += message + seps[i % 2]
            return out

        raise ValueError(f"invalid separator style {style}")


conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers to "
    "the human's questions.",
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "What are the key differences between renewable and "
         "non-renewable energy sources?"],
        ["Assistant", "Renewable energy sources are those that can be "
         "replenished naturally in a relatively short amount of time, such "
         "as solar, wind, hydro, geothermal, and biomass."],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers to "
    "the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers to "
    "the human's questions.",
    roles=("Human", "Assistant"),
    messages=[["Human", "Hi!"],
              ["Assistant", "Hi there! How can I help you today?"]],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers to "
    "the human's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v0_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence "
    "assistant. The assistant is able to understand the visual content that "
    "the user provides, and assist the user with a variety of tasks using "
    "natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence "
    "assistant. The assistant is able to understand the visual content that "
    "the user provides, and assist the user with a variety of tasks using "
    "natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    version="v1_mmtag",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_mpt = Conversation(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

default_conversation = conv_llava_llama_2

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}


def get_conversation(name: str) -> Conversation:
    return conv_templates[name].copy()


def set_default_conversation(name: str) -> None:
    global default_conversation
    default_conversation = conv_templates[name]
