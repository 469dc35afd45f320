"""Interactive CLI chat of the PyTorch port (one CUDA card), beside
`cli_qa.py`, the JAX package's:

  python cli_qa_torch.py -c chat.yaml --model-path <FINAL.pt> \
      --image <png> [--temperature 0 --speculative 4] [--device cpu]

where chat.yaml is a copy of Config/multi_modal_eval.yaml with `text.path`
null (the byte-level tokenizer) and `rgb_vision.vit_name` null or a local
CLIP directory, as for `lhrs_serve_torch.py`.

Each line read is a question; `image <path>` loads another image and
starts a new conversation; `exit` or `quit` ends. The prompt is rendered
with the config's template (`data/conversation.py`), the image marker
wrapped for generation on the first turn, and tokenized around the marker
(`tokenizer_image_token`). The answer streams from
`GenerationEngine.stream(session=True)`: a later turn prefills only what
the engine's cache does not hold yet. `--speculative N` (greedy only, i.e.
`--temperature 0`) verifies up to N prompt-lookup tokens a step; the ids
are plain greedy's in float32, and in bf16 may part from them where the
top-2 margin lies within bf16 rounding (the verify window attends through
plain PyTorch, a decode step through the decode kernel). On the card a
window costs about 1.6 decode steps, so it pays only where the answer
repeats its history. Sampling takes the reference's top-p of 0.9.

Images are read from local files and decoded by the port (PNG without
PIL; other formats through PIL where it is installed), then resized and
center-cropped to the tower's input (`clip_preprocess_uint8`). No URL is
fetched.

`chat(engine, tokenizer, lines, out, ...)` is the loop itself, over any
iterable of lines and any text stream.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional


def add_chat_args(p) -> None:
    p.add_argument("--image", type=str, default=None,
                   help="a local image file")
    p.add_argument("--temperature", type=float, default=0.4,
                   help="0 -> greedy")
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--speculative", type=int, default=0,
                   help="prompt-lookup speculation window (greedy only: "
                        "--temperature 0); slower on the card unless the "
                        "answer repeats its history")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")


def load_image(path: str, size: int):
    """A local image file as the tower's (1, size, size, 3) uint8 input."""
    from lhrs_bot_tpu_torch.data.image_io import decode_image
    from lhrs_bot_tpu_torch.data.transforms import clip_preprocess_uint8

    with open(path, "rb") as fh:
        raw = fh.read()
    return clip_preprocess_uint8(decode_image(raw), size)[None]


def chat(engine, tokenizer, lines: Iterable[str], out, *, gen_cfg,
         image=None, image_size: int = 224, speculative: int = 0,
         template: str = "llava_llama_2") -> List[str]:
    """The chat loop over `lines`, answers streamed to `out`; returns the
    answers. `image` is the tower's (1, H, W, 3) uint8 input or None."""
    import numpy as np

    from lhrs_bot_tpu_torch.data import conversation as conv_lib
    from lhrs_bot_tpu_torch.data.preprocess import (
        tokenizer_image_token, wrap_image_token_for_generation)
    from lhrs_bot_tpu_torch.models.constants import DEFAULT_IMAGE_TOKEN

    conv_lib.set_default_conversation(template)
    conv = conv_lib.default_conversation.copy()
    first_turn = True
    answers = []
    for line in lines:
        user = line.strip()
        if not user:
            continue
        if user.lower() in ("exit", "quit"):
            break
        if user.startswith("image "):
            image = load_image(user[len("image "):].strip(), image_size)
            conv = conv_lib.default_conversation.copy()
            first_turn = True
            out.write("[image loaded; conversation reset]\n")
            continue
        if first_turn and image is not None:
            user = wrap_image_token_for_generation(
                DEFAULT_IMAGE_TOKEN + "\n" + user)
            first_turn = False
        conv.append_message(conv.roles[0], user)
        conv.append_message(conv.roles[1], None)
        ids = tokenizer_image_token(conv.get_prompt(), tokenizer)
        out.write("ASSISTANT: ")
        out.flush()
        emitted: List[int] = []
        text = ""
        for tok in engine.stream(np.asarray([ids], np.int32), len(ids),
                                 images=image, gen_cfg=gen_cfg, session=True,
                                 speculative=speculative):
            emitted.append(tok)
            new = tokenizer.decode(emitted, skip_special_tokens=True)
            out.write(new[len(text):])
            out.flush()
            text = new
        out.write("\n")
        conv.messages[-1][1] = text
        answers.append(text)
    return answers


def _stdin_lines():
    while True:
        try:
            yield input("USER: ")
        except EOFError:
            return


def main(args: Optional[list] = None, lines: Optional[Iterable[str]] = None,
         out=None) -> List[str]:
    from lhrs_bot_tpu_torch.core import (build_engine,
                                         build_model_and_tokenizer,
                                         parse_config, setup)
    from lhrs_bot_tpu_torch.device import resolve_device
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig

    config = parse_config("LHRS-Bot CLI chat (PyTorch port)",
                          extra=add_chat_args, args=args)
    device = resolve_device(config.device)
    setup(config)
    cfg, params, tokenizer = build_model_and_tokenizer(config, device)
    engine = build_engine(cfg, params, config, device)
    del params
    out = out or sys.stdout
    size = cfg.vit.image_size
    image = load_image(config.image, size) if config.image else None
    if image is not None:
        out.write(f"loaded image: {config.image}\n")
    t = float(config.temperature)
    gen_cfg = GenerationConfig(
        max_new_tokens=int(config.max_new_tokens), do_sample=t > 0,
        temperature=max(t, 1e-6), top_p=0.9,
        eos_token_id=int(tokenizer.eos_token_id),
        pad_token_id=int(tokenizer.pad_token_id or 0))
    out.write("Type your question ('exit' to quit, 'image <path>' to "
              "load).\n")
    return chat(engine, tokenizer,
                _stdin_lines() if lines is None else lines, out,
                gen_cfg=gen_cfg, image=image, image_size=size,
                speculative=int(config.speculative),
                template=config.get("prompt_template") or "llava_llama_2")


if __name__ == "__main__":
    main()
