"""The port's chat and eval surfaces on the CPU: `cli_qa_torch.py`,
`utils/eval_utils.py` and `eval/scheduled.py`.

The stoppers and `scheduler_generate` are held to the JAX package's on the
same inputs (the JAX and port engines on the same weights, float32, greedy
ids exactly). `cli_qa_torch.chat`, driven with scripted lines over an
engine built from tests/fixtures/tiny_eval.yaml (its vocabulary holds the
byte tokenizer's ids), streams the text that a direct
`stream(session=True)` run of the same rendered conversation gives, and
its later turns continue the session's cache; `main` runs the entry point
end to end with a PNG image read from disk.
"""

import io
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.eval import scheduled as j_scheduled
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu.utils import eval_utils as j_eval_utils
from lhrs_bot_tpu_torch.core import build_engine
from lhrs_bot_tpu_torch.core.config import load_yaml_config
from lhrs_bot_tpu_torch.core.convert import params_from_numpy
from lhrs_bot_tpu_torch.data import conversation as conv_lib
from lhrs_bot_tpu_torch.data.preprocess import (
    tokenizer_image_token, wrap_image_token_for_generation)
from lhrs_bot_tpu_torch.data.tokenizer import ByteTokenizer
from lhrs_bot_tpu_torch.eval import scheduler_generate
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.serve import engine as t_engine
from lhrs_bot_tpu_torch.utils import eval_utils

from .test_torch_api import _png, _tiny_yaml

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cli():
    return runpy.run_path(str(REPO / "cli_qa_torch.py"),
                          run_name="cli_qa_torch")


def test_keywords_and_token_stoppers_match_jax():
    tok = ByteTokenizer()
    ids = tok.encode("the river bends ### near the forest",
                     add_special_tokens=False)
    stops = [(eval_utils.KeywordsStopper(tok, kws),
              j_eval_utils.KeywordsStopper(tok, kws))
             for kws in (["###"], ["forest"], ["lake", "</s>"])]
    tokens = [(eval_utils.make_token_stopper(s),
               j_eval_utils.make_token_stopper(s))
              for s in ([ids[5]], [2, ids[-1]], [])]
    fired = set()
    for n in range(len(ids) + 1):
        for i, (got, want) in enumerate(stops + tokens):
            assert got(ids[:n]) == want(ids[:n]), (i, n)
            if got(ids[:n]):
                fired.add(i)
    assert fired == {0, 1, 3, 4}
    assert eval_utils.type_dict == {"float16": torch.bfloat16,
                                    "bfloat16": torch.bfloat16,
                                    "float32": torch.float32}
    assert set(eval_utils.type_dict) == set(j_eval_utils.type_dict)


def test_scheduler_generate_matches_jax():
    """tests/test_eval_serve.py's ragged multimodal items: the port's ids
    equal JAX's `scheduler_generate` and the engines' `generate` per item,
    and each request's image is dropped once admitted."""
    j_cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), j_cfg)
    je = j_engine.GenerationEngine(j_cfg, params, max_seq_len=96,
                                   compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32, prompt_bucket=16)
    te = t_engine.GenerationEngine(
        t_vlm.VLMConfig.tiny_test(stage=0),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
        max_seq_len=96, compute_dtype=torch.float32,
        cache_dtype=torch.float32, prompt_bucket=16, device="cpu")
    rng = np.random.default_rng(61)
    items = []
    for i in range(7):
        n = int(rng.integers(5, 24))
        ids = rng.integers(3, 200, size=(n,)).astype(np.int32)
        img = None
        if i % 2 == 0:
            ids[0] = -200
            img = rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)
        items.append({"input_ids": ids, "image": img})
    want = j_scheduled.scheduler_generate(
        j_cfg, je, iter(items), len(items),
        gen_cfg=j_engine.GenerationConfig(max_new_tokens=6, eos_token_id=2),
        max_batch=3, tokens_per_tick=2)
    admitted = []
    from lhrs_bot_tpu_torch.serve import scheduler as t_sched
    admit = t_sched.ContinuousBatchingScheduler.admit

    def spy(self, reqs):
        n = admit(self, reqs)
        admitted.append(reqs[:n])
        return n

    t_sched.ContinuousBatchingScheduler.admit = spy
    try:
        got = scheduler_generate(
            te.cfg, te, iter(items), len(items),
            gen_cfg=t_engine.GenerationConfig(max_new_tokens=6,
                                              eos_token_id=2),
            max_batch=3, tokens_per_tick=2)
    finally:
        t_sched.ContinuousBatchingScheduler.admit = admit
    assert got == want
    for item, ids in zip(items, got):
        img = item["image"]
        assert ids == te.generate(
            item["input_ids"][None], np.asarray([len(item["input_ids"])]),
            images=None if img is None else img[None],
            gen_cfg=t_engine.GenerationConfig(max_new_tokens=6,
                                              eos_token_id=2))[0]
    assert sum(len(a) for a in admitted) == len(items)
    assert all(r.image is None for a in admitted for r in a)


@pytest.fixture(scope="module")
def chat_engine(tmp_path_factory):
    """An engine and byte tokenizer from tests/fixtures/tiny_eval.yaml
    (vocabulary 320), seeded random weights, on the CPU."""
    config = load_yaml_config(_tiny_yaml(tmp_path_factory.mktemp("cfg")))
    cfg = t_vlm.VLMConfig.from_config_dict(config)
    params = t_vlm.init_vlm_params(cfg, seed=0, device="cpu")
    return build_engine(cfg, params, config, "cpu"), ByteTokenizer()


def _direct(engine, tok, questions, image, gen_cfg):
    """The conversation the chat renders, streamed directly."""
    conv_lib.set_default_conversation("llava_llama_2")
    conv = conv_lib.default_conversation.copy()
    engine.reset_session()
    answers = []
    for i, q in enumerate(questions):
        if i == 0 and image is not None:
            q = wrap_image_token_for_generation("<image>\n" + q)
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], None)
        ids = tokenizer_image_token(conv.get_prompt(), tok)
        out = list(engine.stream(np.asarray([ids], np.int32), len(ids),
                                 images=image, gen_cfg=gen_cfg,
                                 session=True))
        text = tok.decode(out, skip_special_tokens=True)
        conv.messages[-1][1] = text
        answers.append(text)
    return answers


@pytest.mark.parametrize("speculative", [0, 3])
def test_chat_matches_direct_session_stream(cli, chat_engine, monkeypatch,
                                            speculative):
    engine, tok = chat_engine
    image = np.random.default_rng(3).integers(
        0, 256, size=(1, 28, 28, 3)).astype(np.uint8)
    gen_cfg = t_engine.GenerationConfig(max_new_tokens=6, eos_token_id=2)
    questions = ["what is in the image?", "where is the river?",
                 "and the road?"]
    want = _direct(engine, tok, questions, image, gen_cfg)
    engine.reset_session()
    continued = []
    cont = engine._prefill_continue
    monkeypatch.setattr(engine, "_prefill_continue",
                        lambda *a: continued.append(1) or cont(*a))
    out = io.StringIO()
    lines = [questions[0], "", questions[1], questions[2], "exit", "never"]
    got = cli["chat"](engine, tok, lines, out, gen_cfg=gen_cfg, image=image,
                      image_size=28, speculative=speculative)
    assert got == want
    # the stream writes each decode's new characters: a byte sequence cut
    # mid-character shows as U+FFFD until it completes, as in cli_qa.py
    assert out.getvalue().count("ASSISTANT: ") == 3
    assert len(continued) == 2  # turns 2 and 3 continue the session


def test_chat_image_command_resets(cli, chat_engine, tmp_path):
    """`image <path>` loads a PNG from disk (decoded and resized by the
    port) and starts a new conversation, whose turn is a fresh one with
    the new image's marker."""
    engine, tok = chat_engine
    arr = np.random.default_rng(4).integers(0, 256, size=(40, 56, 3)).astype(
        np.uint8)
    (tmp_path / "scene.png").write_bytes(_png(arr))
    gen_cfg = t_engine.GenerationConfig(max_new_tokens=4, eos_token_id=2)
    out = io.StringIO()
    got = cli["chat"](engine, tok, ["hello", f"image {tmp_path}/scene.png",
                                    "what is this?"], out, gen_cfg=gen_cfg,
                      image_size=28)
    loaded = cli["load_image"](str(tmp_path / "scene.png"), 28)
    assert loaded.shape == (1, 28, 28, 3) and loaded.dtype == np.uint8
    assert got[1] == _direct(engine, tok, ["what is this?"], loaded,
                             gen_cfg)[0]
    assert "[image loaded; conversation reset]" in out.getvalue()


def test_cli_main_runs_on_cpu(cli, tmp_path):
    arr = np.random.default_rng(5).integers(0, 256, size=(32, 32, 3)).astype(
        np.uint8)
    (tmp_path / "img.png").write_bytes(_png(arr))
    out = io.StringIO()
    answers = cli["main"](
        ["-c", _tiny_yaml(tmp_path), "--device", "cpu", "--output",
         str(tmp_path / "out"), "--image", str(tmp_path / "img.png"),
         "--temperature", "0", "--speculative", "3", "--max-new-tokens",
         "5"],
        lines=["describe it", "more"], out=out)
    assert len(answers) == 2
    text = out.getvalue()
    assert text.startswith(f"loaded image: {tmp_path}/img.png\n")
    assert text.count("ASSISTANT: ") == 2
    assert (tmp_path / "out" / "config.json").exists()
