"""The port's eval entry points (`main_{cls,vqa,vg}_torch.py` here; the
LHRS-Bench and caption entries and the two-process runs in
test_torch_eval_entries_dist.py) against the JAX ones on the CPU, batched
and with --scheduled-eval, and the port's GenerationCollator and eval
protocols (`eval/protocols.py`) against JAX's.

Both packages load the same float32 weight files, written by
`tools/make_fake_reference_ckpt.py` at the tiny fixture's shapes (HF CLIP,
HF LLaMA without tokenizer files, so both take the byte tokenizer, and
FINAL.pt), and both engines compute in float32 (the JAX engine's and
scheduler's `compute_dtype` defaults and the port's `build_engine`
keyword are set for the test; the entries themselves compute in bf16, as
JAX's do). The KV caches stay bf16 on both sides, as the entries build
them. The corpora are written by `tests/torch_corpora.py`. The result
records and every reported metric must be equal.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .cpu_budget import module_budget
from .torch_corpora import (write_caption_corpus, write_caption_eval_corpus,
                            write_cls_corpus, write_rsvqa_corpus,
                            write_vg_corpus)


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    yield from module_budget()


REPO = Path(__file__).resolve().parents[1]
VOCAB = 320


def load_module(path):
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_weights(root):
    """The tiny fixture's weights as HF CLIP, HF LLaMA and FINAL.pt."""
    tool = load_module(REPO / "tools" / "make_fake_reference_ckpt.py")
    tool.write_llama(str(root / "llama"), d=64, ffn=128, L=2, heads=4,
                     V=VOCAB)
    tool.write_clip(str(root / "clip"), w=32, L=4, heads=2, ffn=128,
                    image_size=28)
    tool.write_final_pt(str(root / "FINAL.pt"), VOCAB, w=32, nq=12, L=2,
                        d_llm=64, vit_layers=4, vit_ffn=128, image_size=28)
    return root


def write_config(path, weights, **overrides):
    """tests/fixtures/tiny_eval.yaml (stage 0, llava_llama_2) over the
    weight files."""
    import yaml

    with open(REPO / "tests" / "fixtures" / "tiny_eval.yaml") as fh:
        cfg = yaml.safe_load(fh)
    cfg["rgb_vision"]["vit_name"] = str(weights / "clip")
    cfg["text"]["path"] = str(weights / "llama")
    cfg["model_path"] = str(weights / "FINAL.pt")
    cfg.update(overrides)
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp("weights"))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_corpora")
    return {"cls": write_cls_corpus(str(root / "cls"), seed=31),
            "vqa": write_rsvqa_corpus(str(root / "vqa"), seed=32),
            "vg": write_vg_corpus(str(root / "vg"), seed=33),
            "cap": write_caption_eval_corpus(str(root / "cap"), seed=35),
            "root": root}


@pytest.fixture
def float32_compute(monkeypatch):
    """Both packages' engines (and the JAX scheduler) compute in float32."""
    from lhrs_bot_tpu.serve import engine as j_engine
    from lhrs_bot_tpu.serve import scheduler as j_sched
    from lhrs_bot_tpu_torch.core import bootstrap

    monkeypatch.setitem(j_engine.GenerationEngine.__init__.__kwdefaults__,
                        "compute_dtype", jnp.float32)
    monkeypatch.setitem(
        j_sched.ContinuousBatchingScheduler.__init__.__kwdefaults__,
        "compute_dtype", jnp.float32)
    monkeypatch.setitem(bootstrap.build_engine.__kwdefaults__,
                        "compute_dtype", torch.float32)


def spy(monkeypatch, module, name, seen):
    """Record each call's arguments and result of `module.name` (the JAX
    entries import their metric functions inside main, so a patched
    module attribute is what they call)."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        seen.setdefault(name, []).append((args, out))
        return out
    monkeypatch.setattr(module, name, wrapper)


def run_jax(monkeypatch, name, argv):
    """The JAX entry `name` on argv (its own parse_config reads
    sys.argv)."""
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    return load_module(REPO / f"{name}.py").main()


def run_port(name, argv):
    from lhrs_bot_tpu_torch.eval.entry import parse_eval_config

    config = parse_eval_config(name, args=argv + ["--device", "cpu"])
    return load_module(REPO / f"{name}_torch.py").main(config)


def common_argv(tmp_path, weights, out, batch=4, scheduled=False, **cfg):
    return (["-c", write_config(tmp_path / f"{out}.yaml", weights, **cfg),
             "--output", str(tmp_path / out), "--batch-size", str(batch)]
            + (["--scheduled-eval"] if scheduled else []))


MODES = pytest.mark.parametrize("scheduled", [False, True],
                                ids=["batched", "scheduled"])


@MODES
def test_cls_entry_matches_jax(tmp_path, weights, corpora, monkeypatch,
                               float32_compute, scheduled):
    from lhrs_bot_tpu.eval import metrics as j_met

    seen = {}
    spy(monkeypatch, j_met, "classname_to_idx", seen)
    spy(monkeypatch, j_met, "balanced_accuracy", seen)
    args = ["--data-path", corpora["cls"]]
    want_acc = run_jax(monkeypatch, "main_cls", common_argv(
        tmp_path, weights, "jax", scheduled=scheduled) + args)
    got = run_port("main_cls", common_argv(
        tmp_path, weights, "port", scheduled=scheduled) + args)
    (preds, _), pred_idx = seen["classname_to_idx"][0]
    (trues, _), acc = seen["balanced_accuracy"][0]
    assert got["records"] == [{"pred": p, "label": t}
                              for p, t in zip(preds, trues)]
    assert got["metrics"] == {"balanced_accuracy": want_acc} and \
        acc == want_acc
    assert len(got["records"]) == 12 == len(got["ids"]) == got["images"]
    assert sorted(set(trues)) == [0, 1, 2, 3]
    with open(tmp_path / "port" / "config.json") as fh:
        assert json.load(fh)["device"] == "cpu"


@MODES
def test_vqa_entry_matches_jax(tmp_path, weights, corpora, monkeypatch,
                               float32_compute, scheduled):
    from lhrs_bot_tpu.eval import metrics as j_met

    seen = {}
    spy(monkeypatch, j_met.TextVQAAccuracyEvaluator, "eval_pred_list", seen)
    args = ["--data-path", corpora["vqa"], "--data-target", "lr"]
    want_acc = run_jax(monkeypatch, "main_vqa", common_argv(
        tmp_path, weights, "jax", scheduled=scheduled) + args)
    got = run_port("main_vqa", common_argv(
        tmp_path, weights, "port", scheduled=scheduled) + args)
    with open(tmp_path / "jax" / "vqa_result.json") as fh:
        want = json.load(fh)
    with open(tmp_path / "port" / "vqa_result.json") as fh:
        assert json.load(fh) == got["records"] == want
    (_, per_type) = seen["eval_pred_list"][0][1]
    assert got["metrics"] == {"accuracy": want_acc, "per_type": per_type}
    # count / area questions and the inactive ones are left out
    assert len(want) == 12 and set(per_type) == {"presence", "comp",
                                                 "rural_urban"}
    assert os.path.exists(tmp_path / "port" / "vqa_result_rank0.json")


@MODES
def test_vg_entry_matches_jax(tmp_path, weights, corpora, monkeypatch,
                              float32_compute, scheduled):
    from lhrs_bot_tpu.eval import metrics as j_met

    seen = {}
    spy(monkeypatch, j_met, "grounding_accuracy", seen)
    args = ["--data-path", str(corpora["root"] / "vg"), "--data-target",
            corpora["vg"]]
    want = run_jax(monkeypatch, "main_vg", common_argv(
        tmp_path, weights, "jax", scheduled=scheduled) + args)
    got = run_port("main_vg", common_argv(
        tmp_path, weights, "port", scheduled=scheduled) + args)
    (preds, targets), _ = seen["grounding_accuracy"][0]
    assert got["records"] == [{"pred": p, "target": t}
                              for p, t in zip(preds, targets)]
    assert got["metrics"] == want and len(preds) == 6


def test_generation_collator_matches_jax():
    """GenerationCollator against JAX's: right and left padding, the
    pad multiple and max_length cut, lengths, mask, images and the
    pass-through keys (scalars as an array, others as a list); more than
    one image token raises in both."""
    from types import SimpleNamespace

    from lhrs_bot_tpu.data.collate import GenerationCollator as JColl
    from lhrs_bot_tpu_torch.data.collate import GenerationCollator as TColl

    rng = np.random.default_rng(7)
    tok = SimpleNamespace(pad_token_id=0, model_max_length=48)
    items = []
    for i, n in enumerate((5, 30, 70, 12)):
        ids = rng.integers(3, 300, n)
        ids[1] = -200
        items.append({"input_ids": ids, "target": f"t{i}", "qtype": i % 2,
                      "question_id": 100 + i, "box": [i, i + 1, i + 2, i],
                      "image": rng.integers(0, 256, (8, 8, 3)).astype(
                          np.uint8) if i != 2 else None})
    keys = ("target", "qtype", "question_id", "box", "absent")
    for kw in ({}, {"left_pad": True}, {"pad_multiple": 16},
               {"pad_multiple": 8, "max_length": 24, "left_pad": True}):
        want = JColl(tok, extra_keys=keys, **kw)(items)
        got = TColl(tok, extra_keys=keys, **kw)(items)
        assert list(got) == list(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k
    bad = [{"input_ids": np.asarray([1, -200, 5, -200])}]
    for coll in (JColl(tok), TColl(tok)):
        with pytest.raises(ValueError, match="2 image tokens"):
            coll(bad)


@pytest.fixture(scope="module")
def engines(weights, tmp_path_factory):
    """The JAX and the port engine over the same files, float32, and both
    tokenizers."""
    from lhrs_bot_tpu.core import bootstrap as jb
    from lhrs_bot_tpu.core.config import ConfigDict as JConfig
    from lhrs_bot_tpu_torch.core import (build_engine,
                                         build_model_and_tokenizer)
    from lhrs_bot_tpu_torch.core.config import load_yaml_config

    path = write_config(tmp_path_factory.mktemp("cfg") / "e.yaml", weights)
    config = load_yaml_config(path)
    jconfig = JConfig(dict(config))
    jcfg, jparams, jtok = jb.build_model_and_tokenizer(jconfig)
    from lhrs_bot_tpu.serve.engine import GenerationEngine

    jengine = GenerationEngine(
        jcfg, jparams, max_seq_len=int(config.text.max_position_embeddings)
        + 256, compute_dtype=jnp.float32, cache_dtype=jnp.bfloat16)
    tcfg, tparams, ttok = build_model_and_tokenizer(config, "cpu")
    tengine = build_engine(tcfg, tparams, config, "cpu",
                           compute_dtype=torch.float32)
    return {"jax": (jengine, jtok), "port": (tengine, ttok),
            "config": config, "params": tparams, "cfg": tcfg}


@pytest.mark.parametrize("protocol", ["cls", "caption"])
def test_protocols_match_jax(engines, corpora, protocol):
    """make_cls_eval_fn / make_caption_eval_fn over each package's engine
    and dataset give the same metric dicts (max_samples and a batch that
    does not divide it included)."""
    from lhrs_bot_tpu.data import datasets as j_data
    from lhrs_bot_tpu.eval import protocols as j_proto
    from lhrs_bot_tpu_torch.data import datasets as t_data
    from lhrs_bot_tpu_torch.eval import protocols as t_proto

    out = {}
    for name, data, proto in (("jax", j_data, j_proto),
                              ("port", t_data, t_proto)):
        engine, tok = engines[name]
        if protocol == "cls":
            ds = data.FolderClassificationDataset(corpora["cls"],
                                                  image_size=28)
            fn = proto.make_cls_eval_fn(engine, tok, ds, ds.class_names,
                                        batch_size=5, max_samples=11)
        else:
            ds = data.CapEvalDataset(str(corpora["root"] / "cap"),
                                     corpora["cap"], tok, image_size=28)
            fn = proto.make_caption_eval_fn(engine, tok, ds, batch_size=2,
                                            max_new_tokens=12)
        out[name] = fn()
    assert out["port"] == out["jax"]
    assert "accuracy" in out["port"]


def test_cls_protocol_in_an_eval_hook(engines, corpora, tmp_path):
    """make_cls_eval_fn inside the port trainer's EvalHook: two iterations
    of a stage-1 trainer, the accuracy recorded each iteration and the
    first one saved as the best checkpoint."""
    from lhrs_bot_tpu_torch.core import build_trainer
    from lhrs_bot_tpu_torch.data import SupervisedCollator
    from lhrs_bot_tpu_torch.data.datasets import (
        CaptionDatasetVQA, FolderClassificationDataset)
    from lhrs_bot_tpu_torch.eval import make_cls_eval_fn
    from lhrs_bot_tpu_torch.train import EvalHook

    engine, tok = engines["port"]
    ds = FolderClassificationDataset(corpora["cls"], image_size=28)
    eval_fn = make_cls_eval_fn(engine, tok, ds, ds.class_names,
                               batch_size=4, max_samples=8)
    calls = []

    def counted():
        calls.append(1)
        return eval_fn()
    caps = write_caption_corpus(str(tmp_path / "caps"), seed=3, n=4,
                                jpeg=False)
    train = CaptionDatasetVQA(caps, tok,
                              image_size=28, prompt_type="plain")
    coll = SupervisedCollator(tok, pad_multiple=8)
    loader = [coll([train[0], train[1]]), coll([train[2], train[3]])]
    config = {**engines["config"], "stage": 1, "epochs": 1}
    hook = EvalHook(period=1, eval_fn=counted)
    trainer = build_trainer(config, engines["params"], loader, "cpu",
                            compute_dtype=torch.float32,
                            work_dir=str(tmp_path / "run"), hooks=[hook])
    trainer.train()
    assert len(calls) == 2 and trainer.cur_iter == 2
    assert trainer.metric_storage["accuracy"].latest == hook.best == \
        eval_fn()["accuracy"]
    assert os.listdir(tmp_path / "run" / "checkpoints_best")
