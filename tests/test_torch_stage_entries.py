"""The port's stage entry points (`main_pretrain_stage{1,2,3}_torch.py`)
against the JAX ones on the CPU: the tiny fixture config, a corpus written
into the test's directory, two iterations, a checkpoint, FINAL.pt (and
TextLoRA/ at stages 2 and 3).

Both packages load the same float32 weights: the tool
`tools/make_fake_reference_ckpt.py` writes an HF CLIP directory, an HF
LLaMA directory (with no tokenizer files: both packages take the byte
tokenizer), FINAL.pt and, for stages 2 and 3, TextLoRA/ at the fixture's
shapes (their seeded inits differ, so null weight paths would compare two
different trees). Both entries run in float32 (the trainers' compute
dtype default is set for the test on both sides; the entries themselves
compute in bf16, as JAX's do). The JAX entry builds a mesh whenever the
process sees more than one device (conftest.py gives it eight); it takes
`--dp 1 --tp 1`, a mesh of one device, since an eight-device mesh's
collectives can abort the process when the CPU is oversubscribed, as in
a parallel test run. The frozen leaves of FINAL.pt are
byte-equal, the trained ones (the perceiver at stages 1 and 2, the
adapters at stages 2 and 3) within test_torch_train.py's 1e-5.
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
from .test_torch_train import STATE_TOL
from .torch_corpora import write_caption_corpus, write_instruct_corpus


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    yield from module_budget()


REPO = Path(__file__).resolve().parents[1]
VOCAB = 320


def _module(path):
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The fixture config's weights as HF / FINAL.pt / TextLoRA files."""
    root = tmp_path_factory.mktemp("weights")
    tool = _module(REPO / "tools" / "make_fake_reference_ckpt.py")
    tool.write_llama(str(root / "llama"), d=64, ffn=128, L=2, heads=4,
                     V=VOCAB)
    tool.write_clip(str(root / "clip"), w=32, L=4, heads=2, ffn=128,
                    image_size=28)
    tool.write_final_pt(str(root / "FINAL.pt"), VOCAB, w=32, nq=12, L=2,
                        d_llm=64, vit_layers=4, vit_ffn=128, image_size=28)
    tool.write_text_lora(str(root / "TextLoRA"), r=4, alpha=8, d=64, ffn=128,
                         L=2)
    os.makedirs(root / "stage1")  # FINAL.pt without TextLoRA/
    os.link(root / "FINAL.pt", root / "stage1" / "FINAL.pt")
    return root


def _config(tmp_path, weights, stage):
    """The fixture YAML at `stage`, with the weight paths and the stage's
    knobs (stage 2: LoRA on, a dense base; stage 3: weight_sample, the
    perceiver frozen, `epochs` iterations)."""
    import yaml

    with open(REPO / "tests" / "fixtures" / "tiny_config.yaml") as fh:
        cfg = yaml.safe_load(fh)
    cfg["stage"] = stage
    cfg["rgb_vision"]["vit_name"] = str(weights / "clip")
    cfg["text"]["path"] = str(weights / "llama")
    cfg["model_path"] = str(weights / ("stage1" if stage == 1 else ".")
                            / "FINAL.pt")
    cfg["epochs"] = 1
    if stage > 1:
        cfg["prompt_template"] = "llava_llama_2"
        cfg["lora"]["enable"] = True
    if stage == 3:
        cfg["weight_sample"] = True
        cfg["tune_rgb_pooler"] = False
        cfg["epochs"] = 2
    path = tmp_path / f"stage{stage}.yaml"
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return str(path)


def _final(out):
    sd = torch.load(os.path.join(out, "FINAL.pt"), weights_only=True)
    flat = {"rgb_ckpt/" + k: v for k, v in sd["rgb_ckpt"].items()}
    for group, val in sd["other_ckpt"].items():
        if isinstance(val, dict):
            flat.update({f"{group}/{k}": v for k, v in val.items()})
        else:
            flat[group] = val
    lora = os.path.join(out, "TextLoRA", "adapter_model.bin")
    if os.path.exists(lora):
        flat.update({"lora/" + k: v for k, v in torch.load(
            lora, weights_only=True).items()})
    return flat


@pytest.fixture
def float32_compute(monkeypatch):
    """Both packages' trainers compute in float32 for the comparison."""
    from lhrs_bot_tpu.train import trainer as j_trainer
    from lhrs_bot_tpu_torch.core import bootstrap

    monkeypatch.setitem(j_trainer.Trainer.__init__.__kwdefaults__,
                        "compute_dtype", jnp.float32)
    monkeypatch.setitem(bootstrap.build_trainer.__kwdefaults__,
                        "compute_dtype", torch.float32)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_stage_entry_matches_jax(tmp_path, weights, stage, monkeypatch,
                                 float32_compute):
    data = str(tmp_path / "data")
    if stage == 1:
        write_caption_corpus(data, seed=20, n=8)
    else:
        # stage 3 weighs the sources: no record dropped, since the JAX
        # dataset's weights count the dropped ones
        write_instruct_corpus(data, seed=20 + stage, n_per_task=8,
                              sizes=((40, 52), (28, 30)), text_only=False,
                              missing=stage == 2)
    common = ["-c", _config(tmp_path, weights, stage), "--data-path", data,
              "--batch-size", "8", "--workers", "1", "--seed", "5"]
    outs = {}
    for pkg in ("jax", "port"):
        out = str(tmp_path / pkg)
        argv = common + ["--output", out] + (
            ["--dp", "1", "--tp", "1"] if pkg == "jax"
            else ["--device", "cpu"])
        name = f"main_pretrain_stage{stage}" + ("_torch" if pkg == "port"
                                                else "")
        monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
        mod = _module(REPO / f"{name}.py")
        if pkg == "jax" and stage == 1:
            from lhrs_bot_tpu.core.bootstrap import parse_config

            mod.main(parse_config("stage 1"))
        else:
            mod.main()
        outs[pkg] = out
    with open(os.path.join(outs["port"], "config.json")) as fh:
        assert json.load(fh)["device"] == "cpu"
    ckpts = sorted(os.listdir(os.path.join(outs["port"], "checkpoints")))
    assert ckpts == ["checkpoint_2", "latest.txt"]
    want, got = _final(outs["jax"]), _final(outs["port"])
    assert set(got) == set(want)
    trained = {k for k in want if k.startswith("lora/")
               or (stage < 3 and k.startswith("rgb_pooler/"))}
    moved = 0
    for k in want:
        if k in trained:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=k, **STATE_TOL)
            moved += not torch.equal(got[k], _final(str(weights / (
                "stage1" if stage == 1 else ".")))[k]) \
                if not k.startswith("lora/") else 0
        else:
            assert got[k].numpy().tobytes() == want[k].numpy().tobytes(), k
    assert trained and (stage == 3 or moved)
    # the port's resume: a fresh run with --auto-resume finds checkpoint_2
    # (all iterations done) and trains no further
    monkeypatch.setattr(sys, "argv", [f"main_pretrain_stage{stage}_torch.py"]
                        + common + ["--output", outs["port"], "--device",
                                    "cpu", "--auto-resume"])
    trainer = _module(REPO / f"main_pretrain_stage{stage}_torch.py").main()
    assert trainer.start_iter == trainer.cur_iter == 2


def test_mesh_flags_raise(tmp_path, weights):
    """--dp / --tp make a mesh of the world's ranks (torchrun): in one
    process dp or tp 2 raises ValueError naming the world size."""
    mod = _module(REPO / "main_pretrain_stage1_torch.py")
    from lhrs_bot_tpu_torch.core import add_train_args, parse_config

    for flags in (["--dp", "2"], ["--tp", "2"]):
        config = parse_config("x", extra=add_train_args, args=[
            "-c", _config(tmp_path, weights, 1), "--device", "cpu",
            "--output", str(tmp_path / "o")] + flags)
        with pytest.raises(ValueError, match="world size"):
            mod.main(config)
