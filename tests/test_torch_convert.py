"""The port's converted checkpoint (`core.model_io.save_converted_params` /
`load_converted_params`) against `load_pretrained` and against the JAX
package's orbax round trip, and the two tools that drive it
(`tools/convert_checkpoint_torch.py`, `tools/rehearse_full_scale_torch.py`)
on the CPU.

The artifacts are `tools/make_fake_reference_ckpt.py`'s at
`tests/fixtures/tiny_config.yaml`'s shapes (an HF CLIP directory, an HF
LLaMA directory of LLaMA-2's 32,000-row vocabulary holding the SentencePiece
fixture's tokenizer files, FINAL.pt, TextLoRA/), as the stage-entry tests
write them. The converted round trip moves bytes, so it is held byte-equal
(values and dtypes) to the tree it was given; JAX's orbax round trip of the
same tree is byte-equal to it too, and JAX's own stage-0 load through
orbax is equal to the port's through its conversion on every leaf but the
merged decoder projections, which test_torch_checkpoint_io.py holds to
1e-6 relative (XLA against torch.matmul).
"""

import importlib.util
import io
import json
import os
import shutil
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from lhrs_bot_tpu_torch.core import model_io as t_model_io
from lhrs_bot_tpu_torch.core.config import load_yaml_config
from lhrs_bot_tpu_torch.models import vlm as t_vlm

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "torch_spm_fixture"
VOCAB = 32000
MERGE_RTOL = 1e-6
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _module(path):
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert_weights")
    tool = _module(REPO / "tools" / "make_fake_reference_ckpt.py")
    tool.write_llama(str(root / "llama"), d=64, ffn=128, L=2, heads=4,
                     V=VOCAB)
    for f in ("tokenizer.model", "tokenizer_config.json",
              "special_tokens_map.json"):
        shutil.copy(FIXTURE / f, root / "llama" / f)
    tool.write_clip(str(root / "clip"), w=32, L=4, heads=2, ffn=128,
                    image_size=28)
    tool.write_final_pt(str(root / "FINAL.pt"), VOCAB + 4, w=32, nq=12, L=2,
                        d_llm=64, vit_layers=4, vit_ffn=128, image_size=28)
    tool.write_text_lora(str(root / "TextLoRA"), r=4, alpha=8, d=64, ffn=128,
                         L=2)
    return root


@pytest.fixture(scope="module")
def config_yaml(tmp_path_factory, weights):
    """tiny_config.yaml at stage 0 with LoRA r 4 (merged at the load), the
    paths of `weights` and LLaMA-2's vocabulary."""
    import yaml

    cfg = yaml.safe_load((REPO / "tests" / "fixtures" /
                          "tiny_config.yaml").read_text())
    cfg["stage"] = 0
    cfg["lora"]["enable"] = True
    cfg["text"]["vocab_size"] = VOCAB
    cfg["rgb_vision"]["vit_name"] = str(weights / "clip")
    cfg["text"]["path"] = str(weights / "llama")
    cfg["model_path"] = str(weights / "FINAL.pt")
    path = tmp_path_factory.mktemp("convert_config") / "stage0.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _paths(weights):
    return dict(model_path=str(weights / "FINAL.pt"),
                vit_path=str(weights / "clip"),
                llama_path=str(weights / "llama"))


@pytest.fixture(scope="module")
def loaded(weights, config_yaml):
    cfg = t_vlm.VLMConfig.from_config_dict(load_yaml_config(config_yaml))
    params, report = t_model_io.load_pretrained(cfg, **_paths(weights))
    assert report["random_init"] == [] and "lora" not in params
    return cfg, params


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def assert_byte_equal(got, want, close=()):
    """Same keys, dtypes and shapes; every leaf's bytes equal (those in
    `close` within MERGE_RTOL instead)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g, w = np.asarray(got[path]), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        if path in close:
            np.testing.assert_allclose(g, w, rtol=MERGE_RTOL, atol=0,
                                       err_msg=path)
        else:
            assert g.tobytes() == w.tobytes(), path


def test_round_trip_is_byte_equal(tmp_path, loaded, monkeypatch):
    cfg, params = loaded
    monkeypatch.setattr(t_model_io, "CONVERTED_SHARD_BYTES", 1 << 20)
    path = t_model_io.save_converted_params(str(tmp_path / "conv"), params)
    index = json.loads((tmp_path / "conv" / "params.index.json").read_text())
    assert index["format"] == t_model_io.CONVERTED_FORMAT
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) > 1
    for name in shards:  # a shard over the limit holds one leaf only
        keys = [k for k, v in index["weight_map"].items() if v == name]
        assert os.path.getsize(tmp_path / "conv" / name) <= (1 << 20) + \
            (1 << 16) or len(keys) == 1
    back = t_model_io.load_converted_params(path, cfg)
    assert_byte_equal(back, params)
    # every leaf a copy-on-write mapping: writing to it leaves the file
    leaf = back["llama"]["embed_tokens"]
    assert isinstance(leaf.base, np.memmap) or isinstance(
        getattr(leaf.base, "base", None), np.memmap) or not leaf.flags.owndata
    leaf[0, 0] += 1.0
    again = t_model_io.load_converted_params(path)
    assert again["llama"]["embed_tokens"][0, 0] == \
        params["llama"]["embed_tokens"][0, 0]


def test_dtypes_survive(tmp_path):
    """Each leaf keeps its dtype: float32, float16, int8, int32, bool and
    a bfloat16 tensor (given back as a tensor, numpy having no bf16)."""
    rng = np.random.default_rng(0)
    tree = {"a": {"f32": rng.standard_normal((3, 5), np.float32),
                  "f16": rng.standard_normal(7).astype(np.float16)},
            "q": {"codes": rng.integers(-128, 127, (4, 4), dtype=np.int8),
                  "idx": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "mask": np.asarray([True, False])},
            "bf16": torch.randn(3, 2).to(torch.bfloat16)}
    back = t_model_io.load_converted_params(
        t_model_io.save_converted_params(str(tmp_path / "c"), tree))
    assert back["bf16"].dtype == torch.bfloat16
    assert torch.equal(back.pop("bf16"), tree.pop("bf16"))
    assert_byte_equal(back, tree)


def test_overwrite_refusal(tmp_path, loaded):
    _, params = loaded
    small = {"x": np.ones(3, np.float32)}
    other = tmp_path / "other"
    other.mkdir()
    (other / "keep.txt").write_text("not a checkpoint")
    with pytest.raises(ValueError, match="refusing to overwrite"):
        t_model_io.save_converted_params(str(other), small)
    assert (other / "keep.txt").read_text() == "not a checkpoint"
    a_file = tmp_path / "file.bin"
    a_file.write_bytes(b"x")
    with pytest.raises(ValueError, match="refusing to overwrite"):
        t_model_io.save_converted_params(str(a_file), small)
    # a directory whose index names another format is refused too
    tagged = tmp_path / "tagged"
    tagged.mkdir()
    (tagged / "params.index.json").write_text('{"format": "orbax"}')
    with pytest.raises(ValueError, match="refusing to overwrite"):
        t_model_io.save_converted_params(str(tagged), small)
    # a converted checkpoint is replaced
    conv = t_model_io.save_converted_params(str(tmp_path / "c"), params)
    t_model_io.save_converted_params(conv, small)
    assert sorted(os.listdir(conv)) == [
        "params-00001-of-00001.safetensors", "params.index.json"]
    np.testing.assert_array_equal(
        t_model_io.load_converted_params(conv)["x"], small["x"])
    for bad in (other, a_file, tmp_path / "absent"):
        with pytest.raises(ValueError, match="not a converted checkpoint"):
            t_model_io.load_converted_params(str(bad))
    with pytest.raises(ValueError, match="without '/'"):
        t_model_io.save_converted_params(str(tmp_path / "d"),
                                         {"a/b": small["x"]})


def test_index_and_shards_must_agree(tmp_path):
    tree = {"x": np.ones(3, np.float32), "y": np.zeros(2, np.float32)}
    conv = Path(t_model_io.save_converted_params(str(tmp_path / "c"), tree))
    index = json.loads((conv / "params.index.json").read_text())
    index["tree"]["z"] = "z"
    index["weight_map"]["z"] = index["weight_map"]["x"]
    (conv / "params.index.json").write_text(json.dumps(index))
    with pytest.raises(ValueError, match="leaf 'z' is missing"):
        t_model_io.load_converted_params(str(conv))
    del index["tree"]["z"], index["weight_map"]["z"], index["weight_map"]["y"]
    del index["tree"]["y"]
    (conv / "params.index.json").write_text(json.dumps(index))
    with pytest.raises(ValueError, match="does not name"):
        t_model_io.load_converted_params(str(conv))


def test_matches_the_orbax_round_trip(tmp_path, weights, config_yaml,
                                      loaded):
    """The same host tree through orbax (JAX) and through the converted
    checkpoint: byte-equal. JAX's own load through orbax against the
    port's through its conversion: equal but the merged projections."""
    from lhrs_bot_tpu.core import model_io as j_model_io
    from lhrs_bot_tpu.core.config import load_yaml_config as j_yaml
    from lhrs_bot_tpu.models import vlm as j_vlm

    cfg, params = loaded
    orbax = j_model_io.load_orbax_params(
        j_model_io.save_orbax_params(str(tmp_path / "orbax"), params), None)
    conv = t_model_io.load_converted_params(
        t_model_io.save_converted_params(str(tmp_path / "conv"), params))
    assert_byte_equal(conv, orbax)

    j_cfg = j_vlm.VLMConfig.from_config_dict(j_yaml(config_yaml))
    j_params = j_model_io.load_pretrained(j_cfg, **_paths(weights))
    j_orbax = j_model_io.load_orbax_params(
        j_model_io.save_orbax_params(str(tmp_path / "orbax_jax"), j_params),
        j_cfg)
    merged = {f"llama/layers/{p}" for p in PROJECTIONS}
    assert_byte_equal(conv, j_orbax, close=merged)


def _run(main, args):
    out = io.StringIO()
    with redirect_stdout(out):
        main(args)
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1])


def test_convert_tool(tmp_path, config_yaml, loaded):
    cfg, params = loaded
    tool = _module(REPO / "tools" / "convert_checkpoint_torch.py")
    report = _run(tool.main, ["-c", config_yaml, "--output",
                              str(tmp_path / "out")])
    assert report["path"] == str(tmp_path / "out" / "converted")
    assert report["load_s"] > 0 and report["convert_save_s"] > 0
    assert report["leaves"] == len(list(_leaves(params)))
    assert_byte_equal(t_model_io.load_converted_params(report["path"]),
                      params)


def test_rehearsal_tool(weights, config_yaml):
    """The rehearsal over the reduced artifacts on the CPU, with the
    conversion: the SentencePiece tokenizer from the decoder directory,
    and the same greedy ids as without it."""
    tool = _module(REPO / "tools" / "rehearse_full_scale_torch.py")
    args = ["--ckpt", str(weights), "-c", config_yaml, "--device", "cpu",
            "--max-new-tokens", "3"]
    plain = _run(tool.main, args)
    converted = _run(tool.main, args + ["--convert"])
    shutil.rmtree(weights / "converted")
    for report in (plain, converted):
        assert report["ok"] and report["tokenizer"] == "LlamaTokenizer"
        assert 1 <= report["tokens"] <= 3 and report["tok_s"] > 0
        for key in ("load_s", "engine_init_s", "first_generate_s",
                    "steady_generate_s"):
            assert report[key] > 0, key
    assert converted["convert_save_s"] > 0
    assert converted["convert_load_s"] > 0
    assert converted["text"] == plain["text"]
