"""The port's checkpoint formats against the JAX package's loaders.

`lhrs_bot_tpu_torch.core.safetensors_io` against the `safetensors`
package; every function of the port's `core/torch_import.py`,
`core/zero_import.py` and `core/model_io.py` against its JAX counterpart on
the same files. The loaders move bytes, so they must agree exactly, dtypes
included, on every leaf an artifact covers; the one computed leaf group,
the decoder projections that the stage-0 load merges the TextLoRA adapters
into, agrees within 1e-6 relative (the JAX loader sums A @ B through XLA,
the port through torch.matmul). Leaves no artifact covers keep each side's
own random init and are named, not compared. The checkpoints are
`tools/make_fake_reference_ckpt.py`'s, at the reduced shapes
`tests/test_parity_tool.py` gives it.
"""

import dataclasses
import importlib.util
import json
import os
import struct
from pathlib import Path

import jax
import numpy as np
import pytest
import safetensors
import safetensors.torch as st
import torch

from lhrs_bot_tpu.core import model_io as j_model_io
from lhrs_bot_tpu.core import torch_import as j_ti
from lhrs_bot_tpu.core import zero_import as j_zero
from lhrs_bot_tpu.models import llama as j_llama
from lhrs_bot_tpu.models import lora as j_lora
from lhrs_bot_tpu.models import perceiver as j_perceiver
from lhrs_bot_tpu.models import vit as j_vit
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu_torch.core import build_model, load_pretrained, save_final
from lhrs_bot_tpu_torch.core import safetensors_io as sio
from lhrs_bot_tpu_torch.core import torch_import as t_ti
from lhrs_bot_tpu_torch.core import zero_import as t_zero
from lhrs_bot_tpu_torch.models import llama as t_llama
from lhrs_bot_tpu_torch.models import lora as t_lora
from lhrs_bot_tpu_torch.models import perceiver as t_perceiver
from lhrs_bot_tpu_torch.models import vit as t_vit
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.ops.quant import QuantizedTensor

from .test_zero_import import write_zero2_checkpoint

REPO = Path(__file__).resolve().parents[1]
MERGE_RTOL = 1e-6
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_fake_reference_ckpt",
        REPO / "tools" / "make_fake_reference_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the reduced shapes of tests/test_parity_tool.py
LLAMA = dict(vocab_size=1000, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=4)
VIT = dict(image_size=56, patch_size=14, width=128, layers=4, heads=4,
           mlp_ratio=2, extract_stages=(1, 2, 3))
POOLER = dict(num_query=12, num_layers=2, heads=2, hidden_size=128,
              encoder_hidden_size=128, output_size=256, stage_num=(4, 4, 4),
              split_part=(16, 16, 16))
LORA_R = 8


def _configs(stage, lora=True):
    """(JAX VLMConfig, port VLMConfig) of the reduced checkpoint."""
    j = j_vlm.VLMConfig(
        vit=j_vit.ViTConfig(**VIT), pooler=j_perceiver.PerceiverConfig(
            **POOLER), llama=j_llama.LlamaConfig(**LLAMA),
        lora=j_lora.LoraConfig(r=LORA_R, alpha=2 * LORA_R) if lora else None,
        stage=stage)
    t = t_vlm.VLMConfig(
        vit=t_vit.ViTConfig(**VIT), pooler=t_perceiver.PerceiverConfig(
            **POOLER), llama=t_llama.LlamaConfig(**LLAMA),
        lora=t_lora.LoraConfig(r=LORA_R, alpha=2 * LORA_R) if lora else None,
        stage=stage)
    return j, t


def _write_checkpoint(out, resized_vocab=1000):
    tool = _tool()
    tool.write_llama(str(out / "llama"), d=256, ffn=512, L=2, heads=4,
                     V=1000)
    tool.write_clip(str(out / "clip"), w=128, L=4, heads=4, ffn=256,
                    image_size=56)
    tool.write_final_pt(str(out / "FINAL.pt"), resized_vocab, w=128, nq=12,
                        L=2, d_llm=256, vit_layers=4, vit_ffn=256,
                        image_size=56)
    tool.write_text_lora(str(out / "TextLoRA"), r=LORA_R, alpha=2 * LORA_R,
                         d=256, ffn=512, L=2)
    return out


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return _write_checkpoint(tmp_path_factory.mktemp("fake_ckpt"))


def _paths(ckpt):
    return dict(model_path=str(ckpt / "FINAL.pt"),
                vit_path=str(ckpt / "clip"), llama_path=str(ckpt / "llama"))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def assert_trees_equal(got, want, skip=()):
    """Same keys; every leaf byte-equal in value and dtype (but `skip`)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path in want:
        if path in skip:
            continue
        g, w = np.asarray(got[path]), np.asarray(want[path])
        assert g.dtype == w.dtype, path
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# -- the safetensors format --------------------------------------------------

DTYPE_CASES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, shape in enumerate([(3, 5), (7,), (), (0, 4), (2, 3, 4)]):
        x = torch.randn(shape, generator=g) * 100
        if dtype == torch.bool:
            x = x > 0
        elif not dtype.is_floating_point:
            info = torch.iinfo(dtype)
            x = x.clamp(info.min, info.max)
        out[f"t{i}"] = x.to(dtype)
    return out


@pytest.mark.parametrize("name", list(DTYPE_CASES))
def test_reader_matches_safetensors_package(tmp_path, name):
    """The port's reader gives what `safetensors.torch.load_file` gives,
    dtype and bits, for every dtype it takes; the package reads the
    port's writer's file back to the same tensors and metadata."""
    tensors = _tensors(DTYPE_CASES[name])
    path = str(tmp_path / "a.safetensors")
    st.save_file(tensors, path)
    want, got = st.load_file(path), sio.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k]), k
    mine = str(tmp_path / "b.safetensors")
    sio.save_file(tensors, mine, metadata={"format": "pt"})
    with safetensors.safe_open(mine, "pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert sorted(f.keys()) == sorted(tensors)
        for k in tensors:
            assert torch.equal(f.get_tensor(k), tensors[k]), k
    assert sio.read_header(mine)[1] == {"format": "pt"}


def test_sharded_dir_matches_jax(ckpt):
    """An HF directory of two safetensors shards: the port's state dict is
    the JAX loader's (`safetensors.torch.load_file` over the sorted
    shards), key for key and byte for byte."""
    got = t_ti._load_hf_dir_state_dict(str(ckpt / "llama"))
    want = j_ti._load_hf_dir_state_dict(str(ckpt / "llama"))
    assert sorted(got) == sorted(want) and len(got) == 2 * 9 + 3
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


def test_bin_dir_matches_jax(tmp_path):
    """A directory of `pytorch_model*.bin` files (and no safetensors) reads
    as the JAX loader reads it; a directory with neither raises."""
    sd = _tensors(torch.float32)
    torch.save(dict(list(sd.items())[:2]), tmp_path / "pytorch_model-1.bin")
    torch.save(dict(list(sd.items())[2:]), tmp_path / "pytorch_model-2.bin")
    (tmp_path / "notes.bin").write_bytes(b"not a checkpoint")
    got = t_ti._load_hf_dir_state_dict(str(tmp_path))
    want = j_ti._load_hf_dir_state_dict(str(tmp_path))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert torch.equal(got[k], want[k])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        t_ti._load_hf_dir_state_dict(str(tmp_path / "empty"))


def _rewrite_header(path, edit):
    """Apply `edit` to the JSON header of a safetensors file in place
    (the new header padded to the old length when shorter)."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = fh.read()
    edit(header)
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)) + blob + data)


def _set(name, key, value):
    def edit(header):
        header[name][key] = value
    return edit


BROKEN = {
    "unknown dtype": lambda p: _rewrite_header(p, _set("t0", "dtype", "F8")),
    "truncated": lambda p: open(p, "r+b").truncate(os.path.getsize(p) - 4),
    "offsets overrun": lambda p: _rewrite_header(
        p, _set("t4", "data_offsets", [120, 216])),
    "shape against offsets": lambda p: _rewrite_header(
        p, _set("t0", "shape", [3, 6])),
    "header overruns": lambda p: open(p, "r+b").write(
        struct.pack("<Q", os.path.getsize(p))),
    "bytes past the last tensor": lambda p: open(p, "ab").write(b"\0" * 8),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_reader_refuses_a_broken_file(tmp_path, case):
    """No tensor comes out of a file whose header does not hold: each
    fault raises ValueError before any tensor is made."""
    path = str(tmp_path / "a.safetensors")
    sio.save_file(_tensors(torch.float32), path)
    sio.load_file(path)
    BROKEN[case](path)
    with pytest.raises(ValueError):
        sio.load_file(path)


def test_swapped_offsets_swap_the_tensors(tmp_path):
    """Exchanging two same-shape entries' offsets in the header (the
    planted fault of `chip_smoke.py`'s checkpoint phase) exchanges the
    tensors, and the file stays valid."""
    path = str(tmp_path / "a.safetensors")
    g = torch.Generator().manual_seed(1)
    a, b = torch.randn(4, 4, generator=g), torch.randn(4, 4, generator=g)
    sio.save_file({"a": a, "b": b}, path)

    def swap(header):
        header["a"]["data_offsets"], header["b"]["data_offsets"] = \
            header["b"]["data_offsets"], header["a"]["data_offsets"]
    _rewrite_header(path, swap)
    out = sio.load_file(path)
    assert torch.equal(out["a"], b) and torch.equal(out["b"], a)


# -- torch_import ----------------------------------------------------------


def test_state_dict_converters_match_jax(ckpt):
    """llama / vit / pooler state dicts -> stacked parameters: byte-equal
    to the JAX converters, in the stored dtype (fp16 stays fp16; bf16
    becomes float32 on both sides); with dtype=float32 the values are the
    same, converted."""
    jcfg, tcfg = _configs(stage=0)
    sd = st.load_file(str(ckpt / "llama" /
                          "model-00001-of-00002.safetensors"))
    sd.update(st.load_file(str(ckpt / "llama" /
                               "model-00002-of-00002.safetensors")))
    want = j_ti.llama_params_from_hf_state_dict(sd, jcfg.llama)
    assert_trees_equal(t_ti.llama_params_from_hf_state_dict(sd, tcfg.llama),
                       want)
    as_f32 = t_ti.llama_params_from_hf_state_dict(sd, tcfg.llama,
                                                  torch.float32)
    assert_trees_equal(as_f32, jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), want))
    bf16 = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    assert_trees_equal(t_ti.llama_params_from_hf_state_dict(bf16, tcfg.llama),
                       j_ti.llama_params_from_hf_state_dict(bf16, jcfg.llama))

    clip = st.load_file(str(ckpt / "clip" / "model.safetensors"))
    assert_trees_equal(t_ti.vit_params_from_hf_state_dict(clip, tcfg.vit),
                       j_ti.vit_params_from_hf_state_dict(clip, jcfg.vit))
    assert_trees_equal(
        t_ti.load_hf_clip_vision(str(ckpt / "clip"), tcfg.vit),
        j_ti.load_hf_clip_vision(str(ckpt / "clip"), jcfg.vit))
    assert_trees_equal(t_ti.load_hf_llama(str(ckpt / "llama"), tcfg.llama),
                       j_ti.load_hf_llama(str(ckpt / "llama"), jcfg.llama))

    pool = torch.load(ckpt / "FINAL.pt", weights_only=False)[
        "other_ckpt"]["rgb_pooler"]
    h = POOLER["hidden_size"]
    with_in_proj = {**pool, "in_proj.weight": torch.randn(h, 96),
                    "in_proj.bias": torch.randn(h)}
    for sd in (pool, {"rgb_pooler." + k: v for k, v in pool.items()},
               with_in_proj):
        assert_trees_equal(
            t_ti.pooler_params_from_torch_state_dict(sd, tcfg.pooler),
            j_ti.pooler_params_from_torch_state_dict(sd, jcfg.pooler))


def _final_layouts(ckpt, tmp_path):
    """FINAL.pt in the nested layout (as written), a flat layout and the
    {"model": ...} envelope."""
    ckpt_sd = torch.load(ckpt / "FINAL.pt", weights_only=False)
    other = ckpt_sd["other_ckpt"]
    flat = {"rgb_pooler." + k: v for k, v in other["rgb_pooler"].items()}
    flat["text.text_encoder.model.embed_tokens.weight"] = \
        other["embed_tokens"]["weight"]
    paths = {"nested": ckpt / "FINAL.pt"}
    paths["flat"] = tmp_path / "flat.pt"
    torch.save({"rgb_ckpt": ckpt_sd["rgb_ckpt"], "other_ckpt": flat},
               paths["flat"])
    paths["envelope"] = tmp_path / "envelope.pt"
    torch.save({"model": ckpt_sd}, paths["envelope"])
    return paths


@pytest.mark.parametrize("layout", ["nested", "flat", "envelope"])
def test_load_final_pt_matches_jax(ckpt, tmp_path, layout):
    jcfg, tcfg = _configs(stage=0)
    path = str(_final_layouts(ckpt, tmp_path)[layout])
    got = t_ti.load_final_pt(path, tcfg.vit, tcfg.pooler)
    want = j_ti.load_final_pt(path, jcfg.vit, jcfg.pooler)
    assert sorted(want) == ["extra", "pooler", "vit"]
    assert len(want["extra"]) == 1
    assert_trees_equal(got, want)


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_load_text_lora_matches_jax(ckpt, tmp_path, fmt):
    """TextLoRA/ as adapter_model.bin (as written) or .safetensors:
    stacked (L, d_in, r) / (L, r, d_out), byte-equal to JAX; a missing
    directory is None on both sides."""
    jcfg, tcfg = _configs(stage=2)
    src = ckpt / "TextLoRA"
    if fmt == "safetensors":
        src = tmp_path / "TextLoRA"
        src.mkdir()
        st.save_file(torch.load(ckpt / "TextLoRA" / "adapter_model.bin"),
                     str(src / "adapter_model.safetensors"))
    got = t_ti.load_text_lora(str(src), tcfg.llama, LORA_R, 2 * LORA_R)
    want = j_ti.load_text_lora(str(src), jcfg.llama, LORA_R, 2 * LORA_R)
    assert sorted(want) == sorted(PROJECTIONS)
    assert want["w_down"]["a"].shape == (2, 512, LORA_R)
    assert_trees_equal(got, want)
    assert t_ti.load_text_lora(str(tmp_path / "none"), tcfg.llama, 8,
                               16) is None


def test_text_lora_subset_partial_and_missing(ckpt, tmp_path):
    """A TextLoRA covering a subset of the targets loads that subset, as
    in JAX; a target missing in some layers raises (JAX drops it without a
    word); a directory without an adapter file raises (JAX returns
    None)."""
    jcfg, tcfg = _configs(stage=2)
    sd = torch.load(ckpt / "TextLoRA" / "adapter_model.bin")
    subset = tmp_path / "subset"
    subset.mkdir()
    torch.save({k: v for k, v in sd.items() if "down_proj" not in k},
               subset / "adapter_model.bin")
    got = t_ti.load_text_lora(str(subset), tcfg.llama, 8, 16)
    assert_trees_equal(got, j_ti.load_text_lora(str(subset), jcfg.llama, 8,
                                                16))
    assert "w_down" not in got
    partial = tmp_path / "partial"
    partial.mkdir()
    torch.save({k: v for k, v in sd.items()
                if "layers.1.mlp.down_proj" not in k},
               partial / "adapter_model.bin")
    assert "w_down" not in j_ti.load_text_lora(str(partial), jcfg.llama, 8,
                                               16)
    with pytest.raises(ValueError, match="w_down"):
        t_ti.load_text_lora(str(partial), tcfg.llama, 8, 16)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        t_ti.load_text_lora(str(tmp_path / "empty"), tcfg.llama, 8, 16)


def _sd_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _sd_equal(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


def test_exports_match_jax(ckpt, tmp_path):
    """export_hf_llama_state_dict, export_final_pt and export_text_lora
    write what the JAX exports write (the same keys, float32 values), from
    numpy leaves and from tensors alike."""
    jcfg, tcfg = _configs(stage=2)
    params = j_model_io.load_pretrained(jcfg, **_paths(ckpt))
    params["extra"] = {"embed_tokens.weight": params["llama"][
        "embed_tokens"]}
    as_tensors = jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x)).to(torch.float32), params)
    want = j_ti.export_hf_llama_state_dict(params["llama"], jcfg.llama)
    for src in (params, as_tensors):
        _sd_equal(t_ti.export_hf_llama_state_dict(src["llama"], tcfg.llama),
                  want)
    j_ti.export_final_pt(str(tmp_path / "j.pt"), params, jcfg.vit,
                         jcfg.pooler)
    j_ti.export_text_lora(str(tmp_path / "jl"), params["lora"], jcfg.llama,
                          LORA_R, 2 * LORA_R)
    want = torch.load(tmp_path / "j.pt", weights_only=False)
    want_lora = torch.load(tmp_path / "jl" / "adapter_model.bin")
    for i, src in enumerate((params, as_tensors)):
        t_ti.export_final_pt(str(tmp_path / f"t{i}.pt"), src, tcfg.vit,
                             tcfg.pooler)
        _sd_equal(torch.load(tmp_path / f"t{i}.pt", weights_only=False),
                  want)
        t_ti.export_text_lora(str(tmp_path / f"tl{i}"), src["lora"],
                              tcfg.llama, LORA_R, 2 * LORA_R)
        _sd_equal(torch.load(tmp_path / f"tl{i}" / "adapter_model.bin"),
                  want_lora)
        assert json.loads((tmp_path / f"tl{i}" / "adapter_config.json")
                          .read_text()) == json.loads(
            (tmp_path / "jl" / "adapter_config.json").read_text())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_final_pt_and_text_lora_cross_read(ckpt, tmp_path, writer):
    """A FINAL.pt + TextLoRA/ written by one package is read by the other
    to the same tree as by the writer's own loader."""
    jcfg, tcfg = _configs(stage=2)
    params = j_model_io.load_pretrained(jcfg, **_paths(ckpt))
    out = tmp_path / "out"
    if writer == "port":
        save_final(str(out), params, tcfg)
    else:
        j_model_io.save_final(str(out), params, jcfg)
    j_read = j_ti.load_final_pt(str(out / "FINAL.pt"), jcfg.vit,
                                jcfg.pooler)
    t_read = t_ti.load_final_pt(str(out / "FINAL.pt"), tcfg.vit, tcfg.pooler)
    assert_trees_equal(t_read, j_read)
    assert_trees_equal(t_read["vit"], params["vit"])
    assert_trees_equal(t_read["pooler"], params["pooler"])
    assert_trees_equal(
        t_ti.load_text_lora(str(out / "TextLoRA"), tcfg.llama, 8, 16),
        j_ti.load_text_lora(str(out / "TextLoRA"), jcfg.llama, 8, 16))
    assert_trees_equal(
        t_ti.load_text_lora(str(out / "TextLoRA"), tcfg.llama, 8, 16),
        params["lora"])


# -- load_pretrained -------------------------------------------------------


def _merged_close(got, want):
    for name in PROJECTIONS:
        g, w = got["llama"]["layers"][name], want["llama"]["layers"][name]
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=MERGE_RTOL, atol=0,
                                   err_msg=name)


MERGED = tuple(f"llama/layers/{n}" for n in PROJECTIONS)


@pytest.mark.parametrize("stage", [0, 2])
def test_load_pretrained_matches_jax(ckpt, stage):
    """Every artifact present: each leaf byte-equal to the JAX loader's,
    float32; at stage 0 the TextLoRA is merged (projections within 1e-6
    relative) and no "lora" remains, at stage 2 it is live and exact.
    Nothing is left at the random init; the report names the four
    artifacts."""
    jcfg, tcfg = _configs(stage)
    want = j_model_io.load_pretrained(jcfg, **_paths(ckpt))
    got, report = load_pretrained(tcfg, **_paths(ckpt))
    assert report["random_init"] == []
    assert report["artifacts"] == {
        "clip": str(ckpt / "clip"), "llama": str(ckpt / "llama"),
        "final_pt": str(ckpt / "FINAL.pt"),
        "text_lora": str(ckpt / "TextLoRA")}
    assert ("lora" in got) == (stage == 2) == ("lora" in want)
    assert_trees_equal(got, want, skip=MERGED if stage == 0 else ())
    if stage == 0:
        _merged_close(got, want)
        # the merge moved the base: without TextLoRA the layers differ
        base = t_ti.load_hf_llama(str(ckpt / "llama"), tcfg.llama,
                                  torch.float32)
        assert not np.array_equal(base["layers"]["wq"],
                                  got["llama"]["layers"]["wq"])


def test_load_pretrained_names_the_random_leaves(ckpt, tmp_path):
    """FINAL.pt alone (no HF directories), its embed_tokens resized to
    1004 rows: the tower, perceiver and the first 1000 embedding rows come
    from it exactly; the decoder's other leaves keep each side's own
    random init, and the report names exactly those; the TextLoRA merges
    into that init at stage 0."""
    tool = _tool()
    out = tmp_path / "alone"
    out.mkdir()
    tool.write_final_pt(str(out / "FINAL.pt"), 1004, w=128, nq=12, L=2,
                        d_llm=256, vit_layers=4, vit_ffn=256, image_size=56)
    jcfg, tcfg = _configs(stage=2)
    want = j_model_io.load_pretrained(jcfg, model_path=str(out / "FINAL.pt"))
    got, report = load_pretrained(tcfg, model_path=str(out / "FINAL.pt"))
    random_leaves = ["llama/" + p for p, _ in _leaves(
        got["llama"]) if p != "embed_tokens"] + ["lora"]
    assert sorted(report["random_init"]) == sorted(random_leaves)
    assert report["artifacts"] == {"final_pt": str(out / "FINAL.pt")}
    skip = {p for p, _ in _leaves(want) if p.startswith("lora")
            or (p.startswith("llama/") and p != "llama/embed_tokens")}
    assert_trees_equal(got, want, skip=skip)
    for p in skip:  # the random leaves have the JAX shapes and dtypes
        g, w = dict(_leaves(got))[p], dict(_leaves(want))[p]
        assert g.shape == w.shape and g.dtype == w.dtype
    again, _ = load_pretrained(tcfg, model_path=str(out / "FINAL.pt"))
    assert_trees_equal(again, got)  # the init is the seed's


def test_load_pretrained_missing_paths_raise(ckpt, tmp_path):
    """A path that is given but absent is an error (the JAX loader keeps
    the random init)."""
    _, tcfg = _configs(stage=0)
    for kw in ({"vit_path": str(tmp_path / "no_clip")},
               {"llama_path": str(tmp_path / "no_llama")},
               {"model_path": str(tmp_path / "no.pt")}):
        with pytest.raises(FileNotFoundError):
            load_pretrained(tcfg, **{**_paths(ckpt), **kw})


def _unibind_sd(jcfg, params, tmp_path):
    """The JAX params in the reference module's namespace, through the
    JAX exports (tests/test_zero_import.py's projection)."""
    j_ti.export_final_pt(str(tmp_path / "tmp.pt"), params, jcfg.vit,
                         jcfg.pooler)
    ck = torch.load(tmp_path / "tmp.pt", weights_only=False)
    sd = {"rgb.encoder." + k: v.numpy() for k, v in ck["rgb_ckpt"].items()}
    sd.update({"rgb_pooler." + k: v.numpy()
               for k, v in ck["other_ckpt"]["rgb_pooler"].items()})
    for k, v in j_ti.export_hf_llama_state_dict(params["llama"],
                                                jcfg.llama).items():
        if ".layers." in k:  # peft-wrapped, as on a live training module
            k = "base_model.model." + k.replace(".weight",
                                                ".base_layer.weight")
        sd["text.text_encoder." + k] = v.numpy()
    for i in range(jcfg.llama.num_hidden_layers):
        for ours, peft in (("wq", "self_attn.q_proj"),
                           ("w_down", "mlp.down_proj")):
            base = (f"text.text_encoder.base_model.model.model.layers.{i}."
                    f"{peft}.")
            sd[base + "lora_A.default.weight"] = np.ascontiguousarray(
                params["lora"][ours]["a"][i].T)
            sd[base + "lora_B.default.weight"] = np.ascontiguousarray(
                params["lora"][ours]["b"][i].T)
    return sd


def test_zero_import_matches_jax(ckpt, tmp_path):
    """A ZeRO-2 shard directory (`write_zero2_checkpoint`: the float32
    truth in rank-partitioned optimizer groups, fp16 decoys in the module
    state): the consolidated state dict, its UniBind split and
    load_zero_checkpoint byte-equal to JAX's; load_pretrained over the
    directory equal to JAX's, the live adapters merged at stage 0 (within
    1e-6 relative) and live at stage 2 (exact)."""
    jcfg, tcfg = _configs(stage=2)
    params = j_model_io.load_pretrained(jcfg, **_paths(ckpt))
    sd = _unibind_sd(jcfg, params, tmp_path)
    trainable = [[k for k in sd if "rgb_pooler" in k],
                 [k for k in sd if "lora" in k],
                 [k for k in sd if "embed_tokens" in k]]
    zdir = str(tmp_path / "zero")
    write_zero2_checkpoint(zdir, sd, trainable, world_size=3,
                           frozen_fragments=False)
    assert t_zero.looks_like_zero_checkpoint(zdir)
    got = t_zero.get_fp32_state_dict_from_zero_checkpoint(zdir)
    want = j_zero.get_fp32_state_dict_from_zero_checkpoint(zdir)
    assert_trees_equal(got, want)
    assert_trees_equal(t_zero.split_unibind_state_dict(got),
                       j_zero.split_unibind_state_dict(want))
    assert_trees_equal(
        t_zero.load_zero_checkpoint(zdir, tcfg.vit, tcfg.pooler, tcfg.llama),
        j_zero.load_zero_checkpoint(zdir, jcfg.vit, jcfg.pooler, jcfg.llama))
    for stage in (0, 2):
        jc, tc = _configs(stage)
        want = j_model_io.load_pretrained(jc, model_path=zdir)
        got, report = load_pretrained(tc, model_path=zdir)
        assert report == {"artifacts": {"zero": zdir}, "random_init": []}
        merged = tuple(f"llama/layers/{n}" for n in ("wq", "w_down"))
        assert_trees_equal(got, want, skip=merged if stage == 0 else ())
        if stage == 0:
            for p in merged:
                np.testing.assert_allclose(dict(_leaves(got))[p],
                                           dict(_leaves(want))[p],
                                           rtol=MERGE_RTOL, atol=0)
        else:
            assert sorted(got["lora"]) == ["w_down", "wq"]


def test_save_final_round_trip(ckpt, tmp_path):
    """save_final of a stage-2 tree (tensors, as a trainer holds them),
    then load_pretrained at stage 3 over the same HF directories: the
    tower, the perceiver and the adapters come back bit for bit."""
    _, tcfg = _configs(stage=2)
    params, _ = load_pretrained(tcfg, **_paths(ckpt))
    as_tensors = jax.tree_util.tree_map(torch.from_numpy, params)
    save_final(str(tmp_path / "s2"), as_tensors, tcfg)
    _, t3 = _configs(stage=3)
    back, report = load_pretrained(
        t3, model_path=str(tmp_path / "s2" / "FINAL.pt"),
        vit_path=str(ckpt / "clip"), llama_path=str(ckpt / "llama"))
    assert "text_lora" in report["artifacts"]
    for group in ("vit", "pooler", "lora"):
        assert_trees_equal(back[group], params[group])


def test_build_model_quantizes_the_base_as_jax(ckpt):
    """build_model at stage 2 with bits 8 (the stage-2 recipe): the
    decoder projections int8 QuantizedTensors whose codes and scales equal
    the JAX bootstrap's quantize_llama_layers of the same load; the
    adapters live; at stage 0 nothing is quantized."""
    from lhrs_bot_tpu_torch.core.config import load_yaml_config

    config = load_yaml_config(str(REPO / "Config" /
                                  "multi_modal_stage2.yaml"))
    config["rgb_vision"]["arch"] = "vit_tiny"
    config["rgb_vision"]["vit_name"] = None
    config["rgb_vision"]["attn_pooler"].update(num_query=12, num_layers=2,
                                               num_attn_heads=2)
    config["text"].update(path=str(ckpt / "llama"), vocab_size=1000,
                          hidden_size=256, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=4)
    config["lora"]["lora_r"], config["lora"]["lora_alpha"] = 8, 16
    cfg, params, report = build_model(config, "cpu")
    assert report["artifacts"] == {"llama": str(ckpt / "llama")}
    assert cfg.lora == t_lora.LoraConfig(r=8, alpha=16, dropout=0.05)
    jcfg = j_vlm.VLMConfig(
        vit=j_vit.ViTConfig.tiny_test(), pooler=j_perceiver.PerceiverConfig(
            **dataclasses.asdict(cfg.pooler)),
        llama=j_llama.LlamaConfig(**dataclasses.asdict(cfg.llama)),
        lora=j_lora.LoraConfig(r=8, alpha=16), stage=2)
    want = j_model_io.load_pretrained(jcfg, llama_path=str(ckpt / "llama"))
    wq = j_quant.quantize_llama_layers(want["llama"]["layers"], bits=8)
    for name in PROJECTIONS:
        got = params["llama"]["layers"][name]
        assert isinstance(got, QuantizedTensor) and got.bits == 8
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(wq[name].q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(wq[name].scale))
    assert sorted(params["lora"]) == sorted(PROJECTIONS)
    config["stage"] = 0
    _, params0, _ = build_model(config, "cpu")
    assert isinstance(params0["llama"]["layers"]["wq"], np.ndarray)
    assert "lora" not in params0
