"""The port's W8A8 vision tower against the JAX package on CPU.

Configuration: a ViT of width 128 with 2 heads (head dim 64) on 28x28
images (5 tokens, padded to 16 in the JAX layout), as tests/test_ops.py
tests the fused block, and the matching perceiver (12 queries in groups of
6/4/2 over 3 x 8 tokens). Weights come from the JAX initialisers, float32
values that are not bf16-representable; LayerNorm scales and every bias are
redrawn at random so that no epilogue term is 0 or 1. Inputs come from
numpy's seeded generator. The JAX fused kernels run in interpret mode, as
tests/test_ops.py runs them; the port's kernels take their plain versions
on CPU tensors.

Tolerances, and why:
  * packing, quantize_vision_layers and quantize_activation: exact (the
    same float32 division, rounding half to even);
  * the LayerNorm of kernel A: one int8 code (mean and variance summed in
    another order);
  * w8a8_matmul and the W8A8 dense/MLP: 1e-3 relative L2 (the exact
    integer product; the one bf16 rounding may land on the other side);
  * the fused blocks and the split form: max-abs within 5e-3 of max|ref|,
    the bound of JAX's own grouped-vs-ungrouped test
    (tests/test_ops.py:442). Two roundings differ: K1 rounds the
    unnormalised softmax probabilities to bf16 and divides by their float32
    sum at the end, where the TPU kernel rounds the normalised ones; and
    float32 sums run in another order, so an activation code may flip by
    one where a quotient lies within rounding of a half;
  * the fused towers and encode_image, where those differences pass
    through every layer: 1e-2 relative L2 (the JAX tests hold the W8A8
    tower to 3e-2 against bf16, so this is a third of the int8 noise);
  * the XLA W8A8 towers in float32 compute: 1e-4 relative L2 (summation
    order; measured about 2e-7);
  * the engine: identical greedy ids.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import perceiver as j_perc
from lhrs_bot_tpu.models import vit as j_vit
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.ops import mlp as j_mlp
from lhrs_bot_tpu.ops import perceiver_block as j_pb
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu.ops import vit_block as j_vb
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu_torch.core import build_engine, eval_config, \
    params_from_numpy
from lhrs_bot_tpu_torch.core.bootstrap import vision_w8a8_setting
from lhrs_bot_tpu_torch.models import perceiver as t_perc
from lhrs_bot_tpu_torch.models import vit as t_vit
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.ops import int8_gemm as t_gemm
from lhrs_bot_tpu_torch.ops import ln_quant as t_lnq
from lhrs_bot_tpu_torch.ops import mlp as t_mlp
from lhrs_bot_tpu_torch.ops import perceiver_block as t_pb
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.ops import vit_block as t_vb
from lhrs_bot_tpu_torch.serve import engine as t_engine

VIT = j_vit.ViTConfig(image_size=28, patch_size=14, width=128, layers=2,
                      heads=2, extract_stages=(1, 2))
POOL = j_perc.PerceiverConfig(
    num_query=12, num_layers=2, heads=2, hidden_size=128,
    encoder_hidden_size=128, output_size=64, stage_num=(6, 4, 2),
    split_part=(8, 8, 8))
S_PAD = -(-VIT.seq_len // 16) * 16
# ViT-L/14's 336-px geometry at the same narrow width (577 tokens, head dim
# 64: the rows of the split normalize-first path on the card) and its
# perceiver over 576 image tokens a group
VIT336 = dataclasses.replace(VIT, image_size=336)
POOL336 = dataclasses.replace(POOL, split_part=(576, 576, 576))
BLOCK_TOL = 5e-3   # max-abs / max|ref|: JAX's grouped-vs-ungrouped bound
TOWER_TOL = 1e-2   # relative L2 through whole towers
F32_TOL = 1e-4     # relative L2, float32 compute


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)
                      if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
                      else x)


def _randomized(layers, seed):
    """A numpy copy of stacked layers with LayerNorm scales and biases drawn
    at random (the initialisers' ones and zeros would hide those terms)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in layers.items():
        v = np.array(v, np.float32)
        if k.endswith("_scale"):
            v = 1.0 + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
        elif k.endswith("_bias") or k.startswith("b"):
            v = 0.05 * rng.standard_normal(v.shape).astype(np.float32)
        out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _vit_params(cfg=VIT):
    p = jax.tree_util.tree_map(np.asarray,
                               j_vit.init_vit_params(jax.random.PRNGKey(0),
                                                     cfg))
    p["layers"] = _randomized(p["layers"], 1)
    return p


@functools.lru_cache(maxsize=None)
def _pool_params():
    p = jax.tree_util.tree_map(
        np.asarray, j_perc.init_perceiver_params(jax.random.PRNGKey(1), POOL))
    p["layers"] = _randomized(p["layers"], 2)
    return p


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _layer0(tree, lib):
    if lib == "jax":
        return jax.tree_util.tree_map(lambda p: p[0], tree)
    return {k: v[0] for k, v in tree.items()}


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert err < tol, f"{what}: max-abs {err:.3e} of max|ref| (tol {tol})"


def _rel_l2(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < tol, f"{what}: relative L2 {rel:.3e} (tol {tol})"


def _equal_tree(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert g.shape == w.shape and str(g.dtype).split(".")[-1] == \
            str(w.dtype), (k, g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


# -- packing and quantization: exact ----------------------------------------


def test_pack_vit_layers_fused_byte_identical():
    layers = _vit_params()["layers"]
    got = t_vb.pack_vit_layers_fused(params_from_numpy(layers))
    _equal_tree(got, j_vb.pack_vit_layers_fused(_jtree(layers)))
    for k in ("wqkv", "wo", "w_fc", "w_proj"):  # kernel B's storage
        assert got[k].transpose(-1, -2).is_contiguous()


def test_pack_perceiver_layers_fused_byte_identical():
    layers = _pool_params()["layers"]
    got = t_pb.pack_perceiver_layers_fused(params_from_numpy(layers))
    _equal_tree(got, j_pb.pack_perceiver_layers_fused(_jtree(layers)))
    for k in ("wq", "wkv", "wo", "w_fc", "w_proj"):
        assert got[k].transpose(-1, -2).is_contiguous()


@pytest.mark.parametrize("which", ["vit", "pooler"])
def test_quantize_vision_layers_byte_identical(which):
    layers = (_vit_params() if which == "vit" else _pool_params())["layers"]
    got = t_quant.quantize_vision_layers(params_from_numpy(layers))
    want = j_quant.quantize_vision_layers(_jtree(layers))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, j_quant.QuantizedTensor):
            assert got[k].bits == 8
            np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(got[k].scale.numpy(),
                                          np.asarray(w.scale))
            assert got[k].q.transpose(-1, -2).is_contiguous()
        else:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))
    # bits=4 packs int4 codes, as JAX's does (no forward takes them)
    got = t_quant.quantize_vision_layers(params_from_numpy(layers), bits=4)
    want = j_quant.quantize_vision_layers(_jtree(layers), bits=4)
    for k, w in want.items():
        if isinstance(w, j_quant.QuantizedTensor):
            assert got[k].bits == 4
            np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(got[k].scale.numpy(),
                                          np.asarray(w.scale))


def _activations(dtype):
    """Rows of Gaussian values, one zero row, one row with exact .5 ties
    (amax 127: scale 1) and one with a large outlier."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    x[1] = 0.0
    x[2] = rng.integers(-126, 126, 256) + 0.5
    x[2, 0] = 127.0
    x[3, 7] = 80.0
    return jnp.asarray(x, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_activation_exact(dtype):
    x = _activations(dtype)
    want_q, want_s = j_quant.quantize_activation(x)
    tx = _t(x.astype(jnp.float32)).to(torch.bfloat16 if dtype ==
                                      jnp.bfloat16 else torch.float32)
    for q, s in (t_quant.quantize_activation(tx), t_lnq.ln_quant_plain(tx)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_ln_quant_matches_jax_ln_and_quant(dtype):
    """Kernel A's LayerNorm mode against the TPU kernel's `_ln_f32` +
    `_quant_act`: scales within float32 rounding, codes within one."""
    x = _activations(dtype)
    rng = np.random.default_rng(4)
    scale = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    bias = (0.05 * rng.standard_normal(256)).astype(np.float32)
    h = j_vb._ln_f32(x.astype(jnp.float32), jnp.asarray(scale)[None],
                     jnp.asarray(bias)[None], 1e-5)
    want_q, want_s = j_vb._quant_act(h)
    tx = _t(x.astype(jnp.float32)).to(torch.bfloat16 if dtype ==
                                      jnp.bfloat16 else torch.float32)
    q, s = t_lnq.ln_quant(tx, _t(scale), _t(bias), 1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-5)
    diff = np.abs(q.numpy().astype(int) - np.asarray(want_q).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_int8_gemm_plain_accumulators_exact():
    """The plain product at the ViT's deepest contraction (K = 4096) with
    codes at +-127: equal to the integer product."""
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (37, 4096)).astype(np.int8)
    w = rng.integers(-127, 128, (4096, 24)).astype(np.int8)
    a[0] = 127
    w[:, 0] = 127
    acc = t_gemm.int8_gemm_plain(_t(a), torch.ones(37, 1), _t(w),
                                 torch.ones(24), out_dtype=torch.int32)
    np.testing.assert_array_equal(acc.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_w8a8_matmul_matches_jax(dtype):
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, 9, 128)), dtype)
    w = rng.standard_normal((128, 96)).astype(np.float32) * 0.05
    want = j_quant.w8a8_matmul(x, j_quant.quantize_int8(jnp.asarray(w)))
    qt = t_quant.quantize_int8(_t(w))
    qt = t_quant.QuantizedTensor(t_quant.transposed_storage(qt.q), qt.scale)
    tx = _t(x.astype(jnp.float32)).to(torch.bfloat16 if dtype ==
                                      jnp.bfloat16 else torch.float32)
    got = t_quant.w8a8_matmul(tx, qt)
    assert got.dtype == tx.dtype
    _rel_l2(got, want, 1e-3, "w8a8_matmul")


def test_w8a8_dense_and_gelu_mlp_match_jax():
    """dense_any and gelu_mlp over quantized weights (the XLA W8A8 tower's
    projections), in bf16, with the JAX rounding points."""
    rng = np.random.default_rng(7)
    layers = _vit_params()["layers"]
    jq = _layer0(j_quant.quantize_vision_layers(_jtree(layers)), "jax")
    tq = _layer0(t_quant.quantize_vision_layers(params_from_numpy(layers)),
                 "torch")
    x = jnp.asarray(rng.standard_normal((2, 5, 128)), jnp.bfloat16)
    tx = _t(x.astype(jnp.float32)).to(torch.bfloat16)
    bq = jnp.asarray(layers["bq"][0], jnp.bfloat16)
    _rel_l2(t_mlp.dense_any(tx, tq["wq"], _t(bq.astype(jnp.float32)).to(
        torch.bfloat16)), j_mlp.dense_any(x, jq["wq"], bq), 1e-3, "dense")
    b_fc = jnp.asarray(layers["b_fc"][0], jnp.bfloat16)
    b_pj = jnp.asarray(layers["b_proj"][0], jnp.bfloat16)
    for quick in (True, False):
        want = j_mlp.gelu_mlp(x, jq["w_fc"], b_fc, jq["w_proj"], b_pj,
                              quick_gelu=quick)
        got = t_mlp.gelu_mlp(tx, tq["w_fc"],
                             _t(b_fc.astype(jnp.float32)).to(torch.bfloat16),
                             tq["w_proj"],
                             _t(b_pj.astype(jnp.float32)).to(torch.bfloat16),
                             quick_gelu=quick)
        assert got.dtype == torch.bfloat16
        _rel_l2(got, want, 1e-3, f"gelu_mlp quick={quick}")


# -- fused blocks: within 5e-3 of max|ref| -----------------------------------


def _block_input(n_img, seed):
    """(B, S_pad, W) bf16 with zeroed pad rows, numpy float32 values."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_img, S_PAD, VIT.width), np.float32)
    x[:, :VIT.seq_len] = rng.standard_normal(
        (n_img, VIT.seq_len, VIT.width)) * 0.5
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _packed_vit(cfg=VIT):
    layers = _vit_params(cfg)["layers"]
    return (j_vb.pack_vit_layers_fused(_jtree(layers)),
            t_vb.pack_vit_layers_fused(params_from_numpy(layers)))


@pytest.mark.parametrize("group,attn_pair", [(1, 2), (2, 2), (4, 2)],
                         ids=["g1", "g2", "g4"])
def test_fused_vit_block_matches_jax(group, attn_pair):
    jp, tp = _packed_vit()
    jx, tx = _block_input(4, 8)
    kw = dict(heads=VIT.heads, s_valid=VIT.seq_len, quick_gelu=True,
              group=group, attn_pair=attn_pair)
    want = j_vb.fused_vit_block(jx, _layer0(jp, "jax"), interpret=True, **kw)
    got = t_vb.fused_vit_block(tx, _layer0(tp, "torch"), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    s = VIT.seq_len
    _close(got[:, :s], np.asarray(want, np.float32)[:, :s], BLOCK_TOL,
           f"group {group}")
    # the padded rows are computed too, as the TPU kernel computes them
    _close(got[:, s:], np.asarray(want, np.float32)[:, s:], BLOCK_TOL, "pad")


def test_fused_vit_split_form_matches_jax():
    """fused_vit_qkv (JAX's transposed layout) and fused_vit_post, each on
    the same input as the JAX kernel."""
    jp, tp = _packed_vit()
    jlp, tlp = _layer0(jp, "jax"), _layer0(tp, "torch")
    jx, tx = _block_input(2, 9)
    jx, tx = jx.reshape(1, 2 * S_PAD, -1), tx.reshape(1, 2 * S_PAD, -1)
    want = j_vb.fused_vit_qkv(jx, jlp, interpret=True)
    got = t_vb.fused_vit_qkv(tx, tlp)
    assert got.shape == (1, 3 * VIT.width, 2 * S_PAD)
    _close(got, want, BLOCK_TOL, "qkv")
    rng = np.random.default_rng(10)
    attn = np.asarray(jnp.asarray(rng.standard_normal(tx.shape) * 0.3,
                                  jnp.bfloat16).astype(jnp.float32))
    want = j_vb.fused_vit_post(jx, jnp.asarray(attn, jnp.bfloat16), jlp,
                               interpret=True)
    got = t_vb.fused_vit_post(tx, _t(attn).to(torch.bfloat16), tlp)
    _close(got, want, BLOCK_TOL, "post")


def test_fused_vit_plain_versions_agree():
    """The `*_plain` entry points run the same composition (on the CPU
    both sides take the plain kernels): equal."""
    _, tp = _packed_vit()
    tlp = _layer0(tp, "torch")
    _, tx = _block_input(2, 11)
    kw = dict(heads=VIT.heads, s_valid=VIT.seq_len)
    assert torch.equal(t_vb.fused_vit_block(tx, tlp, **kw),
                       t_vb.fused_vit_block_plain(tx, tlp, **kw))
    assert torch.equal(t_vb.fused_vit_qkv(tx, tlp),
                       t_vb.fused_vit_qkv_plain(tx, tlp))
    assert torch.equal(t_vb.fused_vit_post(tx, tx, tlp),
                       t_vb.fused_vit_post_plain(tx, tx, tlp))


def test_fused_perceiver_block_matches_jax():
    layers = _pool_params()["layers"]
    jlp = _layer0(j_pb.pack_perceiver_layers_fused(_jtree(layers)), "jax")
    tlp = _layer0(t_pb.pack_perceiver_layers_fused(
        params_from_numpy(layers)), "torch")
    rng = np.random.default_rng(12)
    q_pad, kv_pad, nq = 16, 32, POOL.stage_num
    kv_valid = tuple(n + 8 for n in nq)
    q = np.zeros((2, 3, q_pad, 128), np.float32)
    kv = np.zeros((2, 3, kv_pad, 128), np.float32)
    for g, n in enumerate(nq):
        q[:, g, :n] = rng.standard_normal((2, n, 128)) * 0.5
        kv[:, g, :n] = q[:, g, :n]
        kv[:, g, q_pad:q_pad + 8] = rng.standard_normal((2, 8, 128)) * 0.5
    jq, jkv = jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16)
    kw = dict(heads=POOL.heads, group_nq=nq, kv_valid=kv_valid)
    want = j_pb.fused_perceiver_block(jq, jkv, jlp, interpret=True, **kw)
    tq = _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16)
    tkv = _t(np.asarray(jkv.astype(jnp.float32))).to(torch.bfloat16)
    got = t_pb.fused_perceiver_block(tq, tkv, tlp, **kw)
    assert torch.equal(got, t_pb.fused_perceiver_block_plain(tq, tkv, tlp,
                                                             **kw))
    _close(got, want, BLOCK_TOL, "perceiver block")


# -- towers, encode_image and the engine -------------------------------------


def _images(n, seed, size=28):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def _t_vit_cfg(cfg=VIT):
    return t_vit.ViTConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("split, cfg, n", [(False, VIT, 4), (True, VIT, 4),
                                           (False, VIT336, 1),
                                           (True, VIT336, 1)],
                         ids=["block", "split", "block_336", "split_336"])
def test_vit_encode_fused_matches_jax(split, cfg, n):
    params = _vit_params(cfg)
    jp, tp = _packed_vit(cfg)
    imgs = _images(n, 13, cfg.image_size)
    want = j_vit.vit_encode_fused(_jtree(params), jp, jnp.asarray(imgs), cfg,
                                  interpret=True, group=2,
                                  split_attention=split)
    tparams = params_from_numpy(params)
    got = t_vit.vit_encode_fused(tparams, tp, _t(imgs), _t_vit_cfg(cfg),
                                 group=2, split_attention=split)
    assert got.dtype == torch.bfloat16
    _rel_l2(got, want, TOWER_TOL,
            f"vit_encode_fused split={split} {cfg.image_size} px")


def test_xla_w8a8_towers_match_jax():
    """vit_encode and perceiver_resample over quantize_vision_layers
    weights (the JAX bench's XLA W8A8 tower, the engine's perceiver), in
    float32 compute, where both sides round at the same points: within
    F32_TOL. (In bf16 the port's float tower already differs from JAX's by
    about 5e-3 relative L2, bf16 summation noise, and the W8A8 path
    doubles that through code flips; encode_image below covers bf16.)"""
    vp, pp = _vit_params(), _pool_params()
    f32 = jnp.float32
    jv = {**_jtree(vp), "layers": j_quant.quantize_vision_layers(
        _jtree(vp["layers"]))}
    tv = params_from_numpy(vp)
    tv["layers"] = t_quant.quantize_vision_layers(tv["layers"])
    imgs = _images(2, 14)
    want = j_vit.vit_encode(jv, jnp.asarray(imgs), VIT, compute_dtype=f32)
    got = t_vit.vit_encode(tv, _t(imgs), _t_vit_cfg(),
                           compute_dtype=torch.float32)
    _rel_l2(got, want, F32_TOL, "XLA W8A8 tower")

    feats = np.asarray(np.random.default_rng(15).standard_normal(
        (2, 24, 128)) * 0.5, np.float32)
    jpp = {**_jtree(pp), "layers": j_quant.quantize_vision_layers(
        _jtree(pp["layers"]))}
    want = j_perc.perceiver_resample(jpp, jnp.asarray(feats), POOL,
                                     compute_dtype=f32)
    tpp = params_from_numpy(pp)
    tpp["layers"] = t_quant.quantize_vision_layers(tpp["layers"])
    got = t_perc.perceiver_resample(
        tpp, _t(feats), t_perc.PerceiverConfig(**dataclasses.asdict(POOL)),
        compute_dtype=torch.float32)
    _rel_l2(got, want, F32_TOL, "W8A8 perceiver")


@pytest.mark.parametrize("cfg, n", [(POOL, 2), (POOL336, 1)],
                         ids=["split_part_8", "split_part_576"])
def test_perceiver_resample_fused_matches_jax(cfg, n):
    pp = _pool_params()
    feats = np.asarray(np.random.default_rng(16).standard_normal(
        (n, sum(cfg.split_part), 128)) * 0.5, np.float32)
    want = j_perc.perceiver_resample_fused(
        _jtree(pp), j_pb.pack_perceiver_layers_fused(_jtree(pp["layers"])),
        jnp.asarray(feats), cfg, interpret=True)
    tpp = params_from_numpy(pp)
    got = t_perc.perceiver_resample_fused(
        tpp, t_pb.pack_perceiver_layers_fused(tpp["layers"]), _t(feats),
        t_perc.PerceiverConfig(**dataclasses.asdict(cfg)))
    assert got.dtype == torch.bfloat16
    _rel_l2(got, want, TOWER_TOL,
            f"perceiver_resample_fused split_part {cfg.split_part}")


@functools.lru_cache(maxsize=None)
def _vlm_params():
    cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    return cfg, jax.tree_util.tree_map(
        np.asarray, j_vlm.init_vlm_params(jax.random.PRNGKey(0), cfg))


def test_encode_image_vision_packed_matches_jax():
    """encode_image through the fused tower and the W8A8 perceiver (the
    engine's vision path), the JAX side in interpret mode."""
    cfg, params = _vlm_params()
    imgs = _images(2, 17)
    jparams = {**_jtree(params), "pooler": {
        **_jtree(params["pooler"]), "layers": j_quant.quantize_vision_layers(
            _jtree(params["pooler"]["layers"]))}}
    want = j_vlm.encode_image(
        jparams, jnp.asarray(imgs), cfg, compute_dtype=jnp.bfloat16,
        vision_packed=j_vb.pack_vit_layers_fused(
            _jtree(params["vit"]["layers"])), interpret=True)
    te = t_engine.GenerationEngine(t_vlm.VLMConfig.tiny_test(stage=0),
                                   params_from_numpy(params),
                                   vision_w8a8=True, device="cpu")
    got = t_vlm.encode_image(te.params, _t(imgs), te.cfg,
                             vision_packed=te._vision_packed)
    _rel_l2(got, want, TOWER_TOL, "encode_image")


def test_engine_vision_w8a8_greedy_matches_jax(monkeypatch):
    """Both engines with vision_w8a8 on the same float32 weights. The JAX
    engine passes no `interpret` to its fused tower, which cannot run on
    the CPU otherwise, so its splice is given interpret=True."""
    cfg, params = _vlm_params()
    monkeypatch.setattr(j_engine, "prepare_multimodal_inputs",
                        functools.partial(j_vlm.prepare_multimodal_inputs,
                                          interpret=True))
    kw = dict(max_seq_len=96)
    je = j_engine.GenerationEngine(cfg, _jtree(params), vision_w8a8=True,
                                   compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32, **kw)
    te = t_engine.GenerationEngine(
        t_vlm.VLMConfig.tiny_test(stage=0), params_from_numpy(params),
        vision_w8a8=True, compute_dtype=torch.float32,
        cache_dtype=torch.float32, device="cpu", **kw)
    assert te._vision_packed is not None
    assert isinstance(te.params["pooler"]["layers"]["wq"],
                      t_quant.QuantizedTensor)
    rng = np.random.default_rng(18)
    ids = rng.integers(3, 200, size=(2, 11)).astype(np.int32)
    ids[:, 1] = -200
    ids[1, 6:] = 0
    lens = np.asarray([11, 6], np.int32)
    imgs = _images(2, 19)
    gcfg = dict(max_new_tokens=8, eos_token_id=2)
    want = je.generate(ids, lens, images=imgs,
                       gen_cfg=j_engine.GenerationConfig(**gcfg))
    got = te.generate(ids, lens, images=imgs,
                      gen_cfg=t_engine.GenerationConfig(**gcfg))
    assert got == want


def test_build_engine_vision_w8a8_mapping():
    """An explicit setting wins; the default follows the JAX rule with a
    CUDA device in place of the TPU (bits 8, a head dim K1 takes)."""
    vit_l = t_vlm.VLMConfig.from_config_dict(eval_config())
    tiny = t_vlm.VLMConfig.tiny_test(stage=0)  # head dim 16
    assert vision_w8a8_setting(vit_l, {"bits": 8}, 8, "cuda")
    assert vision_w8a8_setting(vit_l, {"bits": 8}, 8, torch.device("cuda", 0))
    assert not vision_w8a8_setting(vit_l, {"bits": 8}, 8, "cpu")
    assert not vision_w8a8_setting(vit_l, {}, 16, "cuda")
    assert not vision_w8a8_setting(tiny, {"bits": 8}, 8, "cuda")
    assert not vision_w8a8_setting(vit_l, {"vision_w8a8": False}, 8, "cuda")
    assert vision_w8a8_setting(tiny, {"vision_w8a8": True}, 16, "cpu")

    _, params = _vlm_params()
    cfg = {**eval_config(), "rgb_vision": {
        "arch": "vit_tiny", "attn_pooler": {
            "num_query": 12, "num_attn_heads": 2, "num_layers": 2,
            "stage_num": [6, 4, 2]}},
        "text": {**eval_config()["text"], "vocab_size": 256,
                 "hidden_size": 64, "intermediate_size": 128,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "max_position_embeddings": 128}}
    vcfg = t_vlm.VLMConfig.from_config_dict(cfg)
    tparams = t_vlm.init_vlm_params(vcfg, seed=0, device="cpu")
    assert build_engine(vcfg, tparams, {**cfg, "bits": 8},
                        "cpu")._vision_packed is None
    engine = build_engine(vcfg, tparams, {**cfg, "bits": 8, "kv_bits": 8,
                                          "vision_w8a8": True}, "cpu")
    assert engine._vision_packed is not None
    out = engine.generate(np.asarray([[1, -200, 5, 6]], np.int32),
                          np.asarray([4], np.int32), images=_images(1, 20),
                          gen_cfg=t_engine.GenerationConfig(max_new_tokens=3))
    assert len(out) == 1 and len(out[0]) <= 3
