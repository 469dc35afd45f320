"""The port's last glue against the JAX package, on the CPU: `build_model`,
the dtype table, the ViT-B/16 tower and float `pixel_values`, the
perceiver's `in_proj` (plain and fused) and its three variants (hoisted
K/V, folded K/V, batch-folded groups; float and int8), the graft entry
(`entry()`'s loss and `dryrun_multichip(4)` on gloo ranks) and the
profiler.

Tolerances, and why:
  * build_model and resolve_dtype: equal (configs, shapes, dtypes);
  * the ViT-B/16 tower (full width, 2 layers, float32) and its embedding
    of float pixels: 1e-5 relative L2 (summation order, float32); float
    pixels against the uint8 path 1e-4 (JAX's own test_models bound);
  * the perceiver variants and the plain in_proj perceiver, float and
    int8 in float32 compute: JAX's own 2e-4 (test_models.py:80-150);
  * the fused in_proj perceiver against JAX's fused path in interpret
    mode: 1e-2 relative L2 (tests/test_torch_vision.py's bound for the
    fused towers);
  * entry()'s bf16 loss: 5e-4 relative (bf16 rounding in another order
    through a 4-layer decoder, read 7e-5; float32 agrees to 1e-5).
Each bound has a planted fault that fails it.
"""

import dataclasses
import glob
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as j_graft
from lhrs_bot_tpu.core import dtypes as j_dtypes
from lhrs_bot_tpu.core.config import load_yaml_config as j_load
from lhrs_bot_tpu.models import build as j_build
from lhrs_bot_tpu.models import perceiver as j_perc
from lhrs_bot_tpu.models import vit as j_vit
from lhrs_bot_tpu.ops import perceiver_block as j_pb
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu_torch import graft_entry as t_graft
from lhrs_bot_tpu_torch.core import dtypes as t_dtypes
from lhrs_bot_tpu_torch.core import params_from_numpy
from lhrs_bot_tpu_torch.core.config import load_yaml_config as t_load
from lhrs_bot_tpu_torch.models import build_model as t_build_model
from lhrs_bot_tpu_torch.models import perceiver as t_perc
from lhrs_bot_tpu_torch.models import vit as t_vit
from lhrs_bot_tpu_torch.models.vlm import VLMConfig as TVLMConfig
from lhrs_bot_tpu_torch.ops import perceiver_block as t_pb
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.utils import profiler as t_prof

from .torch_parallel import REPO, run_ranks

F32 = torch.float32
JAX_TOL = 2e-4


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _asdict_eq(tcfg, jcfg):
    return dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


# -- build_model and dtypes --------------------------------------------------


def _shapes(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _shapes(tree[k], f"{pre}/{k}")
    else:
        yield pre, tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ["vit_tiny", "vit_base"])
def test_build_model_matches_jax(arch):
    """The same VLMConfig and the same parameter shapes and dtypes (the
    values come from another generator)."""
    path = str(REPO / "tests" / "fixtures" / "tiny_config.yaml")
    jconf, tconf = j_load(path), t_load(path)
    for c in (jconf, tconf):
        c["rgb_vision"]["arch"] = arch
    jcfg, jparams = j_build.build_model(jconf)
    tcfg, tparams = t_build_model(tconf, device="cpu")
    assert _asdict_eq(tcfg, jcfg)
    assert list(_shapes(tparams)) == list(_shapes(
        jax.tree_util.tree_map(np.asarray, jparams)))
    g = torch.Generator().manual_seed(3)
    _, again = t_build_model(tconf, generator=g, dtype=torch.bfloat16,
                             device="cpu")
    assert again["llama"]["lm_head"].dtype == torch.bfloat16
    assert not torch.equal(again["llama"]["lm_head"].float(),
                           tparams["llama"]["lm_head"].bfloat16().float())
    assert t_build_model(tconf, init_params=False, device="cpu")[1] is None
    if not torch.cuda.is_available():  # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device visible"):
            t_build_model(tconf)


def test_resolve_dtype_matches_jax():
    assert set(t_dtypes.DTYPE_MAP) == set(j_dtypes._DTYPE_MAP)
    for name in j_dtypes._DTYPE_MAP:
        for spelled in (name, name.upper()):
            got = t_dtypes.resolve_dtype(spelled)
            want = j_dtypes.resolve_dtype(spelled)
            assert str(got).split(".")[-1] == jnp.dtype(want).name, name
    assert t_dtypes.resolve_dtype(torch.float16) is torch.float16
    with pytest.raises(ValueError, match="unknown dtype"):
        t_dtypes.resolve_dtype("float64")
    for cfg_dtype in ("float32", "bf16", "fp16", "int8"):
        cfg = types.SimpleNamespace(dtype=cfg_dtype)
        got = t_dtypes.DTypePolicy.from_config(cfg)
        want = j_dtypes.DTypePolicy.from_config(cfg)
        assert str(got.compute_dtype).split(".")[-1] == jnp.dtype(
            want.compute_dtype).name
    cast = t_dtypes.DEFAULT_POLICY.cast_compute(
        {"a": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)})
    assert cast["a"].dtype == torch.bfloat16 and cast["i"].dtype == \
        torch.int32
    from lhrs_bot_tpu.utils import eval_utils as j_eu  # noqa: F401
    from lhrs_bot_tpu_torch.utils.eval_utils import type_dict

    assert type_dict == {"float16": torch.bfloat16,
                         "bfloat16": torch.bfloat16, "float32": F32}


# -- ViT-B/16 and float pixel values -----------------------------------------

VIT_BASE = dataclasses.replace(j_vit.ViTConfig.vit_base(), layers=2,
                               extract_stages=(1, 2, 2))


def _t_vit_cfg(cfg):
    return t_vit.ViTConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def vit_base():
    params = jax.tree_util.tree_map(
        np.asarray, j_vit.init_vit_params(jax.random.PRNGKey(0), VIT_BASE))
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    from lhrs_bot_tpu.ops.patch_embed import CLIP_MEAN, CLIP_STD

    pv = ((img.astype(np.float32) / 255.0 - np.asarray(CLIP_MEAN))
          / np.asarray(CLIP_STD)).astype(np.float32)
    return params, img, pv


def test_vit_base_config_matches_jax():
    assert _asdict_eq(t_vit.ViTConfig.vit_base(), j_vit.ViTConfig.vit_base())
    conf = t_load(str(REPO / "tests" / "fixtures" / "tiny_config.yaml"))
    conf["rgb_vision"]["arch"] = "vit_base"
    cfg = TVLMConfig.from_config_dict(conf)
    assert cfg.vit == t_vit.ViTConfig.vit_base()
    assert cfg.pooler.split_part == (196,) * 3
    conf["rgb_vision"]["arch"] = "vit_huge"
    with pytest.raises(ValueError, match="unknown rgb_vision.arch"):
        TVLMConfig.from_config_dict(conf)


@pytest.mark.parametrize("layout", ["nchw", "nhwc", "uint8"])
def test_vit_base_tower_matches_jax(vit_base, layout):
    """ViT-B/16 at full width (2 layers), float32: the embedding and the
    tower from uint8 pixels and from float pixel values in either layout,
    against JAX's vit_embed / vit_encode on the same inputs."""
    params, img, pv = vit_base
    x = {"uint8": img, "nhwc": pv, "nchw": pv.transpose(0, 3, 1, 2)}[layout]
    tp = params_from_numpy(params)
    cfg = _t_vit_cfg(VIT_BASE)
    want_e = j_vit.vit_embed(params, jnp.asarray(x), VIT_BASE, jnp.float32)
    got_e = t_vit.vit_embed(tp, torch.from_numpy(np.array(x)), cfg, F32)
    assert _rel_l2(got_e, want_e) < 1e-5
    want = j_vit.vit_encode(params, jnp.asarray(x), VIT_BASE,
                            compute_dtype=jnp.float32)
    got = t_vit.vit_encode(tp, torch.from_numpy(np.array(x)), cfg, F32)
    assert got.shape == (2, 3 * 196, 768)
    assert _rel_l2(got, want) < 1e-5
    if layout == "nchw":
        # float pixels agree with the uint8 path (JAX's own bound), and a
        # batch read in the wrong layout does not
        u8 = t_vit.vit_encode(tp, torch.from_numpy(img), cfg, F32)
        np.testing.assert_allclose(got.numpy(), u8.numpy(), rtol=1e-4,
                                   atol=1e-4)
        swapped = torch.from_numpy(np.ascontiguousarray(
            pv.transpose(0, 3, 2, 1)))  # H and W swapped
        bad = t_vit.vit_encode(tp, swapped, cfg, F32)
        assert _rel_l2(bad, want) > 1e-5


# -- the perceiver: in_proj and the variants ---------------------------------

POOL_IN = j_perc.PerceiverConfig(
    num_query=12, num_layers=2, heads=2, hidden_size=128,
    encoder_hidden_size=96, output_size=64, stage_num=(6, 4, 2),
    split_part=(8, 8, 8))


def _t_pool_cfg(cfg):
    return t_perc.PerceiverConfig(**dataclasses.asdict(cfg))


def _randomized(layers, seed):
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


def _pool_params(cfg, seed):
    p = jax.tree_util.tree_map(
        np.asarray, j_perc.init_perceiver_params(jax.random.PRNGKey(seed),
                                                 cfg))
    p["layers"] = _randomized(p["layers"], seed + 1)
    if "in_proj_b" in p:
        p["in_proj_b"] = (0.05 * np.random.default_rng(seed).standard_normal(
            p["in_proj_b"].shape)).astype(np.float32)
    return p


def _feats(cfg, seed, b=2):
    return (np.random.default_rng(seed).standard_normal(
        (b, sum(cfg.split_part), cfg.encoder_hidden_size)) * 0.5).astype(
        np.float32)


def test_in_proj_param_specs_match_jax():
    from lhrs_bot_tpu.models import vlm as j_vlm
    from lhrs_bot_tpu_torch.models.vlm import init_vlm_params

    jcfg = j_vlm.VLMConfig.tiny_test()
    jcfg = dataclasses.replace(jcfg, pooler=dataclasses.replace(
        jcfg.pooler, hidden_size=64, heads=2))
    tcfg = TVLMConfig.tiny_test()
    tcfg = dataclasses.replace(tcfg, pooler=dataclasses.replace(
        tcfg.pooler, hidden_size=64, heads=2))
    want = jax.tree_util.tree_map(
        np.asarray, j_vlm.init_vlm_params(jax.random.PRNGKey(0), jcfg))
    got = init_vlm_params(tcfg, device="cpu")
    assert list(_shapes(got["pooler"])) == list(_shapes(want["pooler"]))
    assert got["pooler"]["in_proj_w"].shape == (32, 64)


def test_in_proj_perceiver_plain_matches_jax():
    """The plain path with an in_proj (96 -> 128), float32: JAX's 2e-4;
    the in_proj's bias dropped (the planted fault) fails it."""
    p, x = _pool_params(POOL_IN, 3), _feats(POOL_IN, 4)
    want = np.asarray(j_perc.perceiver_resample(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), POOL_IN,
        compute_dtype=jnp.float32))
    tp = params_from_numpy(p)
    got = t_perc.perceiver_resample(tp, torch.from_numpy(x),
                                    _t_pool_cfg(POOL_IN), compute_dtype=F32)
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_TOL, atol=JAX_TOL)
    bad = t_perc.perceiver_resample({**tp, "in_proj_b": tp["in_proj_b"] * 0},
                                    torch.from_numpy(x), _t_pool_cfg(POOL_IN),
                                    compute_dtype=F32)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad.numpy(), want, rtol=JAX_TOL,
                                   atol=JAX_TOL)


def test_in_proj_perceiver_fused_matches_jax():
    """The fused W8A8 perceiver with an in_proj against JAX's fused path
    (interpret mode): 1e-2 relative L2; without the in_proj's bias it
    fails."""
    p, x = _pool_params(POOL_IN, 5), _feats(POOL_IN, 6)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    want = j_perc.perceiver_resample_fused(
        jp, j_pb.pack_perceiver_layers_fused(jp["layers"]), jnp.asarray(x),
        POOL_IN, interpret=True)
    tp = params_from_numpy(p)
    packed = t_pb.pack_perceiver_layers_fused(tp["layers"])
    got = t_perc.perceiver_resample_fused(tp, packed, torch.from_numpy(x),
                                          _t_pool_cfg(POOL_IN))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, want) < 1e-2
    bad = t_perc.perceiver_resample_fused(
        {**tp, "in_proj_b": tp["in_proj_b"] * 0}, packed,
        torch.from_numpy(x), _t_pool_cfg(POOL_IN))
    assert _rel_l2(bad, want) > 1e-2


POOL = j_perc.PerceiverConfig.tiny_test()


def _variant(lib, params, name):
    """The parameters of a variant (after quantization for "int8")."""
    if lib == "jax":
        pack = {"hoisted": j_perc.pack_perceiver_kv,
                "folded": j_perc.pack_perceiver_kv_folded}
    else:
        pack = {"hoisted": t_perc.pack_perceiver_kv,
                "folded": t_perc.pack_perceiver_kv_folded}
    return pack[name](params) if name in pack else params


@pytest.mark.parametrize("quant", ["float", "int8"])
@pytest.mark.parametrize("name", ["hoisted", "folded", "batch_groups"])
def test_perceiver_variants_match_jax(name, quant):
    """Each variant of test_models.py:80-150 against JAX's output on the
    same parameters, float32 compute: JAX's 2e-4. The folded bias dropped
    (t @ w left out, the planted fault) fails it."""
    p, x = _pool_params(POOL, 7), _feats(POOL, 8)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = params_from_numpy(p)
    if quant == "int8":
        jp = {**jp, "layers": j_quant.quantize_vision_layers(jp["layers"])}
        tp = {**tp, "layers": t_quant.quantize_vision_layers(tp["layers"])}
    bg = name == "batch_groups"
    want = np.asarray(j_perc.perceiver_resample(
        _variant("jax", jp, name), jnp.asarray(x), POOL,
        compute_dtype=jnp.float32, batch_groups=bg))
    tv = _variant("torch", tp, name)
    got = t_perc.perceiver_resample(tv, torch.from_numpy(x),
                                    _t_pool_cfg(POOL), compute_dtype=F32,
                                    batch_groups=bg)
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_TOL, atol=JAX_TOL)
    if name == "hoisted":
        bad = {**tv, "kv_big_b": tv["kv_big_b"] * 0}
    elif name == "folded":
        bad = {**tv, "layers": {**tv["layers"],
                                "b_kv": tv["layers"]["b_kv"] * 0}}
    else:  # the pad slots left unmasked
        bad_cfg = dataclasses.replace(_t_pool_cfg(POOL), stage_num=(4, 4, 4))
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(
                t_perc.perceiver_resample(tv, torch.from_numpy(x), bad_cfg,
                                          compute_dtype=F32,
                                          batch_groups=True).numpy(),
                want, rtol=JAX_TOL, atol=JAX_TOL)
        return
    out = t_perc.perceiver_resample(bad, torch.from_numpy(x),
                                    _t_pool_cfg(POOL), compute_dtype=F32)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(out.numpy(), want, rtol=JAX_TOL,
                                   atol=JAX_TOL)


@pytest.mark.parametrize("name", ["hoisted", "folded"])
def test_perceiver_packs_match_jax(name):
    """The packed tensors themselves: float leaves within float32
    rounding, int8 codes equal but where the folded float32 weight lies
    within rounding of a half-step (none at these sizes)."""
    p = _pool_params(POOL, 9)
    jp = {**jax.tree_util.tree_map(jnp.asarray, p)}
    tp = params_from_numpy(p)
    for quant in (False, True):
        if quant:
            jp = {**jp, "layers": j_quant.quantize_vision_layers(
                jp["layers"])}
            tp = {**tp, "layers": t_quant.quantize_vision_layers(
                tp["layers"])}
        jv, tv = _variant("jax", jp, name), _variant("torch", tp, name)
        pairs = ([("kv_big_w", jv["kv_big_w"], tv["kv_big_w"]),
                  ("kv_big_b", jv["kv_big_b"], tv["kv_big_b"])]
                 if name == "hoisted" else
                 [("w_kv", jv["layers"]["w_kv"], tv["layers"]["w_kv"]),
                  ("b_kv", jv["layers"]["b_kv"], tv["layers"]["b_kv"])])
        for key, j, t in pairs:
            if quant and key.startswith(("kv_big_w", "w_kv")):
                np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
                np.testing.assert_allclose(t.scale.numpy(),
                                           np.asarray(j.scale), rtol=1e-6)
            else:
                np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                                           rtol=1e-5, atol=1e-6)


# -- the graft entry ---------------------------------------------------------


def _jax_params_to_port(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def test_graft_entry_loss_matches_jax():
    """entry()'s loss on JAX's entry() parameters carried over: bf16 within
    5e-4 relative (read 7.0e-5; float32 within 1e-5); another batch of
    images (zeros, the planted fault: read 3.9e-3) fails it."""
    jfn, (jparams, jbatch) = j_graft.entry()
    want = float(jax.jit(jfn)(jparams, jbatch))
    assert _asdict_eq(t_graft._small_cfg(), j_graft._small_cfg())
    fn, (params, batch) = t_graft.entry(device="cpu")
    for k, v in j_graft._batch(j_graft._small_cfg()).items():
        np.testing.assert_array_equal(batch[k].numpy(), v)
    tparams = _jax_params_to_port(jparams)
    got = float(fn(tparams, batch))
    assert abs(got - want) / abs(want) < 5e-4, (got, want)
    fn32, _ = t_graft.entry(device="cpu", compute_dtype=F32)
    from lhrs_bot_tpu.models.vlm import vlm_forward_loss

    want32 = float(vlm_forward_loss(jparams, j_graft._small_cfg(), jbatch,
                                    compute_dtype=jnp.float32)["total_loss"])
    assert abs(float(fn32(tparams, batch)) - want32) / want32 < 1e-5
    blank = {**batch, "images": torch.zeros_like(batch["images"])}
    assert abs(float(fn(tparams, blank)) - want) / abs(want) > 5e-4


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
def test_graft_dryrun_multichip_four_ranks(tmp_path):
    """dryrun_multichip(4) on four gloo ranks: the dp 2 x tp 2 step, the
    dp 2 x cp 2 ring loss and the tp 4 serving tick (the schedulers' ids
    equal), with the same readings on every rank."""
    ranks = run_ranks(4, "graft", {}, tmp_path, timeout=240)
    r0 = ranks[0]
    assert (r0["dp"], r0["tp"], r0["cp"], r0["serve_tp"]) == (2, 2, 2, 4)
    assert np.isfinite(r0["loss"]) and np.isfinite(r0["cp_loss"])
    assert all(len(ids) == 4 for ids in r0["ids"])
    for r in ranks[1:]:
        assert r["loss"] == r0["loss"] and r["cp_loss"] == r0["cp_loss"]
        assert r["ids"] == r0["ids"]


# -- the profiler ------------------------------------------------------------


def test_profiler_hook_window_on_cpu(tmp_path):
    """ProfilerHook traces iterations [2, 4): the window opens at 2, closes
    after 3 with a trace file; a window that outlasts training ends with
    it; trace() writes one too; the server raises; no card, no stats."""
    hook = t_prof.ProfilerHook(str(tmp_path / "a"), start_step=2,
                               num_steps=2)
    hook.trainer = types.SimpleNamespace(cur_iter=0)
    opened = []
    for it in range(6):
        hook.trainer.cur_iter = it
        hook.before_iter()
        opened.append(hook.active)
        torch.ones(8).sum()
        hook.after_iter()
    hook.after_train()
    assert opened == [False, False, True, True, False, False]
    files = glob.glob(str(tmp_path / "a" / "*.json"))
    assert len(files) == 1 and files == hook.paths
    late = t_prof.ProfilerHook(str(tmp_path / "b"), start_step=1,
                               num_steps=5)
    late.trainer = types.SimpleNamespace(cur_iter=0)
    for it in range(3):
        late.trainer.cur_iter = it
        late.before_iter()
        late.after_iter()
    assert late.active
    late.after_train()
    assert not late.active and len(late.paths) == 1
    with t_prof.trace(str(tmp_path / "c")):
        torch.ones(4).sum()
    assert len(glob.glob(str(tmp_path / "c" / "*.json"))) == 1
    with pytest.raises(NotImplementedError, match="ProfilerHook"):
        t_prof.start_profiler_server()
    assert t_prof.device_memory_stats() == {}


# -- head dims the kernels do not take ----------------------------------------


@pytest.mark.parametrize("d", [16, 48, 96])
def test_head_dim_padding_is_exact(d):
    """The card runs a head dim below 128 that K1 does not take (ViT-B's
    perceiver: 768 / 16 = 48) zero-padded to 64 or 128 at the true head
    dim's scale, the output cut back: the same attention (the plain
    version on padded inputs, against JAX's on the unpadded ones), and its
    gradients too; padding with noise (the planted fault) is not."""
    from lhrs_bot_tpu.ops.attention import mha_reference as j_mha
    from lhrs_bot_tpu_torch.ops import attention as t_att

    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, 3, 20, d)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(20)[None, :] < np.array([20, 13])[:, None]
    want = np.asarray(j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask), causal=True))
    width = t_att.padded_head_dim(d)
    assert width == (64 if d <= 64 else 128)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = t_att.FlashAttention.apply(
        *(t_att.pad_head_dim(t, width) for t in (tq, tk, tv)),
        torch.from_numpy(mask), None, True, d ** -0.5)[..., :d]
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    ref = t_att.FlashAttention.apply(tq, tk, tv, torch.from_numpy(mask),
                                     None, True, d ** -0.5)
    got_g = torch.autograd.grad(out.square().sum(), (tq, tk, tv))
    want_g = torch.autograd.grad(ref.square().sum(), (tq, tk, tv))
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    def noisy(x):  # pad columns that are not zero
        return torch.cat([torch.from_numpy(x), torch.from_numpy(
            rng.standard_normal(x.shape[:-1] + (width - d,)).astype(
                np.float32))], dim=-1)

    bad = t_att.mha_reference(noisy(q), noisy(k), noisy(v),
                              torch.from_numpy(mask), causal=True,
                              sm_scale=d ** -0.5)[..., :d]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad.numpy(), want, rtol=1e-5, atol=1e-5)
