"""PyTorch port models (lhrs_bot_tpu_torch.models) against the JAX package.

At `VLMConfig.tiny_test()` the port runs on weights bridged from the JAX
`init_vlm_params(PRNGKey(0))` through `core.convert.params_from_numpy`; both
sides compute in float32 (JAX at matmul precision "highest"). Model outputs,
logits and caches are held to rtol = atol = 1e-4: several layers of float32
matmuls summed in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import llama as j_llama
from lhrs_bot_tpu.models import perceiver as j_perceiver
from lhrs_bot_tpu.models import splice as j_splice
from lhrs_bot_tpu.models import vit as j_vit
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu_torch.core.convert import params_from_numpy
from lhrs_bot_tpu_torch.models import llama as t_llama
from lhrs_bot_tpu_torch.models import perceiver as t_perceiver
from lhrs_bot_tpu_torch.models import splice as t_splice
from lhrs_bot_tpu_torch.models import vit as t_vit
from lhrs_bot_tpu_torch.models import vlm as t_vlm

TOL = dict(rtol=1e-4, atol=1e-4)
F32 = torch.float32


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def models():
    j_cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    j_params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), j_cfg)
    np_params = jax.tree_util.tree_map(np.asarray, j_params)
    return (j_cfg, j_params, t_vlm.VLMConfig.tiny_test(stage=0),
            params_from_numpy(np_params))


def _images(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(b, 28, 28, 3)).astype(np.uint8)


@pytest.mark.parametrize("part", ["vit", "pooler", "llama"])
def test_configs_match(models, part):
    j_cfg, _, t_cfg, _ = models
    assert dataclasses.asdict(getattr(t_cfg, part)) == \
        dataclasses.asdict(getattr(j_cfg, part))


def test_init_params_structure_matches_jax(models):
    """The port's seeded init builds the JAX init's tree: same keys, shapes
    and dtypes."""
    _, _, t_cfg, t_params = models
    fresh = t_vlm.init_vlm_params(t_cfg, seed=3, device="cpu")

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return tuple(tree.shape), tree.dtype

    assert spec(fresh) == spec(t_params)


def test_vit_encode(models):
    j_cfg, j_params, t_cfg, t_params = models
    img = _images(0)
    want = j_vit.vit_encode(j_params["vit"], jnp.asarray(img), j_cfg.vit,
                            compute_dtype=jnp.float32)
    got = t_vit.vit_encode(t_params["vit"], torch.from_numpy(img), t_cfg.vit,
                           compute_dtype=F32)
    assert got.shape == (2, 3 * t_cfg.vit.num_patches, t_cfg.vit.width)
    _close(got, want)


def test_perceiver_resample(models):
    j_cfg, j_params, t_cfg, t_params = models
    feats = np.random.default_rng(1).standard_normal(
        (2, sum(t_cfg.pooler.split_part), t_cfg.pooler.hidden_size)
    ).astype(np.float32)
    want = j_perceiver.perceiver_resample(j_params["pooler"],
                                          jnp.asarray(feats), j_cfg.pooler,
                                          compute_dtype=jnp.float32)
    got = t_perceiver.perceiver_resample(t_params["pooler"],
                                         torch.from_numpy(feats),
                                         t_cfg.pooler, compute_dtype=F32)
    assert got.shape == (2, t_cfg.pooler.num_query, t_cfg.pooler.output_size)
    _close(got, want)


# image marker position per row (None = text-only row) and valid lengths
SPLICE_CASES = [([1, 4], [9, 6]), ([0, None], [9, 9]), ([8, 2], [9, 3])]


@pytest.mark.parametrize("case", SPLICE_CASES, ids=str)
def test_splice_image_embeddings(case):
    marker_pos, valid = case
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 50, size=(2, 9)).astype(np.int32)
    for r, p in enumerate(marker_pos):
        if p is not None:
            ids[r, p] = -200
    mask = np.arange(9)[None, :] < np.asarray(valid)[:, None]
    labels = rng.integers(3, 50, size=(2, 9)).astype(np.int32)
    img = rng.standard_normal((2, 5, 8)).astype(np.float32)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    want = j_splice.splice_image_embeddings(
        *map(jnp.asarray, (ids, img, table, mask, labels)))
    got = t_splice.splice_image_embeddings(
        *map(torch.from_numpy, (ids, img, table, mask, labels)))
    np.testing.assert_array_equal(got.inputs_embeds.numpy(),
                                  np.asarray(want.inputs_embeds))
    np.testing.assert_array_equal(got.attention_mask.numpy(),
                                  np.asarray(want.attention_mask))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.seq_len.numpy(),
                                  np.asarray(want.seq_len))


def test_prepare_multimodal_inputs(models):
    j_cfg, j_params, t_cfg, t_params = models
    ids = np.full((2, 7), 9, np.int32)
    ids[:, 2] = -200
    mask = np.arange(7)[None, :] < np.asarray([7, 5])[:, None]
    img = _images(3)
    want = j_vlm.prepare_multimodal_inputs(
        j_params, j_cfg, jnp.asarray(ids), jnp.asarray(img),
        attention_mask=jnp.asarray(mask), compute_dtype=jnp.float32)
    got = t_vlm.prepare_multimodal_inputs(
        t_params, t_cfg, torch.from_numpy(ids), torch.from_numpy(img),
        attention_mask=torch.from_numpy(mask), compute_dtype=F32)
    _close(got.inputs_embeds, want.inputs_embeds)
    np.testing.assert_array_equal(got.seq_len.numpy(),
                                  np.asarray(want.seq_len))


def _prefill_both(models, s=20, cache_len=32, lens=(20, 13)):
    j_cfg, j_params, t_cfg, t_params = models
    emb = np.random.default_rng(4).standard_normal(
        (2, s, t_cfg.llama.hidden_size)).astype(np.float32)
    plen = np.asarray(lens, np.int32)
    j_cache = j_llama.KVCache.create(j_cfg.llama, 2, cache_len,
                                     dtype=jnp.float32)
    j_out = j_llama.llama_prefill(j_params["llama"], j_cfg.llama, j_cache,
                                  inputs_embeds=jnp.asarray(emb),
                                  prompt_len=jnp.asarray(plen),
                                  compute_dtype=jnp.float32)
    t_cache = t_llama.KVCache.create(t_cfg.llama, 2, cache_len, dtype=F32,
                                     device="cpu")
    t_out = t_llama.llama_prefill(t_params["llama"], t_cfg.llama, t_cache,
                                  inputs_embeds=torch.from_numpy(emb),
                                  prompt_len=torch.from_numpy(plen),
                                  compute_dtype=F32)
    return j_out, t_out


def test_llama_prefill_logits_and_cache(models):
    (j_logits, j_cache), (t_logits, t_cache) = _prefill_both(models)
    _close(t_logits, j_logits)
    _close(t_cache.k, j_cache.k)
    _close(t_cache.v, j_cache.v)
    np.testing.assert_array_equal(t_cache.length.numpy(),
                                  np.asarray(j_cache.length))


def test_llama_decode_chain(models):
    """Three chained decode steps after a prefill: logits and caches."""
    j_cfg, j_params, t_cfg, t_params = models
    (_, j_cache), (_, t_cache) = _prefill_both(models)
    rng = np.random.default_rng(5)
    for _ in range(3):
        emb = rng.standard_normal(
            (2, 1, t_cfg.llama.hidden_size)).astype(np.float32)
        j_logits, j_cache = j_llama.llama_decode_step(
            j_params["llama"], j_cfg.llama, j_cache,
            inputs_embeds=jnp.asarray(emb), compute_dtype=jnp.float32)
        t_logits, t_cache = t_llama.llama_decode_step(
            t_params["llama"], t_cfg.llama, t_cache,
            inputs_embeds=torch.from_numpy(emb), compute_dtype=F32)
        _close(t_logits, j_logits)
        _close(t_cache.k, j_cache.k)
        _close(t_cache.v, j_cache.v)
        np.testing.assert_array_equal(t_cache.length.numpy(),
                                      np.asarray(j_cache.length))


def test_kv_cache_rejects_int8():
    """An int8 cache comes with float32 scale planes at 1 (the quantized
    cache); a dtype with no decode path (float16) is rejected."""
    cfg = t_llama.LlamaConfig.tiny_test()
    cache = t_llama.KVCache.create(cfg, 1, 8, dtype=torch.int8, device="cpu")
    assert cache.quantized and cache.k.dtype == torch.int8
    assert cache.k_scale.shape == cache.k.shape[:-1]
    assert bool((cache.v_scale == 1).all())
    with pytest.raises(NotImplementedError):
        t_llama.KVCache.create(cfg, 1, 8, dtype=torch.float16, device="cpu")


# -- bf16 against JAX --------------------------------------------------------


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _serve_logits(mod, cfg, llama, dtype, fault=None, s=20,
                  lens=(20, 13), steps=3):
    """The prefill logits, then each of `steps` decode steps' logits, of
    `mod` (j_llama or t_llama) with parameters and cache in `dtype`, as
    the engines serve. `fault` plants one: "prompt" drops the last prompt
    row of each sequence, "early" / "late" decode one cache row early /
    late."""
    rng = np.random.default_rng(14)
    emb = rng.standard_normal((2, s, cfg.hidden_size)).astype(np.float32)
    steps_emb = rng.standard_normal(
        (steps, 2, 1, cfg.hidden_size)).astype(np.float32)
    plen = np.asarray(lens, np.int32) - (fault == "prompt")
    if mod is j_llama:
        lp = jax.tree_util.tree_map(lambda x: x.astype(dtype), llama)
        cache = j_llama.KVCache.create(cfg, 2, 48, dtype=dtype)
        arr = jnp.asarray
        cast = lambda x: arr(x).astype(dtype)  # noqa: E731
    else:
        lp = t_vlm.cast_floats(llama, dtype)
        cache = t_llama.KVCache.create(cfg, 2, 48, dtype=dtype, device="cpu")
        arr = torch.as_tensor
        cast = lambda x: arr(x).to(dtype)  # noqa: E731
    logits, cache = mod.llama_prefill(lp, cfg, cache,
                                      inputs_embeds=cast(emb),
                                      prompt_len=arr(plen),
                                      compute_dtype=dtype)
    out = [logits]
    if fault in ("early", "late"):
        length = cache.length + (1 if fault == "late" else -1)
        cache = dataclasses.replace(cache, length=length) \
            if mod is t_llama else cache._replace(length=length)
    for e in steps_emb:
        logits, cache = mod.llama_decode_step(lp, cfg, cache,
                                              inputs_embeds=cast(e),
                                              compute_dtype=dtype)
        out.append(logits)
    return [np.asarray(x.float() if mod is t_llama
                       else x.astype(jnp.float32)) for x in out]


def test_llama_prefill_and_decode_bf16_match_jax(models):
    """llama_prefill and three llama_decode_steps in bf16 (parameters,
    activations and KV cache: the engines' default), port against JAX on
    the same weights. Each call's logits lie within a bf16-scale bound of
    JAX's bf16 logits: relative L2 at most JAX's own bf16-vs-float32
    deviation on the same call, and below 2e-2. q and k are scaled by 10 on
    both sides: at their init scale the tiny model attends almost
    uniformly, and a decode that reads the cache wrong moves the logits by
    less than that bound. Planted faults must exceed it: the last prompt
    row dropped (the prefill), a decode one cache row early or late (each
    decode step)."""
    j_cfg, j_params, t_cfg, _ = models
    llama = jax.tree_util.tree_map(np.asarray, j_params["llama"])
    llama = {**llama, "layers": {**llama["layers"],
                                 "wq": llama["layers"]["wq"] * 10,
                                 "wk": llama["layers"]["wk"] * 10}}
    j_llama_p = jax.tree_util.tree_map(jnp.asarray, llama)
    t_llama_p = params_from_numpy(llama)
    want = _serve_logits(j_llama, j_cfg.llama, j_llama_p, jnp.bfloat16)
    ref32 = _serve_logits(j_llama, j_cfg.llama, j_llama_p, jnp.float32)
    got = _serve_logits(t_llama, t_cfg.llama, t_llama_p, torch.bfloat16)
    bounds = []
    for i, (g, w, r) in enumerate(zip(got, want, ref32)):
        dev, noise = _rel_l2(g, w), _rel_l2(w, r)
        bound = min(max(noise, 1e-6), 2e-2)
        assert dev <= bound, (i, dev, noise)
        bounds.append(bound)
    for fault, calls in (("prompt", range(1)), ("early", range(1, 4)),
                         ("late", range(1, 4))):
        faulty = _serve_logits(t_llama, t_cfg.llama, t_llama_p,
                               torch.bfloat16, fault=fault)
        for i in calls:
            assert _rel_l2(faulty[i], want[i]) > bounds[i], (fault, i)
