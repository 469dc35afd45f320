"""The port's quantized serving path against the JAX package on CPU.

Model level: LLaMA `tiny_test` on the JAX `init_llama_params(PRNGKey(0))`
weights, quantized by each package's own `quantize_llama_layers`, prefilled
and decoded in float32 by both. Engine level: `VLMConfig.tiny_test(stage=0)`
weights from the JAX `init_vlm_params(PRNGKey(0))` as a numpy tree, served
by both engines.

Tolerances. The quantized products round the activation to bf16 on both
sides, so a float32 difference of summation order (1e-7 relative) can move
one activation across a bf16 rounding boundary (2^-9 relative) and the
W4A8 path's per-token int8 activation across an int8 one; logits are
therefore held to 1e-3 relative L2 (not elementwise 1e-5), with identical
greedy ids. Against the TPU int8-cache kernel in interpret mode, which
rounds q * sm_scale and p * v_scale to bf16 where the port's plain version
keeps float32, the bound is the same 1e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import llama as j_llama
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.ops import fused_decode as j_fused
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu_torch.core import params_from_numpy
from lhrs_bot_tpu_torch.models import llama as t_llama
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.serve import engine as t_engine

F32 = torch.float32
REL_L2 = 1e-3


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_logits(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    assert _rel_l2(got, want) <= REL_L2
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))


@pytest.fixture(scope="module")
def llama():
    cfg = j_llama.LlamaConfig.tiny_test()
    params = j_llama.init_llama_params(jax.random.PRNGKey(0), cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    return cfg, params, t_llama.LlamaConfig.tiny_test(), t_params


# weights: (bits, quant_type) for quantize_llama_layers
WEIGHTS = {"int8": (8, "nf4"), "int4h": (4, "int4h"), "nf4": (4, "nf4")}


def _quantized(llama, weights):
    _, j_params, _, t_params = llama
    bits, qt = WEIGHTS[weights]
    jq = {**j_params, "layers": j_quant.quantize_llama_layers(
        j_params["layers"], bits=bits, quant_type=qt)}
    tq = {**t_params, "layers": t_quant.quantize_llama_layers(
        t_params["layers"], bits=bits, quant_type=qt)}
    return jq, tq


def _prefill(llama, j_params, t_params, cache_dtype, s=20, cache_len=128):
    j_cfg, _, t_cfg, _ = llama
    emb = np.random.default_rng(4).standard_normal(
        (2, s, t_cfg.hidden_size)).astype(np.float32)
    plen = np.asarray([20, 13], np.int32)
    j_cache = j_llama.KVCache.create(
        j_cfg, 2, cache_len,
        dtype=jnp.int8 if cache_dtype == torch.int8 else jnp.float32)
    j_out = j_llama.llama_prefill(j_params, j_cfg, j_cache,
                                  inputs_embeds=jnp.asarray(emb),
                                  prompt_len=jnp.asarray(plen),
                                  compute_dtype=jnp.float32)
    t_cache = t_llama.KVCache.create(t_cfg, 2, cache_len, dtype=cache_dtype,
                                     device="cpu")
    t_out = t_llama.llama_prefill(t_params, t_cfg, t_cache,
                                  inputs_embeds=torch.from_numpy(emb),
                                  prompt_len=torch.from_numpy(plen),
                                  compute_dtype=F32)
    return j_out, t_out


def test_prefill_into_int8_cache_matches_jax(llama):
    """Codes equal except where the unrounded value sits on a rounding tie
    (within float32 noise of .5); scales equal within float32 noise; the
    untouched rows keep codes 0 and scales 1."""
    j_params, t_params = llama[1], llama[3]
    (j_logits, j_cache), (t_logits, t_cache) = _prefill(
        llama, j_params, t_params, torch.int8)
    _check_logits(t_logits, j_logits)
    # the port's float K/V of the same prefill, to locate rounding ties
    _, (_, f_cache) = _prefill(llama, j_params, t_params, F32)
    for arr, scale, j_arr, j_scale, fresh in (
            (t_cache.k, t_cache.k_scale, j_cache.k, j_cache.k_scale,
             f_cache.k),
            (t_cache.v, t_cache.v_scale, j_cache.v, j_cache.v_scale,
             f_cache.v)):
        np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale),
                                   rtol=1e-5, atol=0)
        diff = arr.numpy().astype(np.int32) - np.asarray(j_arr, np.int32)
        assert np.abs(diff).max() <= 1
        ratio = (fresh / scale[..., None]).numpy()[diff != 0]
        assert np.all(np.abs(np.abs(ratio - np.trunc(ratio)) - 0.5) < 1e-3)
        assert (diff != 0).mean() < 1e-3
    assert not t_cache.k[:, :, :, 20:].any()
    assert bool((t_cache.k_scale[:, :, :, 20:] == 1).all())


@pytest.mark.parametrize("weights", ["int8", "int4h", "nf4"])
def test_decode_with_quantized_weights_matches_jax(llama, weights):
    """Prefill then three decode steps over a float32 cache. "4h" weights
    decode W4A8 on both sides: the port's plain W4A8 path against JAX with
    use_w4=True (its interpret-mode kernel)."""
    j_cfg, _, t_cfg, _ = llama
    j_params, t_params = _quantized(llama, weights)
    (j_logits, j_cache), (t_logits, t_cache) = _prefill(
        llama, j_params, t_params, F32)
    _check_logits(t_logits, j_logits)
    rng = np.random.default_rng(5)
    for _ in range(3):
        emb = rng.standard_normal((2, 1, t_cfg.hidden_size)).astype(
            np.float32)
        j_logits, j_cache = j_llama.llama_decode_step(
            j_params, j_cfg, j_cache, inputs_embeds=jnp.asarray(emb),
            compute_dtype=jnp.float32, use_w4=weights == "int4h")
        t_logits, t_cache = t_llama.llama_decode_step(
            t_params, t_cfg, t_cache, inputs_embeds=torch.from_numpy(emb),
            compute_dtype=F32)
        _check_logits(t_logits, j_logits)
        np.testing.assert_array_equal(t_cache.length.numpy(),
                                      np.asarray(j_cache.length))


@pytest.mark.parametrize("jax_path", ["xla", "kernel"])
def test_decode_over_int8_cache_matches_jax(llama, jax_path):
    """Three decode steps over the int8 cache: against JAX's scale-folded
    XLA path (use_fused=False) and against its fused_decode_attention_q in
    interpret mode (use_fused=True), as tests/test_ops.py patches it."""
    j_cfg, j_params, t_cfg, t_params = llama
    (_, j_cache), (_, t_cache) = _prefill(llama, j_params, t_params,
                                          torch.int8)
    rng = np.random.default_rng(6)
    orig = j_fused.fused_decode_attention_q
    j_fused.fused_decode_attention_q = functools.partial(
        orig, interpret=True, block_s=32)
    try:
        for _ in range(3):
            emb = rng.standard_normal((2, 1, t_cfg.hidden_size)).astype(
                np.float32)
            j_logits, j_cache = j_llama.llama_decode_step(
                j_params, j_cfg, j_cache, inputs_embeds=jnp.asarray(emb),
                compute_dtype=jnp.float32, use_fused=jax_path == "kernel")
            t_logits, t_cache = t_llama.llama_decode_step(
                t_params, t_cfg, t_cache,
                inputs_embeds=torch.from_numpy(emb), compute_dtype=F32)
            _check_logits(t_logits, j_logits)
    finally:
        j_fused.fused_decode_attention_q = orig
    # the appended rows: codes within one step of a tie, scales close
    diff = t_cache.k.numpy().astype(np.int32) - np.asarray(j_cache.k,
                                                           np.int32)
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() < 1e-3
    np.testing.assert_allclose(t_cache.k_scale.numpy(),
                               np.asarray(j_cache.k_scale), rtol=1e-5)


def test_int8_lm_head_matches_jax(llama):
    j_cfg, j_params, t_cfg, t_params = llama
    x = np.random.default_rng(7).standard_normal(
        (3, t_cfg.hidden_size)).astype(np.float32)
    jq = j_quant.quantize_int8(jnp.asarray(j_params["lm_head"]), axis=0)
    tq = t_quant.quantize_int8(t_params["lm_head"], axis=0)
    want = j_llama._lm_head_logits(jnp.asarray(x), jq, jnp.float32)
    got = t_llama._lm_head_logits(torch.from_numpy(x), tq)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- engine level ----------------------------------------------------------


@pytest.fixture(scope="module")
def vlm_weights():
    j_cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), j_cfg)
    return j_cfg, jax.tree_util.tree_map(np.asarray, params)


def _request(seed, lens=(11, 6)):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 200, size=(len(lens), max(lens))).astype(np.int32)
    for r, n in enumerate(lens):
        ids[r, n:] = 0
        ids[r, 1] = -200
    imgs = rng.integers(0, 256, size=(len(lens), 28, 28, 3)).astype(np.uint8)
    return ids, np.asarray(lens, np.int32), imgs


def _engines(vlm_weights, **kwargs):
    j_cfg, np_params = vlm_weights
    j_kwargs = {k: (jnp.int8 if v is torch.int8 else v)
                for k, v in kwargs.items()}
    je = j_engine.GenerationEngine(j_cfg, np_params, max_seq_len=128,
                                   compute_dtype=jnp.float32, **j_kwargs)
    te = t_engine.GenerationEngine(
        t_vlm.VLMConfig.tiny_test(stage=0), params_from_numpy(np_params),
        max_seq_len=128, compute_dtype=F32, device="cpu", **kwargs)
    return je, te


def _same_codes(je, te):
    """Identical codes; identical scales, except NF4's double-quantized
    absmax, whose float32 mean may be summed in another order (1e-6)."""
    for name, qt in te.llama_params["layers"].items():
        if isinstance(qt, t_quant.QuantizedTensor):
            jq = je.llama_params["layers"][name]
            np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jq.q))
            np.testing.assert_allclose(
                qt.scale.numpy(), np.asarray(jq.scale), atol=0,
                rtol=1e-6 if qt.bits == "nf4" else 0)
    head = te.llama_params["lm_head"]
    if isinstance(head, t_quant.QuantizedTensor):
        np.testing.assert_array_equal(
            head.q.numpy(), np.asarray(je.llama_params["lm_head"].q))


def test_int8_engine_greedy_matches_jax(vlm_weights):
    """bits 8 + int8 KV cache + int8 lm_head: identical codes and greedy
    ids from the two GenerationEngines (both decode on the CPU's plain
    paths)."""
    je, te = _engines(vlm_weights, quantize_bits=8, lm_head_bits=8,
                      cache_dtype=torch.int8)
    _same_codes(je, te)
    ids, lens, imgs = _request(0)
    gcfg = dict(max_new_tokens=8, eos_token_id=2)
    want = je.generate(ids, lens, images=imgs,
                       gen_cfg=j_engine.GenerationConfig(**gcfg))
    got = te.generate(ids, lens, images=imgs,
                      gen_cfg=t_engine.GenerationConfig(**gcfg))
    assert got == want


def _cut_at_eos(rows, eos=2):
    return [row[:row.index(eos)] if eos in row else row for row in rows]


def test_w4a8_engine_greedy_matches_jax_loop(vlm_weights):
    """"4h" weights + int8 KV cache + int8 lm_head. The JAX engine on the
    CPU decodes "4h" weights W4A16 (its W4A8 kernel is gated to the TPU,
    lhrs_bot_tpu/models/llama.py:658-662), which would hold the port to the
    wrong activation precision; the reference is therefore a JAX loop of
    the engine's own prefill and `llama_decode_step(use_w4=True)`, greedy,
    on the JAX engine's quantized parameters."""
    je, te = _engines(vlm_weights, quantize_bits="4h", lm_head_bits=8,
                      cache_dtype=torch.int8)
    _same_codes(je, te)
    ids, lens, imgs = _request(1, lens=(13, 9))
    new = 6
    got = te.generate(ids, lens, images=imgs,
                      gen_cfg=t_engine.GenerationConfig(max_new_tokens=new))
    width, cache_len = je._bucketed(ids.shape[1], je.cfg.pooler.num_query,
                                    new)
    logits, cache = je._prefill_jit(
        je.params, je.llama_params, None,
        jnp.asarray(je._pad_ids(ids, width, 0)), jnp.asarray(imgs),
        jnp.asarray(lens), batch=len(ids), cache_len=cache_len)
    toks = [np.asarray(jnp.argmax(logits, -1))]
    for _ in range(new - 1):
        emb = jnp.take(je.llama_params["embed_tokens"],
                       jnp.asarray(toks[-1])[:, None], axis=0)
        logits, cache = j_llama.llama_decode_step(
            je.llama_params, je.cfg.llama, cache, inputs_embeds=emb,
            compute_dtype=jnp.float32, use_w4=True)
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    want = _cut_at_eos(np.stack(toks, 1).tolist())
    assert got == want


def test_nf4_engine_quantizes_after_the_cast(vlm_weights):
    """bits 4 (NF4) and the int8 lm_head without quantized layers take the
    JAX engine's cast-then-quantize route: the same codes."""
    je, te = _engines(vlm_weights, quantize_bits=4, quant_type="nf4")
    _same_codes(je, te)
    je, te = _engines(vlm_weights, lm_head_bits=8)
    _same_codes(je, te)
    assert not isinstance(te.llama_params["layers"]["wq"],
                          t_quant.QuantizedTensor)


def test_kv_cache_create_int8_matches_jax(llama):
    j_cfg, _, t_cfg, _ = llama
    j_cache = j_llama.KVCache.create(j_cfg, 2, 16, dtype=jnp.int8)
    t_cache = t_llama.KVCache.create(t_cfg, 2, 16, dtype=torch.int8,
                                     device="cpu")
    assert t_cache.quantized and j_cache.quantized
    for name in ("k", "v", "k_scale", "v_scale", "length"):
        got, want = getattr(t_cache, name), getattr(j_cache, name)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not dataclasses.replace(t_cache, k_scale=None).quantized
