"""The port's int8-dots decode attention (`fused_decode_attention_q(...,
int8_dots=True)`) against the JAX package on CPU.

The plain version is held to the JAX Pallas kernel `_kernel_q` with
`int8_dots=True` in interpret mode, at the JAX test's shapes
(tests/test_ops.py `test_int8_dots_parity`). Both quantize q and each
block's probability row with the same float32 quotients and take both dots
as exact integer sums, so the codes, scales and caches agree exactly and
the outputs nearly so: the two `exp`s may differ by an ulp, and a
probability code that then crosses a rounding tie moves the output by at
most about max(p * v_scale) / l, so the output is held to a median abs
error of 1e-5 (a systematic fault moves the median) and a max of 2e-3. The
decoder step with int8 dots is held to JAX's XLA attention within the JAX
test's 6e-2, and to the JAX kernel with int8 dots at 1e-3 relative L2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import llama as j_llama
from lhrs_bot_tpu.ops import fused_decode as j_fused
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu_torch.core import params_from_numpy
from lhrs_bot_tpu_torch.models import llama as t_llama
from lhrs_bot_tpu_torch.ops import fused_decode as t_fused

L, B, H, S, D = 2, 2, 2, 128, 128
LENGTHS = (5, 97)


def _codes(rng, shape):
    c, s = j_quant.quantize_activation(
        jnp.asarray(rng.normal(size=shape), jnp.float32))
    return np.asarray(c), np.asarray(s[..., 0])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    kc, ks = _codes(rng, (L, B, H, S, D))
    vc, vs = _codes(rng, (L, B, H, S, D))
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    kn, kns = _codes(rng, (B, H, 1, D))
    vn, vns = _codes(rng, (B, H, 1, D))
    return dict(q=q, kn=kn, kns=kns, vn=vn, vns=vns, kc=kc, vc=vc, ks=ks,
                vs=vs, lens=np.asarray(LENGTHS, np.int32))


def _port(inp, layer, **kw):
    caches = [torch.from_numpy(inp[k].copy()) for k in ("kc", "vc", "ks",
                                                         "vs")]
    out, *after = t_fused.fused_decode_attention_q(
        *(torch.from_numpy(inp[k].copy()) for k in ("q", "kn", "kns", "vn",
                                                     "vns")),
        *caches, torch.from_numpy(inp["lens"]), layer, **kw)
    assert all(a is b for a, b in zip(after, caches))  # in place
    return out.numpy(), [c.numpy() for c in caches]


@pytest.mark.parametrize("layer,block_s", [(0, 32), (1, 32), (0, 96),
                                           (1, 96)])
def test_int8_dots_plain_matches_jax_kernel(inputs, layer, block_s):
    want, *j_caches = j_fused.fused_decode_attention_q(
        *(jnp.asarray(inputs[k]) for k in ("q", "kn", "kns", "vn", "vns",
                                           "kc", "vc", "ks", "vs", "lens")),
        jnp.int32(layer), interpret=True, block_s=block_s, int8_dots=True)
    got, caches = _port(inputs, layer, int8_dots=True, block_s=block_s)
    err = np.abs(got - np.asarray(want))
    assert np.median(err) <= 1e-5 and err.max() <= 2e-3, (np.median(err),
                                                          err.max())
    for mine, theirs in zip(caches, j_caches):
        np.testing.assert_array_equal(mine, np.asarray(theirs))


def test_block_s_is_part_of_the_result(inputs):
    """The probability row's scale is taken per block: 32 and 96 give other
    outputs on the row of 98 valid positions."""
    a, _ = _port(inputs, 0, int8_dots=True, block_s=32)
    b, _ = _port(inputs, 0, int8_dots=True, block_s=96)
    assert np.abs(a[1] - b[1]).max() > 1e-6
    np.testing.assert_array_equal(a[0], b[0])  # 6 rows: one block either way


@pytest.mark.parametrize("flag,int8_path", [("1", True), ("0", False),
                                            (None, False)])
def test_env_flag_selects_the_path(inputs, monkeypatch, flag, int8_path):
    """int8_dots=None reads LHRS_DECODE_INT8_DOTS at the call: "1" takes
    the int8-dots plain version, "0" or unset the bf16-dot one."""
    if flag is None:
        monkeypatch.delenv("LHRS_DECODE_INT8_DOTS", raising=False)
    else:
        monkeypatch.setenv("LHRS_DECODE_INT8_DOTS", flag)
    calls = []
    for name in ("fused_decode_attention_q_int8dots_plain",
                 "fused_decode_attention_q_plain"):
        real = getattr(t_fused, name)
        monkeypatch.setattr(t_fused, name, functools.partial(
            lambda real, name, *a, **k: calls.append(name) or real(*a, **k),
            real, name))
    got, _ = _port(inputs, 0)
    assert calls == ["fused_decode_attention_q_int8dots_plain" if int8_path
                     else "fused_decode_attention_q_plain"]
    want, _ = _port(inputs, 0, int8_dots=int8_path)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def llama():
    cfg = j_llama.LlamaConfig.tiny_test()
    params = j_llama.init_llama_params(jax.random.PRNGKey(0), cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    return cfg, params, t_llama.LlamaConfig.tiny_test(), t_params


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("jax_path", ["xla", "kernel"])
def test_decode_step_with_int8_dots_matches_jax(llama, jax_path):
    """Prefill into an int8 cache, then three decode steps with int8 dots:
    against JAX's XLA attention (use_fused=False) within the JAX test's
    6e-2, and against its int8-dots kernel in interpret mode at 1e-3
    relative L2 with the same greedy ids."""
    j_cfg, j_params, t_cfg, t_params = llama
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, 20, t_cfg.hidden_size)).astype(np.float32)
    plen = np.asarray([20, 13], np.int32)
    _, j_cache = j_llama.llama_prefill(
        j_params, j_cfg, j_llama.KVCache.create(j_cfg, 2, 128,
                                                dtype=jnp.int8),
        inputs_embeds=jnp.asarray(emb), prompt_len=jnp.asarray(plen),
        compute_dtype=jnp.float32)
    _, t_cache = t_llama.llama_prefill(
        t_params, t_cfg, t_llama.KVCache.create(t_cfg, 2, 128,
                                                dtype=torch.int8,
                                                device="cpu"),
        inputs_embeds=torch.from_numpy(emb), prompt_len=torch.from_numpy(plen),
        compute_dtype=torch.float32)
    orig = j_fused.fused_decode_attention_q
    j_fused.fused_decode_attention_q = functools.partial(
        orig, interpret=True, int8_dots=True)  # block_s 512, clamped to S
    try:
        for _ in range(3):
            step = rng.standard_normal((2, 1, t_cfg.hidden_size)).astype(
                np.float32)
            j_logits, j_cache = j_llama.llama_decode_step(
                j_params, j_cfg, j_cache, inputs_embeds=jnp.asarray(step),
                compute_dtype=jnp.float32, use_fused=jax_path == "kernel")
            t_logits, t_cache = t_llama.llama_decode_step(
                t_params, t_cfg, t_cache, inputs_embeds=torch.from_numpy(step),
                compute_dtype=torch.float32, int8_dots=True)
            got, want = t_logits.numpy(), np.asarray(j_logits)
            if jax_path == "xla":
                np.testing.assert_allclose(got, want, rtol=6e-2, atol=6e-2)
            else:
                assert _rel_l2(got, want) <= 1e-3
                np.testing.assert_array_equal(got.argmax(-1),
                                              want.argmax(-1))
    finally:
        j_fused.fused_decode_attention_q = orig
