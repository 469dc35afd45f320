"""The fused vision blocks' softmax modes (`LHRS_VIT_SOFTMAX`) and int4
vision weights, against the JAX package on the CPU.

The JAX kernels read their mode from `lhrs_bot_tpu.ops.vit_block.
_SOFTMAX_MODE` when they are traced, so each case sets it with
monkeypatch and clears JAX's caches; the port reads the variable at each
call. Weights, inputs and sizes are tests/test_torch_vision.py's (a ViT of
width 128 with 2 heads on 5 tokens padded to 16, the matching perceiver),
the JAX kernels in interpret mode, the port's blocks through their plain
versions (CPU tensors). Both take the port's packed layers, which equal
JAX's byte for byte.

Tolerances, and why:
  * the ViT block in each mode: max-abs within 5e-3 of max|ref|, the bound
    of JAX's own grouped-vs-ungrouped test (tests/test_ops.py:442). The
    rounding points are the same in each mode; float32 sums run in another
    order, so an activation code may flip by one where a quotient lies
    within rounding of a half;
  * the attention alone, each mode's plain version against JAX's
    `_attn_probs_and_norm` on the same scores: 1e-5 relative (the same
    bf16 roundings; exp and exp2 of another library). Measured: 0 to
    1.5e-7; a port mode against another JAX mode reads 1.6e-3 to 0.15;
  * the perceiver block: its kernel takes `jax.nn.softmax` in every mode,
    and so does the port's; the same 5e-3;
  * int4 codes and scales: exact (tests/test_torch_vision.py's
    `test_quantize_vision_layers_byte_identical`); a forward over them
    raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.ops import perceiver_block as j_pb
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu.ops import vit_block as j_vb
from lhrs_bot_tpu_torch.core import params_from_numpy
from lhrs_bot_tpu_torch.models import vit as t_vit
from lhrs_bot_tpu_torch.ops import perceiver_block as t_pb
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.ops import vit_block as t_vb

from .cpu_budget import module_budget
from .test_torch_vision import (BLOCK_TOL, POOL, VIT, _block_input, _close,
                                _images, _layer0, _pool_params, _t,
                                _t_vit_cfg, _vit_params)

# the three modes, and a value the JAX kernels read as exp2_post
MODES = {"jnn": "jnn", "exp2_pre": "exp2_pre", "exp2_post": "exp2_post",
         "other": "exp2_post"}


@pytest.fixture(scope="module", params=list(MODES))
def mode(request):
    """Both packages in `request.param`'s mode (module-scoped, so pytest
    runs each mode's cases together). JAX's caches are cleared where the
    mode its kernels trace changes, and after a mode other than its
    default, so that no later test meets a kernel traced in it."""
    value = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LHRS_VIT_SOFTMAX", value)
        mp.setattr(j_vb, "_SOFTMAX_MODE", value)
        if MODES[value] != "jnn":
            jax.clear_caches()
        yield MODES[value]
    if MODES[value] != "jnn":
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    yield from module_budget()


def test_softmax_mode_is_read_at_each_call(mode):
    assert t_vb.softmax_mode() == mode
    assert t_vb.q_fold(0.125, mode) == j_vb._q_fold(0.125)


def test_attention_plain_matches_jax_probs_and_norm(mode):
    """`attention_plain` against the JAX kernels' `_attn_probs_and_norm`
    and P V on the same bf16 q, k, v (scores already scaled, pad keys
    masked)."""
    rng = np.random.default_rng(21)
    s, d = 16, 64
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal((s, d)),
                                      jnp.bfloat16).astype(jnp.float32))
               for _ in range(3))
    valid = 11
    scores = jnp.asarray(q) @ jnp.asarray(k).T
    scores = jnp.where(jnp.arange(s)[None, :] < valid, scores, -1e30)
    probs, post = j_vb._attn_probs_and_norm(scores)
    want = probs.astype(jnp.float32) @ jnp.asarray(v, jnp.bfloat16).astype(
        jnp.float32)
    if post is not None:
        want = want * jnp.transpose(post)
    tq, tk, tv = (_t(a).to(torch.bfloat16)[None, None] for a in (q, k, v))
    mask = (torch.arange(s) < valid)[None]
    got = t_vb.attention_plain(tq, tk, tv, mask, 1.0, torch.float32, mode)
    np.testing.assert_allclose(got[0, 0].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5 * float(
                                   np.abs(np.asarray(want)).max()))


@functools.lru_cache(maxsize=None)
def _packed(pack, params):
    """Layer 0 of `params()`'s layers packed by the port's `pack`, and the
    same arrays for JAX's kernels: the two packages' packings are byte for
    byte equal (tests/test_torch_vision.py), so no JAX packing runs here
    (arrays: JAX's cache clears leave them)."""
    layer = _layer0(pack(params_from_numpy(params()["layers"])), "torch")
    return {k: jnp.asarray(v.numpy()) for k, v in layer.items()}, layer


# "other" reads as exp2_post (the test above)
@pytest.mark.parametrize("mode", ["jnn", "exp2_pre", "exp2_post"],
                         indirect=True)
def test_fused_vit_block_matches_jax_in_each_mode(mode):
    jlp, tlp = _packed(t_vb.pack_vit_layers_fused, _vit_params)
    jx, tx = _block_input(1, 22)
    kw = dict(heads=VIT.heads, s_valid=VIT.seq_len, quick_gelu=True)
    want = j_vb.fused_vit_block(jx, jlp, interpret=True, **kw)
    got = t_vb.fused_vit_block(tx, tlp, **kw)
    assert torch.equal(got, t_vb.fused_vit_block_plain(tx, tlp, **kw))
    _close(got, np.asarray(want, np.float32), BLOCK_TOL, f"mode {mode}")


# the default mode's case is tests/test_torch_vision.py's
@pytest.mark.parametrize("mode", ["exp2_pre", "exp2_post"], indirect=True)
def test_fused_perceiver_block_normalises_first_in_every_mode(mode):
    jlp, tlp = _packed(t_pb.pack_perceiver_layers_fused, _pool_params)
    rng = np.random.default_rng(23)
    # one group (the first level's 6 queries): the softmax is per group
    q_pad, kv_pad, nq = 16, 32, POOL.stage_num[:1]
    kv_valid = tuple(n + 8 for n in nq)
    q = np.zeros((1, 1, q_pad, 128), np.float32)
    kv = np.zeros((1, 1, kv_pad, 128), np.float32)
    for g, n in enumerate(nq):
        q[:, g, :n] = rng.standard_normal((1, n, 128)) * 0.5
        kv[:, g, :n] = q[:, g, :n]
        kv[:, g, q_pad:q_pad + 8] = rng.standard_normal((1, 8, 128)) * 0.5
    jq, jkv = jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16)
    kw = dict(heads=POOL.heads, group_nq=nq, kv_valid=kv_valid)
    want = j_pb.fused_perceiver_block(jq, jkv, jlp, interpret=True, **kw)
    got = t_pb.fused_perceiver_block(
        _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16),
        _t(np.asarray(jkv.astype(jnp.float32))).to(torch.bfloat16), tlp,
        **kw)
    _close(got, want, BLOCK_TOL, f"perceiver, mode {mode}")


def test_int4_vision_forward_raises():
    """A tower over int4 vision weights: the port raises ValueError naming
    the cause; JAX's W8A8 product, where its tower reaches the first
    projection, fails on the packed (in / 2, out) shape."""
    params = _vit_params()
    imgs = _images(1, 24)
    jq = j_quant.quantize_int4(jnp.asarray(params["layers"]["wq"][0]))
    with pytest.raises(TypeError):
        j_quant.w8a8_matmul(jnp.ones((2, VIT.width)), jq)
    tparams = params_from_numpy(params)
    tparams["layers"] = t_quant.quantize_vision_layers(tparams["layers"],
                                                       bits=4)
    with pytest.raises(ValueError, match="int8 weights"):
        t_vit.vit_encode(tparams, _t(imgs), _t_vit_cfg())
    with pytest.raises(ValueError, match="int8 weights"):
        t_quant.w8a8_matmul(torch.ones(2, VIT.width),
                            tparams["layers"]["wq"][0])
