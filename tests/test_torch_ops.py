"""PyTorch port ops (lhrs_bot_tpu_torch.ops) against the JAX package on CPU.

Inputs come from numpy's seeded generator and go through both functions.
Both sides run in float32 (JAX at matmul precision "highest", see
conftest.py), so the only difference is summation order: ops are held to
rtol = atol = 1e-5. Cache rows written by the decode append are copies and
must be exactly equal. On the CPU the kernel entry points take their plain
versions, and the CUDA kernels' launch counters stay at 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.ops import attention as j_attention
from lhrs_bot_tpu.ops import decode_attention as j_decode
from lhrs_bot_tpu.ops import fused_decode as j_fused
from lhrs_bot_tpu.ops import mlp as j_mlp
from lhrs_bot_tpu.ops import patch_embed as j_patch
from lhrs_bot_tpu.ops import rmsnorm as j_norm
from lhrs_bot_tpu.ops import rope as j_rope
from lhrs_bot_tpu_torch.ops import attention as t_attention
from lhrs_bot_tpu_torch.ops import cuda_lib
from lhrs_bot_tpu_torch.ops import decode_attention as t_decode
from lhrs_bot_tpu_torch.ops import fused_decode as t_fused
from lhrs_bot_tpu_torch.ops import mlp as t_mlp
from lhrs_bot_tpu_torch.ops import patch_embed as t_patch
from lhrs_bot_tpu_torch.ops import rmsnorm as t_norm
from lhrs_bot_tpu_torch.ops import rope as t_rope
from lhrs_bot_tpu_torch.ops import w4_matmul as t_w4

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 64)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x, w = _normal(rng, *shape), _normal(rng, shape[-1])
    _close(t_norm.rms_norm(_t(x), _t(w)),
           j_norm.rms_norm(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 64)])
def test_layer_norm(shape):
    rng = np.random.default_rng(1)
    x = _normal(rng, *shape, scale=3.0) + 0.5
    w, b = _normal(rng, shape[-1]), _normal(rng, shape[-1])
    _close(t_norm.layer_norm(_t(x), _t(w), _t(b)),
           j_norm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("head_dim", [16, 128])
def test_rope(head_dim):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 2300, size=(2, 7)).astype(np.int32)
    x = _normal(rng, 2, 7, 3, head_dim)
    tc, ts = t_rope.rope_cos_sin(_t(pos), head_dim)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), head_dim)
    _close(tc, jc)
    _close(ts, js)
    _close(t_rope.apply_rope(_t(x), tc, ts),
           j_rope.apply_rope(jnp.asarray(x), jc, js))


def test_silu_mlp():
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 5, 16)
    wg, wu, wd = (_normal(rng, 16, 24, scale=0.2),
                  _normal(rng, 16, 24, scale=0.2),
                  _normal(rng, 24, 16, scale=0.2))
    _close(t_mlp.silu_mlp(_t(x), _t(wg), _t(wu), _t(wd)),
           j_mlp.silu_mlp(*map(jnp.asarray, (x, wg, wu, wd))))


@pytest.mark.parametrize("quick_gelu", [True, False])
def test_gelu_mlp(quick_gelu):
    rng = np.random.default_rng(4)
    x = _normal(rng, 2, 5, 16)
    wf, bf = _normal(rng, 16, 32, scale=0.3), _normal(rng, 32)
    wp, bp = _normal(rng, 32, 16, scale=0.3), _normal(rng, 16)
    _close(t_mlp.gelu_mlp(*map(_t, (x, wf, bf, wp, bp)),
                          quick_gelu=quick_gelu),
           j_mlp.gelu_mlp(*map(jnp.asarray, (x, wf, bf, wp, bp)),
                          quick_gelu=quick_gelu))


def test_dense_any():
    rng = np.random.default_rng(5)
    x, w, b = _normal(rng, 3, 8), _normal(rng, 8, 4), _normal(rng, 4)
    _close(t_mlp.dense_any(_t(x), _t(w), _t(b)),
           j_mlp.dense_any(*map(jnp.asarray, (x, w, b))))


def test_patch_embed():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, size=(2, 28, 28, 3)).astype(np.uint8)
    w = _normal(rng, 14 * 14 * 3, 32, scale=0.02)
    _close(t_patch.patchify(_t(img), 14),
           j_patch.patchify(jnp.asarray(img), 14), rtol=0, atol=0)
    _close(t_patch.patch_embed(_t(img), _t(w), patch=14,
                               compute_dtype=torch.float32),
           j_patch.patch_embed(jnp.asarray(img), jnp.asarray(w), patch=14,
                               compute_dtype=jnp.float32))


# (B, H, Sq, Skv, D, causal, masked). In the masked cases the last batch
# row has no valid key: the kernels and the port give 0 there, where the JAX
# mha_reference gives uniform weights, so that row is held against the
# kernel alone.
FLASH_CASES = [
    (1, 2, 64, 64, 64, False, False),
    (2, 2, 100, 100, 128, True, False),
    (2, 2, 37, 150, 64, False, True),
    (1, 2, 50, 130, 64, True, False),
    (2, 1, 200, 77, 128, False, True),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_flash_attention_plain_path(case):
    b, h, sq, skv, d, causal, masked = case
    rng = np.random.default_rng(sq * 1000 + skv)
    q, k, v = (_normal(rng, b, h, sq, d), _normal(rng, b, h, skv, d),
               _normal(rng, b, h, skv, d))
    mask = None
    if masked:
        mask = rng.random((b, skv)) > 0.3
        mask[:, 0] = True
        mask[-1] = False
    scale = d ** -0.5
    got = t_attention.flash_attention(
        _t(q), _t(k), _t(v), None if mask is None else _t(mask),
        causal=causal)
    jm = None if mask is None else jnp.asarray(mask)
    want_kernel = j_attention._flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, causal, scale,
        interpret=True, block_q=128, block_k=128)
    want_ref = j_attention.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, causal=causal)
    _close(got, want_kernel)
    rows = slice(None) if mask is None else mask.any(axis=1)
    _close(got[rows], np.asarray(want_ref)[rows])
    if mask is not None:
        assert not got[~rows].any()  # exactly 0, as the kernels give


def test_flash_attention_segment_ids_plain_path():
    """Sequence packing: two segments and a segment-0 padding tail per row,
    against the JAX kernel (interpret mode) with in-kernel segment masking.
    Padding rows attend nothing and give exactly 0 on both sides."""
    rng = np.random.default_rng(9)
    b, h, s, d = 2, 2, 60, 64
    q, k, v = (_normal(rng, b, h, s, d) for _ in range(3))
    seg = np.zeros((b, s), np.int32)
    seg[0, :25], seg[0, 25:52] = 1, 2
    seg[1, :40] = 1
    got = t_attention.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                      segment_ids=_t(seg))
    want = j_attention._flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, True,
        d ** -0.5, interpret=True, block_q=128, block_k=128,
        segment_ids=jnp.asarray(seg))
    _close(got, want)
    assert not got.numpy()[np.broadcast_to((seg == 0)[:, None, :],
                                           (b, h, s))].any()


def test_decode_attention():
    rng = np.random.default_rng(7)
    q, kc, vc = (_normal(rng, 2, 3, 1, 64), _normal(rng, 2, 3, 24, 64),
                 _normal(rng, 2, 3, 24, 64))
    lens = np.asarray([5, 24], np.int32)
    _close(t_decode.decode_attention(_t(q), _t(kc), _t(vc), _t(lens)),
           j_decode.decode_attention(*map(jnp.asarray, (q, kc, vc, lens))))


@pytest.mark.parametrize("layer", [0, 1])
def test_fused_decode_attention_plain_path(layer):
    """The shape of tests/test_ops.py TestFusedDecodeAttention: output vs
    the JAX kernel (interpret mode), the written rows exact, every other row
    and layer untouched."""
    rng = np.random.default_rng(0)
    L, B, H, S, D = 2, 2, 2, 32, 128
    kc, vc = _normal(rng, L, B, H, S, D), _normal(rng, L, B, H, S, D)
    lens = np.asarray([5, 17], np.int32)
    q, kn, vn = (_normal(rng, B, H, 1, D), _normal(rng, B, H, 1, D),
                 _normal(rng, B, H, 1, D))
    want, jk, jv = j_fused.fused_decode_attention(
        *map(jnp.asarray, (q, kn, vn, kc, vc, lens)), jnp.int32(layer),
        interpret=True, block_s=16)
    tk, tv = _t(kc), _t(vc)
    got, k2, v2 = t_fused.fused_decode_attention(
        _t(q), _t(kn), _t(vn), tk, tv, _t(lens), layer)
    assert k2 is tk and v2 is tv  # updated in place
    _close(got, want)
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(jv))
    expect_k = kc.copy()
    for b, p in enumerate(lens):
        expect_k[layer, b, :, p] = kn[b, :, 0]
    np.testing.assert_array_equal(k2.numpy(), expect_k)


def test_cpu_tensors_leave_kernel_counters_at_zero():
    rng = np.random.default_rng(8)
    x = _t(_normal(rng, 1, 2, 8, 64))
    t_attention.flash_attention(x, x, x, causal=True)
    cache = torch.zeros(1, 1, 2, 8, 64)
    t_fused.fused_decode_attention(x[:, :, :1], x[:, :, :1], x[:, :, :1],
                                   cache, cache.clone(),
                                   torch.tensor([3], dtype=torch.int32), 0)
    row8, scale = torch.ones(1, 2, 1, 64, dtype=torch.int8), torch.ones(1, 2,
                                                                        1)
    cache8, planes = cache.to(torch.int8), torch.ones(1, 1, 2, 8)
    t_fused.fused_decode_attention_q(x[:, :, :1], row8, scale, row8, scale,
                                     cache8, cache8.clone(), planes,
                                     planes.clone(),
                                     torch.tensor([3], dtype=torch.int32), 0)
    xq = torch.ones(2, 32, dtype=torch.int8)
    t_w4.w4a8_matmul_stacked(xq, xq, torch.ones(2, 1),
                             torch.ones(1, 32, 16, dtype=torch.int8),
                             torch.ones(1, 1, 16), 0)
    assert t_attention.flash_attention_fwd.launches == 0
    assert t_fused.fused_decode_attention_kernel.launches == 0
    assert t_fused.fused_decode_attention_q_kernel.launches == 0
    assert t_w4.w4a8_matmul_kernel.launches == 0


def test_kernel_wrappers_reject_cpu_tensors():
    x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        t_attention.flash_attention_fwd(x, x, x, None, False, 0.125)
    cache = torch.zeros(1, 1, 2, 8, 64, dtype=torch.bfloat16)
    row = x[:, :, :1].contiguous()
    with pytest.raises(ValueError):
        t_fused.fused_decode_attention_kernel(
            row, row, row, cache, cache.clone(),
            torch.zeros(1, dtype=torch.int32), 0, 0.125)
    row8, scale = row.to(torch.int8), torch.ones(1, 2, 1)
    cache8, planes = cache.to(torch.int8), torch.ones(1, 1, 2, 8)
    with pytest.raises(ValueError):
        t_fused.fused_decode_attention_q_kernel(
            row, row8, scale, row8, scale, cache8, cache8.clone(), planes,
            planes.clone(), torch.zeros(1, dtype=torch.int32), 0, 0.125)
    xq = torch.ones(2, 32, dtype=torch.int8)
    with pytest.raises(ValueError):
        t_w4.w4a8_matmul_kernel(xq, xq, torch.ones(2, 1),
                                torch.ones(1, 32, 16, dtype=torch.int8),
                                torch.ones(1, 1, 16), 0)
    with pytest.raises(ValueError):
        t_w4.w4a8_project_kernel(torch.ones(2, 64, dtype=torch.bfloat16),
                                 torch.ones(1, 32, 16, dtype=torch.int8),
                                 torch.ones(1, 1, 16), 0)
    assert t_attention.flash_attention_fwd.launches == 0
    assert t_fused.fused_decode_attention_kernel.launches == 0
    assert t_fused.fused_decode_attention_q_kernel.launches == 0
    assert t_w4.w4a8_matmul_kernel.launches == 0


def test_kernel_library_key_covers_shared_headers(tmp_path, monkeypatch):
    """The wgmma kernels include csrc/sm90.cuh: the library's build
    directory must change when that header changes, and not otherwise."""
    assert "sm90.cuh" in [h.name for h in cuda_lib._headers()]
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "sm90.cuh"\n')
    (src / "sm90.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_lib, "CSRC", src)
    monkeypatch.setattr(cuda_lib, "BUILD_ROOT", tmp_path / "build")
    first = cuda_lib.library_path()
    assert first == cuda_lib.library_path()
    assert first.parent.parent == tmp_path / "build"
    (src / "sm90.cuh").write_text("// v2\n")
    assert cuda_lib.library_path() != first
    (src / "sm90.cuh").write_text("// v1\n")
    assert cuda_lib.library_path() == first
    (src / "a.cu").write_text("// edited\n")
    assert cuda_lib.library_path() != first
