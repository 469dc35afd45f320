"""The port's quantization ops (lhrs_bot_tpu_torch.ops.quant, w4_matmul, the
int8-cache decode attention) against the JAX package on CPU.

Inputs come from numpy's seeded generator and go through both functions.
Integer results are held exactly: int8 / int4 / halves-int4 / NF4 codes,
packed bytes, per-channel scales (the same float32 division), and the W4A8
matmul, whose integer accumulation is exact on both sides and whose float32
epilogue runs in the same order. Float products are held to rtol = atol =
1e-5 (float32 summation order). On the CPU the kernel entry points take
their plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import llama as j_llama
from lhrs_bot_tpu.ops import decode_attention as j_decode
from lhrs_bot_tpu.ops import fused_decode as j_fused
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu.ops import w4_matmul as j_w4
from lhrs_bot_tpu_torch.ops import decode_attention as t_decode
from lhrs_bot_tpu_torch.ops import fused_decode as t_fused
from lhrs_bot_tpu_torch.ops import ln_quant as t_lnq
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.ops import w4_matmul as t_w4

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _equal(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _weight(rng, shape, qmax):
    """Gaussian (..., in, out) weights whose column 0 is all zeros and whose
    column 1 has absmax `qmax` (scale exactly 1) and exact .5 ties."""
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[..., :, 0] = 0.0
    ties = rng.integers(-qmax, qmax, size=shape[:-1]).astype(np.float32)
    w[..., :, 1] = ties + 0.5
    w[..., 0, 1] = qmax
    return w


QUANTIZERS = [("quantize_int8", 127), ("quantize_int4", 7),
              ("quantize_int4h", 7)]


@pytest.mark.parametrize("name,qmax", QUANTIZERS, ids=[q[0] for q in
                                                       QUANTIZERS])
@pytest.mark.parametrize("shape,axis", [((64, 24), -2), ((2, 32, 16), 1)],
                         ids=["2d", "stacked"])
def test_quantizer_codes_and_scales_match_jax(name, qmax, shape, axis):
    w = _weight(np.random.default_rng(0), shape, qmax)
    got = getattr(t_quant, name)(_t(w), axis=axis)
    want = getattr(j_quant, name)(jnp.asarray(w), axis=axis)
    assert got.bits == want.bits
    _equal(got.q, want.q)
    _equal(got.scale, want.scale)
    _equal(t_quant.dequantize(got), j_quant.dequantize(want))


def test_quantize_activation_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    x[0, 0] = 0.0                               # zero row: scale 1
    x[1, 1] = rng.integers(-127, 127, 32) + 0.5  # exact .5 ties
    x[1, 1, 0] = 127.0
    q, s = t_quant.quantize_activation(_t(x))
    jq, js = j_quant.quantize_activation(jnp.asarray(x))
    _equal(q, jq)
    _equal(s, js)
    # bf16 input, as the decoder quantizes its K/V rows
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q, s = t_quant.quantize_activation(xb)
    jq, js = j_quant.quantize_activation(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    _equal(q, jq)
    _equal(s, js)


@pytest.mark.parametrize("pack,unpack", [("pack_int4", "unpack_int4"),
                                         ("pack_int4_halves",
                                          "unpack_int4_halves")])
def test_pack_unpack_round_trip_matches_jax(pack, unpack):
    rng = np.random.default_rng(2)
    q = rng.integers(-8, 8, size=(3, 64, 48)).astype(np.int8)
    packed = getattr(t_quant, pack)(_t(q))
    _equal(packed, getattr(j_quant, pack)(jnp.asarray(q)))
    _equal(getattr(t_quant, unpack)(packed), q)
    # every byte value unpacks as JAX unpacks it
    every = np.arange(-128, 128, dtype=np.int8).reshape(2, 128)
    _equal(getattr(t_quant, unpack)(_t(every)),
           getattr(j_quant, unpack)(jnp.asarray(every)))
    _equal(t_quant.unpack_uint4(_t(every)),
           j_quant.unpack_uint4(jnp.asarray(every)))


@pytest.mark.parametrize("double_quant", [False, True])
def test_nf4_codes_and_absmax_match_jax(double_quant):
    """Identical codes, midpoint ties included; the absmax within 1e-6
    relative (the double-quant mean is a float32 reduction whose order may
    differ)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 128, 40)).astype(np.float32) * 0.02
    w[:, :, 0] = 0.0
    code = np.asarray(t_quant.NF4_CODE, np.float32)
    mid = (code[1:] + code[:-1]) / 2.0
    w[:, :, 1] = 0.0
    w[:, 0, 1] = 1.0            # absmax 1 in the first block of column 1
    w[:, 1:16, 1] = mid         # exact midpoints: the lower code
    got = t_quant.quantize_nf4(_t(w), axis=1, double_quant=double_quant)
    want = j_quant.quantize_nf4(jnp.asarray(w), axis=1,
                                double_quant=double_quant)
    assert got.bits == want.bits == "nf4"
    _equal(got.q, want.q)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6, atol=0)
    if not double_quant:
        idx = t_quant.unpack_uint4(got.q).numpy()
        np.testing.assert_array_equal(idx[:, 1:16, 1],
                                      np.tile(np.arange(15), (2, 1)))
    np.testing.assert_allclose(t_quant.dequantize(got).numpy(),
                               np.asarray(j_quant.dequantize(want)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", [8, 4, "4h", "nf4"])
def test_quantized_matmul_matches_jax(bits):
    """float32 activations: both sides round x to bf16 before the float32
    product, whatever the compute dtype."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((128, 48)).astype(np.float32) * 0.05
    x = rng.standard_normal((2, 3, 128)).astype(np.float32)
    fn = {8: "quantize_int8", 4: "quantize_int4", "4h": "quantize_int4h",
          "nf4": "quantize_nf4"}[bits]
    tq, jq = getattr(t_quant, fn)(_t(w)), getattr(j_quant, fn)(
        jnp.asarray(w))
    for out_dtype, j_dtype in ((None, None), (torch.float32, jnp.float32)):
        got = t_quant.quantized_matmul(_t(x), tq, out_dtype=out_dtype)
        want = j_quant.quantized_matmul(jnp.asarray(x), jq,
                                        out_dtype=j_dtype)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the bf16 cast of x is part of the function: unrounded x differs
    exact = x @ t_quant.dequantize(tq).numpy()
    assert np.abs(got.numpy() - exact).max() > 1e-4


@pytest.mark.parametrize("bits,quant_type", [(8, "nf4"), (4, "nf4"),
                                             (4, "int4h"), (4, "int4")])
def test_quantize_llama_layers_matches_jax(bits, quant_type):
    rng = np.random.default_rng(5)
    layers = {"wq": rng.standard_normal((2, 64, 64)).astype(np.float32),
              "w_down": rng.standard_normal((2, 128, 64)).astype(np.float32),
              "input_norm": np.ones((2, 64), np.float32)}
    got = t_quant.quantize_llama_layers(
        {k: _t(v) for k, v in layers.items()}, bits=bits,
        quant_type=quant_type)
    want = j_quant.quantize_llama_layers(
        {k: jnp.asarray(v) for k, v in layers.items()}, bits=bits,
        quant_type=quant_type)
    for name in ("wq", "w_down"):
        assert got[name].bits == want[name].bits
        _equal(got[name].q, want[name].q)
    assert torch.is_tensor(got["input_norm"])
    back = t_quant.dequantize_llama_layers(got)
    jback = j_quant.dequantize_llama_layers(want)
    for name in layers:
        np.testing.assert_allclose(back[name].numpy(),
                                   np.asarray(jback[name]), rtol=1e-6,
                                   atol=1e-7)


def test_quantized_tensor_layer_view_and_to():
    qt = t_quant.quantize_int8(torch.randn(3, 16, 8), axis=1)
    one = qt[1]
    assert one.q.shape == (16, 8) and one.scale.shape == (1, 8)
    assert one.q.data_ptr() == qt.q[1].data_ptr()  # a view, not a copy
    moved = qt.to("cpu")
    assert moved.bits == 8 and moved.scale.dtype == torch.float32


# (B, K, N) with layer 1 of a 2-layer stack; N = 640 is above 512 and not
# a multiple of it (the TPU kernel's ragged 512-wide block). B = 9 crosses
# the CUDA kernel's 8-row group; K = 776 gives K/2 = 388, not a multiple of
# its 128-row chunks.
W4_CASES = [(1, 64, 640), (5, 64, 640), (5, 128, 96), (3, 64, 640),
            (9, 64, 640), (1, 776, 96), (9, 776, 96)]


@pytest.mark.parametrize("case", W4_CASES, ids=str)
def test_w4a8_project_matches_jax_kernel_exactly(case):
    b, k, n = case
    rng = np.random.default_rng(6)
    w = rng.standard_normal((2, k, n)).astype(np.float32) * 0.05
    x = rng.standard_normal((b, 1, k)).astype(np.float32)
    tq = t_quant.quantize_int4h(_t(w), axis=1)
    jq = j_quant.quantize_int4h(jnp.asarray(w), axis=1)
    got = t_w4.w4a8_project(_t(x), tq, 1)
    want = j_w4.w4a8_project(jnp.asarray(x), jq, jnp.int32(1),
                             interpret=True)
    assert got.shape == (b, 1, n) and got.dtype == torch.float32
    _equal(got, want)


def test_w4a8_matmul_stacked_every_byte():
    """Every packed byte value (both nibbles at their extremes) through the
    plain version, against JAX's interpret-mode kernel, bf16 out."""
    rng = np.random.default_rng(7)
    k2, n, b = 128, 128, 3
    w = np.arange(-128, 128, dtype=np.int8).repeat(n // 2).reshape(1, k2, n)
    w = np.concatenate([w, rng.permutation(w.ravel()).reshape(w.shape)])
    xq = rng.integers(-127, 128, size=(b, 2 * k2)).astype(np.int8)
    xs = rng.random((b, 1)).astype(np.float32) * 0.01
    ws = rng.random((2, 1, n)).astype(np.float32) * 0.1
    for layer in (0, 1):
        got = t_w4.w4a8_matmul_stacked(
            _t(xq[:, :k2]), _t(xq[:, k2:]), _t(xs), _t(w), _t(ws), layer,
            out_dtype=torch.bfloat16)
        want = j_w4.w4a8_matmul_stacked(
            jnp.asarray(xq[:, :k2]), jnp.asarray(xq[:, k2:]),
            jnp.asarray(xs), jnp.asarray(w), jnp.asarray(ws),
            jnp.int32(layer), out_dtype=jnp.bfloat16, interpret=True)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def _kernel_rows(k2, cluster, chunk):
    """The packed rows each CTA of a cluster reads, walked as
    csrc/w4a8_matmul.cu walks them: 32 four-row groups a 128-row step."""
    seen = []
    for rank in range(cluster):
        begin, end = rank * chunk, min((rank + 1) * chunk, k2)
        rows = [r + i for g in range(32)
                for r in range(begin + 4 * g, end, 128) for i in range(4)]
        assert rows, f"CTA {rank} of {cluster} is empty"
        seen += rows
    return seen


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 6, 8])
def test_w4a8_split_k_covers_every_row(cluster):
    """`w4a8_plan`, the cluster geometry that replaced the split-K plan:
    every packed row read exactly once, chunks of whole 128-row steps (at
    most 2048 rows), at most 8 CTAs, none of them empty."""
    for k2, n in ((2048, 4096), (2048, 11008), (5504, 4096), (32, 640),
                  (44, 96), (388, 96), (16384, 4096)):
        c, chunk = t_w4.w4a8_plan(k2, n, cluster)
        assert 1 <= c <= 8 and chunk % 128 == 0 and chunk <= 2048
        assert (c - 1) * chunk < k2 <= c * chunk
        assert c <= max(cluster, -(-k2 // 2048))
        assert sorted(_kernel_rows(k2, c, chunk)) == list(range(k2))
    assert t_w4.w4a8_plan(2048, 4096) == (8, 256)
    assert t_w4.w4a8_plan(5504, 4096, 4) == (4, 1408)
    with pytest.raises(ValueError):
        t_w4.w4a8_plan(2048, 4096, 9)


def test_w4a8_pick_cluster_fits_one_wave():
    """The largest cluster whose clusters all fit on the card at once, 1
    where none does, read from the occupancy the card reports."""
    resident = {8: 45, 6: 62, 4: 92, 3: 124, 2: 198}.__getitem__
    assert t_w4.pick_cluster(32, resident) == 8
    assert t_w4.pick_cluster(86, resident) == 4
    assert t_w4.pick_cluster(124, resident) == 3
    assert t_w4.pick_cluster(500, resident) == 1


LNQ_ROWS = [((32, 128), "kv_b1"), ((7 * 32, 128), "kv_b7"),
            ((1, 11008), "wide"), ((1, 4100), "ragged")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [r[0] for r in LNQ_ROWS],
                         ids=[r[1] for r in LNQ_ROWS])
def test_ln_quant_plain_matches_jax_quantize_activation(shape, dtype):
    """Kernel A's plain quantize-only mode against JAX's
    `quantize_activation` at the int8 cache's K/V rows (B * 32 rows of 128)
    and at single wide rows, codes and scales exact; a zero row and a row
    of exact .5 ties included where there are several rows."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal(shape).astype(np.float32)
    if shape[0] > 2:
        x[0] = 0.0
        x[1] = rng.integers(-127, 127, shape[1]) + 0.5
        x[1, 0] = 127.0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = t_lnq.ln_quant_plain(tx)
    jq, js = j_quant.quantize_activation(
        jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype)))
    _equal(q, jq)
    _equal(s, js)


@pytest.mark.parametrize("w", [128, 1024, 4096, 4100, 11008])
def test_ln_quant_row_plan_covers_every_element(w):
    """Kernel A's row groups: every column of a row read by one lane once,
    every row by one group once, power-of-two groups of 8 to 512 lanes, at
    most 4 chunks a lane, and no lane past the row's end in every chunk."""
    lanes, chunks, rows = t_lnq.row_plan(w)
    assert lanes & (lanes - 1) == 0 and 8 <= lanes <= 512
    assert 1 <= chunks <= 4 and lanes * (chunks - 1) * 16 < w
    assert rows == max(lanes, 256) // lanes
    cols = [col + i for lane in range(lanes) for c in range(chunks)
            for col in [(c * lanes + lane) * 16] for i in range(16)
            if col + i < w]
    assert sorted(cols) == list(range(w))
    for m in (1, 7 * 32, 16448, 16449):
        ctas = -(-m // rows)
        got = [cta * rows + g for cta in range(ctas) for g in range(rows)
               if cta * rows + g < m]
        assert got == list(range(m))


def _int8_cache(rng, shape):
    kc, ks = j_quant.quantize_activation(
        jnp.asarray(rng.standard_normal(shape), jnp.float32))
    return np.asarray(kc), np.asarray(ks[..., 0])


def test_decode_attention_with_scales_matches_jax():
    rng = np.random.default_rng(8)
    b, h, s, d = 2, 3, 40, 64
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    kc, ks = _int8_cache(rng, (b, h, s, d))
    vc, vs = _int8_cache(rng, (b, h, s, d))
    lens = np.asarray([7, 40], np.int32)
    got = t_decode.decode_attention(_t(q), _t(kc), _t(vc), _t(lens),
                                    k_scale=_t(ks), v_scale=_t(vs))
    want = j_decode.decode_attention(
        *map(jnp.asarray, (q, kc, vc, lens)), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# The TPU kernel rounds q * sm_scale and p * v_scale to bf16
# (fused_decode.py:338, :429) where the plain version keeps float32, so the
# plain version is held to the JAX kernel at bf16 resolution (2^-8
# relative on the rounded factors, about 4e-3 on these outputs) and to
# the JAX plain path (the XLA `_write_at` + `decode_attention`) at 1e-5.
KERNEL_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("layer", [0, 1])
def test_fused_decode_attention_q_plain_path(s, layer):
    """As tests/test_ops.py TestFusedDecodeAttentionQ calls the JAX kernel:
    output vs the kernel (interpret mode) and vs the JAX plain path; the
    int8 rows and both scale planes, all layers, exactly equal."""
    rng = np.random.default_rng(s + layer)
    L, B, H, D = 2, 2, 2, 128
    kc, ks = _int8_cache(rng, (L, B, H, s, D))
    vc, vs = _int8_cache(rng, (L, B, H, s, D))
    lens = np.asarray([5, s - 31], np.int32)
    q = rng.standard_normal((B, H, 1, D)).astype(np.float32)
    kn, kns = _int8_cache(rng, (B, H, 1, D))
    vn, vns = _int8_cache(rng, (B, H, 1, D))
    want, jk, jv, jks, jvs = j_fused.fused_decode_attention_q(
        *map(jnp.asarray, (q, kn, kns, vn, vns, kc, vc, ks, vs, lens)),
        jnp.int32(layer), interpret=True, block_s=32)
    plain = j_decode.decode_attention(
        jnp.asarray(q), j_llama._write_at(jnp.asarray(kc[layer]),
                                          jnp.asarray(kn), jnp.asarray(lens)),
        j_llama._write_at(jnp.asarray(vc[layer]), jnp.asarray(vn),
                          jnp.asarray(lens)), jnp.asarray(lens + 1),
        k_scale=j_llama._write_scale_at(jnp.asarray(ks[layer]),
                                        jnp.asarray(kns), jnp.asarray(lens)),
        v_scale=j_llama._write_scale_at(jnp.asarray(vs[layer]),
                                        jnp.asarray(vns), jnp.asarray(lens)))
    tensors = [_t(a) for a in (kc, vc, ks, vs)]
    got, *caches = t_fused.fused_decode_attention_q(
        _t(q), _t(kn), _t(kns), _t(vn), _t(vns), *tensors, _t(lens), layer)
    assert all(a is b for a, b in zip(caches, tensors))  # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    for mine, theirs in zip(caches, (jk, jv, jks, jvs)):
        _equal(mine, theirs)

