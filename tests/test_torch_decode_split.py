"""The split decode attention of K2 and K4 (csrc/decode_split.cuh) on the CPU.

The kernels split each head's rows across a thread-block cluster of C CTAs;
the pieces of that design that live in Python are held here: the launch
plan (`decode_split_plan`), the shares each rank takes
(`decode_shares`, the mirror of the kernels' arithmetic on the device),
and the plain float32 split-and-merge (`split_decode_attention_plain`)
against the JAX kernels in interpret mode and the port's plain path. The
kernels themselves run only on the card (`chip_smoke.py`).

Tolerances: against the JAX kernels 1e-2 absolute + relative, as the
existing plain-path tests hold them (the int8 kernel rounds q * sm_scale
and p * v_scale to bf16); against the port's own float32 plain path 1e-5
(the same function, its sums in another order). Written rows and scales
are copies and must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.ops import fused_decode as j_fused
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu_torch.ops import fused_decode as t_fused

H = 32
KERNEL_TOL = dict(rtol=1e-2, atol=1e-2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b", [1, 2, 7])
@pytest.mark.parametrize("s", [64, 256, 2304])
def test_split_plan_and_shares(s, b, d):
    """For every length of the cache and every cluster size: the shares
    cover rows 0..len once, start at multiples of 128, and are balanced;
    the plan's C is one of 1, 2, 4, 8, is 1 wherever B * H reaches the SM
    count, and keeps C * B * H within the resident CTAs it assumes."""
    for elt in (1, 2):
        for sm_count in (132, 64, 16):
            c = t_fused.decode_split_plan(b, H, s, d, elt, sm_count)
            assert c in t_fused.SPLITS
            if b * H >= sm_count:
                assert c == 1
            if c > 1:
                assert c * b * H <= t_fused.decode_resident_ctas(
                    d, elt, sm_count)
            assert c <= max(1, -(-s // t_fused.SPLIT_ROWS))
    for length in range(s):
        n = length + 1
        for c in t_fused.SPLITS:
            shares = t_fused.decode_shares(n, c)
            assert len(shares) == c
            pos, sizes = 0, []
            for start, end in shares:
                assert start == pos and end >= start
                if end > start:
                    assert start % t_fused.SPLIT_ROWS == 0
                    sizes.append(end - start)
                pos = end
            assert pos == n
            # every non-empty share but the last holds the same whole blocks
            assert len(set(sizes[:-1])) <= 1
            assert all(z % t_fused.SPLIT_ROWS == 0 for z in sizes[:-1])
            assert sizes[-1] <= sizes[0]


def test_split_plan_on_the_h100():
    """The plan's C for 32 heads of 128 dims at S 2304 on 132 SMs, as the
    card's sweep settled it: 2 at B = 1-4, 1 at B = 5 and 7 (both caches),
    each grid within the 2 CTAs an SM that the kernels' shared memory and
    registers allow."""
    for elt in (1, 2):
        got = [t_fused.decode_split_plan(b, H, 2304, 128, elt, 132)
               for b in (1, 2, 3, 4, 5, 7)]
        assert got == [2, 2, 2, 2, 1, 1]
        assert t_fused.decode_resident_ctas(128, elt, 132) == 2 * 132
        assert t_fused.decode_smem_bytes(128, elt) <= 232448


def test_split_splits_are_checked():
    """A cluster size outside 1, 2, 4, 8 raises before anything launches."""
    x = torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16)
    cache = torch.zeros(1, 1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="splits"):
        t_fused.fused_decode_attention_kernel(
            x, x, x, cache, cache.clone(), torch.zeros(1, dtype=torch.int32),
            0, 0.125, splits=3)
    with pytest.raises(ValueError, match="splits"):
        t_fused.fused_decode_attention_q_kernel(
            x, x, x, x, x, cache, cache, cache, cache,
            torch.zeros(1, dtype=torch.int32), 0, 0.125, splits=16)


# Rows: len 0 (one row, ranks 1.. empty), 127 (one whole block), 128 (the
# appended row alone in a new block: a share boundary at C >= 2) and
# S - 1; at C = 8 most ranks are empty.
S, LENGTHS, LAYER = 384, (0, 127, 128, 383), 1


def _int8_cache(rng, shape):
    kc, ks = j_quant.quantize_activation(
        jnp.asarray(rng.standard_normal(shape), jnp.float32))
    return np.asarray(kc), np.asarray(ks[..., 0])


@pytest.fixture(scope="module")
def bf16_case():
    """Inputs of the bf16-cache kernel (float32 here) and the JAX kernel's
    output and caches, in interpret mode."""
    rng = np.random.default_rng(10)
    nl, b, d = 2, len(LENGTHS), 128
    x = {
        "q": rng.standard_normal((b, 2, 1, d)).astype(np.float32),
        "kn": rng.standard_normal((b, 2, 1, d)).astype(np.float32),
        "vn": rng.standard_normal((b, 2, 1, d)).astype(np.float32),
        "kc": rng.standard_normal((nl, b, 2, S, d)).astype(np.float32),
        "vc": rng.standard_normal((nl, b, 2, S, d)).astype(np.float32),
        "lens": np.asarray(LENGTHS, np.int32),
    }
    x["jax"] = j_fused.fused_decode_attention(
        *(jnp.asarray(x[k]) for k in ("q", "kn", "vn", "kc", "vc", "lens")),
        jnp.int32(LAYER), interpret=True, block_s=128)
    return x


@pytest.fixture(scope="module")
def int8_case():
    """Inputs of the int8-cache kernel and the JAX kernel's output, caches
    and scale planes, in interpret mode."""
    rng = np.random.default_rng(11)
    nl, b, d = 2, len(LENGTHS), 128
    x = {"q": rng.standard_normal((b, 2, 1, d)).astype(np.float32),
         "lens": np.asarray(LENGTHS, np.int32)}
    x["kc"], x["ks"] = _int8_cache(rng, (nl, b, 2, S, d))
    x["vc"], x["vs"] = _int8_cache(rng, (nl, b, 2, S, d))
    x["kn"], x["kns"] = _int8_cache(rng, (b, 2, 1, d))
    x["vn"], x["vns"] = _int8_cache(rng, (b, 2, 1, d))
    x["jax"] = j_fused.fused_decode_attention_q(
        *(jnp.asarray(x[k]) for k in ("q", "kn", "kns", "vn", "vns", "kc",
                                      "vc", "ks", "vs", "lens")),
        jnp.int32(LAYER), int8_dots=False, interpret=True, block_s=128)
    return x


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_plain_bf16_cache(bf16_case, splits):
    x = bf16_case
    want, jk, jv = x["jax"]
    tk, tv = _t(x["kc"]), _t(x["vc"])
    got, k2, v2 = t_fused.fused_decode_attention_split_plain(
        _t(x["q"]), _t(x["kn"]), _t(x["vn"]), tk, tv, _t(x["lens"]), LAYER,
        splits=splits)
    assert k2 is tk and v2 is tv  # updated in place
    plain = t_fused.fused_decode_attention_plain(
        _t(x["q"]), _t(x["kn"]), _t(x["vn"]), _t(x["kc"]), _t(x["vc"]),
        _t(x["lens"]), LAYER)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_array_equal(k2.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v2.numpy(), np.asarray(jv))


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_plain_int8_cache(int8_case, splits):
    x = int8_case
    want, *jcaches = x["jax"]
    names = ("kc", "vc", "ks", "vs")
    caches = [_t(x[k]) for k in names]
    got, *mine = t_fused.fused_decode_attention_q_split_plain(
        *(_t(x[k]) for k in ("q", "kn", "kns", "vn", "vns")), *caches,
        _t(x["lens"]), LAYER, splits=splits)
    assert all(a is c for a, c in zip(mine, caches))  # in place
    plain = t_fused.fused_decode_attention_q_plain(
        *(_t(x[k]) for k in ("q", "kn", "kns", "vn", "vns")),
        *(_t(x[k]) for k in names), _t(x["lens"]), LAYER)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    for a, w in zip(mine, jcaches):
        assert a.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("int8", [False, True])
def test_split_plain_d64_shares(int8):
    """D = 64 at lengths around C = 4's share boundaries (share of 256
    rows at 513 rows: the appended row alone in rank 2, rank 3 empty)
    against the port's plain path, for every cluster size."""
    rng = np.random.default_rng(12)
    b, s, d = 4, 640, 64
    lens = torch.tensor([512, 255, 256, 639], dtype=torch.int32)
    q = _t(rng.standard_normal((b, 2, 1, d)).astype(np.float32))
    kl = _t(rng.standard_normal((b, 2, s, d)).astype(np.float32))
    vl = _t(rng.standard_normal((b, 2, s, d)).astype(np.float32))
    scales = {}
    if int8:
        kl, vl = kl.round().clamp(-127, 127), vl.round().clamp(-127, 127)
        scales = {"k_scale": _t(rng.uniform(0.005, 0.03, (b, 2, s))
                                .astype(np.float32)),
                  "v_scale": _t(rng.uniform(0.005, 0.03, (b, 2, s))
                                .astype(np.float32))}
    from lhrs_bot_tpu_torch.ops.decode_attention import decode_attention

    want = decode_attention(q, kl, vl, lens + 1, sm_scale=d ** -0.5,
                            **scales)
    for splits in t_fused.SPLITS:
        got = t_fused.split_decode_attention_plain(
            q, kl, vl, lens, splits, sm_scale=d ** -0.5, **scales)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_split_plain_fault_leaves_out_the_last_rank():
    """The planted fault (rank 0 leaves the last rank's state out) moves the
    output past the kernels' tolerance where that rank holds rows whose
    values stand apart, and changes nothing where it is empty."""
    rng = np.random.default_rng(13)
    b, s, d = 2, 768, 128
    lens = torch.tensor([700, 100], dtype=torch.int32)
    q = _t(rng.standard_normal((b, 2, 1, d)).astype(np.float32))
    kl = _t(rng.standard_normal((b, 2, s, d)).astype(np.float32))
    vl = _t(rng.standard_normal((b, 2, s, d)).astype(np.float32))
    vl[:, :, 384:] += 4.0  # the last share at C = 2 (rows 384..700)
    ok = t_fused.split_decode_attention_plain(q, kl, vl, lens, 2,
                                              sm_scale=d ** -0.5)
    bad = t_fused.split_decode_attention_plain(q, kl, vl, lens, 2,
                                               sm_scale=d ** -0.5, fault=1)
    err = (bad - ok).abs()
    assert float(err[0].min()) > 0.1  # every output of row 0 moved
    assert float(err[1].max()) == 0.0  # row 1's last rank is empty
