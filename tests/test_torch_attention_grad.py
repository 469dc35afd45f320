"""The port's attention forward with LSE and segment ids, its plain flash
backward and the autograd wiring, against the JAX package on the CPU.

Inputs come from numpy's seeded generator and go through both sides. The
JAX side is the Pallas forward and backward kernels in interpret mode (as
tests/test_ops.py runs them) and, for autograd, `jax.vjp` of the JAX
`flash_attention` (its XLA path on the CPU). Float32 within 1e-5; bf16
within 2e-2 relative L2 (the two sides round to bf16 at the same points
but sum in another order, so a value near a rounding boundary may land one
bf16 step away). On the CPU the port runs its plain versions, so the
kernels' launch counters stay at 0; the CUDA kernels are held against these
plain versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from lhrs_bot_tpu.ops import attention as j_attention
from lhrs_bot_tpu_torch.ops import attention as t_attention

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_REL_L2 = 2e-2


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _segments(b, s, lengths):
    seg = np.zeros((b, s), np.int32)
    for row in range(b):
        pos = 0
        for i, n in enumerate(lengths[row]):
            seg[row, pos:pos + n] = i + 1
            pos += n
    return seg


# (name, B, H, Sq, Skv, D, causal, mask / segments)
CASES = [
    ("causal_kv_mask_d64", 2, 2, 100, 100, 64, True, "mask"),
    ("causal_kv_mask_d128", 1, 2, 130, 130, 128, True, "mask"),
    ("causal_segments_d64", 2, 2, 96, 96, 64, True, "seg"),
    ("causal_segments_d128", 1, 2, 70, 70, 128, True, "seg"),
    ("noncausal_rect_d64", 2, 2, 48, 200, 64, False, None),
    ("noncausal_rect_d128", 1, 3, 40, 77, 128, False, None),
]


def _case(case):
    name, b, h, sq, skv, d, causal, extra = case
    rng = np.random.default_rng(sum(map(ord, name)))
    q, k, v, do = (_normal(rng, b, h, sq, d), _normal(rng, b, h, skv, d),
                   _normal(rng, b, h, skv, d), _normal(rng, b, h, sq, d))
    mask = seg = None
    if extra == "mask":
        mask = np.arange(skv)[None, :] < np.asarray([skv - 17, skv])[:b, None]
        mask = np.array(np.broadcast_to(mask, (b, skv)))
    elif extra == "seg":
        # packed segments and a segment-0 padding tail
        seg = _segments(b, sq, [[30, 1, sq - 45], [sq - 10]][:b])
    return q, k, v, do, mask, seg, causal, d ** -0.5


def _jax_fwd_bwd(q, k, v, do, mask, seg, causal, scale, dtype):
    """The JAX Pallas kernels (interpret mode): out, lse (B, H, Sq), dq, dk,
    dv as float32 numpy."""
    j = lambda x: jnp.asarray(x, dtype)  # noqa: E731
    jm = None if mask is None else jnp.asarray(mask)
    js = None if seg is None else jnp.asarray(seg)
    out, lse = j_attention._flash_attention_pallas(
        j(q), j(k), j(v), jm, causal, scale, interpret=True, block_q=128,
        block_k=128, return_lse=True, segment_ids=js)
    dq, dk, dv = j_attention._flash_attention_bwd_pallas(
        j(q), j(k), j(v), jm, out, lse, j(do), causal, scale,
        interpret=True, block_q=128, block_k=128, segment_ids=js)
    b, h, sq, _ = q.shape
    lse = np.asarray(lse)[:, :sq, 0].reshape(b, h, sq)
    return tuple(np.asarray(x.astype(jnp.float32)) for x in
                 (out, dq, dk, dv)) + (lse,)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(np.array(x)).to(dtype)


def _masks(mask, seg):
    return (None if mask is None else torch.from_numpy(mask),
            None if seg is None else torch.from_numpy(seg))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_forward_lse_and_backward_float32(case):
    """mha_reference(return_lse=True) and flash_attention_bwd_reference
    against the JAX forward and backward kernels, float32."""
    q, k, v, do, mask, seg, causal, scale = _case(case)
    out_j, dq_j, dk_j, dv_j, lse_j = _jax_fwd_bwd(q, k, v, do, mask, seg,
                                                  causal, scale, jnp.float32)
    tm, ts = _masks(mask, seg)
    out, lse = t_attention.mha_reference(
        _t(q), _t(k), _t(v), tm, causal=causal, sm_scale=scale,
        segment_ids=ts, return_lse=True)
    np.testing.assert_allclose(out.numpy(), out_j, **TOL)
    valid = lse_j < 1e29
    np.testing.assert_allclose(lse.numpy()[valid], lse_j[valid], **TOL)
    assert (lse.numpy()[~valid] == 1e30).all()
    if seg is not None:
        assert (~valid).any()  # the padding tail: rows with no valid key
    dq, dk, dv = t_attention.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), tm, ts, out, lse, _t(do), causal, scale)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_plain_forward_and_backward_bf16(case):
    """The same in bf16: the forward from the same inputs, the backward
    from the JAX kernel's own out and LSE, so it is held at its rounding
    points (dS rounded to bf16 for dQ and dK only, float32 P for dV)."""
    q, k, v, do, mask, seg, causal, scale = _case(case)
    out_j, dq_j, dk_j, dv_j, lse_j = _jax_fwd_bwd(q, k, v, do, mask, seg,
                                                  causal, scale, jnp.bfloat16)
    tm, ts = _masks(mask, seg)
    bf = torch.bfloat16
    out, lse = t_attention.mha_reference(
        _t(q, bf), _t(k, bf), _t(v, bf), tm, causal=causal, sm_scale=scale,
        segment_ids=ts, return_lse=True)
    assert out.dtype == bf
    assert _rel_l2(out.float().numpy(), out_j) < BF16_REL_L2
    valid = lse_j < 1e29
    np.testing.assert_allclose(lse.numpy()[valid], lse_j[valid], rtol=1e-5,
                               atol=1e-4)
    dq, dk, dv = t_attention.flash_attention_bwd_reference(
        _t(q, bf), _t(k, bf), _t(v, bf), tm, ts, _t(out_j, bf),
        torch.from_numpy(np.array(lse_j)), _t(do, bf), causal, scale)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == bf
        assert _rel_l2(got.float().numpy(), want) < BF16_REL_L2


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_autograd_matches_jax_vjp(case):
    """torch.autograd through the port's flash_attention (the
    FlashAttention Function, plain pair on the CPU) against jax.vjp of the
    JAX flash_attention (XLA path on the CPU), float32. Upstream gradients
    at rows with no valid key are zero, as in training (their logits meet
    IGNORE labels): the JAX reference gives those rows uniform weights,
    where the kernels give 0."""
    q, k, v, do, mask, seg, causal, scale = _case(case)
    if seg is not None:
        do = do * (seg != 0)[:, None, :, None]
    tm, ts = _masks(mask, seg)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = t_attention.flash_attention(qt, kt, vt, tm, causal=causal,
                                      segment_ids=ts)
    out.backward(_t(do))

    def fn(q_, k_, v_):
        return j_attention.flash_attention(
            q_, k_, v_, None if mask is None else jnp.asarray(mask),
            causal=causal, segment_ids=None if seg is None
            else jnp.asarray(seg))

    out_j, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    rows = np.ones(q.shape[:3], bool) if seg is None else np.broadcast_to(
        (seg != 0)[:, None, :], q.shape[:3])
    np.testing.assert_allclose(out.detach().numpy()[rows],
                               np.asarray(out_j)[rows], **TOL)
    for got, want in zip((qt.grad, kt.grad, vt.grad), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert t_attention.flash_attention_fwd.launches == 0
    assert t_attention.flash_attention_bwd_dq.launches == 0
    assert t_attention.flash_attention_bwd_dkv.launches == 0


def test_no_grad_and_checkpoint():
    """Under no_grad no graph is built; under torch.utils.checkpoint
    (non-reentrant, the remat of llama_apply) the gradients equal the plain
    autograd ones."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(_normal(rng, 1, 2, 40, 64)) for _ in range(3))
    seg = torch.from_numpy(_segments(1, 40, [[15, 20]]))
    with torch.no_grad():
        out = t_attention.flash_attention(q.requires_grad_(), k, v,
                                          causal=True, segment_ids=seg)
    assert out.grad_fn is None

    def f(x):
        return t_attention.flash_attention(x * 2.0, k, v, causal=True,
                                           segment_ids=seg).square().sum()

    x1 = q.detach().clone().requires_grad_()
    f(x1).backward()
    x2 = q.detach().clone().requires_grad_()
    torch.utils.checkpoint.checkpoint(f, x2, use_reentrant=False).backward()
    assert torch.equal(x1.grad, x2.grad)


def test_backward_kernel_wrappers_reject_cpu_tensors():
    x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        t_attention.flash_attention_bwd_dq(x, x, x, None, None, rows, rows, x,
                                           True, 0.125)
    with pytest.raises(ValueError):
        t_attention.flash_attention_bwd_dkv(x, x, x, None, None, rows, rows,
                                            x, True, 0.125)
    with pytest.raises(ValueError):
        t_attention.flash_attention_bwd(x, x, x, None, None, x, rows, x,
                                        True, 0.125)
    assert t_attention.flash_attention_bwd_dq.launches == 0
    assert t_attention.flash_attention_bwd_dkv.launches == 0
