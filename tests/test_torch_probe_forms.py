"""The int8 probe's two computations on the card (`chain_form`) against the
JAX package's five TPU chain kernels, run in TPU interpret mode on CPU.

`benchmarks/int8_probe.py` is loaded by path, unchanged, at M = K = N = 256
(one cluster rank's quarter of the columns is 64 wide) with 3 and 4
products: at odd NDOTS `_k_int8_alt`'s last product is the transposed one,
so its window is acc[:128, :8]^T. Each variant's chain computed the way the
kernels compute it (`form_chain`: the accumulating or the requantized (M, N)
chain of `chain_form`, the window in the form's orientation) must give the
TPU kernel's (g, 8, 128) output bit for bit (bf16 within 1e-2 relative: float32
sums in another order); a planted fault, every requantized row's amax over
the first quarter of the columns, must not. XLA compiles the TPU kernels'
`amax / 127.0` on the CPU as amax * RN(1/127), which is a bit off the exact
quotient in some rows and, at a near tie, moves a code (a seeded 256-wide
case here does); the kernels take the exact quotient, as the port's
plain versions do. So the forms are held to JAX with XLA's scale
(`xla_scale=True`), and, with the exact one, to the port's per-variant
plain chains, which the kernels are held to on the card. `kernel_plan` must
refuse every shape the CUDA kernels do not take, and take the probe's and
`chip_smoke.py`'s.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lhrs_bot_tpu_torch.benchmarks import int8_probe as t_int8
from lhrs_bot_tpu_torch.ops.ln_quant import div_exact

REPO = Path(__file__).resolve().parents[1]
SIZE = 256
KERNELS = {"int8": "_k_int8", "int8_req": "_k_int8_req",
           "int8_lhsT": "_k_int8_lhsT", "int8_alt": "_k_int8_alt",
           "bf16": "_k_bf16"}


def _requant_rows(acc, cols, xla_scale):
    """The requantization of `int8_probe._requant` along the rows, its amax
    over the first `cols` columns alone (all of them, or one cluster rank's
    quarter: the planted fault); with `xla_scale`, s = amax * RN(1/127), as
    XLA rewrites the TPU kernels' division by the constant on the CPU."""
    f = acc.float() * t_int8.INV127
    amax = f[:, :cols].abs().amax(dim=-1, keepdim=True)
    s = amax * t_int8.INV127 if xla_scale else div_exact(amax, 127.0)
    s = torch.where(amax == 0, torch.ones_like(amax), s)
    return torch.clamp(torch.round(f / s), -127, 127).to(torch.int8)


def form_chain(xg, ws, variant, fault=False, xla_scale=False):
    """A variant's chain computed as the kernels compute it: its
    `chain_form`'s (M, N) computation, the window in the form's
    orientation, the sum added (wrapping for int8). `fault`: every
    requantized row's amax over the first quarter of the columns, as one
    of four CTAs splitting N would take it without its peers' maxima."""
    kind, trans = t_int8.chain_form(variant, ws.shape[0])
    k = xg.shape[2]
    outs = []
    for x in xg:
        if variant == "bf16":
            acc = sum(torch.matmul(x.float(), w.float()) for w in ws)
        elif kind == "accumulate":
            acc = sum(t_int8._dot(x, w) for w in ws)
        else:
            h = x
            for w in ws:
                acc = t_int8._dot(h, w)
                cols = acc.shape[1] // 4 if fault else acc.shape[1]
                h = _requant_rows(acc, cols, xla_scale)[:, :k]
        win = acc[:128, :8].transpose(0, 1) if trans else acc[:8, :128]
        out = win + acc.sum()
        outs.append(out if variant == "bf16" else t_int8._wrap32(out))
    return torch.stack(outs)


@pytest.fixture(scope="module")
def j_int8():
    spec = importlib.util.spec_from_file_location(
        "jax_int8_probe_forms", REPO / "benchmarks" / "int8_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.M = module.K = module.N = SIZE
    return module


def _operands(variant, ndots, seed):
    """Numpy-seeded (g, M, K) blocks and (ndots, K, N) weights, as JAX
    arrays and as the port's tensors (the weights in the kernels' layout)."""
    rng = np.random.default_rng(seed)
    g = 2
    if variant == "bf16":
        jx = jnp.asarray(rng.normal(size=(g, SIZE, SIZE)) * 0.1, jnp.bfloat16)
        jw = jnp.asarray(rng.normal(size=(ndots, SIZE, SIZE)) * 0.1,
                         jnp.bfloat16)

        def to_t(a):
            return torch.from_numpy(np.asarray(a.astype(jnp.float32))
                                    ).bfloat16()
    else:
        jx = jnp.asarray(rng.integers(-127, 127, (g, SIZE, SIZE)), jnp.int8)
        jw = jnp.asarray(rng.integers(-127, 127, (ndots, SIZE, SIZE)),
                         jnp.int8)

        def to_t(a):
            return torch.from_numpy(np.asarray(a))
    return jx, jw, to_t(jx), t_int8.weight_storage(to_t(jw))


def _tpu_chain(module, variant, ndots, xg, ws):
    """The (g, 8, 128) output of `_pl_repeat`'s pallas_call at `ndots`
    products (its run returns only the float32 sum of it)."""
    seen = {}
    real, saved = pl.pallas_call, module.NDOTS

    def spy(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*operands):
            seen["out"] = call(*operands)
            return seen["out"]
        return run

    module.pl.pallas_call, module.NDOTS = spy, ndots
    try:
        out_dtype = jnp.float32 if variant == "bf16" else jnp.int32
        with pltpu.force_tpu_interpret_mode():
            module._pl_repeat(getattr(module, KERNELS[variant]),
                              xg.shape[0], out_dtype)(xg, ws)
    finally:
        module.pl.pallas_call, module.NDOTS = real, saved
    return np.asarray(seen["out"])


@pytest.mark.parametrize("ndots", [3, 4])
@pytest.mark.parametrize("variant", list(KERNELS))
def test_chain_forms_match_the_tpu_kernels(j_int8, variant, ndots):
    jx, jw, tx, tw = _operands(variant, ndots, 10 + ndots)
    want = _tpu_chain(j_int8, variant, ndots, jx, jw)
    got = form_chain(tx, tw, variant, xla_scale=True).numpy()
    assert got.shape == (2, 8, 128)
    if variant == "bf16":
        np.testing.assert_allclose(got, want, rtol=1e-2)
    else:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # the two blocks' windows differ, so a window taken from the wrong
    # block, or the wrong orientation, could not match
    assert not np.array_equal(want[0], want[1])


@pytest.mark.parametrize("ndots", [3, 4])
@pytest.mark.parametrize("variant", ["int8_req", "int8_alt"])
def test_planted_amax_fault_differs_from_the_tpu_kernels(j_int8, variant,
                                                         ndots):
    jx, jw, tx, tw = _operands(variant, ndots, 20 + ndots)
    want = _tpu_chain(j_int8, variant, ndots, jx, jw)
    np.testing.assert_array_equal(
        form_chain(tx, tw, variant, xla_scale=True).numpy(),
        want)
    bad = form_chain(tx, tw, variant, fault=True,
                                  xla_scale=True).numpy()
    assert not np.array_equal(bad, want)


@pytest.mark.parametrize("ndots", [1, 3, 4])
@pytest.mark.parametrize("variant", list(KERNELS))
def test_chain_forms_match_the_plain_variants(variant, ndots):
    """With the exact scale, each form gives the port's per-variant plain
    chain (the TPU kernels' five forms, written out) bit for bit; the
    planted fault does not."""
    _, _, tx, tw = _operands(variant, ndots, 30 + ndots)
    want = t_int8.int8_chain_plain(tx, tw, variant)
    torch.testing.assert_close(form_chain(tx, tw, variant),
                               want, rtol=0, atol=0)
    if variant in ("int8_req", "int8_alt") and ndots > 1:
        assert not torch.equal(
            form_chain(tx, tw, variant, fault=True), want)


def test_xla_scale_moves_a_code_at_a_near_tie():
    """The seeded case where XLA's scale and the exact quotient give
    another code: the TPU kernels (compiled by XLA on the CPU) follow the
    former, the port's plain chain the latter."""
    _, _, tx, tw = _operands("int8_req", 4, 14)
    assert not torch.equal(
        form_chain(tx, tw, "int8_req", xla_scale=True),
        form_chain(tx, tw, "int8_req"))


def test_chain_form_table():
    assert t_int8.chain_form("int8", 16) == ("accumulate", False)
    assert t_int8.chain_form("bf16", 3) == ("accumulate", False)
    assert t_int8.chain_form("int8_lhsT", 16) == ("accumulate", True)
    assert t_int8.chain_form("int8_req", 3) == ("requant", False)
    assert t_int8.chain_form("int8_alt", 16) == ("requant", False)
    assert t_int8.chain_form("int8_alt", 3) == ("requant", True)
    with pytest.raises(ValueError, match="variant"):
        t_int8.chain_form("int4", 2)


# (g, M, K, N, ndots, variant, element bytes): shapes the CUDA kernels do
# not take
REFUSED = {
    "M not a multiple of 128": (2, 192, 256, 256, 2, "int8", 1),
    "N not a multiple of 256": (2, 128, 256, 128, 2, "int8", 1),
    "K bytes not a multiple of 128": (2, 128, 200, 256, 2, "int8", 1),
    "bf16 K of 96 (192 bytes)": (2, 128, 96, 256, 2, "bf16", 2),
    "requant K != N": (2, 128, 512, 256, 2, "int8_req", 1),
    "int8_alt K != N": (2, 128, 256, 512, 3, "int8_alt", 1),
    "requant K = N > 1024": (2, 128, 2048, 2048, 2, "int8_alt", 1),
    "requant over 65535 row tiles": (65536, 128, 256, 256, 2, "int8_req", 1),
    "lhsT M not a multiple of 128": (2, 64, 256, 256, 2, "int8_lhsT", 1),
    "no products": (2, 128, 256, 256, 0, "int8", 1),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_plan_refuses_shapes_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        t_int8.kernel_plan(*REFUSED[case])


@pytest.mark.parametrize("variant", list(KERNELS))
def test_kernel_plan_takes_the_probe_and_smoke_shapes(variant):
    elt = 2 if variant == "bf16" else 1
    kind, trans = t_int8.chain_form(variant, t_int8.NDOTS)
    assert t_int8.kernel_plan(t_int8.G, t_int8.M, t_int8.K, t_int8.N,
                              t_int8.NDOTS, variant, elt) == (
        kind == "requant", trans)
    # chip_smoke.py's other cases: M = K = N = 256, 3 products, 2 blocks
    # (int8_alt's transposed window); one block of M 128 at K = N 512 and
    # 768 (the requantized kernel's clusters of 2 and 3)
    req, win_t = t_int8.kernel_plan(2, 256, 256, 256, 3, variant, elt)
    assert win_t == (variant in ("int8_lhsT", "int8_alt"))
    for n, ndots in ((512, 2), (768, 3)):
        assert t_int8.kernel_plan(1, 128, n, n, ndots, variant, elt)[0] == (
            variant in ("int8_req", "int8_alt"))
