"""The port's measurement probes (`lhrs_bot_tpu_torch.benchmarks`) against
the JAX package's TPU probes, run in TPU interpret mode on CPU.

`benchmarks/hbm_peak_probe.py` and `benchmarks/int8_probe.py` are loaded by
path, unchanged. The readers: the TPU reader takes the max of each block's
first row, the port's every element, so the inputs hold each block's max
in its first row and the two arrays' largest values in one block, where
the two definitions agree; on general inputs the port is held to numpy's
max. The chains run at M = K = N = 128 with 4 products (M >= 128 for
`_k_int8_lhsT`'s acc[:8, :128]) and g = 2; the int8 variants must agree
exactly, the bf16 chain within 1e-2 relative (float32 sums in another
order).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lhrs_bot_tpu_torch.benchmarks import hbm_peak_probe as t_hbm
from lhrs_bot_tpu_torch.benchmarks import int8_probe as t_int8

REPO = Path(__file__).resolve().parents[1]
BLOCK_ROWS = 32


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def j_hbm():
    return _load("hbm_peak_probe")


def _blocks(rng, dtype, peak):
    """(256, 512) values whose every 32-row block has its max in row 0 and
    whose largest value, `peak`, sits in block 2."""
    if dtype == "int8":
        x = rng.integers(-100, 90, (256, 512)).astype(np.float32)
        x[::BLOCK_ROWS, :8] = rng.integers(90, 100, (256 // BLOCK_ROWS, 8))
    else:
        x = rng.normal(size=(256, 512)).astype(np.float32)
        x[::BLOCK_ROWS, :8] = 5.0 + rng.random((256 // BLOCK_ROWS, 8))
    x[2 * BLOCK_ROWS, 3] = peak
    return x


def _pair(x, dtype):
    if dtype == "int8":
        return jnp.asarray(x, jnp.int8), torch.from_numpy(x).to(torch.int8)
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_readers_match_the_tpu_readers(j_hbm, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(_blocks(rng, dtype, 120 if dtype == "int8" else 9.5),
                   dtype)
    jy, ty = _pair(_blocks(rng, dtype, 110 if dtype == "int8" else 8.25),
                   dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_hbm.pallas_reader(jx, BLOCK_ROWS))
        want2 = np.asarray(j_hbm.pallas_dual_reader(jx, jy, BLOCK_ROWS))
    np.testing.assert_array_equal(t_hbm.hbm_read(tx).numpy(), want)
    np.testing.assert_array_equal(t_hbm.hbm_dual_read(tx, ty).numpy(), want2)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_readers_take_every_element(dtype):
    """On general inputs (the max anywhere) the port reads numpy's max."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(77, 48)).astype(np.float32) * 30
    y = rng.normal(size=(77, 48)).astype(np.float32) * 30
    _, tx = _pair(x, dtype)
    _, ty = _pair(y, dtype)
    ref_x, ref_y = tx.float().numpy(), ty.float().numpy()
    assert float(t_hbm.hbm_read(tx)) == ref_x.max()
    assert float(t_hbm.hbm_dual_read(tx, ty)) == np.float32(
        ref_x.max() + ref_y.max())


@pytest.fixture(scope="module")
def j_int8():
    module = _load("int8_probe")
    module.M, module.K, module.N, module.NDOTS = 128, 128, 128, 4
    return module


KERNELS = {"int8": "_k_int8", "int8_req": "_k_int8_req",
           "int8_lhsT": "_k_int8_lhsT", "int8_alt": "_k_int8_alt",
           "bf16": "_k_bf16"}


def _tpu_chain(module, variant, xg, ws, monkeypatch):
    """The (g, 8, 128) output of `_pl_repeat`'s pallas_call (its run
    returns only the float32 sum of it, which is checked too)."""
    seen = {}
    real = pl.pallas_call

    def spy(*args, **kwargs):
        call = real(*args, **kwargs)

        def run(*operands):
            seen["out"] = call(*operands)
            return seen["out"]
        return run

    monkeypatch.setattr(module.pl, "pallas_call", spy)
    out_dtype = jnp.float32 if variant == "bf16" else jnp.int32
    with pltpu.force_tpu_interpret_mode():
        total = module._pl_repeat(getattr(module, KERNELS[variant]),
                                  xg.shape[0], out_dtype)(xg, ws)
    monkeypatch.undo()
    np.testing.assert_allclose(
        float(total), float(jnp.sum(seen["out"].astype(jnp.float32))),
        rtol=1e-6)
    return np.asarray(seen["out"])


@pytest.mark.parametrize("variant", list(KERNELS))
def test_chains_match_the_tpu_kernels(j_int8, variant, monkeypatch):
    rng = np.random.default_rng(2)
    g, m, k, n, nd = 2, 128, 128, 128, 4
    if variant == "bf16":
        jx = jnp.asarray(rng.normal(size=(g, m, k)) * 0.1, jnp.bfloat16)
        jw = jnp.asarray(rng.normal(size=(nd, k, n)) * 0.1, jnp.bfloat16)

        def to_t(a):
            return torch.from_numpy(np.asarray(a.astype(jnp.float32))
                                    ).bfloat16()
    else:
        jx = jnp.asarray(rng.integers(-127, 127, (g, m, k)), jnp.int8)
        jw = jnp.asarray(rng.integers(-127, 127, (nd, k, n)), jnp.int8)

        def to_t(a):
            return torch.from_numpy(np.asarray(a))
    want = _tpu_chain(j_int8, variant, jx, jw, monkeypatch)
    got = t_int8.int8_chain(to_t(jx), t_int8.weight_storage(to_t(jw)),
                            variant).numpy()
    assert got.shape == (g, 8, 128)
    if variant == "bf16":
        np.testing.assert_allclose(got, want, rtol=1e-2)
    else:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_chain_sums_wrap_like_int32():
    """acc[:8, :128] + sum(acc) wraps modulo 2^32: a chain whose sum passes
    2^31 comes out as JAX's int32 arithmetic gives it."""
    x = torch.full((1, 128, 256), 127, dtype=torch.int8)
    w = torch.full((2, 256, 256), 127, dtype=torch.int8)
    got = t_int8.int8_chain(x, w, "int8")
    acc = 2 * 256 * 127 * 127
    total = acc * 128 * 256
    want = np.int64(acc + total)
    want = np.int32(((want + 2 ** 31) % 2 ** 32) - 2 ** 31)
    assert total > 2 ** 31
    assert bool((got == int(want)).all())


def test_probe_kernels_take_only_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        t_hbm.hbm_read_kernel(torch.zeros(64, dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        t_int8.int8_chain_kernel(torch.zeros(1, 128, 128, dtype=torch.int8),
                                 torch.zeros(1, 128, 128, dtype=torch.int8),
                                 "int8")


def _filled(dtype, shape, seed):
    """A small buffer below `FILL_MAX`, as `buffers` fills the 1.4 GB
    ones."""
    gen = torch.Generator().manual_seed(seed)
    if dtype == "int8":
        top = t_hbm.FILL_MAX[torch.int8]
        return torch.randint(-top, top + 1, shape, generator=gen,
                             dtype=torch.int8)
    top = t_hbm.FILL_MAX[torch.bfloat16]
    return torch.randn(shape, generator=gen).clamp_(-top, top).bfloat16()


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_check_reader_reads_back_every_planted_maximum(dtype, dual):
    x = _filled(dtype, (64, 512), 3)
    arrays = (x, _filled(dtype, (64, 512), 4)) if dual else (x,)
    before = [a.clone() for a in arrays]
    assert t_hbm.check_reader(*arrays, seed=5, plants=6) == 6
    assert all(torch.equal(a, b) for a, b in zip(arrays, before))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_check_reader_catches_a_reader_that_skips_a_word(dtype):
    x = _filled(dtype, (64, 512), 6)
    skip = 16 // x.element_size()
    with pytest.raises(AssertionError, match="planted"):
        t_hbm.check_reader(x, plants=2, read=lambda a: (
            t_hbm.hbm_read_plain(a.view(-1)[:-skip])))


def test_check_reader_refuses_a_buffer_at_the_planted_values():
    x = _filled("int8", (8, 512), 7)
    x[3, 5] = t_hbm.PLANT[torch.int8][0]
    with pytest.raises(ValueError, match="below the planted values"):
        t_hbm.check_reader(x)


def test_bf16_chain_parts_sum_to_the_chain():
    gen = torch.Generator().manual_seed(8)
    xg = (torch.randn(2, 128, 128, generator=gen) * 0.1).bfloat16()
    ws = (torch.randn(2, 128, 128, generator=gen) * 0.1).bfloat16()
    win, total = t_int8.bf16_parts_plain(xg, ws)
    assert win.shape == (2, 8, 128) and total.shape == (2,)
    torch.testing.assert_close(win + total[:, None, None],
                               t_int8.int8_chain_plain(xg, ws, "bf16"),
                               rtol=0, atol=0)
