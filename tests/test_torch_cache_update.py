"""The port's in-place cache row write (`ops.cache_update.cache_row_update`)
against the JAX package's Pallas kernel in interpret mode, on CPU.

A row write moves values and computes nothing, so the caches must agree
exactly, for every dtype the kernel takes (float32, bf16, int8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.ops.cache_update import cache_row_update as j_update
from lhrs_bot_tpu_torch.ops import cache_update as t_update

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "int8": (torch.int8, jnp.int8)}


def _values(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lengths", [(3, 15), (0, 8)], ids=["mid-end",
                                                           "start-window"])
def test_cache_row_update_matches_jax(dtype, lengths):
    rng = np.random.default_rng(sum(lengths))
    t_dtype, j_dtype = DTYPES[dtype]
    base = _values(rng, (2, 4, 16, 8), dtype)
    new = _values(rng, (2, 4, 1, 8), dtype)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(j_update(jnp.asarray(base, j_dtype),
                               jnp.asarray(new, j_dtype), jnp.asarray(lens),
                               interpret=True).astype(jnp.float32))
    cache = torch.from_numpy(base).to(t_dtype)
    got = t_update.cache_row_update(cache, torch.from_numpy(new).to(t_dtype),
                                    torch.from_numpy(lens))
    assert got is cache  # in place
    np.testing.assert_array_equal(got.float().numpy(), want)
    for b, p in enumerate(lengths):  # the row is new_vals, the rest as was
        np.testing.assert_array_equal(
            got[b, :, p].float().numpy(),
            torch.from_numpy(new[b, :, 0]).to(t_dtype).float().numpy())


def test_row_past_the_cache_raises_in_the_plain_version():
    cache = torch.zeros(2, 2, 4, 8)
    with pytest.raises(IndexError):
        t_update.cache_row_update(cache, torch.ones(2, 2, 1, 8),
                                  torch.tensor([1, 4], dtype=torch.int32))


def test_kernel_wrapper_takes_only_cuda_tensors():
    cache = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        t_update.cache_row_update_kernel(cache, torch.ones(1, 1, 1, 8),
                                         torch.zeros(1, dtype=torch.int32))
