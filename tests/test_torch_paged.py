"""The port's paged KV cache (lhrs_bot_tpu_torch.models.llama_paged,
ops.paged_fused, serve.paged.PageAllocator, serve.prefix.PrefixPool)
against the JAX package on the CPU.

Inputs come from numpy's seeded generator and go through both functions.
The plain paged decode is the JAX reference path (`_append_rows` +
`paged_attention_reference`): outputs within rtol = atol = 1e-5 (float32
summation order), pools and scale pages byte-equal. Against the JAX Pallas
kernels in interpret mode: the float32 pool within 1e-5; the int8 pool at
bf16 resolution (the TPU kernel rounds q * sm_scale and p * v_scale to bf16
where the plain path keeps float32: rtol = atol = 1e-2, the bound
tests/test_torch_quant.py holds the int8 contiguous kernel to). The paged
prefill and decode steps run the tiny config in float32 (logits within
1e-4, several layers of float32 matmuls in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import llama_paged as j_paged
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.ops import paged_fused as j_fused
from lhrs_bot_tpu.serve import paged as j_sched
from lhrs_bot_tpu.serve import prefix as j_prefix
from lhrs_bot_tpu_torch.core.convert import params_from_numpy
from lhrs_bot_tpu_torch.models import llama_paged as t_paged
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.ops import paged_fused as t_fused
from lhrs_bot_tpu_torch.serve import paged as t_sched
from lhrs_bot_tpu_torch.serve import prefix as t_prefix

TOL = dict(rtol=1e-5, atol=1e-5)
KERNEL_TOL = dict(rtol=1e-2, atol=1e-2)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _equal(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# (lengths, page, pages_per_seq, shuffled table): a mid-page append, appends
# that open a fresh page (off 0) and fill a page's last row, a sequence of
# one page, and page ids in shuffled pool order
DECODE_CASES = {
    "mid_page": ((37, 20, 5), 16, 4, False),
    "page_boundary": ((16, 31, 47), 16, 4, False),
    "single_page": ((5,), 16, 2, False),
    "shuffled": ((37, 63, 17), 16, 4, True),
}


def _decode_inputs(case, int8, seed=0, h=4, d=64, nl=2):
    lengths, page, pps, shuffled = DECODE_CASES[case]
    rng = np.random.default_rng(seed)
    b = len(lengths)
    n_pages = 1 + b * pps + 3
    ids = np.arange(1, n_pages)
    if shuffled:
        ids = rng.permutation(ids)
    table = ids[:b * pps].reshape(b, pps).astype(np.int32)
    # entries past each row's valid pages stay null
    for r, n in enumerate(lengths):
        table[r, -(-(n + 1) // page):] = 0
    shape = (nl, n_pages, h, page, d)
    out = {"q": rng.standard_normal((b, h, 1, d)).astype(np.float32),
           "table": table, "lengths": np.asarray(lengths, np.int32)}
    if int8:
        out.update(
            kp=rng.integers(-127, 128, shape).astype(np.int8),
            vp=rng.integers(-127, 128, shape).astype(np.int8),
            ks=rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32),
            vs=rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32),
            kn=rng.integers(-127, 128, (b, h, 1, d)).astype(np.int8),
            vn=rng.integers(-127, 128, (b, h, 1, d)).astype(np.int8),
            kns=rng.uniform(0.01, 0.03, (b, h, 1)).astype(np.float32),
            vns=rng.uniform(0.01, 0.03, (b, h, 1)).astype(np.float32))
    else:
        out.update(
            kp=rng.standard_normal(shape).astype(np.float32),
            vp=rng.standard_normal(shape).astype(np.float32),
            kn=rng.standard_normal((b, h, 1, d)).astype(np.float32),
            vn=rng.standard_normal((b, h, 1, d)).astype(np.float32))
    return out


def _jax_reference(x, layer, int8):
    """JAX's reference decode path (paged_decode_step with use_kernel
    False): `_append_rows` + `paged_attention_reference`."""
    page = x["kp"].shape[3]
    table, lengths = jnp.asarray(x["table"]), jnp.asarray(x["lengths"])
    page_ids = jnp.take_along_axis(table, (lengths // page)[:, None],
                                   axis=1)[:, 0]
    offs = lengths % page
    kp = j_paged._append_rows(jnp.asarray(x["kp"]), layer, page_ids, offs,
                              jnp.asarray(x["kn"])[:, :, 0])
    vp = j_paged._append_rows(jnp.asarray(x["vp"]), layer, page_ids, offs,
                              jnp.asarray(x["vn"])[:, :, 0])
    pools = [kp, vp]
    ks = vs = None
    if int8:
        ks = jnp.asarray(x["ks"]).at[layer, page_ids, :, offs].set(
            jnp.asarray(x["kns"])[:, :, 0])
        vs = jnp.asarray(x["vs"]).at[layer, page_ids, :, offs].set(
            jnp.asarray(x["vns"])[:, :, 0])
        pools += [ks, vs]
    out = j_paged.paged_attention_reference(
        jnp.asarray(x["q"]), kp[layer], vp[layer], table, lengths + 1,
        k_scales=None if ks is None else ks[layer],
        v_scales=None if vs is None else vs[layer])
    return out, pools


def _port_decode(x, layer, int8):
    """The port's entry point on CPU tensors; returns (out, pools) and
    checks that the pools were updated in place."""
    names = ("kp", "vp", "ks", "vs") if int8 else ("kp", "vp")
    pools = [_t(x[n]) for n in names]
    if int8:
        out, *got = t_fused.paged_fused_decode_q(
            _t(x["q"]), _t(x["kn"]), _t(x["kns"]), _t(x["vn"]), _t(x["vns"]),
            *pools, _t(x["table"]), _t(x["lengths"]), layer)
    else:
        out, *got = t_fused.paged_fused_decode(
            _t(x["q"]), _t(x["kn"]), _t(x["vn"]), *pools, _t(x["table"]),
            _t(x["lengths"]), layer)
    assert all(a is b for a, b in zip(got, pools))  # in place
    return out, pools


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("layer", [0, 1])
def test_plain_paged_decode_matches_jax_reference(case, int8, layer):
    x = _decode_inputs(case, int8, seed=layer)
    want, want_pools = _jax_reference(x, layer, int8)
    got, pools = _port_decode(x, layer, int8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for mine, theirs in zip(pools, want_pools):
        _equal(mine, theirs)


@pytest.mark.parametrize("case", ["mid_page", "page_boundary", "single_page",
                                  "shuffled"])
def test_plain_paged_decode_matches_jax_kernel_f32(case):
    """Against JAX's `_kernel_p` in interpret mode at page 16."""
    x = _decode_inputs(case, False, seed=3, h=2, d=128)
    want, jk, jv = j_fused.paged_fused_decode(
        *map(jnp.asarray, (x["q"], x["kn"], x["vn"], x["kp"], x["vp"],
                           x["table"], x["lengths"])), jnp.int32(1),
        interpret=True)
    got, (kp, vp) = _port_decode(x, 1, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _equal(kp, jk)
    _equal(vp, jv)


@pytest.mark.parametrize("lengths", [(37, 64, 5), (31, 95, 32)], ids=str)
def test_plain_paged_decode_q_matches_jax_kernel(lengths):
    """Against JAX's `_kernel_pq` in interpret mode. Its int8 window is 32
    rows, so its page is a multiple of 32: page 32 here. Pools and scale
    pages exactly; outputs at bf16 resolution (KERNEL_TOL)."""
    rng = np.random.default_rng(sum(lengths))
    nl, h, d, page, pps = 2, 2, 128, 32, 4
    b = len(lengths)
    n_pages = 1 + b * pps
    table = rng.permutation(np.arange(1, n_pages)).reshape(b, pps).astype(
        np.int32)
    shape = (nl, n_pages, h, page, d)
    x = dict(q=rng.standard_normal((b, h, 1, d)).astype(np.float32),
             kp=rng.integers(-127, 128, shape).astype(np.int8),
             vp=rng.integers(-127, 128, shape).astype(np.int8),
             ks=rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32),
             vs=rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32),
             kn=rng.integers(-127, 128, (b, h, 1, d)).astype(np.int8),
             vn=rng.integers(-127, 128, (b, h, 1, d)).astype(np.int8),
             kns=rng.uniform(0.01, 0.03, (b, h, 1)).astype(np.float32),
             vns=rng.uniform(0.01, 0.03, (b, h, 1)).astype(np.float32),
             table=table, lengths=np.asarray(lengths, np.int32))
    want, *jpools = j_fused.paged_fused_decode_q(
        jnp.asarray(x["q"], jnp.bfloat16),
        *map(jnp.asarray, (x["kn"], x["kns"], x["vn"], x["vns"], x["kp"],
                           x["vp"], x["ks"], x["vs"], x["table"],
                           x["lengths"])), jnp.int32(0), interpret=True)
    ref, _ = _jax_reference(x, 0, True)
    got, pools = _port_decode(x, 0, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **KERNEL_TOL)
    for mine, theirs in zip(pools, jpools):
        _equal(mine, theirs)


def test_paged_kernels_raise_on_cpu_tensors():
    """The kernel wrappers take CUDA tensors only: no path falls back."""
    x = _decode_inputs("mid_page", False)
    with pytest.raises(ValueError):
        t_fused.paged_fused_decode_kernel(
            *(_t(x[k]) for k in ("q", "kn", "vn", "kp", "vp", "table",
                                 "lengths")), 0, 0.125)


# -- the decoder over the paged cache ----------------------------------------


@pytest.fixture(scope="module")
def llama():
    j_cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    j_params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), j_cfg)
    t_params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params))
    return j_cfg.llama, j_params["llama"], t_params["llama"]


POOL_DTYPES = {"f32": (jnp.float32, torch.float32),
               "bf16": (jnp.bfloat16, torch.bfloat16),
               "int8": (jnp.int8, torch.int8)}


def _caches(cfg, b, num_pages, pps, page, pool):
    jd, td = POOL_DTYPES[pool]
    return (j_paged.PagedKVCache.create(cfg, b, num_pages, pps,
                                        page_size=page, dtype=jd),
            t_paged.PagedKVCache.create(cfg, b, num_pages, pps,
                                        page_size=page, dtype=td, device=CPU))


def _cache_equal(tc, jc):
    for name in ("k_pages", "v_pages", "k_scale_pages", "v_scale_pages",
                 "page_table", "lengths"):
        got, want = getattr(tc, name), getattr(jc, name)
        assert (got is None) == (want is None), name
        if got is not None:
            if got.dtype == torch.bfloat16:
                got, want = got.float(), np.asarray(want, np.float32)
            _equal(got, want)


def _prefill(cfg, params, cache, emb, suffix, ctx, slots, rows, port):
    if port:
        return t_paged.paged_prefill_with_context(
            params, cfg, cache, inputs_embeds=_t(emb), suffix_len=_t(suffix),
            ctx_len=_t(ctx), slot_idx=_t(slots), table_rows=_t(rows),
            compute_dtype=torch.float32)
    return j_paged.paged_prefill_with_context(
        params, cfg, cache, inputs_embeds=jnp.asarray(emb),
        suffix_len=jnp.asarray(suffix), ctx_len=jnp.asarray(ctx),
        slot_idx=jnp.asarray(slots), table_rows=jnp.asarray(rows),
        compute_dtype=jnp.float32)


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shared", [False, True], ids=["dense", "context"])
def test_paged_prefill_with_context_matches_jax(llama, pool, shared):
    """A dense paged prefill of two rows into shuffled pages; with
    `shared`, a third request then prefills only its suffix against two
    pages of row 0's context. Logits and every pool, table and length
    agree with JAX; with a bf16 pool the stored rows are the float32 K/V
    rounded once, so they may differ in the last bf16 bit."""
    cfg, jp, tp = llama
    rng = np.random.default_rng(4)
    emb = np.asarray(jp["embed_tokens"])
    full = rng.integers(3, 200, size=(2, 48)).astype(np.int32)
    suffix = np.asarray([48, 29], np.int32)
    rows = np.zeros((2, 6), np.int32)
    rows[0, :4] = [3, 7, 2, 9]
    rows[1, :2] = [11, 5]
    jc, tc = _caches(cfg, 3, 16, 6, 16, pool)
    runs = [(emb[full], suffix, np.zeros(2, np.int32),
             np.asarray([0, 1], np.int32), rows)]
    if shared:
        sfx = rng.integers(3, 200, size=(1, 16)).astype(np.int32)
        rows2 = np.zeros((1, 6), np.int32)
        rows2[0, :4] = [3, 7, 13, 4]  # two shared pages, two fresh
        runs.append((emb[sfx], np.asarray([16], np.int32),
                     np.asarray([32], np.int32), np.asarray([2], np.int32),
                     rows2))
    for e, s, c, sl, r in runs:
        jl, jc = _prefill(cfg, jp, jc, e, s, c, sl, r, port=False)
        tl, tc = _prefill(cfg, tp, tc, e, s, c, sl, r, port=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    _equal(tc.page_table, jc.page_table)
    _equal(tc.lengths, jc.lengths)
    names = ("k_pages", "v_pages") + (("k_scale_pages", "v_scale_pages")
                                      if pool == "int8" else ())
    for name in names:
        got = getattr(tc, name).float().numpy()
        want = np.asarray(getattr(jc, name), np.float32)
        if pool == "int8" and name in ("k_pages", "v_pages"):
            # codes of float32 K/V that differ in the last bits: at most a
            # code off by one, at a rounding tie
            assert np.abs(got - want).max() <= 1
            assert (got != want).mean() < 1e-3
        else:
            rtol = 2 ** -7 if pool == "bf16" else 1e-5
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_paged_decode_step_matches_jax_with_null_page_poisoned(llama, pool):
    """Prefill two rows, poison the null page, then four decode steps of
    both decoders: logits within MODEL_TOL and greedy tokens equal; the
    poison never reaches a live row (the port's logits equal a run on the
    unpoisoned cache)."""
    cfg, jp, tp = llama
    rng = np.random.default_rng(6)
    emb = np.asarray(jp["embed_tokens"])
    ids = rng.integers(3, 200, size=(2, 32)).astype(np.int32)
    rows = np.zeros((2, 6), np.int32)
    rows[0, :3] = [8, 2, 5]
    rows[1, :3] = [1, 9, 4]
    jc, tc = _caches(cfg, 2, 12, 6, 16, pool)
    args = (emb[ids], np.asarray([30, 16], np.int32), np.zeros(2, np.int32),
            np.asarray([0, 1], np.int32), rows)
    jl, jc = _prefill(cfg, jp, jc, *args, port=False)
    tl, tc = _prefill(cfg, tp, tc, *args, port=True)
    poison = 127 if pool == "int8" else 1e4
    jc = jc._replace(k_pages=jc.k_pages.at[:, 0].set(poison),
                     v_pages=jc.v_pages.at[:, 0].set(poison))
    clean = t_paged.PagedKVCache(
        *(None if t is None else t.clone() for t in (
            tc.k_pages, tc.v_pages, tc.page_table, tc.lengths,
            tc.k_scale_pages, tc.v_scale_pages)))
    tc.k_pages[:, 0] = poison
    tc.v_pages[:, 0] = poison
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
    for _ in range(4):
        e = emb[tok][:, None]
        jl, jc = j_paged.paged_decode_step(jp, cfg, jc,
                                           inputs_embeds=jnp.asarray(e),
                                           compute_dtype=jnp.float32)
        tl, tc = t_paged.paged_decode_step(tp, cfg, tc, inputs_embeds=_t(e),
                                           compute_dtype=torch.float32)
        cl, clean = t_paged.paged_decode_step(
            tp, cfg, clean, inputs_embeds=_t(e), compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
        _equal(tl, cl.numpy())
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        _equal(tl.argmax(-1).int(), tok)
    _equal(tc.lengths, jc.lengths)
    for name in ("k_pages", "v_pages"):
        got, want = getattr(tc, name)[:, 1:], np.asarray(getattr(jc, name))[
            :, 1:]
        if pool == "int8":
            _equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_scatter_prefill_matches_jax(llama):
    cfg, jp, tp = llama
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, 2, 4, 32, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 4, 32, 16)).astype(np.float32)
    lens = np.asarray([30, 17], np.int32)
    rows = np.asarray([[4, 2, 0], [7, 1, 0]], np.int32)
    from lhrs_bot_tpu.models.llama import KVCache as JK
    from lhrs_bot_tpu_torch.models.llama import KVCache as TK
    jc, tc = _caches(cfg, 3, 9, 3, 16, "f32")
    jc = j_paged.scatter_prefill(
        jc, JK(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)),
        jnp.asarray([2, 0]), jnp.asarray(rows), jnp.asarray(lens))
    tc = t_paged.scatter_prefill(tc, TK(_t(k), _t(v), _t(lens)),
                                 _t(np.asarray([2, 0])), _t(rows), _t(lens))
    _cache_equal(tc, jc)


def test_paged_cache_create_matches_jax(llama):
    cfg = llama[0]
    for pool in ("bf16", "int8"):
        jc, tc = _caches(cfg, 3, 9, 4, 16, pool)
        _cache_equal(tc, jc)
        assert tc.page_size == 16 and tc.pages_per_seq == 4
        assert tc.quantized == (pool == "int8")


# -- host bookkeeping ---------------------------------------------------------


def test_page_allocator_matches_jax():
    """The operation sequence of tests/test_paged.py::test_allocator on
    both allocators."""
    results = []
    for mod in (j_sched, t_sched):
        a = mod.PageAllocator(8)
        log = [a.available()]
        p1 = a.alloc(3)
        p2 = a.alloc(4)
        assert not set(p1) & set(p2) and 0 not in p1 + p2
        with pytest.raises(RuntimeError):
            a.alloc(1)
        a.free(p1)
        log += [p1, p2, a.alloc(3), a.available()]
        with pytest.raises(ValueError):
            a.free([0])
        with pytest.raises(ValueError):
            mod.PageAllocator(1)
        results.append(log)
    assert results[0] == results[1]


def test_prefix_pool_matches_jax():
    """One sequence of match / acquire / insert / release / evict on both
    pools: the same keys, pages, refcounts, evictions and stats."""
    rng = np.random.default_rng(5)
    system = rng.integers(3, 200, size=(40,)).astype(np.int32)
    other = rng.integers(3, 200, size=(33,)).astype(np.int32)
    image = np.concatenate([system[:20], [-200], system[20:]]).astype(
        np.int32)
    logs = []
    for mod in (j_prefix, t_prefix):
        pool = mod.PrefixPool()
        log = [pool.match(system, 16)]
        parent = None
        for k, page in enumerate((5, 9)):
            parent, inserted = pool.insert(parent, system[k * 16:(k + 1) * 16],
                                           page)
            log.append(inserted)
        log.append(pool.insert(None, system[:16], 11)[1])  # occupied
        keys, pages = pool.match(system, 16)
        log += [pages, pool.match(image, 16)[1], pool.match(other, 16)[1]]
        pool.acquire(keys)
        log.append((pool.evictable(), pool.stats()))
        pool.release(keys)
        pool.release(keys)  # the inserter's reference
        log.append(pool.evictable())
        with pytest.raises(ValueError):
            pool.release(keys)
        pool.insert(None, other[:16], 3)
        pool.release([pool._key(None, other[:16])])
        log += [pool.evict(2), pool.evict(5), pool.stats()]
        logs.append(log)
    assert logs[0] == logs[1]
