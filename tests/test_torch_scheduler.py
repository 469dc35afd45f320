"""The port's continuous-batching schedulers (lhrs_bot_tpu_torch.serve.
scheduler and serve.paged) against the JAX contiguous scheduler on the CPU.

Both packages serve `VLMConfig.tiny_test(stage=0)` on the same weights (JAX
`init_vlm_params(PRNGKey(0))`, bridged with `params_from_numpy`) in float32,
with the request waves of tests/test_paged.py and tests/test_scheduler.py.
Greedy token ids must be identical: the port's contiguous and paged
schedulers against the JAX contiguous scheduler, at 1, 2 and 8 decode steps
a tick, with chunked prefill, prefix-cache hits, an image request, cancel
and fail_all, and on the wave where the JAX paged scheduler's idle slots
overwrite a live sequence's page. The sampler's greedy rows and top-p mask
are held to the JAX sampler's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu.serve import scheduler as j_sched
from lhrs_bot_tpu_torch.core.convert import params_from_numpy
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.serve import engine as t_engine
from lhrs_bot_tpu_torch.serve import paged as t_paged
from lhrs_bot_tpu_torch.serve import scheduler as t_sched

CPU = torch.device("cpu")
J_DTYPE = {"f32": jnp.float32, "int8": jnp.int8}
T_DTYPE = {"f32": torch.float32, "int8": torch.int8}


@pytest.fixture(scope="module")
def setup():
    j_cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), j_cfg)
    je = j_engine.GenerationEngine(j_cfg, params, max_seq_len=96,
                                   compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32)
    te = t_engine.GenerationEngine(
        t_vlm.VLMConfig.tiny_test(stage=0),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
        max_seq_len=96, compute_dtype=torch.float32,
        cache_dtype=torch.float32, device=CPU)
    return j_cfg, params, je, te


@dataclasses.dataclass(frozen=True)
class Wave:
    """A request wave and the schedulers' settings (tests/test_paged.py)."""
    seed: int
    lengths: tuple
    budgets: tuple
    max_batch: int
    num_pages: int
    pages_per_seq: int = 6
    image_rows: tuple = ()


WAVES = {
    # test_scheduler_equivalence: two admission waves recycle pages
    "recycle": Wave(3, (40, 7, 23, 12, 31, 5), (8,) * 6, 3, 15),
    # test_scheduler_equivalence_int8
    "int8": Wave(11, (26, 9, 33), (6,) * 3, 2, 13),
    # the reference's page-table fault: idle slot 2 keeps appending into a
    # freed page that live slot 1 holds
    "hazard": Wave(5, (20, 20, 40, 45), (3, 3, 30, 20), 3, 40),
    # two rows with an image marker and an image
    "image": Wave(13, (20, 9, 14), (5,) * 3, 2, 30, image_rows=(0, 2)),
}


def _requests(mod, wave: Wave):
    rng = np.random.default_rng(wave.seed)
    reqs = []
    for i, (n, budget) in enumerate(zip(wave.lengths, wave.budgets)):
        ids = rng.integers(3, 200, size=(n,)).astype(np.int32)
        image = None
        if i in wave.image_rows:
            ids[1] = -200
            image = rng.integers(0, 256, size=(28, 28, 3)).astype(np.uint8)
        reqs.append(mod.Request(uid=i, input_ids=ids, image=image,
                                max_new_tokens=budget))
    return reqs


_JAX_RUNS = {}


def _jax_outputs(setup, wave_name, cache, k):
    """The JAX contiguous scheduler's greedy ids on a wave (memoised)."""
    key = (wave_name, cache, k)
    if key not in _JAX_RUNS:
        j_cfg, params, je, _ = setup
        wave = WAVES[wave_name]
        sched = j_sched.ContinuousBatchingScheduler(
            j_cfg, params, je.llama_params, max_batch=wave.max_batch,
            max_seq_len=96, compute_dtype=jnp.float32,
            cache_dtype=J_DTYPE[cache], prompt_bucket=16, tokens_per_tick=k)
        reqs = _requests(j_sched, wave)
        sched.run(reqs)
        assert all(r.done for r in reqs)
        _JAX_RUNS[key] = [r.output_ids for r in reqs]
    return _JAX_RUNS[key]


def _port_scheduler(setup, wave, cache, k, paged, **kw):
    te = setup[3]
    common = dict(max_batch=wave.max_batch, compute_dtype=torch.float32,
                  cache_dtype=T_DTYPE[cache], prompt_bucket=16,
                  tokens_per_tick=k, device=CPU)
    if paged:
        return t_paged.PagedScheduler(
            te.cfg, te.params, te.llama_params, num_pages=wave.num_pages,
            page_size=16, pages_per_seq=wave.pages_per_seq, **common, **kw)
    return t_sched.ContinuousBatchingScheduler(
        te.cfg, te.params, te.llama_params, max_seq_len=96, **common, **kw)


def _pool_idle(sched):
    """Every page of a paged scheduler is free or a refcount-0 prefix
    page, and no slot holds one."""
    st = sched.pool_stats()
    assert (st["free_pages"] + st["prefix"]["evictable"]
            == st["total_pages"]), st
    assert st["prefix"]["entries"] == st["prefix"]["evictable"]
    assert all(not p for p in sched.slot_pages)


RUNS = [("recycle", "f32", 1), ("recycle", "f32", 2), ("recycle", "f32", 8),
        ("int8", "int8", 1), ("int8", "int8", 2), ("int8", "int8", 8),
        ("image", "f32", 2)]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("wave_name,cache,k", RUNS,
                         ids=[f"{w}-{c}-k{k}" for w, c, k in RUNS])
def test_port_scheduler_matches_jax(setup, wave_name, cache, k, paged):
    want = _jax_outputs(setup, wave_name, cache, k)
    sched = _port_scheduler(setup, WAVES[wave_name], cache, k, paged)
    reqs = _requests(t_sched, WAVES[wave_name])
    sched.run(reqs)
    assert all(r.done for r in reqs)
    assert [r.output_ids for r in reqs] == want
    if paged:
        _pool_idle(sched)


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_paged_prefill_chunk_matches_jax(setup, cache):
    """prefill_chunk=16: the decoder prefills 16-wide slices."""
    wave_name = "recycle" if cache == "f32" else "int8"
    want = _jax_outputs(setup, wave_name, cache, 2)
    sched = _port_scheduler(setup, WAVES[wave_name], cache, 2, True,
                            prefill_chunk=16)
    reqs = _requests(t_sched, WAVES[wave_name])
    sched.run(reqs)
    assert [r.output_ids for r in reqs] == want
    _pool_idle(sched)


def _idle_rows_null(sched):
    """No idle slot's table row names a page a live slot holds."""
    table = sched.cache.page_table.numpy()
    held = set(table[sched.active].ravel().tolist()) - {0}
    for slot in np.flatnonzero(~sched.active):
        assert not set(table[slot].tolist()) & held, (slot, table)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_hazard_wave_matches_jax(setup, paged):
    """The wave on which the JAX paged scheduler's idle slot 2 appends into
    live slot 1's page (its released table row still names the page): the
    port's schedulers give the JAX contiguous scheduler's ids, and after
    every tick no idle slot's table row names a live slot's page."""
    want = _jax_outputs(setup, "hazard", "f32", 2)
    sched = _port_scheduler(setup, WAVES["hazard"], "f32", 2, paged,
                            **({"enable_prefix_cache": False} if paged
                               else {}))
    reqs = _requests(t_sched, WAVES["hazard"])
    pending = list(reqs)
    while sched.active.any() or pending:
        if pending and sched._free_slots():
            pending = pending[sched.admit(pending):]
        sched.step(waiting=len(pending))
        if paged:
            _idle_rows_null(sched)
    assert [r.output_ids for r in reqs] == want
    if paged:
        _pool_idle(sched)


def test_prefix_cache_hits_match_jax(setup):
    """Three prompts behind a common 32-token prefix, the first served
    alone: the later two hit its pages and prefill only their suffix, with
    the JAX contiguous scheduler's ids."""
    j_cfg, params, je, _ = setup
    rng = np.random.default_rng(8)
    system = rng.integers(3, 200, size=(32,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(3, 200, size=(n,))
                               .astype(np.int32)]) for n in (9, 17, 4)]
    outs = []
    for mod, sched in (
            (j_sched, j_sched.ContinuousBatchingScheduler(
                j_cfg, params, je.llama_params, max_batch=2, max_seq_len=96,
                compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                prompt_bucket=16, tokens_per_tick=2)),
            (t_sched, _port_scheduler(setup, WAVES["image"], "f32", 2,
                                      True))):
        reqs = [mod.Request(uid=i, input_ids=p, max_new_tokens=5)
                for i, p in enumerate(prompts)]
        sched.run(reqs[:1])
        sched.run(reqs[1:])
        outs.append([r.output_ids for r in reqs])
    assert outs[1] == outs[0]
    st = sched.pool_stats()["prefix"]
    assert st["hits"] >= 2 and st["tokens_reused"] >= 2 * 32
    _pool_idle(sched)


def _cancel_and_fail(mod, sched):
    """Admit two long requests, tick, cancel one, tick, fail_all, then
    serve a third request; returns every request's ids."""
    rng = np.random.default_rng(7)
    a, b, c = (mod.Request(uid=100 + i,
                           input_ids=rng.integers(3, 200, size=(n,))
                           .astype(np.int32), max_new_tokens=30)
               for i, n in enumerate((6, 19, 11)))
    assert sched.admit([a, b]) == 2
    sched.step()
    assert sched.cancel(a.uid) and a.cancelled and a.done
    assert not sched.cancel(a.uid)
    sched.step()
    sched.fail_all()
    assert not sched.active.any()
    c.max_new_tokens = 5
    sched.run([c])
    return [r.output_ids for r in (a, b, c)]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_cancel_and_fail_all_match_jax(setup, paged):
    j_cfg, params, je, _ = setup
    want = _cancel_and_fail(j_sched, j_sched.ContinuousBatchingScheduler(
        j_cfg, params, je.llama_params, max_batch=2, max_seq_len=96,
        compute_dtype=jnp.float32, cache_dtype=jnp.float32,
        prompt_bucket=16, tokens_per_tick=2))
    sched = _port_scheduler(setup, WAVES["image"], "f32", 2, paged)
    assert _cancel_and_fail(t_sched, sched) == want
    if paged:
        _pool_idle(sched)
        assert not sched.cache.page_table.any()


@pytest.mark.parametrize("n", list(range(1, 10)))
def test_bucket_sizes_match_jax(n):
    assert t_sched.ContinuousBatchingScheduler._bucket_sizes(n) == \
        j_sched.ContinuousBatchingScheduler._bucket_sizes(n)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_adaptive_tick_k_matches_jax(k):
    """The adaptive tick size over mixed budgets, with and without
    requests waiting, on bare instances of both schedulers."""
    rng = np.random.default_rng(k)
    for _ in range(20):
        budgets = rng.integers(1, 40, size=4).astype(np.int32)
        active = rng.random(4) < 0.7
        got = []
        for cls in (j_sched.ContinuousBatchingScheduler,
                    t_sched.ContinuousBatchingScheduler):
            s = object.__new__(cls)
            s.tokens_per_tick, s.adaptive_tick = k, True
            s.slot_budget, s.active = budgets, active
            got.append([s._tick_k(w) for w in (False, True)])
        assert got[0] == got[1]


def test_adaptive_scheduler_matches_jax(setup):
    j_cfg, params, je, _ = setup
    wave = WAVES["recycle"]
    sched = j_sched.ContinuousBatchingScheduler(
        j_cfg, params, je.llama_params, max_batch=3, max_seq_len=96,
        compute_dtype=jnp.float32, cache_dtype=jnp.float32, prompt_bucket=16,
        tokens_per_tick=8, adaptive_tick=True)
    want = _requests(j_sched, wave)
    sched.run(want)
    port = _port_scheduler(setup, wave, "f32", 8, True, adaptive_tick=True)
    got = _requests(t_sched, wave)
    port.run(got)
    assert [r.output_ids for r in got] == [r.output_ids for r in want]
    port.set_tokens_per_tick(0)
    assert port.tokens_per_tick == 1


@pytest.mark.parametrize("kwargs", [{"speculative": 4}, {"mesh": "m"}],
                         ids=str)
def test_unported_scheduler_options_raise(setup, kwargs):
    with pytest.raises(NotImplementedError):
        _port_scheduler(setup, WAVES["recycle"], "f32", 2, False, **kwargs)


def test_multi_image_request_raises(setup):
    sched = _port_scheduler(setup, WAVES["image"], "f32", 2, True)
    req = t_sched.Request(uid=0, input_ids=np.asarray([1, -200, 5, -200, 6]),
                          image=np.zeros((2, 28, 28, 3), np.uint8))
    with pytest.raises(NotImplementedError):
        sched.admit([req])
    with pytest.raises(NotImplementedError):
        sched.set_speculative(2)


# -- the sampler -------------------------------------------------------------


def test_sample_token_per_slot_matches_jax():
    """Greedy rows (temperature 0) give the argmax; sampled rows draw only
    inside the JAX top-p set. JAX's categorical draw is argmax(masked +
    Gumbel noise of its key), so the port's masked logits with the same
    noise must give JAX's token for every key: a mask with one token more
    or less shows within the 64 keys."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((6, 256)) * 3).astype(np.float32)
    temp = np.asarray([0.0, 0.7, 1.0, 1.5, 0.0, 0.3], np.float32)
    top_p = np.asarray([0.9, 0.9, 0.5, 0.95, 1.0, 1e-6], np.float32)
    masked = t_engine._top_p_logits(torch.from_numpy(logits),
                                    torch.from_numpy(temp),
                                    torch.from_numpy(top_p)).numpy()
    for seed in range(64):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(j_engine._sample_token_per_slot(
            jnp.asarray(logits), key, jnp.asarray(temp), jnp.asarray(top_p)))
        noise = np.asarray(jax.random.gumbel(key, logits.shape))
        sampled = np.argmax(masked + noise, axis=-1)
        np.testing.assert_array_equal(
            np.where(temp > 0, sampled, logits.argmax(-1)), want)
    got = t_engine._sample_token_per_slot(
        torch.from_numpy(logits), torch.Generator().manual_seed(1),
        torch.from_numpy(temp), torch.from_numpy(top_p)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[temp == 0],
                                  logits.argmax(-1)[temp == 0])
    assert (masked[np.arange(6), got] > -1e29).all()
    assert got[5] == logits[5].argmax()  # a top-p below the top token
