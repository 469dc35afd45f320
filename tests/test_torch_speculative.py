"""Prompt-lookup speculation in the port against the JAX package on the
CPU: the engine's `stream(speculative=N)` and the functions of
`serve/speculative.py` (the scheduler's speculative tick is held to JAX in
tests/test_torch_scheduler.py).

The engines run `VLMConfig.tiny_test(stage=0)` on the same weights (JAX
`init_vlm_params(PRNGKey(0))`, bridged with `params_from_numpy`) in
float32. Greedy speculative ids equal plain greedy's and JAX's speculative
ids exactly; the proposal and acceptance functions equal JAX's exactly on
random inputs; the port's sampled acceptance, which draws from a
torch.Generator, is held to plain sampling's distribution (a Monte-Carlo
check, as tests/test_scheduler.py holds JAX's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu.serve import speculative as j_spec
from lhrs_bot_tpu_torch.core.convert import params_from_numpy
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.serve import engine as t_engine
from lhrs_bot_tpu_torch.serve import speculative as t_spec


@pytest.fixture(scope="module")
def engines():
    j_cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), j_cfg)
    je = j_engine.GenerationEngine(j_cfg, params, max_seq_len=96,
                                   compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32)
    te = t_engine.GenerationEngine(
        t_vlm.VLMConfig.tiny_test(stage=0),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
        max_seq_len=96, compute_dtype=torch.float32,
        cache_dtype=torch.float32, device="cpu")
    return je, te


def _prompt(kind, seed=71):
    rng = np.random.default_rng(seed)
    if kind == "repetitive":
        phrase = rng.integers(3, 200, size=(6,)).astype(np.int32)
        return np.concatenate([phrase] * 5)[None]
    return rng.integers(3, 200, size=(1, 30)).astype(np.int32)


@pytest.mark.parametrize("kind", ["repetitive", "random"])
def test_speculative_stream_matches_greedy_and_jax(engines, kind):
    """tests/test_eval_serve.py's speculative case: the port's speculative
    ids equal its plain greedy ids and JAX's speculative ids; on the
    repetitive prompt windows are verified and proposals accepted."""
    je, te = engines
    ids = _prompt(kind)
    t = ids.shape[1]
    gcfg = dict(max_new_tokens=12, eos_token_id=2)
    want = list(je.stream(ids, t, gen_cfg=j_engine.GenerationConfig(**gcfg),
                          speculative=4))
    plain = list(te.stream(ids, t, gen_cfg=t_engine.GenerationConfig(**gcfg)))
    windows = []
    speculate = te._speculate
    te._speculate = lambda cache, w, valid, start: (
        windows.append((w[0].tolist(), int(valid[0]), int(start[0])))
        or speculate(cache, w, valid, start))
    try:
        got = list(te.stream(ids, t, gen_cfg=t_engine.GenerationConfig(
            **gcfg), speculative=4))
    finally:
        del te._speculate
    assert got == plain == want
    if kind == "repetitive":
        assert windows
        # an accepted proposal skips a decode step: fewer windows and
        # steps than tokens
        assert len(windows) < len(got) - 1


def test_speculative_budget_and_stop(engines):
    je, te = engines
    rng = np.random.default_rng(73)
    phrase = rng.integers(3, 200, size=(5,)).astype(np.int32)
    ids = np.concatenate([phrase] * 6)[None]
    t = ids.shape[1]
    gcfg = t_engine.GenerationConfig(max_new_tokens=5, eos_token_id=2)
    out = list(te.stream(ids, t, gen_cfg=gcfg, speculative=8))
    ref = list(te.stream(ids, t, gen_cfg=gcfg))
    assert out == ref and len(out) <= 5
    assert out == list(je.stream(ids, t, gen_cfg=j_engine.GenerationConfig(
        max_new_tokens=5, eos_token_id=2), speculative=8))
    long = t_engine.GenerationConfig(max_new_tokens=12, eos_token_id=2)
    stopped = list(te.stream(ids, t, gen_cfg=long, speculative=4,
                             stop_fn=lambda e: len(e) >= 3))
    assert len(stopped) == 3 and stopped == ref[:3]


def test_speculative_session_matches_jax(engines):
    """A two-turn session with speculation: the ids, and the raw ids the
    session holds (prompt + the emitted tokens whose rows are cached),
    equal JAX's at each turn, and turn 2 equals a fresh plain run."""
    je, te = engines
    ids = _prompt("repetitive", seed=5)[0][:24]
    gcfg = dict(max_new_tokens=6, eos_token_id=2)
    je.reset_session()
    te.reset_session()
    turns = [ids]
    for turn in range(2):
        cur = turns[-1]
        want = list(je.stream(cur[None], len(cur),
                              gen_cfg=j_engine.GenerationConfig(**gcfg),
                              session=True, speculative=3))
        got = list(te.stream(cur[None], len(cur),
                             gen_cfg=t_engine.GenerationConfig(**gcfg),
                             session=True, speculative=3))
        assert got == want
        np.testing.assert_array_equal(te._session["raw_ids"],
                                      je._session["raw_ids"])
        turns.append(np.concatenate([cur, np.asarray(got, np.int32),
                                     cur[3:9]]))
    saved = te._session
    te.reset_session()
    assert got == list(te.stream(turns[1][None], len(turns[1]),
                                 gen_cfg=t_engine.GenerationConfig(**gcfg)))
    te._session = saved


def test_propose_matches_jax():
    """The engine's proposal: `propose_from_history` on one row, the
    history valid up to its length in a longer buffer, on random short
    histories (special tokens and markers among them) and widths."""
    rng = np.random.default_rng(3)
    for _ in range(100):
        n = int(rng.integers(2, 30))
        hist = np.zeros((1, 40), np.int32)
        hist[0, :n] = rng.integers(-1, 6, size=(n,))
        hlen = np.asarray([n], np.int32)
        ngram, width = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        want = j_spec.propose_from_history(
            jnp.asarray(hist), jnp.asarray(hlen), ngram=ngram, width=width)
        got = t_spec.propose_from_history(
            torch.from_numpy(hist), torch.from_numpy(hlen), ngram=ngram,
            width=width)
        k = int(want[1][0])
        assert int(got[1][0]) == k
        np.testing.assert_array_equal(got[0][0, :k].numpy(),
                                      np.asarray(want[0])[0, :k])


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_propose_from_history_matches_jax(ngram):
    rng = np.random.default_rng(ngram)
    b, s, w = 16, 40, 5
    hist = rng.integers(0, 9, size=(b, s)).astype(np.int32)
    hlen = rng.integers(0, s + 1, size=(b,)).astype(np.int32)
    hist[3, :] = 7  # a fully repetitive row
    hlen[3] = 20
    hlen[4] = 0
    hlen[5] = s
    hlen[6] = ngram
    want = j_spec.propose_from_history(jnp.asarray(hist), jnp.asarray(hlen),
                                       ngram=ngram, width=w)
    got = t_spec.propose_from_history(torch.from_numpy(hist),
                                      torch.from_numpy(hlen), ngram=ngram,
                                      width=w)
    n = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), n)
    assert n.max() > 0 and (n == 0).any()
    for r in range(b):  # columns past n_prop carry no meaning
        np.testing.assert_array_equal(got[0][r, :n[r]].numpy(),
                                      np.asarray(want[0])[r, :n[r]])


def _window(seed, b=6, w=4, v=11):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, w + 1, v)).astype(np.float32)
    preds = logits.argmax(-1).astype(np.int32)
    prop = rng.integers(0, v, size=(b, w)).astype(np.int32)
    prop[0] = preds[0, :w]  # fully accepted
    prop[2, :2] = preds[2, :2]
    prop[4, 0] = preds[4, 0]
    n_prop = np.asarray([w, 0, 3, 1, 2, w], np.int32)[:b]
    return logits, preds, prop, n_prop


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_window_matches_jax(seed):
    logits, preds, prop, n_prop = _window(seed)
    want = j_spec.accept_window(jnp.asarray(prop), jnp.asarray(n_prop),
                                jnp.asarray(preds))
    got = t_spec.accept_window(torch.from_numpy(prop),
                               torch.from_numpy(n_prop),
                               torch.from_numpy(preds))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    p = got[0].tolist()
    assert p[:2] == [4, 0] and p[2] >= 2  # full, none, planted prefix


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_window_sampled_greedy_rows_match_jax(seed):
    """Rows with temperature 0 give JAX's `accept_window_sampled` result
    and the port's `accept_window` result exactly, beside sampled rows."""
    logits, preds, prop, n_prop = _window(seed)
    b = len(n_prop)
    temps = np.zeros(b, np.float32)
    temps[1::2] = 0.8  # odd rows sample
    top_ps = np.full(b, 0.9, np.float32)
    want = j_spec.accept_window_sampled(
        jnp.asarray(prop), jnp.asarray(n_prop), jnp.asarray(logits),
        jax.random.PRNGKey(seed), jnp.asarray(temps), jnp.asarray(top_ps))
    got = t_spec.accept_window_sampled(
        torch.from_numpy(prop), torch.from_numpy(n_prop),
        torch.from_numpy(logits), torch.Generator().manual_seed(seed),
        torch.from_numpy(temps), torch.from_numpy(top_ps))
    greedy = t_spec.accept_window(torch.from_numpy(prop),
                                  torch.from_numpy(n_prop),
                                  torch.from_numpy(preds))
    rows = temps <= 0
    for g, w, a in zip(got, want, greedy):
        np.testing.assert_array_equal(g.numpy()[rows], np.asarray(w)[rows])
        np.testing.assert_array_equal(g.numpy()[rows], a.numpy()[rows])
    p = got[0].numpy()
    assert (p[~rows] <= n_prop[~rows]).all()


def test_warp_logits_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(3, 4, 17)).astype(np.float32)
    temps = np.asarray([0.0, 0.7, 1.3], np.float32)
    top_ps = np.asarray([1.0, 0.9, 0.5], np.float32)
    want = np.asarray(j_spec._warp_logits(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps)))
    got = t_spec._warp_logits(torch.from_numpy(logits),
                              torch.from_numpy(temps),
                              torch.from_numpy(top_ps)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    keep = want > -1e29
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_accept_window_sampled_marginal():
    """The first emitted token (an accepted proposal or the correction),
    over many draws of the port's generator, is distributed as one plain
    sample from the warped verify distribution at position 0."""
    v, w, n = 6, 2, 4000
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.normal(size=(1, w + 1, v)).astype(
        np.float32)).expand(n, w + 1, v).contiguous()
    temps = torch.full((n,), 0.7)
    top_ps = torch.ones(n)
    prop = torch.tensor([[2, 3]], dtype=torch.int32).expand(n, w)
    n_prop = torch.full((n,), w, dtype=torch.int32)
    p, corr = t_spec.accept_window_sampled(
        prop, n_prop, logits, torch.Generator().manual_seed(42), temps,
        top_ps)
    first = torch.where(p > 0, prop[:, 0], corr).numpy()
    counts = np.bincount(first, minlength=v) / n
    target = torch.softmax(t_spec._warp_logits(logits[:1], temps[:1],
                                               top_ps[:1])[0, 0], -1).numpy()
    # multinomial noise at n = 4000: 4 sigma < 0.032
    assert np.abs(counts - target).max() < 0.035, (counts, target)
    # the planted fault: accepting every proposal moves the marginal
    assert np.abs(np.bincount(prop[:, 0].numpy(), minlength=v) / n
                  - target).max() > 0.035
