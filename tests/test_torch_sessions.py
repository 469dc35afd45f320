"""The port's continuation prefill and what is built on it, against the JAX
package on the CPU: `llama_prefill_continue`, `KVCache.resized`, the
engine's chunked prefill and its multi-turn sessions.

Both packages run `VLMConfig.tiny_test(stage=0)` on the same weights (JAX
`init_vlm_params(PRNGKey(0))`, bridged with `params_from_numpy`) with
float32 activations, as tests/test_eval_serve.py builds the JAX engine.
Float32 logits and caches agree within 1e-5; a bf16 cache within one bf16
step of its values; int8 codes, lengths and greedy ids exactly, int8
scales within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import llama as j_llama
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu_torch.core import build_engine, eval_config
from lhrs_bot_tpu_torch.core.convert import params_from_numpy
from lhrs_bot_tpu_torch.models import llama as t_llama
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.serve import engine as t_engine

F32 = torch.float32
TOL = dict(rtol=1e-5, atol=1e-5)
J_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
T_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
S_MAX = 32


@pytest.fixture(scope="module")
def weights():
    j_cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    params = j_vlm.init_vlm_params(jax.random.PRNGKey(0), j_cfg)
    return j_cfg, params, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params))


def _engines(weights, cache="f32", **kw):
    j_cfg, params, t_params = weights
    je = j_engine.GenerationEngine(j_cfg, params, max_seq_len=96,
                                   compute_dtype=jnp.float32,
                                   cache_dtype=J_DTYPE[cache], **kw)
    te = t_engine.GenerationEngine(t_vlm.VLMConfig.tiny_test(stage=0),
                                   t_params, max_seq_len=96,
                                   compute_dtype=F32,
                                   cache_dtype=T_DTYPE[cache], device="cpu",
                                   **kw)
    return je, te


@pytest.fixture(scope="module")
def engines(weights):
    # a 16-token prompt bucket leaves a continuation room in a 96-row
    # cache up to 80 cached rows (start + bucket <= max_seq_len)
    return _engines(weights, prompt_bucket=16)


def _caches_equal(got, want, cache):
    """A port cache against a JAX one: lengths exact; float32 within TOL,
    bf16 within one bf16 step; int8 codes exact, scales within 1e-6."""
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(want.length))
    for name in ("k", "v"):
        g = getattr(got, name)
        w = np.asarray(getattr(want, name))
        if cache == "int8":
            np.testing.assert_array_equal(g.numpy(), w)
        elif cache == "bf16":
            np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                       rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_allclose(g.numpy(), w, **TOL)
    if cache == "int8":
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-6, atol=0)


def _filled(weights, cache, plen, seed=0):
    """Both packages' caches of S_MAX rows after a prefill of random
    embeddings of lengths `plen`."""
    j_cfg, params, t_params = weights
    b = len(plen)
    emb = np.random.default_rng(seed).standard_normal(
        (b, max(plen), j_cfg.llama.hidden_size)).astype(np.float32)
    plen = np.asarray(plen, np.int32)
    jc = j_llama.KVCache.create(j_cfg.llama, b, S_MAX,
                                dtype=J_DTYPE[cache])
    _, jc = j_llama.llama_prefill(params["llama"], j_cfg.llama, jc,
                                  inputs_embeds=jnp.asarray(emb),
                                  prompt_len=jnp.asarray(plen),
                                  compute_dtype=jnp.float32)
    t_cfg = t_llama.LlamaConfig.tiny_test()
    tc = t_llama.KVCache.create(t_cfg, b, S_MAX, dtype=T_DTYPE[cache],
                                device="cpu")
    _, tc = t_llama.llama_prefill(t_params["llama"], t_cfg, tc,
                                  inputs_embeds=torch.from_numpy(emb),
                                  prompt_len=torch.from_numpy(plen),
                                  compute_dtype=F32)
    return jc, tc


# (prompt lengths in the cache, continuation starts, suffix lengths): ragged
# suffixes with a 0; a row whose suffix fills the cache to S_MAX - 1 with
# padded columns past the end (JAX drops their writes)
CONTINUE_CASES = {
    "ragged": ((20, 13, 7), (20, 13, 7), (5, 0, 8)),
    "full": ((20, 9), (24, 9), (8, 3)),
}


@pytest.mark.parametrize("all_logits", [False, True], ids=["last", "all"])
@pytest.mark.parametrize("case", list(CONTINUE_CASES))
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_llama_prefill_continue_matches_jax(weights, cache, case,
                                            all_logits):
    j_cfg, params, t_params = weights
    plen, start, slen = CONTINUE_CASES[case]
    jc, tc = _filled(weights, cache, plen)
    width = 8
    emb = np.random.default_rng(1).standard_normal(
        (len(plen), width, j_cfg.llama.hidden_size)).astype(np.float32)
    start = np.asarray(start, np.int32)
    slen = np.asarray(slen, np.int32)
    if case == "full":
        assert start[0] + slen[0] == S_MAX  # rows up to S_MAX - 1
    want, jc = j_llama.llama_prefill_continue(
        params["llama"], j_cfg.llama, jc, inputs_embeds=jnp.asarray(emb),
        suffix_len=jnp.asarray(slen), start=jnp.asarray(start),
        compute_dtype=jnp.float32, return_all_logits=all_logits)
    got, tc = t_llama.llama_prefill_continue(
        t_params["llama"], t_llama.LlamaConfig.tiny_test(), tc,
        inputs_embeds=torch.from_numpy(emb), suffix_len=torch.from_numpy(slen),
        start=torch.from_numpy(start), compute_dtype=F32,
        return_all_logits=all_logits)
    assert got.shape == (len(plen),) + ((width,) if all_logits else ()) + (
        j_cfg.llama.vocab_size,)
    if all_logits:  # only a row's valid columns are meaningful
        for r, n in enumerate(slen):
            np.testing.assert_allclose(got[r, :n].numpy(),
                                       np.asarray(want)[r, :n], **TOL)
    else:
        valid = slen > 0
        np.testing.assert_allclose(got.numpy()[valid],
                                   np.asarray(want)[valid], **TOL)
    _caches_equal(tc, jc, cache)


def test_continue_writes_no_padded_or_empty_row(weights):
    """Padded suffix columns and a row of suffix 0 leave the cache as it
    was: the row past a short suffix, the last row of a full cache, and
    every row of the suffix-0 batch row."""
    j_cfg, _, t_params = weights
    _, tc = _filled(weights, "f32", (20, 13, 7))
    before = tc.k.clone(), tc.v.clone()
    emb = torch.randn(3, 8, j_cfg.llama.hidden_size,
                      generator=torch.Generator().manual_seed(3))
    _, tc = t_llama.llama_prefill_continue(
        t_params["llama"], t_llama.LlamaConfig.tiny_test(), tc,
        inputs_embeds=emb, suffix_len=torch.tensor([5, 0, 8]),
        start=torch.tensor([20, 13, S_MAX - 8]), compute_dtype=F32)
    for now, was in zip((tc.k, tc.v), before):
        assert torch.equal(now[:, 0, :, 25:], was[:, 0, :, 25:])
        assert not torch.equal(now[:, 0, :, 20:25], was[:, 0, :, 20:25])
        assert torch.equal(now[:, 1], was[:, 1])
        assert not torch.equal(now[:, 2, :, S_MAX - 1], was[:, 2, :, -1])
    assert tc.length.tolist() == [25, 13, S_MAX]


@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_kv_cache_resized_matches_jax(weights, cache):
    jc, tc = _filled(weights, cache, (20, 13))
    got, want = tc.resized(48), jc.resized(48)
    assert got.k.shape[3] == 48 and got.k.data_ptr() != tc.k.data_ptr()
    _caches_equal(got, want, cache)
    if cache == "int8":
        assert bool((got.k_scale[..., S_MAX:] == 1.0).all())
    assert bool((got.k[..., S_MAX:, :] == 0).all())
    assert tc.resized(S_MAX) is tc
    with pytest.raises(ValueError, match="shrink"):
        tc.resized(S_MAX - 1)


# -- chunked prefill ---------------------------------------------------------


@pytest.fixture(scope="module")
def chunked(weights):
    return _engines(weights, prompt_bucket=16, prefill_chunk=16)


@pytest.mark.parametrize("with_image", [False, True], ids=["text", "image"])
def test_chunked_prefill_generate_matches_jax(engines, chunked, with_image):
    """prefill_chunk=16 (as tests/test_eval_serve.py's chunked case):
    ragged text prompts and an image prompt; the port's chunked ids equal
    JAX's chunked and monolithic ids, and its first-token logits equal the
    port's monolithic prefill's."""
    j_mono, t_mono = engines
    j_chunk, t_chunk = chunked
    rng = np.random.default_rng(15)
    gcfg = dict(max_new_tokens=4, eos_token_id=2)
    if with_image:
        ids = np.full((2, 20), 7, np.int32)
        ids[:, 1] = -200
        ids[1, 17:] = 0
        lens = np.asarray([20, 17], np.int32)
        imgs = rng.integers(0, 256, size=(2, 28, 28, 3)).astype(np.uint8)
    else:
        ids = rng.integers(3, 200, size=(3, 41)).astype(np.int32)
        lens = np.asarray([41, 17, 5], np.int32)
        imgs = None
    want = j_chunk.generate(ids, lens, images=imgs,
                            gen_cfg=j_engine.GenerationConfig(**gcfg))
    assert want == j_mono.generate(ids, lens, images=imgs,
                                   gen_cfg=j_engine.GenerationConfig(**gcfg))
    got = t_chunk.generate(ids, lens, images=imgs,
                           gen_cfg=t_engine.GenerationConfig(**gcfg))
    assert got == want
    cfg = t_engine.GenerationConfig(max_new_tokens=4)
    logits_c = t_chunk._start(ids, lens, imgs, cfg)[0]
    logits_m = t_mono._start(ids, lens, imgs, cfg)[0]
    np.testing.assert_allclose(logits_c.numpy(), logits_m.numpy(), **TOL)
    ids1 = ids[:1, :int(lens[0])]
    assert list(t_chunk.stream(ids1, int(lens[0]),
                               images=None if imgs is None else imgs[:1],
                               gen_cfg=t_engine.GenerationConfig(**gcfg))) \
        == want[0]


def test_build_engine_takes_prefill_chunk():
    cfg = {**eval_config(), "rgb_vision": {
        "arch": "vit_tiny", "attn_pooler": {
            "num_query": 12, "num_attn_heads": 2, "num_layers": 2,
            "stage_num": [6, 4, 2]}},
        "text": {**eval_config()["text"], "vocab_size": 256,
                 "hidden_size": 64, "intermediate_size": 128,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "max_position_embeddings": 128}}
    vcfg = t_vlm.VLMConfig.from_config_dict(cfg)
    params = t_vlm.init_vlm_params(vcfg, seed=0, device="cpu")
    engine = build_engine(vcfg, params, {**cfg, "prefill_chunk": 64}, "cpu")
    plain = build_engine(vcfg, params, cfg, "cpu")
    assert engine.prefill_chunk == 64 and plain.prefill_chunk is None
    ids = np.full((1, 30), 9, np.int32)
    gcfg = t_engine.GenerationConfig(max_new_tokens=3)
    assert engine.generate(ids, np.asarray([30]), gen_cfg=gcfg) == \
        plain.generate(ids, np.asarray([30]), gen_cfg=gcfg)


# -- sessions ------------------------------------------------------------------


def _turns(je, te, prompts, images=None, new=5, fresh=True):
    """Stream each prompt with session=True on both engines, in order, and
    (with `fresh`) sessionless on the port; checks the session's raw ids
    against JAX's after every turn. Returns the port's and JAX's ids."""
    je.reset_session()
    te.reset_session()
    got, want, plain = [], [], []
    for i, ids in enumerate(prompts):
        img = None if images is None else images[i]
        j_out = list(je.stream(ids[None], len(ids), images=img,
                               gen_cfg=j_engine.GenerationConfig(
                                   max_new_tokens=new), session=True))
        t_out = list(te.stream(ids[None], len(ids), images=img,
                               gen_cfg=t_engine.GenerationConfig(
                                   max_new_tokens=new), session=True))
        np.testing.assert_array_equal(te._session["raw_ids"],
                                      je._session["raw_ids"])
        assert te._session["image_fp"] == je._session["image_fp"]
        got.append(t_out)
        want.append(j_out)
        if fresh:
            saved = te._session
            te.reset_session()
            plain.append(list(te.stream(
                ids[None], len(ids), images=img,
                gen_cfg=t_engine.GenerationConfig(max_new_tokens=new))))
            te._session = saved
    return got, want, plain


def test_session_continuation_matches_fresh_and_jax(engines):
    je, te = engines
    rng = np.random.default_rng(11)
    turn1 = rng.integers(3, 200, size=(24,)).astype(np.int32)
    te.reset_session()
    t1 = list(te.stream(turn1[None], 24, gen_cfg=t_engine.GenerationConfig(
        max_new_tokens=5), session=True))
    assert len(te._session["raw_ids"]) == 24 + max(len(t1) - 1, 0)
    turn2 = np.concatenate([turn1, np.asarray(t1, np.int32),
                            rng.integers(3, 200, size=(7,)).astype(np.int32)])
    turn3 = np.concatenate([turn2, rng.integers(3, 200, size=(9,))
                            .astype(np.int32)])
    continued = []
    cont = te._prefill_continue
    te._prefill_continue = lambda *a: continued.append(1) or cont(*a)
    try:
        got, want, fresh = _turns(je, te, [turn1, turn2, turn3])
    finally:
        del te._prefill_continue
    assert got == want == fresh
    assert len(continued) == 2  # turns 2 and 3


def test_session_continues_from_the_cache(engines, monkeypatch):
    """Turn 2 prefills only its suffix past the cached rows: one
    continuation prefill of the new tokens at start = the matched prefix,
    and no full prefill."""
    _, te = engines
    rng = np.random.default_rng(12)
    turn1 = rng.integers(3, 200, size=(30,)).astype(np.int32)
    gcfg = t_engine.GenerationConfig(max_new_tokens=4)
    te.reset_session()
    t1 = list(te.stream(turn1[None], 30, gen_cfg=gcfg, session=True))
    held = len(te._session["raw_ids"])
    turn2 = np.concatenate([turn1, np.asarray(t1, np.int32),
                            rng.integers(3, 200, size=(6,)).astype(np.int32)])
    calls = []
    monkeypatch.setattr(te, "_prefill", lambda *a, **k: calls.append("full"))
    cont = te._prefill_continue
    monkeypatch.setattr(te, "_prefill_continue", lambda cache, ids, n, start:
                        calls.append((int(n[0]), int(start[0])))
                        or cont(cache, ids, n, start))
    list(te.stream(turn2[None], len(turn2), gen_cfg=gcfg, session=True))
    assert calls == [(len(turn2) - held, held)]
    te.reset_session()


def test_session_image_change_resets(engines):
    """Image turns continue while the image is the same (the continuation
    equals a fresh run and JAX's session); a different image falls back
    to a full prefill."""
    je, te = engines
    img1 = np.zeros((1, 28, 28, 3), np.uint8)
    img2 = np.full((1, 28, 28, 3), 255, np.uint8)
    base = np.full((20,), 7, np.int32)
    base[1] = -200
    te.reset_session()
    t1 = list(te.stream(base[None], 20, images=img1,
                        gen_cfg=t_engine.GenerationConfig(max_new_tokens=4),
                        session=True))
    follow = np.concatenate([base, np.asarray(t1, np.int32),
                             np.arange(30, 42, dtype=np.int32)])
    got, want, fresh = _turns(je, te, [base, follow], [img1, img1], new=4)
    assert got == want == fresh
    got, want, fresh = _turns(je, te, [base, follow], [img1, img2], new=4)
    assert got == want == fresh
    assert te._session["image_fp"] == t_engine.GenerationEngine._image_fp(
        img2)


def test_session_divergent_history_partial_match(engines):
    je, te = engines
    rng = np.random.default_rng(13)
    a = rng.integers(3, 200, size=(40,)).astype(np.int32)
    b = a.copy()
    b[30:] = rng.integers(3, 200, size=(10,))
    b = np.concatenate([b, rng.integers(3, 200, size=(6,)).astype(np.int32)])
    got, want, fresh = _turns(je, te, [a, b], new=4)
    assert got == want == fresh


def test_session_cache_presized_no_resize(engines, monkeypatch):
    """The first session turn's cache is max_seq_len long; a later turn
    whose history passes the old bucketed size neither grows nor copies
    it (the same tensors), and matches a fresh run."""
    je, te = engines
    rng = np.random.default_rng(17)
    turn1 = rng.integers(3, 200, size=(10,)).astype(np.int32)
    gcfg = t_engine.GenerationConfig(max_new_tokens=4)
    te.reset_session()
    t1 = list(te.stream(turn1[None], 10, gen_cfg=gcfg, session=True))
    cache = te._session["cache"]
    assert cache.k.shape[3] == te.max_seq_len
    grown = []
    resized = t_llama.KVCache.resized
    monkeypatch.setattr(t_llama.KVCache, "resized", lambda self, n: (
        grown.append(n) if n != self.k.shape[3] else None) or
        resized(self, n))
    convo = np.concatenate([turn1, np.asarray(t1, np.int32),
                            rng.integers(3, 200, size=(30,)).astype(np.int32)])
    got, want, fresh = _turns(je, te, [turn1, convo], new=4)
    assert got == want == fresh
    assert te._session["cache"].k.shape[3] == te.max_seq_len
    assert grown == []


def test_session_failed_prefill_leaves_none(engines, monkeypatch):
    _, te = engines
    rng = np.random.default_rng(19)
    turn1 = rng.integers(3, 200, size=(16,)).astype(np.int32)
    gcfg = t_engine.GenerationConfig(max_new_tokens=3)
    te.reset_session()
    t1 = list(te.stream(turn1[None], 16, gen_cfg=gcfg, session=True))
    turn2 = np.concatenate([turn1, np.asarray(t1, np.int32),
                            np.arange(40, 45, dtype=np.int32)])

    def fail(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(te, "_prefill_continue", fail)
    with pytest.raises(RuntimeError, match="planted"):
        list(te.stream(turn2[None], len(turn2), gen_cfg=gcfg, session=True))
    assert te._session is None


def test_session_int8_cache_matches_jax(weights):
    """tests/test_eval_serve.py's int8-cache session: the scale planes ride
    the continuation; ids equal a fresh run and JAX's, the session's codes
    equal JAX's byte for byte and its scales within 1e-6."""
    je, te = _engines(weights, cache="int8")
    rng = np.random.default_rng(17)
    turn1 = rng.integers(3, 200, size=(20,)).astype(np.int32)
    te.reset_session()
    t1 = list(te.stream(turn1[None], 20, gen_cfg=t_engine.GenerationConfig(
        max_new_tokens=4), session=True))
    turn2 = np.concatenate([turn1, np.asarray(t1, np.int32),
                            rng.integers(3, 200, size=(9,)).astype(np.int32)])
    got, want, fresh = _turns(je, te, [turn1, turn2], new=4)
    assert got == want == fresh
    _caches_equal(te._session["cache"], je._session["cache"], "int8")
