"""Tensor-parallel serving of the port (engine, contiguous and paged
schedulers over a dp 1 x tp mesh, one gloo process a rank) against the
JAX package's mesh engine and mesh scheduler, and the quantized recipes
under tensor parallelism against the port's single-rank run.

The ranks run in subprocesses (tests/torch_parallel.py); the JAX side runs
here, on the conftest's virtual CPU devices, over `make_mesh(dp=1, tp)`.
Both serve `VLMConfig.tiny_test(stage=0)` on the JAX package's
`init_vlm_params(PRNGKey(0))` weights in float32:

  * float32, tp 2 and 4: the engine's greedy ids equal the JAX mesh
    engine's, its prefill logits within 1e-5 relative (of the largest
    logit); both schedulers' ids (and the lockstep of a leading rank and
    its followers) equal the JAX mesh scheduler's, and a paged pool ends
    with every page free and every table row null on every rank;
  * quantized, tp 2: int8 weights + int8
    KV, "4h" W4A8 + int8 lm_head + int8 KV, NF4 with double quantization
    (on a wider decoder whose rows split into whole 64-row blocks), and the
    paged scheduler over an int8 pool: each rank's codes and scales equal
    the logical slice of the single-rank engine's tree exactly, the
    W4A8 row-parallel activation codes equal the single-rank codes
    exactly, ids equal and logits within 1e-5 relative of the single-rank
    run's; the W4 rows sliced along the packed axis (the planted fault)
    move the logits far past that bound; at tp 4 the NF4 split, which
    would cut an absmax block, raises;
  * `lhrs_serve_torch.py --tp 2 --dist-backend gloo` under torchrun's
    environment: rank 0's frontend answers as a one-process server does,
    the other rank following its scheduler's calls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.parallel.mesh import make_mesh as j_make_mesh
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu.serve import paged as j_paged
from lhrs_bot_tpu.serve import scheduler as j_sched
from lhrs_bot_tpu_torch.core.checkpoint import to_host
from lhrs_bot_tpu_torch.models.vlm import VLMConfig, init_vlm_params
from lhrs_bot_tpu_torch.ops.quant import QuantizedTensor
from lhrs_bot_tpu_torch.parallel import partition
from lhrs_bot_tpu_torch.parallel.mesh import MODEL_AXIS, Axis

from .torch_parallel import REPO, run_ranks

REL = 1e-5  # logits: relative to the largest magnitude
NEW = 6
WIDE = {"hidden_size": 128, "intermediate_size": 256}

QUANTIZED = {
    "int8": {"kw": {"quantize_bits": 8, "cache_dtype": "int8"}},
    "w4a8": {"kw": {"quantize_bits": "4h", "lm_head_bits": 8,
                    "cache_dtype": "int8"}},
    "nf4": {"kw": {"quantize_bits": 4, "quant_type": "nf4",
                   "double_quant": True}, "params": "wide", "llama": WIDE},
}


def _requests():
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 200, size=(2, 11)).astype(np.int32)
    ids[1, 6:] = 0
    ids[:, 1] = -200
    imgs = rng.integers(0, 256, size=(2, 28, 28, 3)).astype(np.uint8)
    return [(ids, np.asarray([11, 6], np.int32), imgs)]


def _wave(seed, lengths, budgets):
    rng = np.random.default_rng(seed)
    return [(rng.integers(3, 200, size=(n,)).astype(np.int32), b, None)
            for n, b in zip(lengths, budgets)]


WAVE = _wave(51, (21, 6, 13, 9), (5, 5, 4, 6))


def _payload(params, wide, tp):
    engines = {"f32": {}}
    scheds = {
        "cont": {"max_batch": 2, "k": 2, "paged": False, "requests": WAVE},
        "paged": {"max_batch": 2, "k": 2, "paged": True, "num_pages": 20,
                  "requests": WAVE},
        "lockstep": {"max_batch": 2, "k": 2, "paged": True,
                     "num_pages": 20, "requests": WAVE, "lockstep": True},
    }
    if tp == 4:  # the NF4 decoder's rows do not split into 64-row blocks
        engines["nf4"] = QUANTIZED["nf4"]
    else:
        engines.update({k: dict(v, keep_params=True)
                        for k, v in QUANTIZED.items()})
        engines["w4a8_packed_axis"] = dict(QUANTIZED["w4a8"],
                                           fault="packed_axis")
        scheds["paged_int8"] = {
            "max_batch": 2, "k": 2, "paged": True, "num_pages": 20,
            "cache": "int8", "requests": WAVE,
            "engine_kw": {"quantize_bits": 8}}
    return {"tp": tp, "params": {"tiny": params, "wide": wide},
            "new_tokens": NEW, "requests": _requests(), "engines": engines,
            "scheds": scheds,
            "codes_input": np.random.default_rng(9).standard_normal(
                (5, 128)).astype(np.float32) * np.float32(3.0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port at tp 1, 2 and 4 (one process group each), and the JAX
    mesh engine's and scheduler's outputs at tp 2 and 4."""
    cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    params = jax.tree_util.tree_map(
        np.asarray, j_vlm.init_vlm_params(jax.random.PRNGKey(0), cfg))
    wide_cfg = VLMConfig.tiny_test(stage=0)
    wide_cfg = dataclasses.replace(
        wide_cfg, llama=dataclasses.replace(wide_cfg.llama, **WIDE),
        pooler=dataclasses.replace(wide_cfg.pooler, output_size=128))
    wide = to_host(init_vlm_params(wide_cfg, seed=1, device="cpu"))
    tmp = tmp_path_factory.mktemp("tp")
    port = {tp: run_ranks(tp, "serve",
                          _payload(params, wide, tp),
                          tmp / f"tp{tp}", timeout=240)
            for tp in (1, 2, 4)}
    jax_out = {}
    for tp in (2, 4):
        mesh = j_make_mesh(dp=1, tp=tp)
        je = j_engine.GenerationEngine(cfg, params, max_seq_len=96,
                                       compute_dtype=jnp.float32,
                                       cache_dtype=jnp.float32, mesh=mesh)
        gcfg = j_engine.GenerationConfig(max_new_tokens=NEW, eos_token_id=2)
        ids, lens, imgs = _requests()[0]
        n_img = cfg.pooler.num_query
        width, cache_len = je._bucketed(ids.shape[1], n_img, NEW)
        logits, _ = je._prefill_jit(
            je.params, je.llama_params, None,
            jnp.asarray(je._pad_ids(ids, width, 0)), jnp.asarray(imgs),
            jnp.asarray(lens), batch=2, cache_len=cache_len)
        out = {"ids": je.generate(ids, lens, images=imgs, gen_cfg=gcfg),
               "logits": np.asarray(logits)}
        for paged in (False, True):
            kw = dict(max_batch=2, compute_dtype=jnp.float32,
                      cache_dtype=jnp.float32, prompt_bucket=16,
                      tokens_per_tick=2, mesh=mesh, eos_token_id=2)
            if paged:
                sched = j_paged.PagedScheduler(
                    cfg, params, je.llama_params, num_pages=20,
                    page_size=16, pages_per_seq=6, **kw)
            else:
                sched = j_sched.ContinuousBatchingScheduler(
                    cfg, params, je.llama_params, max_seq_len=96, **kw)
            reqs = [j_sched.Request(uid=i, input_ids=p, max_new_tokens=b)
                    for i, (p, b, _) in enumerate(WAVE)]
            sched.run(reqs)
            out["paged" if paged else "cont"] = [r.output_ids for r in reqs]
        jax_out[tp] = out
    return port, jax_out


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * float(np.abs(want).max()))


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_engine_matches_jax_mesh_engine(runs, tp):
    port, jax_out = runs
    for rank in port[tp]:
        eng = rank["engines"]["f32"]
        assert eng["ids"][0] == jax_out[tp]["ids"]
        _close(eng["logits"][0], jax_out[tp]["logits"])


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["cont", "paged", "lockstep"])
def test_tp_schedulers_match_jax_mesh_scheduler(runs, tp, kind):
    """The contiguous and the paged scheduler (and the paged one with
    rank 0 leading, the others following its broadcast calls) give the
    JAX mesh scheduler's ids on every rank; the paged pool ends free with
    null table rows (the released-row repair) on every rank."""
    port, jax_out = runs
    want = jax_out[tp]["cont"]
    assert jax_out[tp]["paged"] == want
    for rank in port[tp]:
        got = rank["scheds"][kind]
        if kind == "lockstep" and rank is not port[tp][0]:
            assert got["ids"] == []  # a follower holds no requests
        else:
            assert got["ids"] == want
        if kind != "cont":
            assert got["free"] == 19 and not got["table"].any()


def _sliced(tree, spec, axis):
    if isinstance(tree, dict):
        tree = QuantizedTensor(torch.as_tensor(tree["q"]),
                               torch.as_tensor(tree["scale"]), tree["bits"])
    return partition.shard_leaf(torch.as_tensor(tree) if isinstance(
        tree, np.ndarray) else tree, spec, axis)


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
@pytest.mark.parametrize("name", list(QUANTIZED))
def test_quantized_tp_slices_and_outputs(runs, name):
    """Codes and scales of every rank equal the logical slice of the
    single-rank tree exactly; ids equal and logits within the bound."""
    port, _ = runs
    one = port[1][0]["engines"][name]
    specs = partition.llama_serving_specs(one["llama"])
    for r, rank in enumerate(port[2]):
        got = rank["engines"][name]
        assert got["ids"] == one["ids"]
        _close(got["logits"][0], one["logits"][0])
        axis = Axis(MODEL_AXIS, [0, 1], r)
        for key in ("wq", "wo", "w_up", "w_down"):
            want = _sliced(one["llama"]["layers"][key],
                           specs["layers"][key], axis)
            have = got["llama"]["layers"][key]
            assert have["bits"] == want.bits
            assert np.array_equal(have["q"], want.q.numpy()), key
            assert np.array_equal(have["scale"], want.scale.numpy()), key
        head = one["llama"]["lm_head"]
        want = _sliced(head, specs["lm_head"], axis)
        have = got["llama"]["lm_head"]
        if isinstance(have, dict):
            assert np.array_equal(have["q"], want.q.numpy())
            assert np.array_equal(have["scale"], want.scale.numpy())
        else:
            assert np.array_equal(have, want.numpy())


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
def test_w4a8_row_parallel_codes_and_the_packed_axis_fault(runs):
    """The row-parallel activation codes (the row maximum all-reduced
    before the scale) equal the single-rank codes' slice exactly; the W4
    rows sliced along the packed axis give logits far outside the bound."""
    port, _ = runs
    for tp in (2, 4):
        for rank in port[tp]:
            c = rank["codes"]
            assert np.array_equal(c["codes"], c["ref_codes"])
            assert np.array_equal(c["scale"], c["ref_scale"])
    one = port[1][0]["engines"]["w4a8"]["logits"][0]
    for rank in port[2]:
        bad = rank["engines"]["w4a8_packed_axis"]["logits"][0]
        assert np.abs(bad - one).max() > 100 * REL * np.abs(one).max()


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
def test_tp_int8_page_pool_and_nf4_block_rule(runs):
    """The paged scheduler over an int8 pool at tp 2 gives the
    single-rank ids, pool free; at tp 4 the NF4 decoder's o projection
    (K = 128, 32 rows a rank) would cut a 64-row absmax block: raises."""
    port, _ = runs
    want = port[1][0]["scheds"]["paged_int8"]
    assert want["free"] == 19
    for rank in port[2]:
        got = rank["scheds"]["paged_int8"]
        assert got["ids"] == want["ids"] and got["free"] == 19
    assert port[1][0]["errors"] == {} and port[2][0]["errors"] == {}
    for rank in port[4]:
        assert "absmax" in rank["errors"]["nf4"]


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_lhrs_serve_torch_tp2_follows_the_leader(tmp_path, paged,
                                                 monkeypatch):
    import runpy

    from lhrs_bot_tpu_torch.core import bootstrap

    from .test_torch_api import _tiny_yaml

    script = str(REPO / "lhrs_serve_torch.py")
    args = ["-c", _tiny_yaml(tmp_path), "--device", "cpu", "--slots", "2",
            "--output", str(tmp_path / "out")]
    if paged:
        args += ["--paged", "--page-size", "16", "--pool-tokens", "512"]
    prompts = [("describe the scene", 6), ("how many ships?", 5),
               ("a third question about the harbor", 7)]
    ranks = run_ranks(2, "serve_entry", {
        "script": script, "prompts": prompts,
        "argv": args + ["--tp", "2", "--dist-backend", "gloo"]},
        tmp_path / "run")
    assert ranks[1] == {"follower": True}
    monkeypatch.setitem(bootstrap.build_engine.__kwdefaults__,
                        "compute_dtype", torch.float32)
    front, _ = runpy.run_path(script, run_name="lhrs_serve_torch")[
        "build_frontend"](args)
    try:
        want = [front.generate_blocking(text, None, n) for text, n in prompts]
    finally:
        front.shutdown()
    assert ranks[0]["outs"] == want
    assert all(o["finish_reason"] == "stop" and o["tokens"] for o in want)


def test_a_failing_follower_raises():
    """A follower whose call raises ends its loop with that error (its
    process then exits non-zero) instead of logging it and waiting for
    the leader's next call; "stop" ends the loop quietly."""
    import types

    from lhrs_bot_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler)

    class Channel:
        def __init__(self, calls):
            self.calls = list(calls)

        def broadcast_object(self, obj=None):
            return self.calls.pop(0)

    ran = []

    def step(waiting):
        ran.append(waiting)
        if waiting == 2:
            raise RuntimeError("out of memory on this rank")

    follower = types.SimpleNamespace(
        channel=Channel([("step", (1,)), ("step", (2,)), ("stop", ())]),
        _step=step)
    with pytest.raises(RuntimeError, match="out of memory"):
        ContinuousBatchingScheduler.follow(follower)
    assert ran == [1, 2] and follower.channel.calls == [("stop", ())]
    ContinuousBatchingScheduler.follow(follower)
    assert follower.channel.calls == []
