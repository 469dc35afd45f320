"""Serving over a data axis (engine, contiguous and paged schedulers under
a dp x tp mesh, one gloo process a rank) against the JAX package.

The ranks run in subprocesses (tests/torch_parallel.py), both meshes at
once; the JAX side runs here meanwhile, on the conftest's virtual CPU
devices. Both serve `VLMConfig.tiny_test(stage=0)` on the JAX package's
`init_vlm_params(PRNGKey(0))` weights (jitted) in float32:

  * dp 2 x tp 1: the engine's `generate` over a batch of 4 (each data
    group prefills and decodes its own 2 rows) and over its first 3 rows
    (dp does not divide 3: each group computes all 3) gives the JAX
    engine's greedy ids at dp 1 (its batch of 4: the rows are
    independent), and its first-token logits, gathered, within 1e-5
    relative of the largest; a contiguous wave (max_batch 4: 2 slots a
    group), the same wave with speculation, a leading rank with the
    others following, and the paged scheduler (the whole pool on each
    group) give the JAX scheduler's ids at dp 1, the paged pool ending
    free with null table rows; the tokens gathered in reverse group order
    (the planted fault) give other ids; sampling (the engine's batch of
    4, a wave that mixes sampled and greedy requests, with speculation
    and without) gives the port's ids at dp 1 from the same generator
    seed: each group draws its rows' share of the whole batch's draws;
  * dp 2 x tp 2: the engine's batch of 4 and the contiguous wave give the
    JAX scheduler's ids at dp 1 and at `make_mesh(dp=2, tp=2)`;
  * a contiguous scheduler whose max_batch dp does not divide raises
    ValueError.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.parallel.mesh import make_mesh as j_make_mesh
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu.serve import scheduler as j_sched
from lhrs_bot_tpu_torch.models.vlm import VLMConfig
from lhrs_bot_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Axis, Mesh
from lhrs_bot_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

from .cpu_budget import module_budget
from .torch_parallel import run_ranks

REL = 1e-5  # logits: relative to the largest magnitude
NEW = 6


def _batches():
    """A batch of 4 and its first 3 rows (dp does not divide 3; the rows
    are independent, so JAX's batch of 4 holds both)."""
    rng = np.random.default_rng(3)
    lens = np.asarray((11, 6, 9, 4), np.int32)
    ids = rng.integers(3, 200, size=(4, 11)).astype(np.int32)
    for r, n in enumerate(lens):
        ids[r, n:] = 0
    ids[:, 1] = -200
    imgs = rng.integers(0, 256, size=(4, 28, 28, 3)).astype(np.uint8)
    return [(ids, lens, imgs), (ids[:3], lens[:3], imgs[:3])]


def _wave():
    rng = np.random.default_rng(61)
    wave = []
    for i, (n, budget) in enumerate(((21, 5), (6, 5), (13, 4), (9, 6),
                                     (17, 3), (5, 5))):
        ids = rng.integers(3, 200, size=(n,)).astype(np.int32)
        img = None
        if i in (1, 4):  # two requests with an image
            ids[0] = -200
            img = rng.integers(0, 256, size=(28, 28, 3)).astype(np.uint8)
        wave.append((ids, budget, img))
    return wave


WAVE = _wave()
SCHED = {"max_batch": 4, "k": 2, "requests": WAVE}
# requests 0, 2, 3 and 5 sample, the others decode greedily
SAMPLED = dict(SCHED, sampling={0: {"temperature": 1.5, "top_p": 0.95},
                                2: {"temperature": 1.0},
                                3: {"temperature": 2.0, "top_p": 0.9},
                                5: {"temperature": 1.5}})


def _port(params):
    """The port at dp 2 x tp 1 and dp 2 x tp 2, run in threads (each
    starts its ranks and waits for them)."""
    runs = {
        (2, 1): {"batches": _batches(), "scheds": {
            "cont": SCHED, "spec": dict(SCHED, speculative=2),
            "lockstep": dict(SCHED, lockstep=True),
            "paged": dict(SCHED, paged=True, num_pages=30),
            "fault": dict(SCHED, fault=True)},
            "sampled": {"cont": SAMPLED,
                        "spec": dict(SAMPLED, speculative=2)}},
        (2, 2): {"batches": _batches()[:1], "scheds": {"cont": SCHED}},
    }
    out, errors = {}, []

    def run(mesh, spec, tmp):
        try:
            out[mesh] = run_ranks(mesh[0] * mesh[1], "dp_serve", {
                "dp": mesh[0], "tp": mesh[1], "params": params,
                "new_tokens": NEW, **spec}, tmp, timeout=240)
        except BaseException as exc:  # raised again in the test's thread
            errors.append(exc)

    return runs, out, errors, run


def _jax_wave(cfg, params, mesh):
    je = j_engine.GenerationEngine(cfg, params, max_seq_len=96,
                                   compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32, mesh=mesh)
    sched = j_sched.ContinuousBatchingScheduler(
        cfg, params, je.llama_params, max_batch=4, max_seq_len=96,
        compute_dtype=jnp.float32, cache_dtype=jnp.float32, prompt_bucket=16,
        tokens_per_tick=2, mesh=mesh, eos_token_id=2)
    reqs = [j_sched.Request(uid=i, input_ids=p, max_new_tokens=b, image=img)
            for i, (p, b, img) in enumerate(WAVE)]
    sched.run(reqs)
    return je, [r.output_ids for r in reqs]


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    yield from module_budget()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's ranks at both meshes, and the JAX engine's and
    scheduler's outputs at dp 1 and the scheduler's at dp 2 x tp 2."""
    cfg = j_vlm.VLMConfig.tiny_test(stage=0)
    init = jax.jit(j_vlm.init_vlm_params, static_argnums=1)  # one compile
    params = jax.tree_util.tree_map(np.asarray,
                                    init(jax.random.PRNGKey(0), cfg))
    specs, port, errors, run = _port(params)
    tmp = tmp_path_factory.mktemp("dp")
    threads = [threading.Thread(target=run, args=(m, s, tmp / f"dp{m}"))
               for m, s in specs.items()]
    mesh_wave = []

    def jax_mesh_wave():  # JAX's own threads compile beside this one's
        try:
            mesh_wave.append(_jax_wave(cfg, params,
                                       j_make_mesh(dp=2, tp=2))[1])
        except BaseException as exc:
            errors.append(exc)

    threads.append(threading.Thread(target=jax_mesh_wave))
    for t in threads:
        t.start()
    try:
        je, wave = _jax_wave(cfg, params, None)
        gcfg = j_engine.GenerationConfig(max_new_tokens=NEW, eos_token_id=2)
        ids, lens, imgs = _batches()[0]
        width, cache_len = je._bucketed(ids.shape[1], cfg.pooler.num_query,
                                        NEW)
        logits, _ = je._prefill_jit(
            je.params, je.llama_params, None,
            jnp.asarray(je._pad_ids(ids, width, 0)), jnp.asarray(imgs),
            jnp.asarray(lens), batch=4, cache_len=cache_len)
        want = je.generate(ids, lens, images=imgs, gen_cfg=gcfg)
        engine = [{"ids": want[:n], "logits": np.asarray(logits)[:n]}
                  for n in (4, 3)]
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return port, {"engine": engine, "wave": wave, "wave_dp2": mesh_wave[0]}


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=["dp2", "dp2_tp2"])
def test_dp_engine_matches_jax_at_dp1(runs, mesh):
    port, want = runs
    for rank in port[mesh]:
        for b, (got, ref) in enumerate(zip(rank["engine"], want["engine"])):
            assert got["ids"] == ref["ids"], (mesh, b)
            np.testing.assert_allclose(
                got["logits"], ref["logits"], rtol=REL,
                atol=REL * float(np.abs(ref["logits"]).max()))
            # a batch of 4 splits 2 / 2; dp does not divide a batch of 3
            assert got["rows"] == (2 if len(ref["ids"]) == 4 else 3)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", ["cont", "spec", "lockstep", "paged"])
def test_dp2_schedulers_match_jax_at_dp1(runs, kind):
    """Every rank's ids are the JAX scheduler's at dp 1 (a follower holds
    no requests); the contiguous cache holds 2 of the 4 slots a group,
    the paged pool all of them, ending free with null table rows."""
    port, want = runs
    for r, rank in enumerate(port[(2, 1)]):
        got = rank["scheds"][kind]
        if kind == "lockstep" and r:
            assert got["ids"] == []
        else:
            assert got["ids"] == want["wave"]
        if kind == "paged":
            assert got["free"] == 29 and not got["table"].any()
        else:
            assert got["slots"] == 2


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kind", ["engine", "cont", "spec"])
def test_dp2_sampling_draws_what_dp1_draws(runs, kind):
    """A data group's rows draw their share of the whole batch's random
    numbers: the sampled ids at dp 2 are dp 1's from the same seed (and
    not all greedy's)."""
    port, want = runs
    for rank in port[(2, 1)]:
        at_dp2, at_dp1 = rank["sampled"][kind]
        assert at_dp2 == at_dp1
    greedy = want["engine"][0]["ids"] if kind == "engine" else want["wave"]
    assert at_dp1 != greedy


@pytest.mark.timeout(300)
def test_dp2_tp2_wave_matches_jax_mesh_and_dp1(runs):
    port, want = runs
    assert want["wave_dp2"] == want["wave"]
    for rank in port[(2, 2)]:
        assert rank["scheds"]["cont"]["ids"] == want["wave"]
        assert rank["scheds"]["cont"]["slots"] == 2


@pytest.mark.timeout(300)
def test_slots_gathered_out_of_order_are_caught(runs):
    port, want = runs
    for rank in port[(2, 1)]:
        assert rank["scheds"]["fault"]["ids"] != want["wave"]


def test_max_batch_must_split_over_the_data_axis():
    """Raised before any collective: a one-process stand-in of a dp 2
    mesh's rank 0 is enough."""
    mesh = Mesh(2, 1, 0, data=Axis(DATA_AXIS, [0, 2], 0),
                model=Axis(MODEL_AXIS, [0], 0))
    with pytest.raises(ValueError, match="multiple of the data axis"):
        ContinuousBatchingScheduler(VLMConfig.tiny_test(stage=0), {}, {},
                                    max_batch=3, device="cpu", mesh=mesh)
    with pytest.raises(TypeError):
        ContinuousBatchingScheduler(VLMConfig.tiny_test(stage=0), {}, {},
                                    max_batch=4, device="cpu", mesh=object())
