"""Data and tensor-parallel training of the port (the ZeRO-sharded
optimizer, the trainer over a mesh, one gloo process a rank) against the
JAX package's mesh step and the port's single-rank run, on the CPU in
float32.

Both packages train `VLMConfig.tiny_test(stage=2, lora=True)` (LoRA merged
into the dense base; the perceiver and the adapters train) from the JAX
package's `init_vlm_params(PRNGKey(0))` weights with non-zero LoRA B, with
AdamW, weight decay and clipping at a norm the gradients exceed, over two
global batches of 4 rows whose halves hold different counts of valid
tokens:

  * dp 2 x tp 2 (four ranks) against JAX's `make_mesh(dp=2, tp=2)` step:
    loss, text_loss and grad_norm within 1e-5 relative, every updated
    parameter within 1e-5 relative + 2e-5 absolute (2% of one step of lr
    1e-3: where a gradient element lies near zero its summation order
    moves Adam's step), and the replicated trainable leaves bit-identical
    on every rank;
  * dp 2 (ZeRO slots over two ranks) against the single-rank port: the
    same bounds, and the gathered `state_dict` equal to the single-rank
    one within 1e-5 of the slots' largest magnitude (the slots see the
    gradients summed in another order); a rank that skips its gradient
    reduction (the planted fault) moves the parameters past the bound;
  * checkpoints: written at dp 2 and resumed at dp 1, and written at dp 1
    and resumed at dp 2, the resumed optimizer state equals the written
    one exactly and the run ends within the bounds of an unbroken run;
  * the stage-2 entry point under torchrun's environment with `--dp 2
    --tp 2 --dist-backend gloo` against `--dp 2 --tp 1`: FINAL.pt's
    trained leaves within the bounds, its frozen leaves byte-equal.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.core.config import ConfigDict
from lhrs_bot_tpu.data import collate as j_collate
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.parallel.mesh import make_mesh as j_make_mesh
from lhrs_bot_tpu.parallel.partition import shard_params as j_shard_params
from lhrs_bot_tpu.train import optimizer as j_optimizer
from lhrs_bot_tpu.train import trainer as j_trainer
from lhrs_bot_tpu_torch.core.checkpoint import to_host
from lhrs_bot_tpu_torch.core.convert import (as_loaded,
                                             training_params_from_numpy)
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.train import IterBasedTrainer, build_optimizer
from lhrs_bot_tpu_torch.train.trainer import make_train_step

from .cpu_budget import module_budget
from .fake_tokenizer import FakeTokenizer
from .test_torch_stage_entries import _config, _final, weights  # noqa: F401
from .torch_corpora import write_instruct_corpus
from .torch_parallel import REPO, run_ranks


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    yield from module_budget()


METRIC_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=2e-5)
OPT = {"optimizer": "adamw", "lr": 1e-3, "wd": 0.05, "max_grad_norm": 0.5}
STEPS = 2


def _samples(rng, n, vocab=256):
    out = []
    for _ in range(n):
        ids = rng.integers(3, vocab, int(rng.integers(6, 24)))
        ids[0], ids[1] = 1, -200
        labels = ids.copy()
        labels[:2] = -100
        out.append({"input_ids": ids, "labels": labels,
                    "image": rng.integers(0, 256, (28, 28, 3)).astype(
                        np.uint8)})
    return out


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    tok = FakeTokenizer(256)
    return [j_collate.SupervisedCollator(tok, pad_multiple=8)(
        _samples(rng, 4)) for _ in range(n)]


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{pre}[{i}]")
    else:
        yield pre, np.asarray(tree)


def _assert_trees(got, want, exact=False, scaled=None, **tol):
    """Leaf by leaf: equal, within `tol`, or (`scaled`) within that
    fraction of the largest magnitude in `want`."""
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    top = scaled and max(float(np.abs(w).max(initial=0.0))
                         for w in want.values())
    for k, w in want.items():
        if exact:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        elif scaled is not None:
            np.testing.assert_allclose(got[k], w, rtol=0, err_msg=k,
                                       atol=scaled * top)
        else:
            np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_vlm.VLMConfig.tiny_test(stage=2, lora=True)
    params = jax.tree_util.tree_map(
        np.asarray, j_vlm.init_vlm_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    for ab in params["lora"].values():
        ab["b"] = (rng.standard_normal(ab["b"].shape) * 0.02).astype(
            np.float32)
    batches = _batches(STEPS)
    for b in batches:  # the two data halves hold different token counts
        valid = (np.asarray(b["labels"])[:, 1:] != -100).sum(axis=1)
        assert valid[:2].sum() != valid[2:].sum()
    return jcfg, params, batches


@pytest.fixture(scope="module")
def jax_mesh_run(setup):
    """JAX's step over make_mesh(dp=2, tp=2), the batch on "data"."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    jcfg, params, batches = setup
    mask = j_vlm.trainable_mask(params, jcfg)
    tx = j_optimizer.build_optimizer(ConfigDict(OPT), params, mask)
    mesh = j_make_mesh(dp=2, tp=2)
    p = j_shard_params(mesh, params)
    st = tx.init(p)
    step = jax.jit(j_trainer.make_train_step(
        jcfg, tx, compute_dtype=jnp.float32, trainable=mask))
    metrics = []
    for b in batches:
        bsh = jax.tree_util.tree_map(
            lambda x: jax.device_put(np.asarray(x),
                                     NamedSharding(mesh, P("data"))), b)
        p, st, m = step(p, st, bsh)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree_util.tree_map(np.asarray, p)


def _payload(setup, dp, tp, **kw):
    _, params, batches = setup
    return dict({"cfg": {"stage": 2, "lora": True}, "params": params,
                 "opt": OPT, "batches": batches, "dp": dp, "tp": tp}, **kw)


@pytest.fixture(scope="module")
def port_runs(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    return {key: run_ranks(key[0] * key[1], "train",
                           _payload(setup, *key), tmp / f"{key}",
                           timeout=240)
            for key in ((2, 2), (2, 1))}


def _single_rank(setup, batches=None, steps=True):
    """The port without a mesh: (metrics, whole params, optimizer
    state)."""
    _, params, all_batches = setup
    cfg = t_vlm.VLMConfig.tiny_test(stage=2, lora=True)
    p = training_params_from_numpy(params, cfg, torch.float32, "cpu")
    opt = build_optimizer(OPT, p, t_vlm.trainable_mask(p, cfg))
    step = make_train_step(cfg, opt, torch.float32)
    metrics = [{k: float(v) for k, v in step(p, b).items()}
               for b in (batches or all_batches)]
    return metrics, to_host(as_loaded(p)), to_host(opt.state_dict())


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
def test_dp2_tp2_step_matches_jax_mesh_step(setup, jax_mesh_run,
                                            port_runs):
    want_metrics, want_params = jax_mesh_run
    ranks = port_runs[(2, 2)]
    for got in ranks:
        for g, w in zip(got["metrics"], want_metrics):
            for k in ("total_loss", "text_loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                           err_msg=k)
        _assert_trees(got["params"], want_params, **PARAM_TOL)
    for got in ranks[1:]:
        _assert_trees(got["replicated"], ranks[0]["replicated"], exact=True)


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
def test_zero_dp2_state_matches_single_rank(setup, port_runs, tmp_path):
    """ZeRO over two ranks: parameters and the gathered slots as one
    rank's; a rank that skips its gradient reduction breaks them."""
    metrics, params, opt = _single_rank(setup)
    ranks = port_runs[(2, 1)]
    for got in ranks:
        for g, w in zip(got["metrics"], metrics):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL)
        _assert_trees(got["params"], params, **PARAM_TOL)
        assert got["opt"]["name"] == opt["name"]
        assert got["opt"]["paths"] == opt["paths"]
        assert got["opt"]["count"] == opt["count"] == STEPS
        _assert_trees(got["opt"]["slots"], opt["slots"], scaled=1e-5)
        _assert_trees(got["replicated"], ranks[0]["replicated"], exact=True)
    bad = run_ranks(2, "train", _payload(setup, 2, 1, fault="skip_reduce"),
                    tmp_path)
    with pytest.raises(AssertionError):
        _assert_trees(bad[0]["params"], params, **PARAM_TOL)


def _trainer(setup, work_dir, max_iters):
    _, params, batches = setup
    cfg = t_vlm.VLMConfig.tiny_test(stage=2, lora=True)
    p = training_params_from_numpy(params, cfg, torch.float32, "cpu")
    opt = build_optimizer(OPT, p, t_vlm.trainable_mask(p, cfg))
    return IterBasedTrainer(cfg, p, opt, batches, max_iters=max_iters,
                            work_dir=str(work_dir),
                            compute_dtype=torch.float32, ckpt_period=2,
                            log_period=100)


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
def test_checkpoints_move_between_dp2_and_dp1(tmp_path):
    """dp 2 -> dp 1 and dp 1 -> dp 2 resumes: the optimizer state read
    back is the one written, and the runs end as an unbroken one does."""
    jcfg = j_vlm.VLMConfig.tiny_test(stage=2, lora=True)
    params = jax.tree_util.tree_map(
        np.asarray, j_vlm.init_vlm_params(jax.random.PRNGKey(0), jcfg))
    setup = (jcfg, params, _batches(4, seed=3))
    whole = _trainer(setup, tmp_path / "whole", 4)
    whole.train()
    want = to_host(as_loaded(whole.params))

    def written(work_dir):
        from lhrs_bot_tpu_torch.core import checkpoint as ckpt

        path = ckpt.latest_checkpoint(str(work_dir / "checkpoints"))
        assert os.path.basename(path) == "checkpoint_2"
        return ckpt.load_checkpoint(path)

    # dp 2 writes at iteration 2; dp 1 resumes
    run_ranks(2, "train", _payload(setup, 2, 1, ckpt={
        "dir": str(tmp_path / "a"), "max_iters": 2, "period": 2}),
        tmp_path / "a_run")
    state = written(tmp_path / "a")
    assert state["client_state"]["mesh_shape"] == {"data": 2, "model": 1}
    t = _trainer(setup, tmp_path / "a", 4)
    assert t.resume()
    _assert_trees(to_host(t.optimizer.state_dict()), state["opt_state"],
                  exact=True)
    t.train()
    _assert_trees(to_host(as_loaded(t.params)), want, **PARAM_TOL)

    # dp 1 writes at iteration 2; dp 2 resumes
    t = _trainer(setup, tmp_path / "b", 2)
    t.train()
    state = written(tmp_path / "b")
    shutil.copytree(tmp_path / "b", tmp_path / "c")
    ranks = run_ranks(2, "train", _payload(setup, 2, 1, ckpt={
        "dir": str(tmp_path / "c"), "max_iters": 4, "period": 100,
        "resume": True}), tmp_path / "c_run")
    for got in ranks:
        _assert_trees(got["resumed_opt"], state["opt_state"], exact=True)
        _assert_trees(got["resumed_params"], state["params"], exact=True)
        _assert_trees(got["params"], want, **PARAM_TOL)


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
def test_stage2_entry_dp2_tp2_matches_dp2(tmp_path, weights):
    """`main_pretrain_stage2_torch.py` over a dp 2 x tp 2 mesh of gloo
    ranks trains as over dp 2 x tp 1: each data index draws the same
    samples (the loader's share and the generators' seed follow the data
    index, not the rank), and the decoder's split changes no number
    beyond summation order."""
    data = str(tmp_path / "data")
    write_instruct_corpus(data, seed=22, n_per_task=8,
                          sizes=((40, 52), (28, 30)), text_only=False,
                          missing=False)
    common = ["-c", _config(tmp_path, weights, 2), "--data-path", data,
              "--workers", "1", "--seed", "5", "--device", "cpu",
              "--batch-size", "4", "--dist-backend", "gloo"]
    script = str(REPO / "main_pretrain_stage2_torch.py")
    outs = {}
    for dp, tp in ((2, 2), (2, 1)):
        out = str(tmp_path / f"dp{dp}tp{tp}")
        ranks = run_ranks(dp * tp, "entry", {"script": script, "argv": common
                          + ["--dp", str(dp), "--tp", str(tp), "--output",
                             out]}, tmp_path / f"run{dp}{tp}")
        assert [r["mesh"] for r in ranks] == [{"data": dp, "model": tp}] * (
            dp * tp)
        assert {r["cur_iter"] for r in ranks} == {2}
        outs[(dp, tp)] = _final(out)
    got, want = outs[(2, 2)], outs[(2, 1)]
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith(("lora/", "rgb_pooler/")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                       **PARAM_TOL)
        else:
            assert got[k].numpy().tobytes() == w.numpy().tobytes(), k
