"""The port's training checkpoints (core/checkpoint.py, the trainer's save
and resume, the checkpoint / eval / epoch-seed hooks) and what a trained
tree writes (save_final's frozen leaves, the dense LoRA merge), against the
JAX package on the CPU at the tiny widths.

Frozen leaves are written as they were loaded: FINAL.pt's frozen leaves are
byte-equal to the JAX trainer's, in either compute dtype; trained leaves
agree within test_torch_train.py's bound (1e-5) in float32. A port
checkpoint loads in JAX's `load_checkpoint`. An interrupted and resumed run
equals the uninterrupted one bit for bit (parameters, optimizer state,
schedule, metric sums, EvalHook.best, the sampler's epoch).
"""

import dataclasses
import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.core import checkpoint as j_ckpt
from lhrs_bot_tpu.core import model_io as j_model_io
from lhrs_bot_tpu.core.config import ConfigDict
from lhrs_bot_tpu.models import lora as j_lora
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.train import optimizer as j_optimizer
from lhrs_bot_tpu.train import schedule as j_schedule
from lhrs_bot_tpu.train import trainer as j_trainer
from lhrs_bot_tpu_torch.core import checkpoint as t_ckpt
from lhrs_bot_tpu_torch.core import model_io as t_model_io
from lhrs_bot_tpu_torch.core.convert import (as_loaded, source_of,
                                             training_params_from_numpy)
from lhrs_bot_tpu_torch.data import SupervisedCollator
from lhrs_bot_tpu_torch.data.datasets import InstructDataset
from lhrs_bot_tpu_torch.data.loader import DataLoader
from lhrs_bot_tpu_torch.models import lora as t_lora
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.ops.quant import quantize_int8
from lhrs_bot_tpu_torch.train import (EpochSeedHook, EvalHook, HookBase,
                                      IterBasedTrainer, build_optimizer,
                                      build_schedule)

from .fake_tokenizer import FakeTokenizer
from .test_torch_train import STATE_TOL, TRAIN_CONFIG, _supervised_batch
from .torch_corpora import write_instruct_corpus


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _configs(stage):
    lora = stage == 3
    jcfg = dataclasses.replace(j_vlm.VLMConfig.tiny_test(stage, lora=lora),
                               tune_rgb_pooler=stage != 3)
    tcfg = dataclasses.replace(t_vlm.VLMConfig.tiny_test(stage, lora=lora),
                               tune_rgb_pooler=stage != 3)
    return jcfg, tcfg


def _jax_trainer(jcfg, jparams, loader, dtype, **kw):
    sched = j_schedule.build_schedule(ConfigDict(TRAIN_CONFIG), len(loader))
    tx = j_optimizer.build_optimizer(ConfigDict(TRAIN_CONFIG), jparams,
                                     j_vlm.trainable_mask(jparams, jcfg),
                                     schedule=sched)
    return j_trainer.IterBasedTrainer(
        jcfg, jax.tree_util.tree_map(jnp.array, jparams), tx, loader,
        max_iters=len(loader), compute_dtype=dtype, log_period=1,
        schedule=sched, **kw)


def _port_trainer(tcfg, nparams, loader, dtype, max_iters=None, **kw):
    params = training_params_from_numpy(nparams, tcfg, dtype, "cpu")
    n = max_iters or len(loader)
    sched = build_schedule(TRAIN_CONFIG, n)
    opt = build_optimizer(TRAIN_CONFIG, params,
                          t_vlm.trainable_mask(params, tcfg), sched)
    return IterBasedTrainer(tcfg, params, opt, loader, max_iters=n,
                            compute_dtype=dtype, log_period=1,
                            schedule=sched, **kw)


def _final_pt(out_dir):
    sd = torch.load(os.path.join(out_dir, "FINAL.pt"), weights_only=True)
    flat = dict(_flat(sd))
    lora = os.path.join(out_dir, "TextLoRA", "adapter_model.bin")
    if os.path.exists(lora):
        for k, v in torch.load(lora, weights_only=True).items():
            flat["lora/" + k] = v
    return flat


# -- what a trained tree writes -----------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per stage: two float32 steps of the JAX trainer from a seeded tree,
    its FINAL.pt written by JAX's save_final. {stage: (jcfg, tcfg, numpy
    init, loader, JAX params after the steps as numpy, FINAL.pt's
    leaves)}."""
    runs = {}
    for stage in (1, 3):
        jcfg, tcfg = _configs(stage)
        jparams = j_vlm.init_vlm_params(jax.random.PRNGKey(3), jcfg)
        loader = [_supervised_batch(60 + i) for i in range(2)]
        jt = _jax_trainer(jcfg, jparams, loader, jnp.float32)
        jt.train()
        out = str(tmp_path_factory.mktemp(f"jax_stage{stage}"))
        j_model_io.save_final(out, jt.params, jcfg)
        runs[stage] = (jcfg, tcfg, _np_tree(jparams), loader,
                       _np_tree(jt.params), _final_pt(out))
    return runs


@pytest.mark.parametrize("stage", [1, 3])
def test_save_final_writes_frozen_leaves_as_loaded(tmp_path, stage,
                                                   jax_runs):
    """Two steps of the JAX trainer (float32) and of the port's trainer
    (bf16 and float32) from the same float32 seeded tree, then save_final
    in both packages: the frozen leaves (the ViT; at stage 3 the perceiver
    too) byte-equal to JAX's FINAL.pt in either compute dtype (the JAX
    trainer keeps them in float32 whatever it computes in); the trained
    leaves (the perceiver at stage 1, the adapters at stage 3) within 1e-5
    in float32."""
    _, tcfg, nparams, loader, _, want = jax_runs[stage]
    frozen = [k for k in want if k.startswith("rgb_ckpt")
              or (stage == 3 and "rgb_pooler" in k)]
    trained = [k for k in want if k.startswith("lora/")
               or (stage == 1 and "rgb_pooler" in k)]
    assert frozen and trained
    for dtype in (torch.bfloat16, torch.float32):
        tt = _port_trainer(tcfg, nparams, loader, dtype)
        tt.train()
        out = str(tmp_path / f"port_{dtype}")
        t_model_io.save_final(out, tt.params, tcfg)
        got = _final_pt(out)
        assert set(got) == set(want)
        worst = max(float((got[k].double() - want[k].double()).abs().max())
                    for k in frozen)
        assert worst == 0.0, f"{dtype}: frozen leaves differ by up to " \
            f"{worst:.3g}"
        for k in frozen:
            assert got[k].dtype == want[k].dtype == torch.float32
            assert got[k].numpy().tobytes() == want[k].numpy().tobytes(), k
        if dtype == torch.float32:
            for k in trained:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           err_msg=k, **STATE_TOL)
        else:  # a bf16 copy whose source is the given array, not a copy
            vit_wq = tt.params["vit"]["layers"]["wq"]
            assert vit_wq.dtype == torch.bfloat16
            assert source_of(vit_wq) is nparams["vit"]["layers"]["wq"]


def test_dense_lora_merge_rounds_once():
    """Over a dense base, JAX merges into its float32 base and the model
    casts once: round(W + d). A bf16 base merged again, round(round(W) +
    d), misses that by more than one bf16 ulp of the merged weight where W
    and d nearly cancel, so training keeps the merged projections' base in
    float32 (`training_params_from_numpy`) and the merge rounds once: the
    port's merged weights equal JAX's bit for bit."""
    jcfg = j_vlm.VLMConfig.tiny_test(2, lora=True)
    tcfg = t_vlm.VLMConfig.tiny_test(2, lora=True)
    nparams = _np_tree(j_vlm.init_vlm_params(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(5)
    for ab in nparams["lora"].values():  # adapters as after some training
        ab["b"] = (rng.standard_normal(ab["b"].shape) * 0.05).astype(
            np.float32)
    jmerged = j_lora.merge_lora(
        jax.tree_util.tree_map(jnp.asarray, nparams["llama"]["layers"]),
        jax.tree_util.tree_map(jnp.asarray, nparams["lora"]), jcfg.lora)
    params = training_params_from_numpy(nparams, tcfg, torch.bfloat16, "cpu")
    layers = t_vlm.effective_llama_params(params, tcfg)["layers"]
    bf16_base = t_lora.merge_lora(
        {k: torch.tensor(nparams["llama"]["layers"][k]).bfloat16()
         for k in nparams["lora"]},
        {k: {n: torch.tensor(x) for n, x in ab.items()}
         for k, ab in nparams["lora"].items()}, tcfg.lora)
    worst_ulps = 0.0
    for name in nparams["lora"]:
        want = np.asarray(jmerged[name].astype(jnp.bfloat16).astype(
            jnp.float32))
        assert params["llama"]["layers"][name].dtype == torch.float32
        got = layers[name].to(torch.bfloat16).float().detach().numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                      - 7)
        old = bf16_base[name].float().numpy()
        worst_ulps = max(worst_ulps, float((np.abs(old - want) / ulp).max()))
    print(f"bf16-base merge: up to {worst_ulps:.1f} bf16 ulps from JAX")
    assert worst_ulps > 1.0
    # the norms and the embedding stay in the compute dtype
    assert params["llama"]["embed_tokens"].dtype == torch.bfloat16


# -- core/checkpoint.py ---------------------------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"pooler": {"query": rng.standard_normal((3, 4)).astype(
        np.float32)}, "llama": {"n": np.arange(5, dtype=np.int32)}}


def test_save_prune_latest_load_match_jax(tmp_path):
    """Both packages: checkpoint_<step>/ renamed from .tmp, latest.txt,
    pruning to max_to_keep, the mtime fallback, and the load."""
    for pkg, mod in (("jax", j_ckpt), ("port", t_ckpt)):
        d = str(tmp_path / pkg)
        for step in (1, 2, 3, 4):
            mod.save_checkpoint(d, step, _tree(step), {"c": step},
                                {"cur_iter": step}, max_to_keep=2)
        assert sorted(os.listdir(d)) == ["checkpoint_3", "checkpoint_4",
                                         "latest.txt"]
        assert mod.latest_checkpoint(d) == os.path.join(d, "checkpoint_4")
        os.remove(os.path.join(d, "latest.txt"))
        os.utime(os.path.join(d, "checkpoint_3"), (1e9, 4e9))
        assert mod.latest_checkpoint(d) == os.path.join(d, "checkpoint_3")
        assert mod.latest_checkpoint(str(tmp_path / "none")) is None
        out = mod.load_checkpoint(os.path.join(d, "checkpoint_4"))
        assert out["step"] == 4 and out["client_state"] == {"cur_iter": 4}
        np.testing.assert_array_equal(out["params"]["pooler"]["query"],
                                      _tree(4)["pooler"]["query"])
    port = os.path.join(str(tmp_path / "port"), "checkpoint_4")
    assert sorted(os.listdir(port)) == ["client_state.pkl", "meta.json",
                                        "state.pkl"]


def test_checkpoint_pickles_hold_plain_types(tmp_path):
    """state.pkl and client_state.pkl hold only dicts, lists, tuples,
    scalars, strings, None and numpy arrays: bf16 tensors widened to
    float32, a quantized weight as its marker dict."""
    w = torch.randn(2, 8, 6)
    tree = {"a": torch.randn(3, dtype=torch.bfloat16), "q": quantize_int8(w),
            "l": [torch.ones(2)], "t": (1, "x", None, 2.5)}
    path = t_ckpt.save_checkpoint(str(tmp_path), 7, tree, {"m": [tree["a"]]},
                                  {"cur_iter": 7, "hooks": {}})

    class Strict(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] not in ("numpy", "builtins", "copyreg",
                                            "_codecs"):
                raise pickle.UnpicklingError(f"{module}.{name}")
            return super().find_class(module, name)

    for name in ("state.pkl", "client_state.pkl"):
        with open(os.path.join(path, name), "rb") as fh:
            Strict(fh).load()
    out = t_ckpt.load_checkpoint(path)
    assert out["params"]["a"].dtype == np.float32
    q = out["params"]["q"]
    assert q[t_ckpt.QUANTIZED_KEY] == 1 and q["bits"] == 8
    np.testing.assert_array_equal(q["q"], tree["q"].q.numpy())
    np.testing.assert_array_equal(q["scale"], tree["q"].scale.numpy())
    assert out["params"]["t"] == (1, "x", None, 2.5)


def test_jax_load_checkpoint_reads_a_port_checkpoint(tmp_path, jax_runs):
    """Two steps of each trainer on the same batches, the port's
    checkpoint read by JAX's load_checkpoint (state.pkl, no state/): its
    params are the JAX trainer's: frozen leaves equal, the perceiver
    within 1e-5."""
    _, tcfg, nparams, loader, jax_params, _ = jax_runs[1]
    tt = _port_trainer(tcfg, nparams, loader, torch.float32,
                       work_dir=str(tmp_path), ckpt_period=2)
    tt.train()
    path = t_ckpt.latest_checkpoint(str(tmp_path / "checkpoints"))
    assert os.path.basename(path) == "checkpoint_2"
    out = j_ckpt.load_checkpoint(path)
    assert out["step"] == 2 and out["client_state"]["cur_iter"] == 2
    assert set(out["client_state"]) == {"cur_iter", "world_size",
                                        "mesh_shape", "metric_storage",
                                        "hooks"}
    want = dict(_flat(jax_params))
    got = dict(_flat(out["params"]))
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("pooler"):
            np.testing.assert_allclose(got[k], w, err_msg=k, **STATE_TOL)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert out["opt_state"]["name"] == "adanp"
    assert out["opt_state"]["count"] == 2


# -- the JAX trainer's cases, on the port --------------------------------------


class _ToyLoader:
    """tests/test_train.py's loader: the same batch forever (length 1)."""

    def __init__(self):
        self.batch = _supervised_batch(80)

    def __iter__(self):
        yield self.batch

    def __len__(self):
        return 1


def _toy_trainer(tmp_path, max_iters=4):
    _, tcfg = _configs(1)
    nparams = _np_tree(j_vlm.init_vlm_params(jax.random.PRNGKey(0),
                                             j_vlm.VLMConfig.tiny_test(1)))
    params = training_params_from_numpy(nparams, tcfg, torch.float32, "cpu")
    opt = build_optimizer({"optimizer": "adamw", "lr": 1e-3, "wd": 0.0},
                          params, t_vlm.trainable_mask(params, tcfg))
    return IterBasedTrainer(tcfg, params, opt, _ToyLoader(),
                            max_iters=max_iters, work_dir=str(tmp_path),
                            compute_dtype=torch.float32, log_period=2,
                            ckpt_period=2)


def test_loop_runs_and_checkpoints(tmp_path):
    """tests/test_train.py::TestTrainerLoop::test_loop_runs_and_checkpoints
    on the port."""
    t = _toy_trainer(tmp_path)
    t.train()
    assert t.cur_iter == 4
    assert "total_loss" in t.metric_storage.keys()
    ckpts = os.listdir(os.path.join(str(tmp_path), "checkpoints"))
    assert any(c.startswith("checkpoint_") for c in ckpts)


def test_resume_restores_iter_and_params(tmp_path):
    """tests/test_train.py::TestTrainerLoop::
    test_resume_restores_iter_and_params on the port."""
    t = _toy_trainer(tmp_path, max_iters=2)
    t.train()
    w_after = t.params["pooler"]["query"].detach().numpy().copy()
    t2 = _toy_trainer(tmp_path, max_iters=4)
    assert t2.resume()
    assert t2.cur_iter == 2
    np.testing.assert_allclose(t2.params["pooler"]["query"].detach().numpy(),
                               w_after, atol=1e-6)
    t2.train()
    assert t2.cur_iter == 4


def test_pluggable_into_eval_hook():
    """tests/test_eval_serve.py::test_pluggable_into_eval_hook on the
    port."""
    calls = []
    hook = EvalHook(period=2, eval_fn=lambda: (calls.append(1) or
                                               {"accuracy": len(calls)}),
                    save_best=False)

    class FakeTrainer:
        cur_iter = 0

        class metric_storage:
            @staticmethod
            def update(**kw):
                pass

    hook.trainer = FakeTrainer()
    for it in range(4):
        hook.trainer.cur_iter = it
        hook.after_iter()
    assert len(calls) == 2 and hook.best == 2


# -- resume, bit for bit ---------------------------------------------------------


class _Interrupt(Exception):
    pass


class _StopAt(HookBase):
    """Raises before iteration `at` runs: a run killed after the
    checkpoint of the iterations before it."""

    def __init__(self, at):
        self.at = at

    def before_iter(self):
        if self.trainer.cur_iter == self.at:
            raise _Interrupt()


def _disk_trainer(tmp_path, corpus, nparams, tcfg, hooks, max_iters=7):
    tok = FakeTokenizer(256)
    ds = InstructDataset(
        [os.path.join(corpus, "osm_task.json")],
        [os.path.join(corpus, "osm_task_Image")], tok, image_size=28)
    loader = DataLoader(ds, batch_size=2,
                        collate_fn=SupervisedCollator(tok, pad_multiple=8),
                        num_workers=1, seed=4)
    params = training_params_from_numpy(nparams, tcfg, torch.float32, "cpu")
    sched = build_schedule(TRAIN_CONFIG, max_iters)
    opt = build_optimizer(TRAIN_CONFIG, params,
                          t_vlm.trainable_mask(params, tcfg), sched)
    trainer = IterBasedTrainer(
        tcfg, params, opt, loader, max_iters=max_iters,
        epoch_len=len(loader), work_dir=str(tmp_path),
        compute_dtype=torch.float32, log_period=100, ckpt_period=2,
        schedule=sched, hooks=hooks)
    return trainer


def _eval_fn(holder):
    def fn():
        q = holder[0].params["pooler"]["query"]
        return {"accuracy": float(q.detach().double().sum())}
    return fn


def test_interrupted_resume_is_bit_for_bit(tmp_path):
    """An uninterrupted run of 7 iterations over a 3-batch epoch (one
    worker, seeded random, EpochSeedHook, an EvalHook, checkpoints every 2)
    against one killed before iteration 5 and resumed by a fresh trainer
    from its checkpoint at 4 (in epoch 1, one batch skipped): parameters,
    optimizer state, schedule step, metric sums and last values,
    EvalHook.best and the sampler's epoch equal bit for bit."""
    corpus = write_instruct_corpus(str(tmp_path / "corpus"), seed=12,
                                   tasks=("osm_task",), n_per_task=6,
                                   sizes=((28, 34), (40, 28)), jpeg=True,
                                   long_record=False, text_only=False,
                                   missing=False)
    _, tcfg = _configs(1)
    tcfg = dataclasses.replace(tcfg, llama=dataclasses.replace(
        tcfg.llama, vocab_size=256))
    jcfg = dataclasses.replace(j_vlm.VLMConfig.tiny_test(1),
                               llama=dataclasses.replace(
                                   j_vlm.VLMConfig.tiny_test(1).llama,
                                   vocab_size=256))
    nparams = _np_tree(j_vlm.init_vlm_params(jax.random.PRNGKey(7), jcfg))

    def run(work, hooks_extra, resume=False):
        holder = []
        ev = EvalHook(period=3, eval_fn=_eval_fn(holder), save_best=False)
        t = _disk_trainer(work, corpus, nparams, tcfg,
                          [EpochSeedHook(), ev] + hooks_extra)
        holder.append(t)
        random.seed(0)
        t.train(resume=resume)
        return t, ev

    full, full_ev = run(tmp_path / "full", [])
    with pytest.raises(_Interrupt):
        run(tmp_path / "cut", [_StopAt(5)])
    assert sorted(os.listdir(tmp_path / "cut" / "checkpoints")) == [
        "checkpoint_4", "latest.txt"]
    resumed, resumed_ev = run(tmp_path / "cut", [], resume=True)
    assert resumed.start_iter == 4 and resumed.cur_iter == full.cur_iter == 7
    for (k, g), (_, w) in zip(_flat(resumed.params), _flat(full.params)):
        assert torch.equal(g, w), k
    gs, ws = resumed.optimizer.state_dict(), full.optimizer.state_dict()
    assert gs["count"] == ws["count"] == 7 and gs["paths"] == ws["paths"]
    for slot in ws["slots"]:
        for g, w in zip(gs["slots"][slot], ws["slots"][slot]):
            assert torch.equal(g, w), slot
    for key in ("total_loss", "text_loss", "grad_norm", "lr"):
        g, w = resumed.metric_storage[key], full.metric_storage[key]
        assert (g._sum, g._count) == (w._sum, w._count), key
        assert g.values[-3:] == w.values[-3:], key
    assert resumed_ev.best == full_ev.best > float("-inf")
    assert resumed.data_loader.sampler.epoch == \
        full.data_loader.sampler.epoch == 2
    # as_loaded gives the trained masters and the loaded frozen leaves
    loaded = as_loaded(resumed.params)
    assert loaded["pooler"]["query"] is resumed.params["pooler"]["query"]
