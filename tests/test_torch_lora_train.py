"""The port's stage-2 and stage-3 training (LoRA / QLoRA) against the JAX
trainer: the first step's gradients and three `Trainer` steps over an int8
base with live adapters (stage 2 and stage 3) and over a dense base (stage
2), and `build_trainer` from the recipes' config surface. The tolerances,
and why an int8 base needs its own, are in tests/test_torch_lora.py's
docstring.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.core.config import ConfigDict
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu.train import optimizer as j_optimizer
from lhrs_bot_tpu.train import schedule as j_schedule
from lhrs_bot_tpu.train import trainer as j_trainer
from lhrs_bot_tpu_torch.core import build_trainer, training_params_from_numpy
from lhrs_bot_tpu_torch.core.config import load_yaml_config
from lhrs_bot_tpu_torch.models import lora as t_lora
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.train import (HookBase, IterBasedTrainer,
                                      build_optimizer, build_schedule)

from .test_torch_lora import ALPHA, R, STATE_TOL, tiny  # noqa: F401
from .test_torch_train import _leaves, _np_tree, _rel_l2, _supervised_batch


# -- training --------------------------------------------------------------


STAGE_CONFIG = {"optimizer": "adamw", "betas": [0.9, 0.95], "lr": 0.002,
                "wd": 0.0, "max_grad_norm": 1.0,
                "schedule": {"name": "cosine", "min_lr": 0.0002,
                             "warmup_epochs": 2, "warmup_method": "linear",
                             "warmup_factor": 0.1}}
TRAIN_CASES = {"stage2_int8": (2, 8), "stage3_int8": (3, 8),
               "stage2_dense": (2, 16)}


def _stage_tree(case, params):
    stage, bits = TRAIN_CASES[case]
    if bits == 8:
        params = {**params, "llama": {**params["llama"], "layers": _np_tree(
            j_quant.quantize_llama_layers(params["llama"]["layers"],
                                          bits=8))}}
    return stage, params


def _bumped(params, groups=("pooler",)):
    """`params` with the leaves of `groups` scaled by (1 + 2^-23): a one-ulp
    change of the kind that a different float32 summation order makes."""
    return {**params, **{k: jax.tree_util.tree_map(
        lambda x: x * np.float32(1 + 2 ** -23), params[k]) for k in groups}}


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel()
                           for x in _leaves(_np_tree(tree))])


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_first_step_grads_match_jax(tiny, case, monkeypatch):
    """The loss and its gradients with respect to the adapters and the
    pooler against jax.value_and_grad of the JAX vlm_forward_loss: loss
    within 1e-5, gradients within 1e-4 relative L2 (1e-3 over an int8
    base, which must lie above JAX's own gradients' move under a one-ulp
    change of the pooler and below a planted fault); the quantized base
    gets no gradient."""
    jcfg, tcfg, base = tiny
    stage, params = _stage_tree(case, base)
    jcfg = dataclasses.replace(jcfg, stage=stage)
    tcfg = dataclasses.replace(tcfg, stage=stage)
    batch = _supervised_batch(7)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    groups = ("lora", "pooler")

    def jloss(train):
        return j_vlm.vlm_forward_loss({**jp, **train}, jcfg, {
            k: jnp.asarray(v) for k, v in batch.items()},
            compute_dtype=jnp.float32)["total_loss"]

    loss_j, g_j = jax.value_and_grad(jloss)({k: jp[k] for k in groups})
    tp = training_params_from_numpy(params, tcfg, torch.float32, "cpu")
    int8 = TRAIN_CASES[case][1] == 8
    bound = 1e-3 if int8 else 1e-4
    leaves = [t for k in groups for t in _leaves(tp[k])]
    assert all(t.requires_grad for t in leaves)
    n_lora = len(list(_leaves(tp["lora"])))

    def deviations():
        loss = t_vlm.vlm_forward_loss(
            tp, tcfg, batch, compute_dtype=torch.float32)["total_loss"]
        grads = torch.autograd.grad(loss, leaves)
        out = {}
        for k, got in (("lora", grads[:n_lora]), ("pooler", grads[n_lora:])):
            got = np.concatenate([g.numpy().ravel() for g in got])
            out[k] = _rel_l2(got, _flat(g_j[k]))
        return float(loss.detach()), out

    loss, dev = deviations()
    print(f"{case}: the port's gradients from JAX's {dev}")
    np.testing.assert_allclose(loss, float(loss_j), **STATE_TOL)
    assert max(dev.values()) < bound, dev
    if int8:
        assert isinstance(tp["llama"]["layers"]["wq"], t_quant.QuantizedTensor)
        g_b = jax.grad(jloss)(_bumped({k: jp[k] for k in groups}))
        spread = {k: _rel_l2(_flat(g_b[k]), _flat(g_j[k])) for k in groups}
        print(f"{case}: JAX's gradients under a one-ulp pooler {spread}")
        assert spread["lora"] < bound, spread
        backward = t_quant._QuantizedMatmul.backward

        def faulty(ctx, g):
            dx, *rest = backward(ctx, g)
            return (dx * 0.99, *rest)

        monkeypatch.setattr(t_quant._QuantizedMatmul, "backward",
                            staticmethod(faulty))
        fault = deviations()[1]
        print(f"{case}: the port's gradients with dx * 0.99 {fault}")
        assert min(fault.values()) > bound, fault


PARAM_BOUND_INT8 = 1.5e-4


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_trainer_steps_match_jax(tiny, case):
    """Three steps of the port's IterBasedTrainer against the JAX trainer
    at stage 2 (int8 base with live adapters, and a dense base) and stage 3
    (int8 base, the perceiver frozen), float32, AdamW with clipping and a
    cosine schedule: losses and lr within 1e-5, grad_norm within 1e-5 (1e-3
    relative over an int8 base), the adapters and the pooler after every
    step within 1e-5 (over an int8 base: 1.5e-4 relative L2 of them all,
    which must lie above JAX's own move under a one-ulp change of the
    pooler and below the move that B's scale off by 1% makes after three
    steps; see the module docstring); the frozen leaves (the int8 codes
    among them) never move."""
    jcfg, tcfg, base = tiny
    stage, params = _stage_tree(case, base)
    jcfg = dataclasses.replace(jcfg, stage=stage, tune_rgb_pooler=stage == 2)
    tcfg = dataclasses.replace(tcfg, stage=stage, tune_rgb_pooler=stage == 2)
    loader = [_supervised_batch(50 + i) for i in range(3)]
    watched = ("lora", "pooler")

    class JProbe(j_trainer.HookBase):
        def __init__(self):
            self.seen = []

        def after_iter(self):
            self.seen.append([np.array(x) for k in watched for x in
                              _leaves(_np_tree(self.trainer.params[k]))])

    class TProbe(HookBase):
        def __init__(self):
            self.seen = []

        def after_iter(self):
            self.seen.append([t.detach().float().numpy().copy()
                              for k in watched
                              for t in _leaves(self.trainer.params[k])])

    def run_jax(params):
        jsched = j_schedule.build_schedule(ConfigDict(STAGE_CONFIG), 3)
        tx = j_optimizer.build_optimizer(ConfigDict(STAGE_CONFIG), params,
                                         j_vlm.trainable_mask(params, jcfg),
                                         schedule=jsched)
        probe = JProbe()
        jt = j_trainer.IterBasedTrainer(
            jcfg, jax.tree_util.tree_map(jnp.array, params), tx, loader,
            max_iters=3, compute_dtype=jnp.float32, log_period=1,
            schedule=jsched, hooks=[probe])
        jt.train()
        return jt, probe.seen

    def run_port(cfg):
        tp = training_params_from_numpy(params, cfg, torch.float32, "cpu")
        tsched = build_schedule(STAGE_CONFIG, 3)
        opt = build_optimizer(STAGE_CONFIG, tp, t_vlm.trainable_mask(tp, cfg),
                              tsched)
        assert len(opt.params) == len(list(_leaves(tp["lora"]))) + (
            len(list(_leaves(tp["pooler"]))) if stage == 2 else 0)
        probe = TProbe()
        tt = IterBasedTrainer(cfg, tp, opt, loader, max_iters=3,
                              compute_dtype=torch.float32, log_period=1,
                              schedule=tsched, hooks=[probe])
        tt.train()
        return tt, probe.seen

    def param_gaps(seen, want):
        return [_rel_l2(np.concatenate([g.ravel() for g in got]),
                        np.concatenate([w.ravel() for w in ref]))
                for got, ref in zip(seen, want)]

    jt, jseen = run_jax(params)
    tt, tseen = run_port(tcfg)

    def norm_gaps(values):
        want = np.asarray(jt.metric_storage["grad_norm"]._window)
        return [float(x) for x in np.abs(np.asarray(values) / want - 1)]

    int8 = TRAIN_CASES[case][1] == 8
    for key in ("total_loss", "text_loss", "grad_norm", "lr"):
        tol = dict(rtol=1e-3, atol=0) if int8 and key == "grad_norm" \
            else STATE_TOL
        np.testing.assert_allclose(tt.metric_storage[key].values,
                                   list(jt.metric_storage[key]._window),
                                   **tol)
    assert len(tseen) == len(jseen) == 3
    if int8:
        gaps = param_gaps(tseen, jseen)
        print(f"{case}: the port's parameters from JAX's {gaps}, grad_norm "
              f"{norm_gaps(tt.metric_storage['grad_norm'].values)}")
        assert max(gaps) < PARAM_BOUND_INT8, gaps
        jt_b, bumped = run_jax(_bumped(params))
        spread = param_gaps(bumped, jseen)
        norm_b = norm_gaps(list(jt_b.metric_storage["grad_norm"]._window))
        print(f"{case}: JAX's parameters under a one-ulp pooler {spread}, "
              f"grad_norm {norm_b}")
        assert max(spread) < PARAM_BOUND_INT8, spread
        faulty = dataclasses.replace(tcfg, lora=dataclasses.replace(
            tcfg.lora, alpha=tcfg.lora.alpha * 1.01))
        tt_f, fseen = run_port(faulty)
        fault = param_gaps(fseen, jseen)
        fault_norm = norm_gaps(tt_f.metric_storage["grad_norm"].values)
        print(f"{case}: the port's parameters with B's scale * 1.01 {fault}, "
              f"grad_norm {fault_norm}")
        assert fault[-1] > PARAM_BOUND_INT8, fault
        assert max(fault_norm) > 1e-3, fault_norm
    else:
        for got, want in zip(tseen, jseen):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, **STATE_TOL)
    wq = tt.params["llama"]["layers"]["wq"]
    given = params["llama"]["layers"]["wq"]
    if int8:
        np.testing.assert_array_equal(wq.q.numpy(), given.q)
    else:
        np.testing.assert_array_equal(wq.numpy(), given)
    if stage == 3:
        for got, want in zip(_leaves(tt.params["pooler"]),
                             _leaves(params["pooler"])):
            np.testing.assert_array_equal(got.numpy(), want)


def test_build_trainer_stage2_and_stage3(tiny):
    """build_trainer from the stage-2 / stage-3 recipes' config surface:
    stage 2 an epoch-based trainer over the adapters and the pooler, stage
    3 an iteration-based one over the adapters only (the recipe freezes
    the perceiver); both run and move only those leaves."""
    _, _, params = tiny
    for name, stage, trains_pooler in (("stage2", 2, True),
                                       ("stage3", 3, False)):
        config = load_yaml_config(f"Config/multi_modal_{name}.yaml")
        config["rgb_vision"]["arch"] = "vit_tiny"
        config["rgb_vision"]["attn_pooler"].update(num_query=12,
                                                   num_layers=2,
                                                   num_attn_heads=2,
                                                   stage_num=[6, 4, 2])
        config["text"].update(vocab_size=256, hidden_size=64,
                              intermediate_size=128, num_hidden_layers=2,
                              num_attention_heads=4,
                              max_position_embeddings=128)
        config["lora"].update(lora_r=R, lora_alpha=ALPHA)
        config["epochs"] = 2
        t = build_trainer(config, params, [_supervised_batch(60)], "cpu",
                          compute_dtype=torch.float32)
        assert t.model_cfg.stage == stage and t.max_iters == 2
        assert t.model_cfg.lora == t_lora.LoraConfig(r=R, alpha=ALPHA,
                                                     dropout=0.05)
        n_lora = len(list(_leaves(params["lora"])))
        n_pool = len(list(_leaves(params["pooler"])))
        assert len(t.optimizer.params) == n_lora + trains_pooler * n_pool
        t.train()
        assert np.isfinite(t.metric_storage["total_loss"].latest)
        moved = [not np.array_equal(x.detach().numpy(), y) for x, y in zip(
            _leaves(t.params["pooler"]), _leaves(params["pooler"]))]
        assert any(moved) == trains_pooler
        assert not np.array_equal(t.params["lora"]["wq"]["a"].detach()
                                  .numpy(), params["lora"]["wq"]["a"])
