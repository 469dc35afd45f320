"""The port's stage-1 training path (lhrs_bot_tpu_torch: llama_apply,
causal_lm_loss, the multi-image splice, vlm_forward_loss, the collators,
schedules, optimizers, metric storage and the trainer) against the JAX
package on the CPU.

Inputs and weights come from numpy's seeded generator or the JAX package's
`init_*_params` and go through both sides, in float32 (JAX at matmul
precision "highest", see conftest.py), so the sides differ only in
summation order: logits within 1e-4, losses within 1e-5, gradients within
1e-4 relative L2, optimizer and trainer states within 1e-5, schedules
within 1e-7. Integer outputs (collators, splice positions and segment ids)
must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lhrs_bot_tpu.core.config import ConfigDict
from lhrs_bot_tpu.data import collate as j_collate
from lhrs_bot_tpu.models import llama as j_llama
from lhrs_bot_tpu.models import splice as j_splice
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.train import hooks as j_hooks
from lhrs_bot_tpu.train import metric as j_metric
from lhrs_bot_tpu.train import optimizer as j_optimizer
from lhrs_bot_tpu.train import schedule as j_schedule
from lhrs_bot_tpu.train import trainer as j_trainer
from lhrs_bot_tpu_torch.core import (build_trainer, params_from_numpy,
                                     training_params_from_numpy)
from lhrs_bot_tpu_torch.data import PackingCollator, SupervisedCollator
from lhrs_bot_tpu_torch.models import llama as t_llama
from lhrs_bot_tpu_torch.models import splice as t_splice
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.ops import attention as t_attention
from lhrs_bot_tpu_torch.train import (HookBase, IterBasedTrainer,
                                      MetricStorage, Trainer,
                                      build_optimizer, build_schedule)

from .cpu_budget import module_budget
from .fake_tokenizer import FakeTokenizer


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    yield from module_budget()


LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.fixture(scope="module")
def vlm_setup():
    """The tiny stage-1 VLM: both configs, the JAX parameters and their
    numpy copy."""
    jcfg = j_vlm.VLMConfig.tiny_test(stage=1)
    tcfg = t_vlm.VLMConfig.tiny_test(stage=1)
    jparams = j_vlm.init_vlm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, _np_tree(jparams)


def _samples(rng, n, lo, hi, vocab, image=True, size=28):
    out = []
    for _ in range(n):
        ids = rng.integers(3, vocab, int(rng.integers(lo, hi)))
        ids[0] = 1
        if image:
            ids[1] = -200
        labels = ids.copy()
        labels[:2] = -100
        out.append({"input_ids": ids, "labels": labels,
                    "image": rng.integers(0, 256, (size, size, 3)).astype(
                        np.uint8) if image else None})
    return out


def _supervised_batch(seed, vocab=256):
    rng = np.random.default_rng(seed)
    tok = FakeTokenizer(vocab)
    return j_collate.SupervisedCollator(tok, pad_multiple=8)(
        _samples(rng, 3, 6, 20, vocab))


def _packed_batch(seed, vocab=256):
    rng = np.random.default_rng(seed)
    tok = FakeTokenizer(vocab)
    return j_collate.PackingCollator(tok, target_len=40, rows_per_batch=2,
                                     max_images_per_row=2)(
        _samples(rng, 4, 8, 18, vocab))


# -- decoder ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["attention_mask", "segment_ids"])
def test_llama_apply_logits(kind):
    """Cacheless logits with cumsum positions over a right-padded mask, or
    per-segment positions and block-diagonal attention; with segments only
    the positions of a segment are compared (padding rows attend nothing
    in the port, uniformly in the JAX reference)."""
    cfg = j_llama.LlamaConfig.tiny_test()
    jp = j_llama.init_llama_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(2)
    b, s = 2, 32
    ids = rng.integers(3, cfg.vocab_size, (b, s)).astype(np.int32)
    mask = np.ones((b, s), bool)
    seg = None
    if kind == "attention_mask":
        mask[1, 20:] = False
    else:
        seg = np.zeros((b, s), np.int32)
        seg[0, :10], seg[0, 10:27] = 1, 2
        seg[1, :30] = 1
        mask = seg != 0
    want = j_llama.llama_apply(
        jp, cfg, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), compute_dtype=jnp.float32,
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = t_llama.llama_apply(
        params_from_numpy(_np_tree(jp)), t_llama.LlamaConfig.tiny_test(),
        input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(mask), compute_dtype=torch.float32,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    rows = mask if seg is not None else np.ones_like(mask)
    np.testing.assert_allclose(got.detach().numpy()[rows],
                               np.asarray(want)[rows], **LOGIT_TOL)


def test_segment_positions():
    seg = np.asarray([[1, 1, 1, 2, 2, 3, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1]],
                     np.int32)
    got = t_llama.segment_positions(torch.from_numpy(seg))
    assert got.tolist() == [[0, 1, 2, 0, 1, 0, 0, 1], list(range(8))]


def test_causal_lm_loss():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    labels[0, :4] = -100
    labels[1, 7:] = -100
    want = j_llama.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = t_llama.causal_lm_loss(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    all_ignored = np.full((1, 4), -100, np.int32)
    assert float(t_llama.causal_lm_loss(
        torch.from_numpy(logits[:1, :4]), torch.from_numpy(all_ignored))) == 0


@pytest.mark.parametrize("with_segments", [False, True])
def test_splice_multi(with_segments):
    """Up to K = 3 markers a row (rows with 3, 1 and 0), labels and
    attention mask, and segment ids carried through: equal outputs."""
    rng = np.random.default_rng(4)
    b, t, k, n, d = 3, 24, 3, 5, 8
    ids = rng.integers(3, 60, (b, t)).astype(np.int32)
    ids[0, [2, 9, 15]] = -200
    ids[1, 4] = -200
    mask = np.ones((b, t), bool)
    mask[1, 20:] = False
    mask[2, 18:] = False
    labels = ids.copy()
    labels[:, :2] = -100
    seg = None
    if with_segments:
        seg = np.zeros((b, t), np.int32)
        seg[0, :8], seg[0, 8:22] = 1, 2
        seg[1, :20] = 1
        seg[2, :10], seg[2, 10:18] = 1, 2
    image_embeds = rng.standard_normal((b, k, n, d)).astype(np.float32)
    table = rng.standard_normal((60, d)).astype(np.float32)
    want = j_splice.splice_image_embeddings_multi(
        jnp.asarray(ids), jnp.asarray(image_embeds), jnp.asarray(table),
        jnp.asarray(mask), jnp.asarray(labels),
        segment_ids=None if seg is None else jnp.asarray(seg))
    got = t_splice.splice_image_embeddings_multi(
        torch.from_numpy(ids), torch.from_numpy(image_embeds),
        torch.from_numpy(table), torch.from_numpy(mask),
        torch.from_numpy(labels),
        segment_ids=None if seg is None else torch.from_numpy(seg))
    for name in ("inputs_embeds", "attention_mask", "labels", "seq_len"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    if with_segments:
        np.testing.assert_array_equal(got.segment_ids.numpy(),
                                      np.asarray(want.segment_ids))
    else:
        assert got.segment_ids is None


# -- the VLM loss and the pooler's gradient -------------------------------


@pytest.mark.parametrize("kind", ["supervised", "packed"])
def test_vlm_forward_loss_and_pooler_grads(vlm_setup, kind):
    jcfg, tcfg, jparams, nparams = vlm_setup
    batch = _supervised_batch(5) if kind == "supervised" else \
        _packed_batch(6)
    if kind == "packed":
        assert batch["images"].ndim == 5 and batch["segment_ids"].max() > 1
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(pooler):
        return j_vlm.vlm_forward_loss(
            {**jparams, "pooler": pooler}, jcfg, jbatch,
            compute_dtype=jnp.float32)["total_loss"]

    loss_j, g_j = jax.value_and_grad(jloss)(jparams["pooler"])
    params = training_params_from_numpy(nparams, tcfg, torch.float32, "cpu")
    out = t_vlm.vlm_forward_loss(params, tcfg, batch,
                                 compute_dtype=torch.float32)
    leaves = list(_leaves(params["pooler"]))
    grads = torch.autograd.grad(out["total_loss"], leaves)
    np.testing.assert_allclose(float(out["total_loss"].detach()),
                               float(loss_j),
                               rtol=1e-5, atol=1e-5)
    assert out["text_loss"] is out["total_loss"]
    got = np.concatenate([g.numpy().ravel() for g in grads])
    want = np.concatenate([np.asarray(g).ravel()
                           for g in _leaves(_np_tree(g_j))])
    assert _rel_l2(got, want) < 1e-4


def test_remat_gives_the_same_grads(vlm_setup):
    _, tcfg, _, nparams = vlm_setup
    batch = _packed_batch(7)
    grads = []
    for remat in (False, True):
        params = training_params_from_numpy(nparams, tcfg, torch.float32,
                                            "cpu")
        loss = t_vlm.vlm_forward_loss(params, tcfg, batch,
                                      compute_dtype=torch.float32,
                                      remat=remat)["total_loss"]
        grads.append(torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            loss, list(_leaves(params["pooler"])))]))
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_training_params_and_trainable_mask(vlm_setup):
    """Trainable leaves: float32 masters with requires_grad; frozen leaves
    in the compute dtype without grad, but the ViT pre-LayerNorm as
    given; the mask follows the JAX stage rules."""
    jcfg, tcfg, jparams, nparams = vlm_setup
    params = training_params_from_numpy(nparams, tcfg, torch.bfloat16, "cpu")
    mask = t_vlm.trainable_mask(params, tcfg)
    jmask = j_vlm.trainable_mask(jparams, jcfg)
    pre_ln = params["vit"]["pre_ln"]
    for part in ("vit", "pooler", "llama"):
        assert set(_leaves(mask[part])) == set(_leaves(jmask[part]))
        for leaf, m in zip(_leaves(params[part]), _leaves(mask[part])):
            assert leaf.requires_grad == m
            if leaf is not pre_ln["scale"] and leaf is not pre_ln["bias"]:
                assert leaf.dtype == (torch.float32 if m else torch.bfloat16)
    assert pre_ln["scale"].dtype == torch.float32
    eval_cfg = t_vlm.VLMConfig.tiny_test(stage=0)
    assert not any(_leaves(t_vlm.trainable_mask(params, eval_cfg)))


# -- data ------------------------------------------------------------------


def test_supervised_collator_matches_jax():
    rng = np.random.default_rng(8)
    tok = FakeTokenizer(300)
    samples = _samples(rng, 4, 5, 50, 300)
    samples[2]["image"] = None  # a text-only row gets a zero image
    samples[2]["input_ids"][1] = 7
    want = j_collate.SupervisedCollator(tok, pad_multiple=16,
                                        max_length=40)(samples)
    got = SupervisedCollator(tok, pad_multiple=16, max_length=40)(samples)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_packing_collator_matches_jax():
    """Three calls with carryover rows, an oversize sample and text-only
    samples: every array equal, call after call."""
    rng = np.random.default_rng(9)
    tok = FakeTokenizer(300)
    jc = j_collate.PackingCollator(tok, target_len=48, rows_per_batch=2,
                                   max_images_per_row=2)
    tc = PackingCollator(tok, target_len=48, rows_per_batch=2,
                         max_images_per_row=2)
    calls = [_samples(rng, 5, 6, 30, 300), _samples(rng, 2, 40, 60, 300),
             _samples(rng, 3, 6, 20, 300, image=False)]
    for samples in calls:
        want, got = jc(samples), tc(samples)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_metric_storage_matches_jax():
    ours, theirs = MetricStorage(window_size=2), j_metric.MetricStorage(
        window_size=2)
    for ms in (ours, theirs):
        ms.update(0, loss=4.0)
        ms.update(1, loss=2.0)
        ms.update(2, loss=0.0, acc=0.5)
        ms.update(smooth=False, lr=0.5)
    assert ours.values_maybe_smooth() == theirs.values_maybe_smooth()
    assert ours.values_maybe_smooth()["loss"] == pytest.approx(1.0)
    assert ours.state_dict() == theirs.state_dict()
    assert ours["loss"].values == [2.0, 0.0]
    restored = MetricStorage()
    restored.load_state_dict(theirs.state_dict())
    assert restored["loss"].global_avg == pytest.approx(2.0)
    assert "acc" in restored and restored.iter == 2


# -- schedules -------------------------------------------------------------

SCHEDULES = [
    ("fixed", {"lr": 0.3, "schedule": {"name": "fixed"}}, 10),
    ("step", {"lr": 1.0, "schedule": {"name": "step", "multisteps": [3, 6],
                                      "gamma": 0.1}}, 9),
    ("exp", {"lr": 2.0, "schedule": {"name": "exp", "gamma": 0.5}}, 5),
    ("poly", {"lr": 1.0, "schedule": {"name": "poly", "power": 2.0}}, 10),
    ("inv", {"lr": 1.0, "schedule": {"name": "inv", "gamma": 0.1,
                                     "power": 0.75}}, 8),
    ("cosine", {"lr": 1.0, "schedule": {"name": "cosine", "min_lr": 0.1}},
     20),
    ("flat_cosine", {"lr": 1.0, "schedule": {"name": "flat_cosine",
                                             "start_percent": 0.75}}, 20),
    ("linear", {"lr": 1.0, "schedule": {"name": "linear", "min_lr": 0.2}},
     10),
    ("cyclic", {"lr": 1.0, "schedule": {
        "name": "cyclic", "target_ratio": (5.0, 1e-3), "cyclic_times": 2,
        "step_ratio_up": 0.4, "gamma": 0.5}}, 40),
    ("one_cycle", {"lr": 1.0, "schedule": {
        "name": "one_cycle", "max_lr": 1.0, "pct_start": 0.3,
        "div_factor": 25.0, "final_div_factor": 100.0}}, 30),
    ("one_cycle_3phase", {"lr": 1.0, "schedule": {
        "name": "one_cycle", "max_lr": 1.0, "pct_start": 0.3,
        "div_factor": 25.0, "final_div_factor": 100.0,
        "three_phase": True}}, 30),
    ("cosine_warmup_linear", {"lr": 1.0, "schedule": {
        "name": "cosine", "min_lr": 0.1, "warmup_epochs": 10,
        "warmup_method": "linear", "warmup_factor": 0.1}}, 100),
    ("step_warmup_exp", {"lr": 0.5, "schedule": {
        "name": "step", "multisteps": [5, 10], "gamma": 0.9,
        "warmup_epochs": 4, "warmup_method": "exp",
        "warmup_factor": 0.01}}, 20),
    ("poly_warmup_constant", {"lr": 0.5, "schedule": {
        "name": "poly", "warmup_epochs": 3, "warmup_method": "constant",
        "warmup_factor": 0.2}}, 12),
    ("stage1_recipe", {"lr": 0.0002, "schedule": {
        "name": "cosine", "min_lr": 0.00002, "warmup_epochs": 300,
        "warmup_method": "linear", "warmup_factor": 0.1}}, 1000),
]


@pytest.mark.parametrize("case", SCHEDULES, ids=lambda c: c[0])
def test_schedule_matches_jax(case):
    _, conf, total = case
    want = j_schedule.build_schedule(ConfigDict(conf), total_iters=total)
    got = build_schedule(conf, total_iters=total)
    steps = range(total + 1)
    np.testing.assert_allclose([got(i) for i in steps],
                               [float(want(i)) for i in steps],
                               rtol=1e-7, atol=1e-7)


def test_cosine_restart_matches_jax():
    from lhrs_bot_tpu_torch.train import schedule as t_schedule

    want = j_schedule.cosine_restart(1.0, [4, 6], [1.0, 0.5], min_lr=0.05,
                                     warmup_iters=3)
    got = t_schedule.cosine_restart(1.0, [4, 6], [1.0, 0.5], min_lr=0.05,
                                    warmup_iters=3)
    np.testing.assert_allclose([got(i) for i in range(12)],
                               [float(want(i)) for i in range(12)],
                               rtol=1e-7, atol=1e-7)


# -- optimizers ------------------------------------------------------------

OPTIMIZERS = [
    ("adanp_clip_decay_cosine", {"optimizer": "adanp", "lr": 0.01,
                                 "wd": 0.02, "max_grad_norm": 0.5},
     {"name": "cosine", "min_lr": 0.001, "warmup_epochs": 2}),
    ("adan_proximal", {"optimizer": "adan", "lr": 0.01, "wd": 0.05}, None),
    ("adamw_betas_accum2", {"optimizer": "adamw", "lr": 0.01, "wd": 0.01,
                            "betas": [0.9, 0.95], "max_grad_norm": 1.0,
                            "accumulation_steps": 2},
     {"name": "step", "multisteps": [2], "gamma": 0.5}),
    ("sgd_clip", {"optimizer": "sgd", "lr": 0.1, "max_grad_norm": 0.5},
     None),
    ("adanp_stage1_accum3", {"optimizer": "adanp", "lr": 0.0002,
                             "max_grad_norm": 0.3, "accumulation_steps": 3},
     {"name": "cosine", "min_lr": 0.00002, "warmup_epochs": 3}),
]


@pytest.mark.parametrize("case", OPTIMIZERS, ids=lambda c: c[0])
def test_optimizer_matches_optax(case):
    """Six (micro-)steps of the port's optimizer against the JAX
    build_optimizer (optax) on the same gradients: trainable leaves (a
    matrix that decays, a vector and a query that do not... by ndim), a
    frozen leaf that never moves."""
    _, conf, sched = case
    if sched is not None:
        conf = {**conf, "schedule": sched}
    rng = np.random.default_rng(10)
    shapes = {"pooler": {"w": (4, 3), "b": (3,), "q": (2, 5, 3)},
              "frozen": {"w": (3, 3)}}
    nparams = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    trainable = {"pooler": {"w": True, "b": True, "q": True},
                 "frozen": {"w": False}}
    total = 8
    jsched = tsched = None
    if sched is not None:
        jsched = j_schedule.build_schedule(ConfigDict(conf), total)
        tsched = build_schedule(conf, total)
    jp = jax.tree_util.tree_map(jnp.asarray, nparams)
    tx = j_optimizer.build_optimizer(ConfigDict(conf), jp, trainable,
                                     schedule=jsched)
    state = tx.init(jp)
    tp = params_from_numpy(nparams)
    opt = build_optimizer(conf, tp, trainable, schedule=tsched)
    assert set(opt.paths) == {("pooler", "w"), ("pooler", "b"),
                              ("pooler", "q")}
    for _ in range(6):
        grads = jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * 2).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))
        updates, state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(grads[a][b]) for a, b in opt.paths])
        for a, b in (("pooler", "w"), ("pooler", "b"), ("pooler", "q"),
                     ("frozen", "w")):
            np.testing.assert_allclose(tp[a][b].numpy(), np.asarray(jp[a][b]),
                                       **STATE_TOL)
    np.testing.assert_array_equal(tp["frozen"]["w"].numpy(),
                                  nparams["frozen"]["w"])


# -- the trainer -----------------------------------------------------------


TRAIN_CONFIG = {"optimizer": "adanp", "lr": 0.001, "wd": 0.0,
                "max_grad_norm": 0.3,
                "schedule": {"name": "cosine", "min_lr": 0.0001,
                             "warmup_epochs": 2, "warmup_method": "linear",
                             "warmup_factor": 0.1}}


def test_trainer_matches_jax(vlm_setup):
    """Three steps of the port's Trainer against the JAX Trainer, float32,
    the stage-1 optimizer (Adan-p, clipping, cosine with warmup): losses,
    grad_norm, lr and the pooler after every step; the frozen leaves never
    move and never get a .grad."""
    jcfg, tcfg, jparams, nparams = vlm_setup
    loader = [_supervised_batch(20 + i) for i in range(3)]
    jsched = j_schedule.build_schedule(ConfigDict(TRAIN_CONFIG), 3)
    tx = j_optimizer.build_optimizer(ConfigDict(TRAIN_CONFIG), jparams,
                                     j_vlm.trainable_mask(jparams, jcfg),
                                     schedule=jsched)

    def snapshot(params):
        return [np.array(x) for x in _leaves(_np_tree(params["pooler"]))]

    class JProbe(j_hooks.HookBase):
        def __init__(self):
            self.pooler = []

        def after_iter(self):
            self.pooler.append(snapshot(self.trainer.params))

    class TProbe(HookBase):
        def __init__(self):
            self.pooler = []

        def after_iter(self):
            self.pooler.append([t.detach().numpy().copy() for t in
                                _leaves(self.trainer.params["pooler"])])

    jprobe, tprobe = JProbe(), TProbe()
    jt = j_trainer.IterBasedTrainer(
        jcfg, jax.tree_util.tree_map(jnp.array, jparams), tx, loader,
        max_iters=3, compute_dtype=jnp.float32, log_period=1,
        schedule=jsched, hooks=[jprobe])
    jt.train()
    params = training_params_from_numpy(nparams, tcfg, torch.float32, "cpu")
    tsched = build_schedule(TRAIN_CONFIG, 3)
    opt = build_optimizer(TRAIN_CONFIG, params,
                          t_vlm.trainable_mask(params, tcfg), tsched)
    tt = IterBasedTrainer(tcfg, params, opt, loader, max_iters=3,
                          compute_dtype=torch.float32, log_period=1,
                          schedule=tsched, hooks=[tprobe])
    tt.train()
    for key in ("total_loss", "text_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(tt.metric_storage[key].values,
                                   list(jt.metric_storage[key]._window),
                                   **STATE_TOL)
    for got, want in zip(tprobe.pooler, jprobe.pooler):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **STATE_TOL)
    for leaf, given in zip(_leaves(tt.params["llama"]),
                           _leaves(nparams["llama"])):
        np.testing.assert_array_equal(leaf.numpy(), given)
    for leaf in _leaves(tt.params):
        assert leaf.grad is None
    for leaf in _leaves({k: tt.params[k] for k in ("vit", "llama")}):
        assert not leaf.requires_grad
    assert t_attention.flash_attention_bwd_dq.launches == 0


def test_build_trainer_from_config(vlm_setup):
    """build_trainer composes as the JAX entry points do: stage 1 an
    epoch-based trainer over epochs x len(loader) iterations with the
    config's schedule and optimizer, stage 3 an iteration-based one over
    `epochs` iterations."""
    from lhrs_bot_tpu_torch.core.config import load_yaml_config
    from lhrs_bot_tpu_torch.train import EpochBasedTrainer

    _, _, _, nparams = vlm_setup
    config = load_yaml_config("tests/fixtures/tiny_config.yaml")
    config["rgb_vision"]["attn_pooler"]["num_layers"] = 2
    loader = [_supervised_batch(30), _supervised_batch(31)]
    tiny = {**config, "text": {**config["text"], "vocab_size": 256,
                               "max_position_embeddings": 128}}
    tiny["rgb_vision"]["attn_pooler"]["num_query"] = 12
    t = build_trainer(tiny, nparams, loader, "cpu",
                      compute_dtype=torch.float32)
    assert isinstance(t, EpochBasedTrainer) and t.max_iters == 2
    assert t.optimizer.name == "adamw" and t.optimizer.max_grad_norm == 1.0
    t.train()
    assert np.isfinite(t.metric_storage["total_loss"].latest)
    # stage 3 takes the config's LoRA (the stage-2 adapters it continues)
    # even though lora.enable is False, as the JAX VLMConfig does
    t3 = build_trainer({**tiny, "stage": 3}, nparams, loader, "cpu")
    assert isinstance(t3, IterBasedTrainer) and t3.max_iters == 1
    assert (t3.model_cfg.lora.r, t3.model_cfg.lora.alpha) == (4, 8)
    t3 = build_trainer({**tiny, "stage": 3, "epochs": 5, "lora": None},
                       nparams, loader, "cpu", compute_dtype=torch.float32)
    assert isinstance(t3, IterBasedTrainer) and t3.max_iters == 5


def test_unported_paths_raise(vlm_setup):
    _, tcfg, _, nparams = vlm_setup
    params = training_params_from_numpy(nparams, tcfg, torch.float32, "cpu")
    opt = build_optimizer({"optimizer": "adamw", "lr": 0.001}, params,
                          t_vlm.trainable_mask(params, tcfg))
    loader = [_supervised_batch(40)]
    with pytest.raises(TypeError, match="Mesh"):  # meshes: a Mesh only
        Trainer(tcfg, params, opt, loader, max_iters=1, mesh=object())
    # context parallelism takes a CpMesh, and the chunk's global positions
    with pytest.raises(TypeError, match="CpMesh"):
        t_vlm.vlm_forward_loss(params, tcfg, loader[0], cp_mesh=object())
    with pytest.raises(ValueError, match="positions"):
        t_llama.llama_apply(params["llama"], tcfg.llama,
                            input_ids=torch.ones(1, 4, dtype=torch.long),
                            cp_axis=object())
    with pytest.raises(ValueError):
        t_vlm.prepare_multimodal_inputs(
            params, tcfg, torch.ones(1, 4, dtype=torch.long),
            torch.zeros(1, 28, 28, 3, dtype=torch.uint8),
            segment_ids=torch.ones(1, 4, dtype=torch.int32))
