"""The port's LoRA / QLoRA path (stages 2 and 3) against the JAX package.

`models/lora.py` (merge_lora, attach_runtime_lora), the runtime side path
`_proj`, `effective_llama_params`, `trainable_mask`, the input gradient of
`quantized_matmul` over a quantized base, an engine over a LoRA'd tree
(and, in tests/test_torch_lora_train.py, tiny stage-2 and stage-3
`Trainer` steps), each against its JAX
counterpart on the same numpy inputs. In float32 (JAX at matmul precision
"highest", see conftest.py) the sides differ only in summation order:
merges within 1e-6 relative, the side path and losses within 1e-5,
gradients within 1e-4 relative L2 (the quantized_matmul input gradient
within 1e-5), parameters after three steps within 1e-5; integer codes
byte for byte and greedy ids equal.

Over an int8 base both packages round the activation to bf16 before every
base product (and the input gradient to bf16 after it), also in float32
compute, so a float32 difference of one ulp becomes one of a bf16 ulp
wherever it crosses a rounding boundary. tests/test_torch_lora_train.py
measures this against JAX itself, with the pooler scaled by (1 + 2^-23),
and prints each reading (run it with -s). First-step gradients (relative
L2): the port from JAX 3.2e-4 (adapters) and 7.7e-4 (pooler); JAX from
itself 5.1e-4 and 1.1e-3; the port with the base's input gradient scaled
by 0.99, 1.5e-2 and 3.1e-2. The int8 bound is 1e-3, asserted above JAX's
own adapter spread and below the fault; the pooler's spread lies just
above it, so a sound change of summation order could cross the bound
there. Parameters after each of three steps (relative L2 of all
trained leaves; Adam moves an element whose gradient is that noise by
about lr in either direction, so elementwise 1e-5 cannot hold): the port
at most 6.9e-5, JAX from itself at most 8.0e-5, the port with B's scale
off by 1% 2.5e-4 to 6.4e-4 after the third; the bound is 1.5e-4, and the
test asserts both sides. grad_norm: the port at most 6.4e-4, held to
1e-3; JAX from itself up to 1.6e-3 at steps 2 and 3 (stage 2), also
above it; the scale fault's largest 1.3e-2 (stage 3) and 2.0e-2 (stage
2), asserted above it. The losses stay within 1e-5.

The bf16 comparison of llama_apply +
causal_lm_loss is held to a bf16-scale bound: the port's deviation from
JAX's bf16 result at most that of JAX's own bf16 result from its float32
result (and below 2e-2 relative L2 on the logits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.core.config import load_yaml_config as j_load_yaml
from lhrs_bot_tpu.models import llama as j_llama
from lhrs_bot_tpu.models import lora as j_lora
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu.serve import engine as j_engine
from lhrs_bot_tpu_torch.core import params_from_numpy
from lhrs_bot_tpu_torch.core.config import load_yaml_config
from lhrs_bot_tpu_torch.models import llama as t_llama
from lhrs_bot_tpu_torch.models import lora as t_lora
from lhrs_bot_tpu_torch.models import vlm as t_vlm
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.serve import engine as t_engine

from .test_torch_train import _leaves, _np_tree, _rel_l2

STATE_TOL = dict(rtol=1e-5, atol=1e-5)
R, ALPHA = 4, 8
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _lora_np(cfg, seed, r=R):
    """Seeded adapters with B != 0 (a trained adapter's B is nonzero, and
    a zero B would hide A's gradient and the merge)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(PROJECTIONS):  # the key order of a JAX tree
        din, dout = (getattr(cfg, a) for a in j_lora.TARGET_SHAPES[name])
        out[name] = {
            "a": (rng.normal(size=(cfg.num_hidden_layers, din, r))
                  / np.sqrt(din)).astype(np.float32),
            "b": (rng.normal(size=(cfg.num_hidden_layers, r, dout))
                  * 0.05).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def tiny():
    """The tiny VLM with live adapters (r 4, alpha 8) and B != 0: JAX and
    port configs, the numpy tree."""
    jcfg = j_vlm.VLMConfig.tiny_test(stage=2, lora=True)
    tcfg = t_vlm.VLMConfig.tiny_test(stage=2, lora=True)
    params = _np_tree(j_vlm.init_vlm_params(jax.random.PRNGKey(0), jcfg))
    params["lora"] = _lora_np(jcfg.llama, 1)
    return jcfg, tcfg, params


def _t(x):
    return torch.from_numpy(np.array(x))


def test_lora_config_matches_jax():
    """The stage-2 and stage-3 recipes' LoRA config (stage 3 takes LoRA
    although its yaml sets enable False), and none at stages 0 and 1."""
    for name in ("stage2", "stage3", "eval", "stage1"):
        path = f"Config/multi_modal_{name}.yaml"
        want = j_vlm.VLMConfig.from_config_dict(j_load_yaml(path)).lora
        got = t_vlm.VLMConfig.from_config_dict(load_yaml_config(path)).lora
        if want is None:
            assert got is None, name
        else:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.scale == want.scale == 2.0


def test_merge_and_attach_match_jax(tiny):
    """merge_lora within 1e-6 relative in value (and the gradients of a
    scalar of the merged weights with respect to A and B within 1e-5);
    attach_runtime_lora byte for byte; the stepwise delta is numpy's
    einsum to the bit."""
    jcfg, tcfg, params = tiny
    layers, lora = params["llama"]["layers"], params["lora"]
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    want = j_lora.merge_lora(layers, jl, jcfg.lora)
    tl = {k: {n: _t(x).requires_grad_(True) for n, x in ab.items()}
          for k, ab in lora.items()}
    got = t_lora.merge_lora({k: _t(v) for k, v in layers.items()}, tl,
                            tcfg.lora)
    for name in layers:
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   np.asarray(want[name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    weights = {n: np.random.default_rng(2).normal(size=layers[n].shape)
               .astype(np.float32) for n in PROJECTIONS}
    jg = jax.grad(lambda ab: sum(jnp.sum(j_lora.merge_lora(
        layers, ab, jcfg.lora)[n] * weights[n]) for n in PROJECTIONS))(jl)
    loss = sum((got[n] * _t(weights[n])).sum() for n in PROJECTIONS)
    loss.backward()
    for name in PROJECTIONS:
        for part in ("a", "b"):
            np.testing.assert_allclose(tl[name][part].grad.numpy(),
                                       np.asarray(jg[name][part]),
                                       **STATE_TOL)
    attached = t_lora.attach_runtime_lora(
        {k: _t(v) for k, v in layers.items()},
        {k: {n: _t(x) for n, x in ab.items()} for k, ab in lora.items()},
        tcfg.lora)
    jatt = j_lora.attach_runtime_lora(layers, jl, jcfg.lora)
    assert sorted(attached) == sorted(jatt)
    for k in jatt:
        np.testing.assert_array_equal(attached[k].numpy(), np.asarray(
            jatt[k]), err_msg=k)
    for name in PROJECTIONS:
        a, b = lora[name]["a"], lora[name]["b"]
        np.testing.assert_array_equal(
            t_lora.lora_delta_stepwise(_t(a), _t(b)).numpy(),
            np.einsum("lir,lro->lio", a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proj_side_path_matches_jax(tiny, dtype):
    """`_proj` over a layer carrying `<name>__lora_a` / `__lora_b`: x W +
    (x A) B with each product rounded to x's dtype: float32 within 1e-5;
    bf16 within one bf16 ulp of the output's scale."""
    jcfg, tcfg, params = tiny
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    layers = j_lora.attach_runtime_lora(
        params["llama"]["layers"],
        jax.tree_util.tree_map(jnp.asarray, params["lora"]), jcfg.lora)
    lp = {k: np.asarray(v[0]) for k, v in layers.items()}
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    for name in ("wq", "w_gate"):
        want = j_llama._proj({k: jnp.asarray(v, jdt) for k, v in lp.items()},
                             name, jnp.asarray(x, jdt))
        got = t_llama._proj({k: _t(v).to(tdt) for k, v in lp.items()},
                            name, _t(x).to(tdt))
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **STATE_TOL)
        else:
            assert np.abs(got - want).max() <= 2 ** -7 * np.abs(want).max()
        plain = t_llama._dense(_t(x).to(tdt), _t(lp[name]).to(tdt))
        assert not np.allclose(plain.float().numpy(), want)


def test_effective_llama_params_matches_jax(tiny):
    """A dense base: the adapters merged (1e-6 relative); a quantized base
    (int8): the base untouched, the adapters attached (byte for byte);
    no cfg.lora or no "lora": the decoder as it is."""
    jcfg, tcfg, params = tiny
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = params_from_numpy(params)
    want = j_vlm.effective_llama_params(jp, jcfg)
    got = t_vlm.effective_llama_params(tp, tcfg)
    for name in PROJECTIONS:
        np.testing.assert_allclose(got["layers"][name].detach().numpy(),
                                   np.asarray(want["layers"][name]),
                                   rtol=1e-6, atol=1e-7)
    qp = {**params, "llama": {**params["llama"], "layers":
                              _np_tree(j_quant.quantize_llama_layers(
                                  params["llama"]["layers"], bits=8))}}
    want = j_vlm.effective_llama_params(
        jax.tree_util.tree_map(jnp.asarray, qp), jcfg)
    got = t_vlm.effective_llama_params(params_from_numpy(qp), tcfg)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for name, w in want["layers"].items():
        g = got["layers"][name]
        if isinstance(w, j_quant.QuantizedTensor):
            assert g is params_from_numpy(qp)["llama"]["layers"][name] \
                or np.array_equal(g.q.numpy(), np.asarray(w.q))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert t_vlm.effective_llama_params(
        tp, dataclasses.replace(tcfg, lora=None)) is tp["llama"]
    no_lora = {k: v for k, v in tp.items() if k != "lora"}
    assert t_vlm.effective_llama_params(no_lora, tcfg) is tp["llama"]


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_trainable_mask_matches_jax(tiny, stage):
    """The stage rules over a tree with "lora" and an int8 base: the
    adapters train at stages 2 and 3 only, the pooler where
    tune_rgb_pooler says, never the decoder."""
    jcfg, tcfg, params = tiny
    jcfg = dataclasses.replace(jcfg, stage=stage,
                               tune_rgb_pooler=stage != 3)
    tcfg = dataclasses.replace(tcfg, stage=stage,
                               tune_rgb_pooler=stage != 3)
    want = j_vlm.trainable_mask(params, jcfg)
    got = t_vlm.trainable_mask(params, tcfg)
    assert sorted(got) == sorted(want)
    for group in want:
        assert [m for _, m in _leaves_paths(got[group])] == \
            jax.tree_util.tree_leaves(want[group]), group
    assert all(m == (stage in (2, 3)) for _, m in _leaves_paths(got["lora"]))
    qp = {**params, "llama": {**params["llama"], "layers":
                              t_quant.quantize_llama_layers(
                                  params_from_numpy(params["llama"]["layers"]),
                                  bits=8)}}
    mask = t_vlm.trainable_mask(qp, tcfg)
    assert mask["llama"]["layers"]["wq"] is False


def _leaves_paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_paths(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("bits", [8, 4, "4h", "nf4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_matmul_input_grad_matches_jax(bits, dtype):
    """The input gradient of quantized_matmul (the QLoRA backward through
    the frozen base) against jax.grad of the JAX function: within 1e-5
    relative L2 (float32 sums in different orders, rounded to bf16 at the
    activation cast's transpose); the forward as before. No float copy of
    the weight is saved for the backward: only the codes and the scale."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(128, 96)).astype(np.float32) * 0.05
    x = rng.normal(size=(3, 7, 128)).astype(np.float32)
    g = rng.normal(size=(3, 7, 96)).astype(np.float32)
    if bits == "nf4":
        jq = j_quant.quantize_nf4(jnp.asarray(w), axis=0)
    elif bits == "4h":
        jq = j_quant.quantize_int4h(jnp.asarray(w), axis=0)
    elif bits == 4:
        jq = j_quant.quantize_int4(jnp.asarray(w), axis=0)
    else:
        jq = j_quant.quantize_int8(jnp.asarray(w), axis=0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    want_y, vjp = jax.vjp(lambda v: j_quant.quantized_matmul(v, jq), xj)
    (want_dx,) = vjp(gj)
    tq = t_quant.QuantizedTensor(_t(jq.q), _t(jq.scale), bits)
    xt = _t(x).to(tdt).requires_grad_(True)
    y = t_quant.quantized_matmul(xt, tq)
    assert y.grad_fn is not None and y.dtype == tdt
    saved = [t for t in y.grad_fn.saved_tensors]
    assert [t.dtype for t in saved] == [torch.int8, torch.float32]
    (dx,) = torch.autograd.grad(y, xt, _t(g).to(tdt))
    assert dx.dtype == tdt
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)),
                               rtol=1e-5, atol=1e-5)
    got, want = dx.float().numpy(), np.asarray(want_dx.astype(jnp.float32))
    assert _rel_l2(got, want) < 1e-5
    with torch.no_grad():
        plain = t_quant.quantized_matmul(_t(x).to(tdt), tq)
    assert torch.equal(plain, y.detach())


# -- serving ---------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, "4h"])
def test_engine_codes_over_lora_tree_match_jax(tiny, bits):
    """An engine over a numpy tree with live adapters and int8 or "4h"
    weights (and an int8 lm_head): the adapters merged in float32 before
    the quantization, codes and scales byte-equal to the JAX engine's
    `_host_merge_quantize`; without the merge they would differ."""
    jcfg, tcfg, params = tiny
    je = j_engine.GenerationEngine(jcfg, params, max_seq_len=96,
                                   compute_dtype=jnp.float32,
                                   cache_dtype=jnp.float32,
                                   quantize_bits=bits, lm_head_bits=8)
    te = t_engine.GenerationEngine(tcfg, params_from_numpy(params),
                                   max_seq_len=96,
                                   compute_dtype=torch.float32,
                                   cache_dtype=torch.float32,
                                   quantize_bits=bits, lm_head_bits=8,
                                   device="cpu")
    names = PROJECTIONS + ("lm_head",)
    for name in names:
        w = (je.llama_params[name] if name == "lm_head"
             else je.llama_params["layers"][name])
        g = (te.llama_params[name] if name == "lm_head"
             else te.llama_params["layers"][name])
        assert g.bits == w.bits
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q),
                                      err_msg=name)
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale),
                                      err_msg=name)
    unmerged = t_engine.GenerationEngine(
        dataclasses.replace(tcfg, lora=None), params_from_numpy(params),
        max_seq_len=96, compute_dtype=torch.float32, quantize_bits=bits,
        device="cpu")
    assert not torch.equal(unmerged.llama_params["layers"]["wq"].q,
                           te.llama_params["layers"]["wq"].q)


def test_engine_over_lora_tree_greedy_matches_jax(tiny):
    """float32 engines over the LoRA'd tree (merged at load): greedy ids
    equal, prefill logits within 1e-4; over an int8 base the adapters ride
    along as the side path, and greedy ids still match the JAX engine's
    over the same base."""
    jcfg, tcfg, params = tiny
    rng = np.random.default_rng(9)
    ids = rng.integers(3, 200, size=(2, 11)).astype(np.int32)
    ids[:, 1] = -200
    ids[1, 7:] = 0
    lens = np.array([11, 7], np.int32)
    imgs = rng.integers(0, 256, (2, 28, 28, 3)).astype(np.uint8)
    gen = dict(max_new_tokens=6)
    quant = {**params, "llama": {**params["llama"], "layers": _np_tree(
        j_quant.quantize_llama_layers(params["llama"]["layers"], bits=8))}}
    for tree in (params, quant):
        je = j_engine.GenerationEngine(jcfg, tree, max_seq_len=96,
                                       compute_dtype=jnp.float32,
                                       cache_dtype=jnp.float32)
        te = t_engine.GenerationEngine(tcfg, params_from_numpy(tree),
                                       max_seq_len=96,
                                       compute_dtype=torch.float32,
                                       cache_dtype=torch.float32,
                                       device="cpu")
        want = je.generate(ids, lens, images=imgs,
                           gen_cfg=j_engine.GenerationConfig(**gen))
        got = te.generate(ids, lens, images=imgs,
                          gen_cfg=t_engine.GenerationConfig(**gen))
        assert got == want
        if tree is quant:
            assert "wq__lora_a" in te.llama_params["layers"]
        else:
            assert "wq__lora_a" not in te.llama_params["layers"]


# -- bf16 against JAX ------------------------------------------------------


@pytest.mark.parametrize("side_path", [False, True],
                         ids=["dense", "lora_side_path"])
def test_llama_apply_and_loss_bf16_match_jax(tiny, side_path):
    """llama_apply + causal_lm_loss in bf16 (the recipe's compute dtype),
    with and without the LoRA side path, against JAX in bf16 on the same
    weights: the port's deviation from JAX's bf16 logits (relative L2) at
    most that of JAX's bf16 logits from its own float32 logits, and below
    2e-2; the loss within 2e-2 of JAX's bf16 loss."""
    jcfg, tcfg, params = tiny
    llama = params["llama"]
    if side_path:
        layers = j_lora.attach_runtime_lora(
            llama["layers"], jax.tree_util.tree_map(jnp.asarray,
                                                    params["lora"]),
            jcfg.lora)
        llama = {**llama, "layers": _np_tree(layers)}
    rng = np.random.default_rng(12)
    ids = rng.integers(3, 256, (2, 24)).astype(np.int32)
    mask = np.ones((2, 24), bool)
    mask[1, 17:] = False
    labels = np.where(mask, ids, -100)

    def jrun(dtype):
        logits = j_llama.llama_apply(
            jax.tree_util.tree_map(jnp.asarray, llama), jcfg.llama,
            input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
            compute_dtype=dtype)
        return (np.asarray(logits.astype(jnp.float32)),
                float(j_llama.causal_lm_loss(logits, jnp.asarray(labels))))

    (want, loss_w), (ref32, _) = jrun(jnp.bfloat16), jrun(jnp.float32)
    tl = t_vlm.cast_floats(params_from_numpy(llama), torch.bfloat16)
    logits = t_llama.llama_apply(tl, tcfg.llama,
                                 input_ids=torch.as_tensor(ids),
                                 attention_mask=torch.as_tensor(mask),
                                 compute_dtype=torch.bfloat16)
    loss = float(t_llama.causal_lm_loss(logits, torch.as_tensor(labels)))
    got = logits.float().numpy()
    dev, noise = _rel_l2(got, want), _rel_l2(want, ref32)
    assert dev <= max(noise, 1e-6) and dev < 2e-2, (dev, noise)
    assert abs(loss - loss_w) < 2e-2, (loss, loss_w)
