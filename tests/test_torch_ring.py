"""Context parallelism of the port (ring attention, `parallel/context.py`,
the decoder's and the train step's `cp_mesh` path) against the JAX
package's, on the CPU.

Eight gloo ranks (one spawn, `tests/torch_parallel.py`) run every case of
`tests/test_ring.py` on the same numpy-seeded inputs, at JAX's tolerances:
the ring at cp 8 and, on each data index of a dp 2 x cp 4 mesh, at cp 4
(causal and not 2e-5, the mask riding the ring 2e-5 on valid rows,
gradients 3e-5, bf16 in and out 3e-2), `context_parallel_apply`'s logits
at dp 2 x cp 4 (5e-5, valid rows) and its parameter gradients (1e-4), and
the dp 2 x cp 4 train step against JAX's single-device step (loss 1e-4,
parameters 2e-4). The ring's kernel route (one flash launch a block, the
LSE merge, the dK/dV buffers brought home) runs over float32 stand-ins of
the launchers with their contracts, held to the same bounds, with each
rank's launches counted. Each bound has a planted fault that fails it:
the mask not travelling, the owner index not decremented, the seq-group
gradient reduction skipped.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from lhrs_bot_tpu.core.config import ConfigDict
from lhrs_bot_tpu.models import vlm as j_vlm
from lhrs_bot_tpu.models.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
from lhrs_bot_tpu.models.llama import (LlamaConfig, causal_lm_loss,
                                       init_llama_params)
from lhrs_bot_tpu.ops.ring_attention import ring_self_attention
from lhrs_bot_tpu.parallel.context import (context_parallel_apply,
                                           make_cp_mesh)
from lhrs_bot_tpu.train import optimizer as j_optimizer
from lhrs_bot_tpu.train.trainer import make_train_step

from .torch_parallel import run_ranks

WORLD = 8
CP = WORLD // 2
OPT = {"optimizer": "adamw", "lr": 1e-3, "wd": 0.05, "max_grad_norm": 0.5}


def _qkv(seed, b=2, h=4, s=64, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for _ in range(3)]


def _case(seed, causal, **kw):
    q, k, v = _qkv(seed, **{n: kw.pop(n) for n in ("b", "h", "s", "d")
                            if n in kw})
    return dict(q=q, k=k, v=v, causal=causal, **kw)


LENS = np.array([64, 37, 5])
MASK = np.arange(64)[None, :] < LENS[:, None]

# the cases of tests/test_ring.py, by name
HALF_CASES = {
    "non_causal": _case(0, False, kernels=True),
    "causal": _case(0, True, kernels=True),
    "kv_mask": _case(1, True, b=3, mask=MASK, kernels=True),
    "grads": _case(3, True, b=1, h=2, s=32, d=8, grad=True, kernels=True),
    "grads_mask": _case(5, True, b=3, mask=MASK, grad=True, kernels=True),
    "bf16": _case(4, True, dtype="bf16"),
    "fault_mask": _case(1, True, b=3, mask=MASK, fault="mask_stays",
                        kernels=True),
    "fault_owner": _case(1, True, b=3, mask=MASK, fault="owner_fixed",
                         kernels=True),
}
FULL_CASES = {"eight_way": _case(2, True, s=128)}


def _jax_ring(case, n):
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("seq",))
    dtype = jnp.bfloat16 if case.get("dtype") == "bf16" else jnp.float32
    q, k, v = (jnp.asarray(case[n_], dtype) for n_ in ("q", "k", "v"))
    mask = case.get("mask")
    args = (q, k, v) if mask is None else (q, k, v, jnp.asarray(mask))

    def fwd(*a):
        return ring_self_attention(mesh, *a, seq_axis="seq",
                                   causal=case["causal"])

    out = np.asarray(jax.jit(fwd)(*args), np.float32)
    if not case.get("grad"):
        return out, None

    def loss(q, k, v):
        extra = () if mask is None else (jnp.asarray(mask),)
        return jnp.sum(fwd(q, k, v, *extra).astype(jnp.float32) ** 2)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return out, [np.asarray(g, np.float32) for g in grads]


def _ids_batch(seed, b, s, vocab=200):
    return jax.random.randint(jax.random.PRNGKey(seed), (b, s), 3, vocab)


def _train_batch():
    rng = np.random.default_rng(19)
    b, s = 2, 22  # the spliced rows (33) pad to the ring of 4
    ids = rng.integers(3, 200, size=(b, s)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, :4] = IGNORE_INDEX
    labels[1, 15:] = IGNORE_INDEX  # the rows hold different counts
    return {"input_ids": ids, "labels": labels,
            "attention_mask": np.ones((b, s), bool),
            "images": rng.integers(0, 256, (b, 28, 28, 3)).astype(np.uint8)}


@pytest.fixture(scope="module")
def setup():
    lcfg = LlamaConfig.tiny_test()
    llama = jax.tree_util.tree_map(
        np.asarray, init_llama_params(jax.random.PRNGKey(0), lcfg))
    apply_ids = np.asarray(_ids_batch(1, 4, 32))
    apply_mask = np.arange(32)[None, :] < np.array([32, 20, 9, 32])[:, None]
    grad_ids = np.asarray(_ids_batch(1, 2, 16))
    vcfg = j_vlm.VLMConfig.tiny_test(stage=1)
    vparams = jax.tree_util.tree_map(
        np.asarray, j_vlm.init_vlm_params(jax.random.PRNGKey(0), vcfg))
    return {"llama": llama, "lcfg": lcfg,
            "apply": {"ids": apply_ids, "mask": apply_mask},
            "grads": {"ids": grad_ids},
            "train": {"params": vparams, "batch": _train_batch(),
                      "opt": OPT}, "vcfg": vcfg}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    payload = {"full_cases": list(FULL_CASES.values()),
               "half_cases": list(HALF_CASES.values()),
               "llama": setup["llama"], "apply": setup["apply"],
               "grads": setup["grads"], "train": setup["train"],
               "self_attention_case": list(HALF_CASES).index("kv_mask")}
    return run_ranks(WORLD, "ring", payload,
                     tmp_path_factory.mktemp("ring"), timeout=240)


def _whole(ranks, part, idx, key, data=0, dim=2):
    """The whole sequence of one case's chunks, from the ranks of data
    index `data`, in seq order."""
    held = sorted((r[part]["seq"], r[part][key][idx])
                  for r in ranks if r[part].get("data", 0) == data)
    return {k: np.concatenate([c[k] for _, c in held], axis=dim)
            for k in held[0][1] if k != "dtype"}


def _close(got, want, tol, mask=None):
    if mask is None:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        return
    for i, n in enumerate(mask.sum(axis=1)):  # valid rows only
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], atol=tol,
                                   rtol=tol)


def _hold(got, case, want, want_grads, tol, grad_tol):
    _close(got["out"], want, tol, case.get("mask"))
    if want_grads is not None:
        for name, w in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(got[name], w, atol=grad_tol,
                                       rtol=grad_tol, err_msg=name)


@pytest.mark.timeout(300)  # the ranks are killed at run_ranks' timeout
@pytest.mark.parametrize("name", [n for n in HALF_CASES
                                  if not n.startswith("fault")])
def test_ring_cases_match_jax(ranks, name):
    """Each ring case at cp 4 (on both data indices, plain and over the
    kernel route) against JAX's ring on the same inputs."""
    idx = list(HALF_CASES).index(name)
    case = HALF_CASES[name]
    want, want_grads = _jax_ring(case, CP)
    tol = 3e-2 if case.get("dtype") == "bf16" else 2e-5
    for data in (0, 1):
        got = _whole(ranks, "half", idx, "cases", data)
        _hold(got, case, want, want_grads, tol, 3e-5)
    if case.get("dtype") == "bf16":
        assert ranks[0]["half"]["cases"][idx]["dtype"] == "torch.bfloat16"
    if case.get("kernels"):
        k = sum(1 for c in list(HALF_CASES.values())[:idx] if c.get("kernels"))
        _hold(_whole(ranks, "half", k, "kernels"), case, want, want_grads,
              2e-5, 3e-5)
        for r in ranks:  # a launch a block the causal mask leaves
            seq = r["half"]["seq"]
            n = seq + 1 if case["causal"] else CP
            got = r["half"]["launches"][k]
            assert got == {"fwd": n, "dq": n if case.get("grad") else 0,
                           "dkv": n if case.get("grad") else 0}, (seq, got)


@pytest.mark.timeout(300)
def test_ring_self_attention_matches_jax(ranks):
    """`ring_self_attention` (whole tensors in, each rank's rows out) on
    the mask case against JAX's wrapper."""
    case = HALF_CASES["kv_mask"]
    want, _ = _jax_ring(case, CP)
    for data in (0, 1):
        held = sorted((r["half"]["seq"], r["self_attention"]) for r in ranks
                      if r["half"]["data"] == data)
        _close(np.concatenate([c for _, c in held], axis=2), want, 2e-5,
               case["mask"])


@pytest.mark.timeout(300)
def test_ring_eight_way_matches_jax(ranks):
    case = FULL_CASES["eight_way"]
    want, _ = _jax_ring(case, WORLD)
    _close(_whole(ranks, "full", 0, "cases")["out"], want, 2e-5)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["fault_mask", "fault_owner"])
@pytest.mark.parametrize("route", ["cases", "kernels"])
def test_ring_planted_faults_fail_the_bound(ranks, name, route):
    """The mask left behind, or the owner index not decremented, moves
    the valid rows far past 2e-5 on both routes."""
    idx = list(HALF_CASES).index(name)
    case = HALF_CASES[name]
    if route == "kernels":
        idx = sum(1 for c in list(HALF_CASES.values())[:idx]
                  if c.get("kernels"))
    want, _ = _jax_ring({k: v for k, v in case.items() if k != "fault"}, CP)
    with pytest.raises(AssertionError):
        _close(_whole(ranks, "half", idx, route)["out"], want, 2e-5,
               case["mask"])


def _jax_apply(setup):
    lcfg, p, ap = setup["lcfg"], setup["llama"], setup["apply"]
    mesh = make_cp_mesh(cp=CP, dp=2)
    return np.asarray(jax.jit(lambda p_, i, m: context_parallel_apply(
        p_, lcfg, mesh, input_ids=i, attention_mask=m,
        compute_dtype=jnp.float32))(p, ap["ids"], ap["mask"]))


@pytest.mark.timeout(300)
def test_context_parallel_apply_matches_jax(setup, ranks):
    """dp 2 x cp 4: each data index's two rows, chunked over its ring."""
    want = _jax_apply(setup)
    lens = setup["apply"]["mask"].sum(axis=1)
    for data in (0, 1):
        held = sorted((r["half"]["seq"], r["apply"]) for r in ranks
                      if r["half"]["data"] == data)
        got = np.concatenate([c for _, c in held], axis=1)
        for i in range(2):
            n = lens[2 * data + i]
            np.testing.assert_allclose(got[i, :n], want[2 * data + i, :n],
                                       atol=5e-5, rtol=5e-5)


def _flat(tree, pre=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{pre}/{k}")
        else:
            yield f"{pre}/{k}", np.asarray(v)


@pytest.mark.timeout(300)
def test_context_parallel_grads_match_jax(setup, ranks):
    """The summed gradients of the ranks' losses equal JAX's gradient of
    the whole batch's loss through its context-parallel forward (1e-4);
    without the seq-group sum they do not."""
    lcfg, ids = setup["lcfg"], setup["grads"]["ids"]
    mesh = make_cp_mesh(cp=CP, dp=1)

    def loss(p):
        return causal_lm_loss(context_parallel_apply(
            p, lcfg, mesh, input_ids=ids, compute_dtype=jnp.float32), ids)

    want = dict(_flat(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss))(setup["llama"]))))
    for r in ranks:
        assert set(r["grads"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(r["grads"][k], w, atol=1e-4,
                                       rtol=1e-4, err_msg=k)
    with pytest.raises(AssertionError):
        for k, w in want.items():
            np.testing.assert_allclose(ranks[0]["grads_fault"][k], w,
                                       atol=1e-4, rtol=1e-4, err_msg=k)


@pytest.mark.timeout(300)
def test_cp_train_step_matches_jax(setup, ranks):
    """dp 2 x cp 4 stage-1 step (the tower and splice whole on each seq
    rank, the spliced rows padded to the ring) against JAX's step on one
    device: loss within 1e-4, every parameter within 2e-4 and equal on
    every rank; the skipped seq reduction moves the parameters past it."""
    vcfg, tr = setup["vcfg"], setup["train"]
    mask = j_vlm.trainable_mask(tr["params"], vcfg)
    tx = j_optimizer.build_optimizer(ConfigDict(OPT), tr["params"], mask)
    step = jax.jit(make_train_step(vcfg, tx, compute_dtype=jnp.float32,
                                   trainable=mask))
    new_p, _, m = step(tr["params"], tx.init(tr["params"]),
                       jax.tree_util.tree_map(jnp.asarray, tr["batch"]))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, new_p)))
    for r in ranks:
        got = r["train"]["step"]
        assert abs(got["metrics"]["total_loss"]
                   - float(m["total_loss"])) < 1e-4
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   float(m["grad_norm"]), rtol=1e-4)
        flat = dict(_flat(got["params"]))
        assert set(flat) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(flat[k], w, atol=2e-4, rtol=2e-4,
                                       err_msg=k)
            np.testing.assert_array_equal(
                flat[k], dict(_flat(ranks[0]["train"]["step"]["params"]))[k])
    fault = dict(_flat(ranks[0]["train"]["fault"]["params"]))
    worst = max(float(np.abs(fault[k] - w).max() / (2e-4 + 2e-4 * np.abs(
        w).max())) for k, w in want.items())
    assert worst > 1.0, worst


def test_cp_shapes_and_refusals():
    """The port's CP entry points refuse what JAX refuses."""
    import torch

    from lhrs_bot_tpu_torch.models import llama as t_llama
    from lhrs_bot_tpu_torch.parallel.context import make_cp_mesh as t_mesh
    from lhrs_bot_tpu_torch.parallel.context import seq_chunk

    mesh = t_mesh()  # a world of one
    assert mesh.shape == {"data": 1, "seq": 1} and mesh.dp_axis is None
    with pytest.raises(ValueError, match="must equal the world size"):
        t_mesh(cp=2)
    with pytest.raises(ValueError, match="not divisible"):
        seq_chunk(torch.zeros(1, 5), dataclasses.replace(
            _Fake(), cp=2))
    cfg = t_llama.LlamaConfig.tiny_test()
    with pytest.raises(ValueError, match="positions"):
        t_llama.llama_apply({}, cfg, inputs_embeds=torch.zeros(1, 4, 8),
                            cp_axis=mesh.seq)
    with pytest.raises(ValueError, match="compose"):
        t_llama.llama_apply({}, cfg, inputs_embeds=torch.zeros(1, 4, 8),
                            cp_axis=mesh.seq, positions=torch.zeros(1, 4),
                            segment_ids=torch.ones(1, 4, dtype=torch.int32))
    # JAX has no path for CP with a dp x tp mesh, nor for CP with packing
    from lhrs_bot_tpu_torch.models import vlm as t_vlm
    from lhrs_bot_tpu_torch.models.splice import SplicedBatch
    from lhrs_bot_tpu_torch.parallel.mesh import make_mesh
    from lhrs_bot_tpu_torch.train.trainer import make_train_step as t_step

    vcfg = t_vlm.VLMConfig.tiny_test()
    with pytest.raises(ValueError, match="do not compose"):
        t_step(vcfg, None, cp_mesh=mesh, mesh=make_mesh())
    with pytest.raises(ValueError, match="do not compose"):
        t_vlm.vlm_forward_loss({}, vcfg, {}, cp_mesh=mesh, mesh=make_mesh())
    packed = SplicedBatch(torch.zeros(1, 4, 8), torch.ones(1, 4, dtype=bool),
                          torch.zeros(1, 4, dtype=torch.long),
                          torch.tensor([4]), torch.ones(1, 4))
    with pytest.raises(ValueError, match="packing"):
        t_vlm._context_parallel_loss({}, vcfg, packed, mesh, torch.float32,
                                     False)


@dataclasses.dataclass
class _Fake:
    cp: int = 1
    seq_index: int = 0
