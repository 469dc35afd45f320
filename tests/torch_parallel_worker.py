"""One gloo rank of the port's multi-process tests (tests/torch_parallel.py
starts them): `python tests/torch_parallel_worker.py <payload.pkl> <job>`.
It joins the process group from torchrun's environment, runs the job on
the payload and pickles what the job returns to `<payload.pkl>.rank<r>`.
It imports the port only (the tests hold the results to the JAX package
in the pytest process)."""

import dataclasses
import pickle
import sys

import numpy as np
import torch

from lhrs_bot_tpu_torch.core.convert import params_from_numpy
from lhrs_bot_tpu_torch.models.vlm import VLMConfig
from lhrs_bot_tpu_torch.ops.quant import QuantizedTensor
from lhrs_bot_tpu_torch.parallel import distribute
from lhrs_bot_tpu_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def vlm_config(spec):
    """The tiny VLM of tests/fixtures' sizes, with `spec`'s overrides of
    its decoder ("llama") and its stage / LoRA."""
    cfg = VLMConfig.tiny_test(stage=spec.get("stage", 0),
                              lora=spec.get("lora", False))
    llama = dict(spec.get("llama") or {})
    if llama:
        lc = dataclasses.replace(cfg.llama, **llama)
        cfg = dataclasses.replace(
            cfg, llama=lc, pooler=dataclasses.replace(
                cfg.pooler, output_size=lc.hidden_size))
    return cfg


def host(tree):
    """Tensors (and quantized weights) as numpy, for the pickle."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return {"q": host(tree.q), "scale": host(tree.scale),
                "bits": tree.bits}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().float().numpy() \
            if tree.is_floating_point() else tree.detach().cpu().numpy()
    return tree


def snapshot(tree):
    """`core.checkpoint.to_host` of `tree`, copied (a CPU tensor's numpy
    view would follow the tensor's later updates)."""
    from lhrs_bot_tpu_torch.core.checkpoint import to_host

    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(copy(v) for v in t)
        return np.array(t) if isinstance(t, np.ndarray) else t

    return copy(to_host(tree))


def _engine(cfg, params, kw, mesh):
    from lhrs_bot_tpu_torch.serve.engine import GenerationEngine

    kw = dict(kw)
    if "cache_dtype" in kw:
        kw["cache_dtype"] = DTYPES[kw["cache_dtype"]]
    return GenerationEngine(cfg, params, max_seq_len=96,
                            compute_dtype=torch.float32, device=CPU,
                            mesh=mesh, **kw)


def serve_job(p):
    """Engines (generate ids, prefill logits, this rank's decoder slice)
    and both schedulers over a dp 1 x tp mesh."""
    from lhrs_bot_tpu_torch.ops.quant import quantize_activation
    from lhrs_bot_tpu_torch.ops.w4_matmul import row_parallel_codes
    from lhrs_bot_tpu_torch.serve import engine as t_engine
    from lhrs_bot_tpu_torch.serve.paged import PagedScheduler
    from lhrs_bot_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler, Request)

    mesh = make_mesh(dp=1, tp=p["tp"])
    out = {"engines": {}, "scheds": {}, "errors": {}}
    for name, spec in p["engines"].items():
        cfg = vlm_config(spec)
        params = params_from_numpy(p["params"][spec.get("params", "tiny")])
        try:
            eng = _engine(cfg, params, spec.get("kw", {}), mesh)
        except ValueError as exc:
            out["errors"][name] = str(exc)
            continue
        if spec.get("fault") == "packed_axis":
            plant_packed_axis(eng, cfg, params, spec.get("kw", {}), mesh)
        gcfg = t_engine.GenerationConfig(max_new_tokens=p["new_tokens"],
                                         eos_token_id=2)
        res = {"ids": [], "logits": []}
        for ids, lens, imgs in p["requests"]:
            res["ids"].append(eng.generate(ids, lens, images=imgs,
                                           gen_cfg=gcfg))
            res["logits"].append(host(eng._start(ids, lens, imgs, gcfg)[0]))
        if spec.get("keep_params"):
            res["llama"] = host(eng.llama_params)
        out["engines"][name] = res
    x = p.get("codes_input")
    if x is not None:
        t = torch.as_tensor(x)
        k = t.shape[-1] // mesh.tp
        local = t[:, mesh.model_index * k:(mesh.model_index + 1) * k]
        codes, scale = row_parallel_codes(local, mesh.model)
        ref_codes, ref_scale = quantize_activation(t)
        out["codes"] = {"codes": codes.numpy(), "scale": scale.numpy(),
                        "ref_codes": ref_codes[:, mesh.model_index * k:
                                               (mesh.model_index + 1) * k]
                        .numpy(), "ref_scale": ref_scale.numpy()}
    for name, spec in p.get("scheds", {}).items():
        cfg = vlm_config(spec)
        params = params_from_numpy(p["params"][spec.get("params", "tiny")])
        eng = _engine(cfg, params, spec.get("engine_kw", {}), mesh)
        common = dict(max_batch=spec["max_batch"],
                      compute_dtype=torch.float32,
                      cache_dtype=DTYPES[spec.get("cache", "f32")],
                      prompt_bucket=16, tokens_per_tick=spec["k"],
                      device=CPU, mesh=mesh, eos_token_id=2)
        if spec["paged"]:
            sched = PagedScheduler(cfg, eng.params, eng.llama_params,
                                   num_pages=spec["num_pages"], page_size=16,
                                   pages_per_seq=6, **common)
        else:
            sched = ContinuousBatchingScheduler(
                cfg, eng.params, eng.llama_params, max_seq_len=96,
                speculative=spec.get("speculative", 0), **common)
        reqs = [Request(uid=i, input_ids=ids, max_new_tokens=budget,
                        image=img)
                for i, (ids, budget, img) in enumerate(spec["requests"])]
        if spec.get("lockstep"):  # rank 0 leads, the others follow
            if mesh.model_index == 0:
                sched.lead()
                sched.run(reqs)
                sched.release_followers()
            else:
                sched.follow()
                reqs = []
        else:
            sched.run(reqs)
        res = {"ids": [r.output_ids for r in reqs]}
        if spec["paged"]:
            res["free"] = sched.allocator.available() + \
                sched.prefix.evictable()
            res["table"] = sched.cache.page_table.numpy()
        out["scheds"][name] = res
    return out


def dp_serve_job(p):
    """The engine's `generate` (ids, the gathered first-token logits, the
    rows its prefill held) and schedulers' waves over a dp x tp mesh, in
    float32. A scheduler spec with "fault" gathers the data groups' tokens
    in reverse group order (the planted fault; the live flags stay in
    order, so the host's bookkeeping holds and only the ids go wrong).
    With "sampled", the engine's sampled `generate` and the named waves
    (with their requests' "sampling") at the mesh and at dp 1 from the
    same generator seeds."""
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig
    from lhrs_bot_tpu_torch.serve.paged import PagedScheduler
    from lhrs_bot_tpu_torch.serve.scheduler import (
        ContinuousBatchingScheduler, Request)

    mesh = make_mesh(dp=p["dp"], tp=p["tp"])
    cfg = vlm_config({})
    eng = _engine(cfg, params_from_numpy(p["params"]), {}, mesh)
    gcfg = GenerationConfig(max_new_tokens=p["new_tokens"], eos_token_id=2)
    out = {"engine": [], "scheds": {}}
    for ids, lens, imgs in p["batches"]:
        logits, cache, _ = eng._start(ids, lens, imgs, gcfg)
        out["engine"].append({
            "ids": eng.generate(ids, lens, images=imgs, gen_cfg=gcfg),
            "logits": host(eng._gather_rows(logits, ids.shape[0])),
            "rows": cache.k.shape[1]})

    def make(spec, mesh):
        common = dict(max_batch=spec["max_batch"],
                      compute_dtype=torch.float32,
                      cache_dtype=torch.float32, prompt_bucket=16,
                      tokens_per_tick=spec["k"], device=CPU, mesh=mesh,
                      eos_token_id=2,
                      generator=torch.Generator().manual_seed(5))
        if spec.get("paged"):
            return PagedScheduler(cfg, eng.params, eng.llama_params,
                                  num_pages=spec["num_pages"], page_size=16,
                                  pages_per_seq=6, **common)
        return ContinuousBatchingScheduler(
            cfg, eng.params, eng.llama_params, max_seq_len=96,
            speculative=spec.get("speculative", 0), **common)

    def requests(spec):
        return [Request(uid=i, input_ids=ids, max_new_tokens=budget,
                        image=img, **spec.get("sampling", {}).get(i, {}))
                for i, (ids, budget, img) in enumerate(spec["requests"])]

    if p.get("sampled"):  # the same draws at dp 1 (one rank, no mesh)
        ids, lens, imgs = p["batches"][0]
        scfg = GenerationConfig(max_new_tokens=p["new_tokens"],
                                do_sample=True, temperature=1.5, top_p=0.95,
                                eos_token_id=2)
        eng1 = _engine(cfg, params_from_numpy(p["params"]), {}, None)
        out["sampled"] = {"engine": [
            e.generate(ids, lens, images=imgs, gen_cfg=scfg,
                       generator=torch.Generator().manual_seed(7))
            for e in (eng, eng1)]}
        for name, spec in p["sampled"].items():
            got = []
            for m in (mesh, None):
                reqs = requests(spec)
                make(spec, m).run(reqs)
                got.append([r.output_ids for r in reqs])
            out["sampled"][name] = got
    for name, spec in p["scheds"].items():
        sched = make(spec, mesh)
        if spec.get("fault") and sched.dp is not None:
            gather = sched._gather_slots

            def swapped(t, dim, gather=gather):
                t = gather(t, dim)  # (tokens, live flags) stacked on dim 0
                parts = t[0].chunk(sched.dp.size, dim=dim - 1)
                return torch.stack([torch.cat(parts[::-1], dim=dim - 1),
                                    t[1]])

            sched._gather_slots = swapped
        reqs = requests(spec)
        if spec.get("lockstep"):  # rank 0 leads, the others follow
            if mesh.rank == 0:
                sched.lead()
                sched.run(reqs)
                sched.release_followers()
            else:
                sched.follow()
                reqs = []
        else:
            sched.run(reqs)
        res = {"ids": [r.output_ids for r in reqs]}
        if spec.get("paged"):
            res["free"] = sched.allocator.available() + \
                sched.prefix.evictable()
            res["table"] = sched.cache.page_table.numpy()
        else:
            res["slots"] = sched.cache.k.shape[1]
        out["scheds"][name] = res
    return out


def plant_packed_axis(eng, cfg, params, kw, mesh):
    """The planted fault: the row-parallel halves-packed weights sliced
    along their packed K/2 axis (JAX's spec), not by logical rows."""
    from lhrs_bot_tpu_torch.serve.engine import _quantize_llama

    full = _quantize_llama(params["llama"], compute_dtype=torch.float32,
                           device=CPU, quantize_bits=kw["quantize_bits"],
                           quant_type="nf4", double_quant=True,
                           lm_head_bits=kw.get("lm_head_bits"))
    for name in ("wo", "w_down"):
        qt = full["layers"][name]
        k2 = qt.q.shape[1] // mesh.tp
        i = mesh.model_index
        eng.llama_params["layers"][name] = QuantizedTensor(
            qt.q[:, i * k2:(i + 1) * k2].contiguous(), qt.scale, qt.bits)


def local_batch(batch, mesh):
    """This data index's rows of a global batch."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        n = v.shape[0] // mesh.dp
        out[k] = v[mesh.data_index * n:(mesh.data_index + 1) * n]
    return out


def train_job(p):
    """Training steps over a dp x tp mesh from the same weights and
    global batches: each step's metrics, then the whole parameters and
    optimizer state (gathered), and this rank's replicated trainable
    leaves (to hold them equal across ranks). With "ckpt", the trainer
    instead: resume from p["ckpt"]["resume"] (a checkpoint directory) or
    not, train to max_iters, checkpointing every ckpt_period."""
    from lhrs_bot_tpu_torch.core.convert import (as_loaded,
                                                 training_params_from_numpy)
    from lhrs_bot_tpu_torch.models.vlm import trainable_mask
    from lhrs_bot_tpu_torch.parallel.partition import (gather_params,
                                                       shard_params)
    from lhrs_bot_tpu_torch.train import IterBasedTrainer, build_optimizer
    from lhrs_bot_tpu_torch.train.trainer import make_train_step

    mesh = make_mesh(dp=p["dp"], tp=p["tp"])
    cfg = vlm_config(p["cfg"])
    params = shard_params(mesh, training_params_from_numpy(
        p["params"], cfg, torch.float32, CPU))
    opt = build_optimizer(p["opt"], params, trainable_mask(params, cfg),
                          mesh=mesh)
    if p.get("fault") == "skip_reduce" and mesh.rank == 1:
        opt.reduce_grads = False
    out = {"metrics": []}
    batches = [local_batch(b, mesh) for b in p["batches"]]
    ck = p.get("ckpt")
    if ck is not None:
        trainer = IterBasedTrainer(
            cfg, params, opt, batches, max_iters=ck["max_iters"],
            mesh=mesh, work_dir=ck["dir"], compute_dtype=torch.float32,
            ckpt_period=ck["period"], log_period=100)
        if ck.get("resume"):
            assert trainer.resume()
            out["resumed_opt"] = snapshot(opt.state_dict())
            out["resumed_params"] = snapshot(as_loaded(
                gather_params(mesh, trainer.params)))
        trainer.train()
        params = trainer.params
    else:
        step = make_train_step(cfg, opt, torch.float32, mesh=mesh)
        for b in batches:
            m = step(params, b)
            out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = snapshot(as_loaded(gather_params(mesh, params)))
    out["opt"] = snapshot(opt.state_dict())
    out["replicated"] = snapshot({
        "pooler": params["pooler"],
        "lora": {k: v["b" if k in ("wo", "w_down") else "a"]
                 for k, v in params.get("lora", {}).items()}})
    return out


def entry_job(p):
    """A stage entry point's `main()` on p["argv"] (its trainer in
    float32, as tests/test_torch_stage_entries.py runs it)."""
    import importlib.util

    from lhrs_bot_tpu_torch.core import bootstrap

    bootstrap.build_trainer.__kwdefaults__["compute_dtype"] = torch.float32
    spec = importlib.util.spec_from_file_location("entry", p["script"])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sys.argv = [p["script"]] + list(p["argv"])
    trainer = mod.main()
    return {"cur_iter": trainer.cur_iter,
            "mesh": trainer.mesh.shape if trainer.mesh else None}


def serve_entry_job(p):
    """`lhrs_serve_torch.build_frontend(p["argv"])` (the engine in
    float32): the followers run the leader's calls until it releases
    them; the leader answers p["prompts"] through its frontend (the HTTP
    handlers' `generate_blocking`), shuts it down and releases them."""
    import runpy

    from lhrs_bot_tpu_torch.core import bootstrap
    from lhrs_bot_tpu_torch.serve.api import ServingFrontend

    bootstrap.build_engine.__kwdefaults__["compute_dtype"] = torch.float32
    mod = runpy.run_path(p["script"], run_name="lhrs_serve_torch")
    front, _ = mod["build_frontend"](p["argv"])
    if not isinstance(front, ServingFrontend):
        front.follow()
        return {"follower": True}
    outs = [front.generate_blocking(text, None, n) for text, n in p["prompts"]]
    front.shutdown()
    front.sched.release_followers()
    return {"outs": outs}


def _stand_in_kernels(calls):
    """The flash launchers' contracts in plain float32 on the CPU (the
    forward with its LSE; dQ and dK/dV from a given LSE and delta), so the
    ring's kernel route (one launch a block, the LSE merge, the dK/dV
    buffers' way home) runs here; `calls` counts each launcher's calls."""
    from lhrs_bot_tpu_torch.ops import attention as att

    def fwd(q, k, v, kv_mask, causal, sm_scale, out_dtype=torch.bfloat16,
            out=None, *, segment_ids=None, lse=None):
        calls["fwd"] += 1
        o, l_ = att.mha_reference(q, k, v, kv_mask, causal=causal,
                                  sm_scale=sm_scale, return_lse=True)
        lse.copy_(l_)
        return o

    def grads(q, k, v, kv_mask, lse, delta, d_out, causal, sm_scale):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
        allowed = att._allowed(q.shape[2], k.shape[2], kv_mask, None, causal,
                               q.device)
        if allowed is not None:
            s = s.masked_fill(~allowed, -1e30)
        p = torch.exp(s - lse[..., None])
        dp = torch.matmul(d_out.float(), v.float().transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * sm_scale
        return (torch.matmul(ds, k.float()),
                torch.matmul(ds.transpose(-1, -2), q.float()),
                torch.matmul(p.transpose(-1, -2), d_out.float()))

    def dq(q, k, v, kv_mask, seg, lse, delta, d_out, causal, sm_scale,
           runs=None):
        calls["dq"] += 1
        return grads(q, k, v, kv_mask, lse, delta, d_out, causal,
                     sm_scale)[0]

    def dkv(q, k, v, kv_mask, seg, lse, delta, d_out, causal, sm_scale,
            runs=None):
        calls["dkv"] += 1
        return grads(q, k, v, kv_mask, lse, delta, d_out, causal,
                     sm_scale)[1:]

    att.flash_attention_fwd = fwd
    att.flash_attention_bwd_dq = dq
    att.flash_attention_bwd_dkv = dkv


def _ring_case(mesh, case, route):
    """One ring case on this rank's chunks: (output chunk, dq, dk, dv
    chunks or None). `route` "plain", or "kernels" (the kernel route over
    the stand-ins)."""
    from lhrs_bot_tpu_torch.ops.ring_attention import RingAttention
    from lhrs_bot_tpu_torch.parallel.context import seq_chunk

    dtype = DTYPES[case.get("dtype", "f32")]
    q, k, v = (seq_chunk(torch.as_tensor(case[n]), mesh, 2).to(dtype)
               .requires_grad_(case.get("grad", False))
               for n in ("q", "k", "v"))
    mask = case.get("mask")
    if mask is not None:
        mask = seq_chunk(torch.as_tensor(mask), mesh, 1).contiguous()
    out = RingAttention.apply(q, k, v, mask, mesh.seq, case["causal"],
                              q.shape[-1] ** -0.5, case.get("fault"),
                              route == "plain")
    res = {"out": host(out), "dtype": str(out.dtype)}
    if case.get("grad"):
        gq, gk, gv = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
        res.update(dq=host(gq), dk=host(gk), dv=host(gv))
    return res


def ring_job(p):
    """Context parallelism over the world's ranks: the ring cases at cp =
    world and at dp 2 x cp (world / 2) (plain, and the kernel route over
    stand-ins with its launches), `context_parallel_apply`'s logits and
    gradients, and the context-parallel train step (also with the seq
    reduction skipped, the planted fault)."""
    from lhrs_bot_tpu_torch.core.convert import training_params_from_numpy
    from lhrs_bot_tpu_torch.models.llama import LlamaConfig
    from lhrs_bot_tpu_torch.models.vlm import trainable_mask
    from lhrs_bot_tpu_torch.parallel.context import (
        context_parallel_apply, context_parallel_loss, make_cp_mesh,
        reduce_gradients)
    from lhrs_bot_tpu_torch.train import build_optimizer
    from lhrs_bot_tpu_torch.train.trainer import make_train_step

    world = distribute.get_world_size()
    out = {"rank": distribute.get_rank()}
    full = make_cp_mesh(cp=world)
    half = make_cp_mesh(cp=world // 2, dp=2)
    out["full"] = {"seq": full.seq_index,
                   "cases": [_ring_case(full, c, "plain")
                             for c in p["full_cases"]]}
    calls = {"fwd": 0, "dq": 0, "dkv": 0}
    _stand_in_kernels(calls)
    res = {"seq": half.seq_index, "data": half.data_index, "cases": [],
           "kernels": [], "launches": []}
    for case in p["half_cases"]:
        res["cases"].append(_ring_case(half, case, "plain"))
        if case.get("kernels"):
            for key in calls:
                calls[key] = 0
            res["kernels"].append(_ring_case(half, case, "kernels"))
            res["launches"].append(dict(calls))
    out["half"] = res
    # the JAX wrapper's form: whole tensors in, this rank's rows out
    from lhrs_bot_tpu_torch.ops.ring_attention import ring_self_attention

    case = p["half_cases"][p["self_attention_case"]]
    out["self_attention"] = host(ring_self_attention(
        half, *(torch.as_tensor(case[n]) for n in ("q", "k", "v")),
        torch.as_tensor(case["mask"]), causal=case["causal"]))

    lcfg = LlamaConfig.tiny_test()
    lp = params_from_numpy(p["llama"])
    ap = p["apply"]
    rows = slice(half.data_index * 2, half.data_index * 2 + 2)
    with torch.no_grad():
        logits = context_parallel_apply(
            lp, lcfg, half, input_ids=torch.as_tensor(ap["ids"][rows]),
            attention_mask=torch.as_tensor(ap["mask"][rows]),
            compute_dtype=torch.float32)
    out["apply"] = host(logits)

    gp = p["grads"]
    names, leaves = [], []
    for path, t in _named_leaves(lp):
        names.append(path)
        leaves.append(t.requires_grad_())
    ids = torch.as_tensor(gp["ids"][half.data_index:half.data_index + 1])
    loss = context_parallel_loss(context_parallel_apply(
        lp, lcfg, half, input_ids=ids, compute_dtype=torch.float32),
        ids, half)
    local = torch.autograd.grad(loss, leaves)
    out["grads"] = dict(zip(names, host(reduce_gradients(local, half))))
    half.reduce_seq = False
    out["grads_fault"] = dict(zip(names, host(reduce_gradients(local,
                                                               half))))
    half.reduce_seq = True

    tp_ = p["train"]
    cfg = VLMConfig.tiny_test(stage=1)
    batch = {k: v[half.data_index:half.data_index + 1]
             for k, v in tp_["batch"].items()}
    out["train"] = {}
    for name, fault in (("step", False), ("fault", True)):
        params = training_params_from_numpy(tp_["params"], cfg,
                                            torch.float32, CPU)
        opt = build_optimizer(tp_["opt"], params,
                              trainable_mask(params, cfg))
        half.reduce_seq = not fault
        step = make_train_step(cfg, opt, torch.float32, cp_mesh=half)
        m = step(params, batch)
        out["train"][name] = {"metrics": {k: float(v) for k, v in m.items()},
                              "params": snapshot(params)}
    half.reduce_seq = True
    return out


def _named_leaves(tree, pre=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{pre}/{k}")
        else:
            yield f"{pre}/{k}", v


def graft_job(p):
    """`graft_entry.dryrun_multichip` on the world's ranks, on the CPU."""
    from lhrs_bot_tpu_torch import graft_entry

    return graft_entry.dryrun_multichip(distribute.get_world_size(),
                                        backend="gloo", device=CPU)


JOBS = {"serve": serve_job, "dp_serve": dp_serve_job, "train": train_job,
        "entry": entry_job, "serve_entry": serve_entry_job, "ring": ring_job,
        "graft": graft_job}


def main():
    src, job = sys.argv[1], sys.argv[2]
    with open(src, "rb") as fh:
        payload = pickle.load(fh)
    torch.set_num_threads(1)
    distribute.init_distributed("gloo")
    out = JOBS[job](payload)
    distribute.barrier()
    with open(f"{src}.rank{distribute.get_rank()}", "wb") as fh:
        pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)


if __name__ == "__main__":
    main()
