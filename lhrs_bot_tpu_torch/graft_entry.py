"""Driver entry points of the port: a one-card training forward and a
multi-rank dry run.

Counterpart of the repo's `__graft_entry__.py` (the module keeps its name so
a reader finds it):

  entry()             -> (fn, args): the VLM training forward and loss
                         (tower -> perceiver -> splice -> decoder -> loss)
                         of a reduced but structurally complete config;
  dryrun_multichip(n) -> under torchrun's environment on n ranks: one
                         full stage step (optimizer included) over a
                         dp x tp mesh (`make_mesh`, `shard_params`), the
                         dp x cp ring loss over `make_cp_mesh`, and a
                         tensor-parallel serving tick in which the
                         contiguous and the paged schedulers emit the same
                         ids.

`python -m lhrs_bot_tpu_torch.graft_entry` runs `entry()` on the card;
`torchrun --nproc-per-node N -m lhrs_bot_tpu_torch.graft_entry --dryrun
[--dist-backend gloo] [--device cpu]` runs the dry run.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch


def _small_cfg():
    """Full-depth taps, a 3-level perceiver, a multi-layer decoder, at
    sizes that build in seconds (the JAX entry's)."""
    from .models.llama import LlamaConfig
    from .models.perceiver import PerceiverConfig
    from .models.vit import ViTConfig
    from .models.vlm import VLMConfig

    vit = ViTConfig(image_size=56, patch_size=14, width=128, layers=6,
                    heads=4, extract_stages=(2, 4, 5))
    pooler = PerceiverConfig(
        num_query=24, num_layers=2, heads=4, hidden_size=vit.width,
        encoder_hidden_size=vit.width, output_size=256,
        stage_num=(12, 8, 4), split_part=(vit.num_patches,) * 3)
    llama = LlamaConfig(vocab_size=512, hidden_size=256,
                        intermediate_size=512, num_hidden_layers=4,
                        num_attention_heads=8, max_position_embeddings=256)
    return VLMConfig(vit=vit, pooler=pooler, llama=llama, stage=1)


def _batch(cfg, b=2, t=16):
    """The JAX entry's seeded batch (numpy)."""
    from .models.constants import IMAGE_TOKEN_INDEX

    rng = np.random.default_rng(0)
    ids = rng.integers(3, cfg.llama.vocab_size, size=(b, t)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    return {
        "input_ids": ids,
        "labels": ids.copy(),
        "attention_mask": np.ones((b, t), bool),
        "images": rng.integers(
            0, 255, (b, cfg.vit.image_size, cfg.vit.image_size, 3)
        ).astype(np.uint8),
    }


def entry(device="cuda", compute_dtype: torch.dtype = torch.bfloat16):
    """(fn, (params, batch)): fn(params, batch) is the training loss in
    `compute_dtype` over seeded parameters on `device` (the card by
    default; it raises with none visible)."""
    from .models.vlm import init_vlm_params, vlm_forward_loss

    cfg = _small_cfg()
    params = init_vlm_params(cfg, seed=0, device=device)
    batch = {k: torch.as_tensor(v, device=params["llama"]["embed_tokens"]
                                .device) for k, v in _batch(cfg).items()}

    def fn(params, batch):
        out = vlm_forward_loss(params, cfg, batch,
                               compute_dtype=compute_dtype)
        return out["total_loss"]

    return fn, (params, batch)


def _mesh_shape(n: int, heads: int):
    """JAX's choice: dp x tp with both axes above 1 where n allows (tp
    the largest divisor of n and of the heads up to n / 2 from 4 ranks)."""
    cap = min(n // 2 if n >= 4 else n, heads)
    tp = next(c for c in range(cap, 0, -1) if n % c == 0 and heads % c == 0)
    return n // tp, tp


def _stage_step(cfg, dp, tp, device):
    """One full stage step (AdamW, clipping, a cosine schedule) over the
    dp x tp mesh; returns (loss, grad_norm)."""
    from .core.config import ConfigDict
    from .core.convert import training_params_from_numpy
    from .models.vlm import init_vlm_params, trainable_mask
    from .parallel.mesh import make_mesh
    from .parallel.partition import shard_params
    from .train import build_optimizer, build_schedule, make_train_step

    mesh = make_mesh(dp=dp, tp=tp)
    conf = ConfigDict({
        "optimizer": "adamw", "lr": 1e-3, "wd": 0.01, "max_grad_norm": 1.0,
        "schedule": {"name": "cosine", "min_lr": 1e-5, "warmup_epochs": 10},
    })
    params = shard_params(mesh, training_params_from_numpy(
        init_vlm_params(cfg, seed=0, device=device), cfg, torch.bfloat16,
        device))
    opt = build_optimizer(conf, params, trainable_mask(params, cfg),
                          schedule=build_schedule(conf, total_iters=100),
                          mesh=mesh)
    batch = _batch(cfg, b=2 * dp)
    rows = slice(2 * mesh.data_index, 2 * mesh.data_index + 2)
    batch = {k: torch.as_tensor(v[rows], device=device)
             for k, v in batch.items()}
    step = make_train_step(cfg, opt, compute_dtype=torch.bfloat16, mesh=mesh)
    metrics = step(params, batch)
    return float(metrics["total_loss"]), float(metrics["grad_norm"])


def _ring_loss(cfg, dp, cp, device):
    """The sequence-split decoder forward and loss over a dp x cp ring
    (a row of 8 * cp ids a data index); returns the global loss."""
    from .models.vlm import init_vlm_params
    from .parallel.context import (context_parallel_apply,
                                   context_parallel_loss, make_cp_mesh)

    mesh = make_cp_mesh(cp=cp, dp=dp)
    lp = init_vlm_params(cfg, seed=1, device=device)["llama"]
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(3, cfg.llama.vocab_size, (dp, 8 * cp),
                        generator=gen)
    row = ids[mesh.data_index:mesh.data_index + 1].to(device)
    with torch.no_grad():
        logits = context_parallel_apply(lp, cfg.llama, mesh, input_ids=row,
                                        compute_dtype=torch.bfloat16)
        loss = context_parallel_loss(logits, row, mesh).reshape(1)
        mesh.seq.all_reduce(loss)
        mesh.data.all_reduce(loss)
    return float(loss)


def _serving_tick(n, device):
    """One tensor-parallel decode tick through both schedulers on the same
    mesh (tp the largest divisor of n and the heads; with tp below n each
    data index serves its own replica): the ids they emit."""
    from .models.vlm import VLMConfig, init_vlm_params
    from .parallel.mesh import Axis, Mesh, make_mesh
    from .serve.engine import GenerationEngine
    from .serve.paged import PagedScheduler
    from .serve.scheduler import ContinuousBatchingScheduler, Request

    cfg = VLMConfig.tiny_test(stage=0)
    heads = cfg.llama.num_attention_heads
    tp = next(c for c in range(min(n, heads), 0, -1)
              if n % c == 0 and heads % c == 0)
    full = make_mesh(dp=n // tp, tp=tp)
    mesh = Mesh(1, tp, full.rank, data=Axis("data", [full.rank], 0),
                model=full.model)
    params = init_vlm_params(cfg, seed=3, device=device)
    eng = GenerationEngine(cfg, params, max_seq_len=64,
                           compute_dtype=torch.float32,
                           cache_dtype=torch.float32, device=device,
                           mesh=mesh)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 200, size=(k,)).astype(np.int32)
               for k in (11, 7)]
    common = dict(max_batch=2, compute_dtype=torch.float32,
                  cache_dtype=torch.float32, prompt_bucket=16,
                  tokens_per_tick=2, mesh=mesh, device=device,
                  eos_token_id=cfg.llama.eos_token_id)

    def run(sched):
        reqs = [Request(uid=i, input_ids=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        sched.run(reqs)
        return [r.output_ids for r in reqs]

    contig = run(ContinuousBatchingScheduler(
        cfg, eng.params, eng.llama_params, max_seq_len=64, **common))
    paged = run(PagedScheduler(cfg, eng.params, eng.llama_params,
                               num_pages=16, page_size=16, pages_per_seq=4,
                               **common))
    return tp, contig, paged


def dryrun_multichip(n_devices: int, backend=None, device=None) -> dict:
    """The three parts on the world of torchrun's `n_devices` ranks (the
    process group joined here with `backend`, NCCL on cards and gloo
    without by default; `device` defaults to this rank's card, else the
    CPU). Raises where a loss is not finite or the schedulers' ids
    differ; returns the readings."""
    from .parallel import distribute

    distribute.init_distributed(backend)
    world = distribute.get_world_size()
    if world != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, torchrun started "
                           f"{world}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    cfg = _small_cfg()
    dp, tp = _mesh_shape(n_devices, cfg.llama.num_attention_heads)
    loss, norm = _stage_step(cfg, dp, tp, device)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    out = {"dp": dp, "tp": tp, "loss": loss, "grad_norm": norm}
    cp = n_devices // dp
    if n_devices >= 2:
        out["cp"] = cp
        out["cp_loss"] = _ring_loss(cfg, dp, cp, device)
        if not math.isfinite(out["cp_loss"]):
            raise AssertionError(f"non-finite CP loss: {out['cp_loss']}")
        srv_tp, contig, paged = _serving_tick(n_devices, device)
        if contig != paged or not all(contig):
            raise AssertionError(f"tp decode mismatch contiguous vs paged: "
                                 f"{contig} vs {paged}")
        out.update(serve_tp=srv_tp, ids=contig)
    if distribute.is_main_process():
        print(f"dryrun_multichip(n={n_devices}): mesh dp={dp} x tp={tp}, "
              f"loss={loss:.4f} grad_norm={norm:.4f}", flush=True)
        if "cp" in out:
            print(f"dryrun_multichip: context-parallel dp={dp} x cp={cp} "
                  f"ring-attention loss={out['cp_loss']:.4f}", flush=True)
            print(f"dryrun_multichip: tp={out['serve_tp']} serving decode "
                  f"tick ok (contiguous == paged, "
                  f"{sum(len(o) for o in out['ids'])} tokens)", flush=True)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dryrun", action="store_true",
                        help="the multi-rank dry run (under torchrun)")
    parser.add_argument("--dist-backend", default=None,
                        choices=("nccl", "gloo"))
    parser.add_argument("--device", default=None,
                        help="cuda (default where a card is visible) or cpu")
    args = parser.parse_args(argv)
    if args.dryrun:
        from .parallel import distribute

        dryrun_multichip(int(os.environ.get("WORLD_SIZE", "1")),
                         backend=args.dist_backend,
                         device=None if args.device is None
                         else torch.device(args.device))
        distribute.barrier()
        return
    fn, fargs = entry(device=args.device or "cuda")
    print("entry loss:", float(fn(*fargs)), flush=True)


if __name__ == "__main__":
    main()
