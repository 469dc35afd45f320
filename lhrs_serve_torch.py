"""HTTP serving entry point of the PyTorch port (continuous batching, one
CUDA card), beside `lhrs_serve.py`, the JAX package's:

  python lhrs_serve_torch.py -c serve.yaml \
      --model-path <FINAL.pt> --port 8000 --slots 8 [--paged] [--device cpu]

where serve.yaml is a copy of Config/multi_modal_eval.yaml with
`text.path` null (the byte-level tokenizer; the decoder's weights come from
FINAL.pt) and `rgb_vision.vit_name` null or a local CLIP directory: the
port has no SentencePiece reader and fetches nothing from a hub.

It builds the model and tokenizer (`core.build_model_and_tokenizer`), the
engine (`core.build_engine`: `bits`, `kv_bits`, `lm_head_bits` and
`vision_w8a8` from the config), the contiguous scheduler or, with
`--paged`, the paged one over a pool of `--pool-tokens` tokens (default
slots x S_max) in pages of `--page-size` with the prefix cache, and
serves `serve/api.py`'s routes: POST /generate, /generate_stream,
/v1/chat/completions; GET /health, /stats. `--warmup` runs dummy waves
before the port binds, so the kernels are built before the first user.

`--speculative N` runs the contiguous scheduler's speculative ticks
(prompt lookup, up to N proposals a round; greedy slots emit the plain
ticks' tokens in float32, and in bf16 may part from them where the top-2
margin lies within bf16 rounding); with `--paged` it raises ValueError, as
`lhrs_serve.py` does. Every round verifies a window for every slot through
a continuation prefill with plain PyTorch attention, even where nothing
was proposed, so on the card it is slower than plain ticks unless the
traffic repeats its history (PERF.md §6). `--prefill-chunk` sets the engine's chunked prefill and the paged
scheduler's.

The model and the cache live on the card (`--device cuda`, the default,
which raises with no card visible); `--device cpu` runs on the CPU.

`--tp N` serves the decoder tensor parallel over N ranks started by
torchrun (`torchrun --nproc-per-node N lhrs_serve_torch.py ... --tp N`;
`--dist-backend nccl`, the default, takes one card a rank, gloo lets the
ranks share a card or run on the CPU): each rank builds the engine and
slices the decoder (`parallel.partition`), rank 0 serves HTTP with its
scheduler leading, and the other ranks follow its calls
(`ContinuousBatchingScheduler.lead` / `follow`). N must be the world size.
"""

from __future__ import annotations

import datetime


def add_serve_args(p) -> None:
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--tokens-per-tick", type=int, default=16)
    p.add_argument("--adaptive-tick", action="store_true",
                   help="shrink ticks near scheduled completions and while "
                        "requests queue")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 -> greedy (the eval protocol default)")
    p.add_argument("--paged", action="store_true",
                   help="paged KV pool + prefix cache")
    p.add_argument("--pool-tokens", type=int, default=0,
                   help="paged pool capacity in tokens (default: slots x "
                        "S_max, the contiguous cache's memory)")
    p.add_argument("--page-size", type=int, default=128)
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="run the prefill decoder over slices of this many "
                        "tokens (the engine's and the paged scheduler's)")
    p.add_argument("--speculative", type=int, default=0,
                   help="contiguous scheduler: prompt-lookup window per "
                        "speculative round (0: off; not with --paged); "
                        "slower on the card unless the traffic repeats "
                        "its history")
    p.add_argument("--warmup", action="store_true",
                   help="build the kernels and run every admission shape "
                        "before binding the port")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")


def build_frontend(args=None):
    """(frontend, config) for the command line `args` (sys.argv when
    None): the model, engine, scheduler and ServingFrontend, before the
    port binds. On a follower rank of `--tp` the first item is the
    scheduler instead, which serves no HTTP."""
    from lhrs_bot_tpu_torch.core import (build_engine,
                                         build_model_and_tokenizer,
                                         parse_config, setup)
    from lhrs_bot_tpu_torch.device import resolve_device
    from lhrs_bot_tpu_torch.serve.api import ServingFrontend
    from lhrs_bot_tpu_torch.serve.engine import GenerationConfig
    from lhrs_bot_tpu_torch.serve.paged import PagedScheduler
    from lhrs_bot_tpu_torch.serve.scheduler import ContinuousBatchingScheduler

    config = parse_config("LHRS-Bot serving API (PyTorch port)",
                          extra=add_serve_args, args=args)
    mesh = None
    if int(config.get("tp") or 1) > 1:
        from lhrs_bot_tpu_torch.parallel import make_mesh

        mesh = make_mesh(dp=1, tp=int(config.tp))
    device = resolve_device(config.device)
    logger = setup(config)

    speculative = int(config.get("speculative") or 0)
    if speculative and config.paged:
        raise ValueError("--speculative needs the contiguous KV cache (the "
                         "paged scheduler's rows live behind a page table)")
    cfg, params, tokenizer = build_model_and_tokenizer(config, device)
    # the engine holds the weights; the schedulers serve
    engine = build_engine(cfg, params, config, device, mesh=mesh)
    del params

    t = float(config.temperature)
    gen_cfg = GenerationConfig(
        do_sample=t > 0, temperature=max(t, 1e-6),
        eos_token_id=int(tokenizer.eos_token_id),
        pad_token_id=int(tokenizer.pad_token_id or 0))
    common = dict(max_batch=int(config.slots),
                  max_seq_len=engine.max_seq_len,
                  compute_dtype=engine.compute_dtype,
                  cache_dtype=engine.cache_dtype,
                  tokens_per_tick=int(config.tokens_per_tick),
                  adaptive_tick=bool(config.adaptive_tick),
                  gen_cfg=gen_cfg, device=device, mesh=mesh)
    if config.paged:
        page = int(config.page_size)
        pool_tokens = (int(config.pool_tokens)
                       or int(config.slots) * engine.max_seq_len)
        sched = PagedScheduler(
            cfg, engine.params, engine.llama_params,
            num_pages=pool_tokens // page + 1,  # +1: the null page
            page_size=page, prefill_chunk=int(config.prefill_chunk) or None,
            **common)
    else:
        sched = ContinuousBatchingScheduler(cfg, engine.params,
                                            engine.llama_params,
                                            speculative=speculative, **common)
    if mesh is not None:
        # a follower waits for the leader's next call as long as the
        # server idles: that wait has a group of its own, and the model's
        # collectives keep torch's timeout, so a rank whose peer failed
        # raises
        sched.channel = mesh.model.with_timeout(datetime.timedelta(days=30))
        if mesh.model_index:
            return sched, config  # a follower: main() runs sched.follow()
        sched.lead()
    frontend = ServingFrontend(
        sched, tokenizer, image_size=cfg.vit.image_size,
        prompt_template=config.get("prompt_template") or "llava_llama_2")
    logger.info("serving %s on %s (%d slots, S_max=%d, cache %s)",
                "paged" if config.paged else "contiguous", device,
                int(config.slots), engine.max_seq_len,
                str(engine.cache_dtype).replace("torch.", ""))
    return frontend, config


def main(args=None):
    from lhrs_bot_tpu_torch.serve.api import ServingFrontend, serve

    frontend, config = build_frontend(args)
    if not isinstance(frontend, ServingFrontend):
        frontend.follow()  # the leader's calls, until it stops
        return
    try:
        if config.warmup:
            frontend.warmup()
        serve(frontend, port=int(config.port))
    finally:
        frontend.shutdown()  # no call of the worker's after the release
        frontend.sched.release_followers()


if __name__ == "__main__":
    main()
