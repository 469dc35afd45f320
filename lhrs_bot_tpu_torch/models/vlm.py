"""The composed vision-language model: tower -> perceiver -> splice -> LLaMA.

Counterpart of `lhrs_bot_tpu/models/vlm.py`: `VLMConfig`,
`init_vlm_params`, `effective_llama_params` (LoRA merged into a dense
base, or attached as a runtime side path to a quantized one),
`encode_image`, `prepare_multimodal_inputs` (one image a row, or (B, K, H,
W, 3) image slots with packing segment ids), and for training
`vlm_forward_loss` ({"text_loss", "total_loss"}) and `trainable_mask` (the
stage rules of which leaves train). Parameters are a nested dict of
tensors with the JAX package's structure and layout: `{"vit": ...,
"pooler": ..., "llama": ..., ["lora": ...]}`, per-layer tensors stacked on
a leading axis, projection weights (in, out).
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional

import torch

from ..device import resolve_device
from ..ops.quant import QuantizedTensor
from .constants import IGNORE_INDEX
from .llama import LlamaConfig, causal_lm_loss, llama_apply
from .lora import (LoraConfig, attach_runtime_lora, init_lora_params,
                   merge_lora)
from .perceiver import PerceiverConfig, perceiver_resample
from .splice import (SplicedBatch, splice_image_embeddings,
                     splice_image_embeddings_multi)
from .vit import ViTConfig, vit_encode, vit_encode_fused


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig.vit_large)
    pooler: PerceiverConfig = dataclasses.field(
        default_factory=PerceiverConfig)
    llama: LlamaConfig = dataclasses.field(
        default_factory=LlamaConfig.llama2_7b)
    lora: Optional[LoraConfig] = None
    # 1 = caption alignment, 2 / 3 = instruction tuning with LoRA, 0 = eval
    stage: int = 1
    tune_rgb_bk: bool = False
    tune_rgb_pooler: bool = True

    @classmethod
    def tiny_test(cls, stage: int = 1, lora: bool = False
                  ) -> "VLMConfig":
        vit = ViTConfig.tiny_test()
        pooler = dataclasses.replace(
            PerceiverConfig.tiny_test(), hidden_size=vit.width,
            encoder_hidden_size=vit.width, output_size=64,
            split_part=(vit.num_patches,) * 3)
        return cls(vit=vit, pooler=pooler, llama=LlamaConfig.tiny_test(),
                   lora=LoraConfig(r=4, alpha=8) if lora else None,
                   stage=stage)

    @classmethod
    def from_config_dict(cls, cfg) -> "VLMConfig":
        """From a nested config dict with the schema of `Config/*.yaml`."""
        arch = cfg["rgb_vision"]["arch"]
        if arch == "vit_large":
            vit = ViTConfig.vit_large()
        elif arch == "vit_base":
            vit = ViTConfig.vit_base()
        elif arch in ("vit_tiny", "vit_tiny_test"):
            vit = ViTConfig.tiny_test()
        else:
            raise ValueError(f"unknown rgb_vision.arch {arch!r}")
        ap = cfg["rgb_vision"]["attn_pooler"]
        nq = int(ap["num_query"])
        stage_num = tuple(ap.get("stage_num")
                          or ((64, 48, 32) if nq == 144 else None)
                          or (nq // 2, nq - nq // 2 - nq // 4, nq // 4))
        pooler = PerceiverConfig(
            num_query=nq, num_layers=int(ap["num_layers"]),
            heads=int(ap["num_attn_heads"]), hidden_size=vit.width,
            encoder_hidden_size=vit.width,
            output_size=int(cfg["text"]["hidden_size"]),
            stage_num=stage_num,
            split_part=(vit.num_patches,) * len(stage_num))
        # stage 3 trains the stage-2 adapters it loads from TextLoRA/ even
        # though its yaml sets lora.enable False
        lora = cfg.get("lora")
        lora = (LoraConfig.from_config_dict(lora)
                if lora and (lora.get("enable") or cfg.get("stage") == 3)
                else None)
        return cls(vit=vit, pooler=pooler,
                   llama=LlamaConfig.from_config_dict(cfg["text"]),
                   lora=lora, stage=cfg["stage"],
                   tune_rgb_bk=cfg.get("tune_rgb_bk", False),
                   tune_rgb_pooler=cfg.get("tune_rgb_pooler", True))


def param_specs(cfg: VLMConfig):
    """The structure of the "vit", "pooler" and "llama" parameters: a
    nested dict whose leaves are (kind, shape), kind "normal" (N(0, 0.02)),
    "query" (0.02 * N(0, 1) truncated to [-2, 2]), "ones" or "zeros"."""
    v, p, m = cfg.vit, cfg.pooler, cfg.llama

    def normal(*shape):
        return ("normal", shape)

    def ones(*shape):
        return ("ones", shape)

    def zeros(*shape):
        return ("zeros", shape)

    w, lv = v.width, v.layers
    vit = {
        "patch_proj": normal(v.patch_size * v.patch_size * 3, w),
        "class_emb": normal(w),
        "pos_emb": normal(v.seq_len, w),
        "pre_ln": {"scale": ones(w), "bias": zeros(w)},
        "post_ln": {"scale": ones(w), "bias": zeros(w)},
        "layers": {
            "ln1_scale": ones(lv, w), "ln1_bias": zeros(lv, w),
            "wq": normal(lv, w, w), "bq": zeros(lv, w),
            "wk": normal(lv, w, w), "bk": zeros(lv, w),
            "wv": normal(lv, w, w), "bv": zeros(lv, w),
            "wo": normal(lv, w, w), "bo": zeros(lv, w),
            "ln2_scale": ones(lv, w), "ln2_bias": zeros(lv, w),
            "w_fc": normal(lv, w, w * v.mlp_ratio),
            "b_fc": zeros(lv, w * v.mlp_ratio),
            "w_proj": normal(lv, w * v.mlp_ratio, w), "b_proj": zeros(lv, w),
        },
    }
    h, lp, ffn = p.hidden_size, p.num_layers, p.hidden_size * p.mlp_ratio
    pooler = {
        "query": ("query", (p.num_query, h)),
        "layers": {
            "ln1_scale": ones(lp, h), "ln1_bias": zeros(lp, h),
            "ln_kv_scale": ones(lp, h), "ln_kv_bias": zeros(lp, h),
            "wq": normal(lp, h, h), "bq": zeros(lp, h),
            "wk": normal(lp, h, h), "bk": zeros(lp, h),
            "wv": normal(lp, h, h), "bv": zeros(lp, h),
            "wo": normal(lp, h, h), "bo": zeros(lp, h),
            "ln2_scale": ones(lp, h), "ln2_bias": zeros(lp, h),
            "w_fc": normal(lp, h, ffn), "b_fc": zeros(lp, ffn),
            "w_proj": normal(lp, ffn, h), "b_proj": zeros(lp, h),
        },
        "out_proj_w": normal(h, p.output_size),
        "out_proj_b": zeros(p.output_size),
    }
    if p.encoder_hidden_size != h:  # the vision width differs
        pooler["in_proj_w"] = normal(p.encoder_hidden_size, h)
        pooler["in_proj_b"] = zeros(h)
    d, f, nl, vocab = (m.hidden_size, m.intermediate_size,
                       m.num_hidden_layers, m.vocab_size)
    llama = {
        "embed_tokens": normal(vocab, d),
        "layers": {
            "input_norm": ones(nl, d),
            "wq": normal(nl, d, d), "wk": normal(nl, d, d),
            "wv": normal(nl, d, d), "wo": normal(nl, d, d),
            "post_attn_norm": ones(nl, d),
            "w_gate": normal(nl, d, f), "w_up": normal(nl, d, f),
            "w_down": normal(nl, f, d),
        },
        "final_norm": ones(d),
        "lm_head": normal(d, vocab),
    }
    return {"vit": vit, "pooler": pooler, "llama": llama}


def leaf_generator(seed: int, path: str, device="cpu") -> torch.Generator:
    """The generator of the leaf at `path` ("llama/layers/wq", or "lora"
    for the adapters), seeded from `seed` and the path: a leaf's draw does
    not depend on which other leaves are drawn."""
    return torch.Generator(device=device).manual_seed(
        (seed << 32) + zlib.crc32(path.encode()))


def draw_param(spec, path: str, seed: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    """The leaf of `param_specs` at `path`, drawn on `device` from its own
    generator (`leaf_generator`)."""
    kind, shape = spec
    if kind in ("ones", "zeros"):
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=dtype, device=device)
    gen = leaf_generator(seed, path, device)
    if kind == "normal":
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device).mul_(0.02)
    query = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(query, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return query.mul_(0.02).to(dtype)


def init_vlm_params(cfg: VLMConfig, seed: int = 0,
                    dtype: torch.dtype = torch.float32, device="cuda"):
    """Random parameters with the JAX `init_*_params` structure: weights
    N(0, 0.02), perceiver queries 0.02 * N(0, 1) truncated to [-2, 2], norm
    scales 1, biases 0 (`param_specs`), each leaf drawn on `device` by
    `draw_param`; the numbers differ from the JAX package's for the same
    seed. With `cfg.lora`, "lora" holds the adapters of
    `models.lora.init_lora_params` (B = 0) drawn from
    `leaf_generator(seed, "lora")`."""
    device = resolve_device(device)

    def walk(spec, path):
        if isinstance(spec, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in spec.items()}
        return draw_param(spec, path, seed, dtype, device)

    params = walk(param_specs(cfg), "")
    if cfg.lora is not None:
        params["lora"] = init_lora_params(
            cfg.llama, cfg.lora, leaf_generator(seed, "lora", device), dtype,
            device)
    return params


def effective_llama_params(params, cfg: VLMConfig, tp=None):
    """The decoder's parameters with the LoRA adapters applied (where
    `cfg.lora` is set and the tree holds "lora"): merged into a dense base
    (`merge_lora`, with `tp` the model axis of a tensor-parallel slice),
    attached as the runtime side path to a quantized one
    (`attach_runtime_lora`)."""
    llama = params["llama"]
    if cfg.lora is None or "lora" not in params:
        return llama
    if any(isinstance(w, QuantizedTensor)
           for w in llama["layers"].values()):
        layers = attach_runtime_lora(llama["layers"], params["lora"],
                                     cfg.lora)
    else:
        layers = merge_lora(llama["layers"], params["lora"], cfg.lora, tp)
    return {**llama, "layers": layers}


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def encode_image(params, images: torch.Tensor, cfg: VLMConfig,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 vision_packed=None) -> torch.Tensor:
    """uint8 (B, H, W, 3) images -> (B, num_query, llm hidden). With
    `vision_packed` (from `ops.vit_block.pack_vit_layers_fused`) the tower
    is the fused W8A8 one. A tower none of whose parameters requires a
    gradient (the frozen tower of training) runs without building a
    graph."""
    with torch.set_grad_enabled(torch.is_grad_enabled()
                                and _requires_grad(params["vit"])):
        if vision_packed is not None:
            feats = vit_encode_fused(params["vit"], vision_packed, images,
                                     cfg.vit)
        else:
            feats = vit_encode(params["vit"], images, cfg.vit,
                               compute_dtype=compute_dtype)
    return perceiver_resample(params["pooler"], feats, cfg.pooler,
                              compute_dtype=compute_dtype)


def prepare_multimodal_inputs(
    params, cfg: VLMConfig, input_ids: torch.Tensor,
    images: Optional[torch.Tensor],
    attention_mask: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    llama_params=None,
    vision_packed=None,
    segment_ids: Optional[torch.Tensor] = None,
) -> SplicedBatch:
    """Token ids (+ images) -> spliced decoder inputs. Text-only batches
    (images None) are embedded directly. (B, H, W, 3) images splice one a
    row; (B, K, H, W, 3) image slots (multi-image and packed rows) are
    encoded in one tower batch and marker k takes slot k, with
    `segment_ids` carried through. Packing with one image a row raises
    ValueError, as in the JAX package."""
    if llama_params is None:
        llama_params = params["llama"]
    embed_tokens = llama_params["embed_tokens"]
    if images is None:
        embeds = embed_tokens[input_ids.clamp(min=0).long()]
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.bool,
                                        device=input_ids.device)
        return SplicedBatch(embeds, attention_mask, labels,
                            attention_mask.int().sum(dim=1).int(),
                            segment_ids)
    if images.dim() == 5:
        b, k = images.shape[:2]
        image_embeds = encode_image(params, images.reshape(
            (b * k,) + tuple(images.shape[2:])), cfg, compute_dtype,
            vision_packed)
        image_embeds = image_embeds.reshape(b, k, *image_embeds.shape[1:])
        return splice_image_embeddings_multi(
            input_ids, image_embeds, embed_tokens, attention_mask, labels,
            segment_ids=segment_ids)
    if segment_ids is not None:
        raise ValueError("sequence packing requires (B, K, H, W, 3) images "
                         "(PackingCollator) or text-only batches")
    image_embeds = encode_image(params, images, cfg, compute_dtype,
                                vision_packed)
    return splice_image_embeddings(input_ids, image_embeds, embed_tokens,
                                   attention_mask, labels)


def cast_floats(tree, dtype: torch.dtype, keep=()):
    """The tree with every float tensor in `dtype` (a differentiable cast;
    a tensor already in it is returned as is), QuantizedTensors and the
    keys in `keep` as they are."""
    if isinstance(tree, dict):
        return {k: (v if k in keep else cast_floats(v, dtype))
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _batch_tensor(batch, key, device):
    value = batch.get(key)
    if value is None:
        return None
    return torch.as_tensor(value, device=device)


def vlm_forward_loss(params, cfg: VLMConfig, batch: Dict,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     remat: bool = False, cp_mesh=None, mesh=None
                     ) -> Dict[str, torch.Tensor]:
    """Training forward -> {"text_loss", "total_loss"} (equal for the
    published recipes). `batch` holds `input_ids`, `labels` and optionally
    `attention_mask`, `images` and `segment_ids`, as tensors or numpy
    arrays (moved to the parameters' device). Float parameters are cast to
    the compute dtype on the fly, as the JAX model functions cast them (the
    ViT's pre-LayerNorm stays as given); the frozen tower runs without a
    graph; the decoder runs over `effective_llama_params` (LoRA merged or
    attached) and its backward through the flash backward kernels.

    With `cp_mesh` (`parallel.context.CpMesh`) the decoder runs context
    parallel: `params` are whole and `batch` is this data index's rows, the
    same on every rank of the seq group; the tower and the splice run whole
    on each, then the spliced sequence is padded to a multiple of the ring
    (IGNORE_INDEX labels, a false mask), and each rank runs its chunk
    (`context_parallel_apply`) and returns its share of the global loss
    (`context_parallel_loss`): the ranks' losses (and gradients) sum to the
    global batch's. Not with `segment_ids` (ValueError, as in JAX) or with
    `mesh` (ValueError: JAX has no such path).

    With `mesh` (`parallel.mesh.Mesh`) `params` is this rank's slice
    (`parallel.partition.shard_params`) and `batch` its data index's
    share: the decoder runs tensor parallel over the model axis, and the
    loss divides by the data group's valid-token count, so the group's
    sum of the returned losses (and of their gradients) is the loss of
    the global batch (`causal_lm_loss`)."""
    if cp_mesh is not None:
        from ..parallel.context import CpMesh

        if not isinstance(cp_mesh, CpMesh):
            raise TypeError("cp_mesh must be a lhrs_bot_tpu_torch.parallel."
                            f"context.CpMesh, got {type(cp_mesh).__name__}")
        if mesh is not None:
            raise ValueError("cp_mesh and mesh do not compose: context "
                             "parallelism takes whole weights")
    tp = mesh.tp_axis if mesh is not None else None
    llama = effective_llama_params(params, cfg, tp)
    device = llama["embed_tokens"].device
    run = {"vit": cast_floats(params["vit"], compute_dtype, keep=("pre_ln",)),
           "pooler": cast_floats(params["pooler"], compute_dtype)}
    spliced = prepare_multimodal_inputs(
        run, cfg, _batch_tensor(batch, "input_ids", device).long(),
        _batch_tensor(batch, "images", device),
        attention_mask=_batch_tensor(batch, "attention_mask", device),
        labels=_batch_tensor(batch, "labels", device),
        compute_dtype=compute_dtype, llama_params=llama,
        segment_ids=_batch_tensor(batch, "segment_ids", device))
    if cp_mesh is not None:
        return _context_parallel_loss(llama, cfg, spliced, cp_mesh,
                                      compute_dtype, remat)
    logits = llama_apply(llama, cfg.llama,
                         inputs_embeds=spliced.inputs_embeds,
                         attention_mask=spliced.attention_mask,
                         compute_dtype=compute_dtype, remat=remat,
                         segment_ids=spliced.segment_ids, tp=tp)
    text_loss = causal_lm_loss(logits, spliced.labels,
                               mesh.dp_axis if mesh is not None else None)
    return {"text_loss": text_loss, "total_loss": text_loss}


def _context_parallel_loss(llama, cfg: VLMConfig, spliced: SplicedBatch,
                           cp_mesh, compute_dtype, remat):
    """The decoder's loss over a ring (`vlm_forward_loss` with cp_mesh)."""
    from ..parallel.context import (context_parallel_apply,
                                    context_parallel_loss)

    if spliced.segment_ids is not None:
        raise ValueError("sequence packing + context parallelism are not "
                         "composable (ring attention has no segment "
                         "masking)")
    embeds, mask, labels = (spliced.inputs_embeds, spliced.attention_mask,
                            spliced.labels)
    pad = (-embeds.shape[1]) % cp_mesh.cp
    if pad:
        embeds = torch.nn.functional.pad(embeds, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
        labels = torch.nn.functional.pad(labels, (0, pad),
                                         value=IGNORE_INDEX)
    logits = context_parallel_apply(
        llama, cfg.llama, cp_mesh, inputs_embeds=embeds, attention_mask=mask,
        compute_dtype=compute_dtype, remat=remat)
    text_loss = context_parallel_loss(logits, labels, cp_mesh)
    return {"text_loss": text_loss, "total_loss": text_loss}


def trainable_mask(params, cfg: VLMConfig):
    """Nested dict of bools like `params` marking the trainable leaves, by
    the stage rules of the JAX `trainable_mask`: stage 1 trains the pooler
    (and the tower with `tune_rgb_bk`), never the decoder (nor a
    quantized base); stages 2 and 3 also train the "lora" leaves (the
    pooler trains where `tune_rgb_pooler` says, which the stage-3 recipe
    turns off); stage 0 (eval) trains nothing."""

    def full(tree, value):
        if isinstance(tree, dict):
            return {k: full(v, value) for k, v in tree.items()}
        return value

    mask = {"vit": full(params["vit"], bool(cfg.tune_rgb_bk
                                            and cfg.stage != 0)),
            "pooler": full(params["pooler"], bool(cfg.tune_rgb_pooler
                                                  and cfg.stage != 0)),
            "llama": full(params["llama"], False)}
    if "lora" in params:
        mask["lora"] = full(params["lora"], cfg.stage in (2, 3))
    return mask
