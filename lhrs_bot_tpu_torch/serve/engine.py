"""Generation engine: batched prefill + decode over a static KV cache.

Counterpart of `lhrs_bot_tpu/serve/engine.py` `GenerationEngine.generate`
and `stream` (without sessions or speculation): greedy and temperature/top-p
sampling, max_new_tokens and EOS stopping. Prompt widths and cache lengths
are bucketed and clamped exactly as in the JAX engine, so both engines build
the same shapes for the same request.

The engine moves every parameter to its device and casts every float
parameter to the compute dtype once, at construction; the models take them
as they are. The ViT's pre-LayerNorm scale and bias are the exception: the
JAX engine keeps the vision tower's parameters as given and casts only what
its models cast, which leaves that LayerNorm on the given values (float32
for a float32 tree), so the port keeps them as given too.

Quantized serving: `quantize_bits` 8 (int8), 4 (NF4 for quant_type "nf4",
halves-packed W4A8 for "int4h", interleaved int4 otherwise) or "4h" (halves
packed) quantizes the decoder's projection weights, `lm_head_bits=8` the
lm_head (int8, per vocabulary column), and `cache_dtype=torch.int8` keeps
an int8 KV cache with float32 scale planes. The weights are quantized by the
route the JAX engine takes for a numpy parameter tree (the input that
`core.convert.params_from_numpy` bridges): with bits 8 or "4h" from their
given float values (`_host_merge_quantize`), the lm_head included; with
bits 4 after the cast to the compute dtype (`quantize_llama_layers`,
`quantize_int8` for the lm_head). So both engines produce the same codes on
the same weights. One stacked weight is quantized at a time, on the
engine's device.

`vision_w8a8=True` runs the fused W8A8 vision tower (ops/vit_block.py) and
the W8A8 perceiver (`dense_any` over int8 projections), as the JAX engine
does: the ViT layers are packed (`pack_vit_layers_fused`) and the pooler's
projections quantized (`quantize_vision_layers`) from their given values,
before any cast, so the codes are the JAX engine's.

The decode loop is a Python loop of `llama_decode_step` calls whose tokens
stay on the device; the host reads the tokens once, at the end of
`generate`. Chunked prefill, sessions, speculative decoding and meshes
are not ported: asking for one raises NotImplementedError.

A tree with "lora" (and `cfg.lora` set) is served as the JAX engine serves
it: over a dense base the adapters are merged once, at load, in float32
(`models.lora.merge_lora`) before the cast, or, for bits 8 and "4h",
before the quantization from the given values, summed over r in numpy's
order (`lora_delta_stepwise`), so the codes equal the JAX engine's
`_host_merge_quantize` codes byte for byte; over a base that is already
quantized they ride along as the runtime side path
(`attach_runtime_lora`, cast to the compute dtype).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import KVCache, llama_decode_step, llama_prefill
from ..models.lora import (attach_runtime_lora, lora_delta_stepwise,
                           merge_lora)
from ..models.vlm import VLMConfig, prepare_multimodal_inputs
from ..ops.quant import (_QUANT_TARGETS, QuantizedTensor, quantize_int4h,
                         quantize_int8, quantize_llama_layers,
                         quantize_vision_layers)
from ..ops.vit_block import pack_vit_layers_fused

logger = logging.getLogger(__name__)


def _cast_params(tree, dtype: Optional[torch.dtype], device: torch.device):
    """A nested dict of tensors on `device`, float leaves cast to `dtype`
    (kept as they are for None); QuantizedTensors move with their scales in
    float32."""
    if isinstance(tree, dict):
        return {k: _cast_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.to(device)
    if tree.is_floating_point():
        return tree.to(device=device, dtype=dtype)
    return tree.to(device)


def _quantize_llama(llama, *, compute_dtype: torch.dtype,
                    device: torch.device, quantize_bits, quant_type: str,
                    double_quant: bool, lm_head_bits, lora=None,
                    lora_cfg=None):
    """The decoder's parameters on `device`, with the `lora` adapters
    merged or attached and the weights quantized as the JAX engine does it
    for a numpy tree (see the module docstring), one stacked weight at a
    time."""
    from_given = quantize_bits in (8, "4h")
    if quantize_bits == "4h":
        bits, qtype = 4, "int4h"
    else:
        bits, qtype = quantize_bits, quant_type
    base = llama["layers"]
    if lora and any(isinstance(w, QuantizedTensor) for w in base.values()):
        base, lora = attach_runtime_lora(base, lora, lora_cfg), None
    lora = lora or {}

    def merged(name, w):
        ab = lora.get(name)
        if ab is None:
            return w
        a, b = ab["a"].to(device), ab["b"].to(device)
        if from_given:  # _host_merge_quantize's float32 merge
            return w.to(device).float() + lora_delta_stepwise(a, b) \
                * lora_cfg.scale
        return merge_lora({name: w.to(device)}, {name: {"a": a, "b": b}},
                          lora_cfg)[name]

    def quantize(name, w):
        if from_given:  # from the given float values (_host_merge_quantize)
            w = w.to(device)
            return (quantize_int8(w, axis=1) if bits == 8
                    else quantize_int4h(w, axis=1))
        w = w.to(device=device, dtype=compute_dtype)
        return quantize_llama_layers({name: w}, bits=bits, quant_type=qtype,
                                     double_quant=double_quant)[name]

    layers = {}
    for name, w in base.items():
        if isinstance(w, QuantizedTensor):
            layers[name] = w.to(device)
        elif quantize_bits and name in _QUANT_TARGETS:
            layers[name] = quantize(name, merged(name, w))
        else:
            layers[name] = _cast_params(merged(name, w), compute_dtype,
                                        device)
    out = {k: _cast_params(v, compute_dtype, device)
           for k, v in llama.items() if k not in ("layers", "lm_head")}
    head = llama["lm_head"]
    if lm_head_bits == 8 and not isinstance(head, QuantizedTensor):
        head = head.to(device) if from_given else head.to(
            device=device, dtype=compute_dtype)
        out["lm_head"] = quantize_int8(head, axis=0)
    else:
        out["lm_head"] = _cast_params(head, compute_dtype, device)
    out["layers"] = layers
    return out


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    eos_token_id: int = 2
    pad_token_id: int = 0


def _sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                  gen_cfg: GenerationConfig) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32. Greedy or temperature/top-p
    (the smallest set of tokens whose probability reaches top_p)."""
    if not gen_cfg.do_sample:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / max(gen_cfg.temperature, 1e-6)
    if gen_cfg.top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        cutoff_idx = (cum < gen_cfg.top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = sorted_logits.gather(-1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _top_p_logits(logits: torch.Tensor, temp: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature and top-p of `_sample_token_per_slot`: float32
    logits / max(temp, 1e-6), with every token below the row's top-p
    cutoff set to -1e30."""
    scaled = logits.float() / temp.float().clamp(min=1e-6)[:, None]
    sorted_logits = scaled.sort(dim=-1, descending=True).values
    cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
    cutoff_idx = (cum < top_p.float()[:, None]).sum(dim=-1, keepdim=True)
    cutoff = sorted_logits.gather(
        -1, cutoff_idx.clamp(max=logits.shape[-1] - 1))
    return scaled.masked_fill(scaled < cutoff, -1e30)


def _sample_token_per_slot(logits: torch.Tensor,
                           generator: Optional[torch.Generator],
                           temp: torch.Tensor,
                           top_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling for continuous batches (JAX `serve/engine.py`
    `_sample_token_per_slot`): logits (B, V), per-slot temperature (B,) and
    top-p (B,). Rows with temp <= 0 decode greedily; the others draw from
    `generator` after temperature and top-p, so one batch can mix greedy
    and sampled requests. Returns (B,) int32."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(_top_p_logits(logits, temp, top_p), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(temp > 0, sampled.to(torch.int32), greedy)


class GenerationEngine:
    def __init__(
        self,
        cfg: VLMConfig,
        params,
        *,
        device="cuda",
        max_seq_len: int = 2304,  # 2048 text + 144 image + headroom
        compute_dtype: torch.dtype = torch.bfloat16,
        cache_dtype: torch.dtype = torch.bfloat16,
        prompt_bucket: int = 64,
        cache_bucket: int = 256,
        quantize_bits=None,  # 8, 4 or "4h": quantized decoder weights
        quant_type: str = "nf4",  # bits 4: "nf4", "int4h" or linear int4
        double_quant: bool = True,  # bits 4 NF4: double-quantized absmax
        lm_head_bits=None,  # 8: int8 lm_head
        vision_w8a8: bool = False,
        prefill_chunk: Optional[int] = None,
        mesh=None,
    ):
        unported = {"prefill_chunk": prefill_chunk, "mesh": mesh}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"not ported yet: {', '.join(asked)}")
        if cache_dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise NotImplementedError(f"{cache_dtype} KV cache is not ported")
        if quantize_bits not in (None, 8, 4, "4h"):
            raise ValueError(f"quantize_bits must be 8, 4 or '4h', got "
                             f"{quantize_bits!r}")
        if lm_head_bits not in (None, 8):
            raise ValueError(f"lm_head_bits must be 8, got {lm_head_bits!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype
        self.max_seq_len = max_seq_len
        self.prompt_bucket = prompt_bucket
        self.cache_bucket = cache_bucket

        # the one place parameters are placed and cast: the models take
        # every float parameter in the compute dtype, but the ViT's
        # pre-LayerNorm, kept as given (see the module docstring)
        vit = {k: v for k, v in params["vit"].items() if k != "pre_ln"}
        pooler = params["pooler"]
        self._vision_packed = None
        if vision_w8a8:  # quantized from the given values, before any cast
            # the unpacked layers stay in self.params too: the schedulers
            # run the unpacked tower, as the JAX schedulers do
            self._vision_packed = pack_vit_layers_fused(
                _cast_params(vit["layers"], None, self.device))
            pooler = {**pooler, "layers": quantize_vision_layers(
                _cast_params(pooler["layers"], None, self.device))}
        self.params = {
            "vit": {**_cast_params(vit, compute_dtype, self.device),
                    "pre_ln": _cast_params(params["vit"]["pre_ln"], None,
                                           self.device)},
            "pooler": _cast_params(pooler, compute_dtype, self.device)}
        self.llama_params = _quantize_llama(
            params["llama"], compute_dtype=compute_dtype, device=self.device,
            quantize_bits=quantize_bits, quant_type=quant_type,
            double_quant=double_quant, lm_head_bits=lm_head_bits,
            lora=params.get("lora") if cfg.lora is not None else None,
            lora_cfg=cfg.lora)

    # -- pieces -------------------------------------------------------------

    def _prefill(self, input_ids: torch.Tensor, images, seq_lens, *,
                 batch: int, cache_len: int) -> Tuple[torch.Tensor, KVCache]:
        width = input_ids.shape[1]
        mask = torch.arange(width, device=self.device)[None, :] \
            < seq_lens[:, None]
        spliced = prepare_multimodal_inputs(
            self.params, self.cfg, input_ids, images, attention_mask=mask,
            compute_dtype=self.compute_dtype,
            llama_params=self.llama_params,
            vision_packed=self._vision_packed)
        cache = KVCache.create(self.cfg.llama, batch, cache_len,
                               dtype=self.cache_dtype, device=self.device)
        return llama_prefill(self.llama_params, self.cfg.llama, cache,
                             inputs_embeds=spliced.inputs_embeds,
                             prompt_len=spliced.seq_len,
                             compute_dtype=self.compute_dtype)

    def _decode_step(self, cache: KVCache, tokens: torch.Tensor):
        embeds = self.llama_params["embed_tokens"][tokens.long()][:, None]
        return llama_decode_step(self.llama_params, self.cfg.llama, cache,
                                 inputs_embeds=embeds,
                                 compute_dtype=self.compute_dtype)

    def _bucketed(self, t: int, n_img: int, max_new: int) -> Tuple[int, int]:
        """(prompt width, cache length) rounded up to bucket multiples."""
        width = -(-t // self.prompt_bucket) * self.prompt_bucket
        # the splice expands one image token into n_img embeddings: the
        # spliced prompt (width + n_img - 1) must fit the cache
        width = min(width, self.max_seq_len - n_img)
        cache_len = -(-(width + n_img + max_new) //
                      self.cache_bucket) * self.cache_bucket
        return width, min(cache_len, self.max_seq_len)

    def _clamp_new_tokens(self, gen_cfg: GenerationConfig, spliced_max: int,
                          cache_len: int) -> GenerationConfig:
        """Clamp max_new_tokens to the cache room left after the longest
        spliced prompt: the final cache length after max_new tokens is
        spliced_max + max_new - 1 (the first token comes from the prefill
        logits and is appended by the first decode step)."""
        room = max(1, cache_len - spliced_max + 1)
        if gen_cfg.max_new_tokens <= room:
            return gen_cfg
        logger.warning(
            "max_new_tokens %d exceeds cache room %d after a %d-token "
            "spliced prompt (cache_len=%d) - clamping",
            gen_cfg.max_new_tokens, room, spliced_max, cache_len)
        return dataclasses.replace(gen_cfg, max_new_tokens=room)

    @staticmethod
    def _pad_ids(input_ids: np.ndarray, width: int,
                 pad_id: int) -> np.ndarray:
        t = input_ids.shape[1]
        if t == width:
            return input_ids
        if t > width:
            return input_ids[:, :width]
        out = np.full((input_ids.shape[0], width), pad_id, input_ids.dtype)
        out[:, :t] = input_ids
        return out

    def _start(self, input_ids, seq_lens, images, gen_cfg):
        """Bucket, clamp and pad a request, then prefill it. Returns
        (first-token logits, cache, clamped gen_cfg)."""
        batch, t = input_ids.shape
        if images is not None and np.ndim(images) != 4:
            raise NotImplementedError("one (H, W, 3) image per row only")
        k_img = 0 if images is None else 1
        n_img = k_img * self.cfg.pooler.num_query
        width, cache_len = self._bucketed(t, n_img, gen_cfg.max_new_tokens)
        seq_lens = np.minimum(np.asarray(seq_lens), width)
        gen_cfg = self._clamp_new_tokens(
            gen_cfg,
            int(seq_lens.max()) + k_img * (self.cfg.pooler.num_query - 1),
            cache_len)
        ids = self._pad_ids(np.asarray(input_ids), width,
                            gen_cfg.pad_token_id)
        dev = self.device
        logits, cache = self._prefill(
            torch.as_tensor(ids, device=dev),
            None if images is None else torch.as_tensor(images, device=dev),
            torch.as_tensor(seq_lens, device=dev),
            batch=batch, cache_len=cache_len)
        return logits, cache, gen_cfg

    # -- public API ---------------------------------------------------------

    def generate(
        self,
        input_ids: np.ndarray,  # (B, T) right-padded
        seq_lens: np.ndarray,  # (B,)
        images: Optional[np.ndarray] = None,  # (B, H, W, 3) uint8 or None
        gen_cfg: Optional[GenerationConfig] = None,
        generator: Optional[torch.Generator] = None,
    ) -> List[List[int]]:
        """Returns the newly generated token ids of each row, EOS
        excluded. Sampling draws from `generator` (a generator on the
        engine's device; seed 0 when None)."""
        gen_cfg = gen_cfg or GenerationConfig()
        if generator is None and gen_cfg.do_sample:
            generator = torch.Generator(self.device).manual_seed(0)
        logits, cache, gen_cfg = self._start(input_ids, seq_lens, images,
                                             gen_cfg)
        tok = _sample_token(logits, generator, gen_cfg)
        toks = [tok]
        done = tok == gen_cfg.eos_token_id
        for _ in range(gen_cfg.max_new_tokens - 1):
            logits, cache = self._decode_step(cache, tok)
            nxt = _sample_token(logits, generator, gen_cfg)
            tok = torch.where(done, torch.full_like(nxt, gen_cfg.pad_token_id),
                              nxt)
            done = done | (tok == gen_cfg.eos_token_id)
            toks.append(tok)
        all_toks = torch.stack(toks, dim=1).cpu().numpy()

        out: List[List[int]] = []
        for row in all_toks:
            ids = []
            for t in row.tolist():
                if t == gen_cfg.eos_token_id:
                    break
                ids.append(t)
            out.append(ids)
        return out

    def stream(
        self,
        input_ids: np.ndarray,  # (1, T)
        seq_len: int,
        images: Optional[np.ndarray] = None,
        gen_cfg: Optional[GenerationConfig] = None,
        generator: Optional[torch.Generator] = None,
        stop_fn=None,
        session: bool = False,
        speculative: int = 0,
    ) -> Iterator[int]:
        """Single-sequence streaming: yields one token id per step."""
        if session or speculative:
            raise NotImplementedError("sessions and speculative decoding "
                                      "are not ported yet")
        gen_cfg = gen_cfg or GenerationConfig()
        if generator is None and gen_cfg.do_sample:
            generator = torch.Generator(self.device).manual_seed(0)
        logits, cache, gen_cfg = self._start(
            input_ids, np.asarray([seq_len]), images, gen_cfg)
        emitted: List[int] = []
        for i in range(gen_cfg.max_new_tokens):
            tok_arr = _sample_token(logits, generator, gen_cfg)
            tok = int(tok_arr[0])
            if tok == gen_cfg.eos_token_id:
                return
            emitted.append(tok)
            yield tok
            if stop_fn is not None and stop_fn(emitted):
                return
            if i + 1 == gen_cfg.max_new_tokens:
                return  # the final token's cache append would be wasted
            logits, cache = self._decode_step(cache, tok_arr)
