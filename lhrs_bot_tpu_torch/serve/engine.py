"""Generation engine: batched prefill + decode over a static KV cache.

Counterpart of `lhrs_bot_tpu/serve/engine.py` `GenerationEngine.generate`
and `stream`: greedy and temperature/top-p
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
`generate`. Images come one a row, (B, H, W, 3), or K a row, (B, K, H, W,
3), marker k taking image k. `warmup` runs `generate` at the expected
request shapes.

Built on `llama_prefill_continue`, as in the JAX engine:
  * `prefill_chunk`: the splice runs once, then the decoder prefills
    `prefill_chunk`-wide slices of the spliced embeddings against the
    growing cache; each row's logits come from the slice holding its last
    valid row;
  * `stream(session=True)`: the KV cache and the raw ids it holds (the
    prompt and the emitted tokens appended so far) survive the call; the
    next turn's rendered conversation prefills only the suffix past their
    common prefix (at least 8 tokens, pure text, the same image's sha1).
    The first turn's cache is sized to max_seq_len, so a later turn never
    grows it;
  * `stream(speculative=N)` (greedy only): prompt lookup
    (`serve.speculative.propose_from_history`, the scheduler's, on one
    row) proposes up to N tokens from the history, one continuation
    prefill verifies them, the agreeing prefix is kept (`accept_window`)
    and `cache.length` rewound past the rejected rows (which the next
    append overwrites). The ids are plain greedy's where the window and
    the decode step compute the same logits: in float32. In bf16 on the
    card the window attends through plain PyTorch and the decode step
    through K2 / K4, so the ids may part from plain greedy's where the
    top-2 margin lies within bf16 rounding.
`mesh` (a `parallel.mesh.Mesh`, one process a rank) serves over JAX's
("data", "model") mesh. On the model axis the decoder runs tensor
parallel, as the JAX engine does: the weights are merged, quantized and
cast at full size as above, then each rank keeps its slice
(`parallel.partition.shard_llama_for_serving`); its KV cache holds H / tp
heads; the vision tower and the perceiver run replicated. The logits are
gathered whole on every rank of the model group, and each sampled token is
broadcast from its first rank. On the data axis each group computes its
own contiguous block of a batch's rows (the order `P("data")` puts them
in: group d takes rows [d B / dp, (d + 1) B / dp)), vision tower,
prefill and decode, and `generate` gathers the sampled tokens over the
data axis, so every rank returns the whole batch. A batch that dp does not
divide (a stream's single row, a session's turn) is computed whole by
every group, as JAX's replicated engine does. Every rank must make the
same calls in the same order, so the ranks never part.

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
import hashlib
import logging
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.constants import IMAGE_TOKEN_INDEX
from ..models.llama import (KVCache, llama_decode_step, llama_prefill,
                            llama_prefill_continue)
from ..models.lora import (attach_runtime_lora, lora_delta_stepwise,
                           merge_lora)
from ..models.vlm import VLMConfig, prepare_multimodal_inputs
from ..parallel.mesh import Mesh
from ..parallel.partition import shard_llama_for_serving
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


def _multinomial(probs: torch.Tensor, generator: Optional[torch.Generator],
                 draw=None) -> torch.Tensor:
    """One token a row of probs (B, V) from `generator`, (B,) int64. With
    `draw` = (rows, batch), probs holds the rows `rows` (a slice or an
    index tensor) of a `batch`-row batch whose other rows other data
    groups hold: the draw is made over the whole batch, those rows
    uniform, and keeps `rows`. A row's draw depends on its probabilities
    and its place in the batch only, so each row draws what the whole
    batch's call gives it, and the generator ends where that call leaves
    it."""
    if draw is None:
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    rows, batch = draw
    full = probs.new_ones((batch, probs.shape[-1]))
    full[rows] = probs
    return torch.multinomial(full, 1, generator=generator)[rows, 0]


def _uniform(shape, generator: Optional[torch.Generator], device,
             draw=None) -> torch.Tensor:
    """torch.rand of `shape` (B, ...) from `generator`; under `draw`, the
    rows `rows` of the whole batch's draw, as in `_multinomial`."""
    if draw is None:
        return torch.rand(shape, generator=generator, device=device)
    rows, batch = draw
    return torch.rand((batch, *shape[1:]), generator=generator,
                      device=device)[rows]


def _sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                  gen_cfg: GenerationConfig, draw=None) -> torch.Tensor:
    """logits (B, V) -> token ids (B,) int32. Greedy or temperature/top-p
    (the smallest set of tokens whose probability reaches top_p); `draw`
    as in `_multinomial`."""
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
    return _multinomial(probs, generator, draw).to(torch.int32)


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
                           top_p: torch.Tensor, draw=None) -> torch.Tensor:
    """Per-row sampling for continuous batches (JAX `serve/engine.py`
    `_sample_token_per_slot`): logits (B, V), per-slot temperature (B,) and
    top-p (B,). Rows with temp <= 0 decode greedily; the others draw from
    `generator` after temperature and top-p, so one batch can mix greedy
    and sampled requests; `draw` as in `_multinomial`. Returns (B,)
    int32."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    probs = torch.softmax(_top_p_logits(logits, temp, top_p), dim=-1)
    sampled = _multinomial(probs, generator, draw)
    return torch.where(temp > 0, sampled.to(torch.int32), greedy)


def check_serving_mesh(mesh, max_batch: Optional[int] = None) -> None:
    """A serving mesh: None, or a `parallel.mesh.Mesh` (TypeError for
    another object). With `max_batch`, the slots of a scheduler that splits
    them over the data axis: ValueError unless dp divides it, as JAX's
    data-sharded cache requires."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a lhrs_bot_tpu_torch.parallel.Mesh, "
                        f"got {type(mesh).__name__}")
    if max_batch is not None and max_batch % mesh.dp:
        raise ValueError(f"max_batch {max_batch} is not a multiple of the "
                         f"data axis (dp={mesh.dp}): each data group holds "
                         "max_batch / dp slots")


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
        check_serving_mesh(mesh)
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
        self.prefill_chunk = prefill_chunk
        self.mesh = mesh
        self.tp = mesh.tp_axis if mesh is not None else None
        self.dp = mesh.dp_axis if mesh is not None else None
        # stream(session=True)'s state: {"raw_ids", "image_fp", "cache"}
        self._session = None

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
        if self.tp is not None:  # quantized at full size, then sliced
            self.llama_params = shard_llama_for_serving(mesh,
                                                        self.llama_params)

    @property
    def heads(self) -> int:
        """The attention heads this rank's cache holds."""
        return self.cfg.llama.num_attention_heads // (
            1 if self.tp is None else self.tp.size)

    def _agree(self, tok: torch.Tensor) -> torch.Tensor:
        """The model group's first rank's tokens on every rank."""
        return tok if self.tp is None else self.tp.broadcast(tok)

    def _rows(self, batch: int) -> Optional[slice]:
        """This data group's contiguous block of a `batch`-row batch, or
        None where every group computes the whole batch (no data axis, or
        dp does not divide it)."""
        if self.dp is None or batch % self.dp.size:
            return None
        n = batch // self.dp.size
        return slice(self.dp.index * n, (self.dp.index + 1) * n)

    def _draw(self, batch: int):
        """The random draws' share of this data group (`_multinomial`):
        None where it computes the whole `batch`."""
        rows = self._rows(batch)
        return None if rows is None else (rows, batch)

    def _gather_rows(self, t: torch.Tensor, batch: int) -> torch.Tensor:
        """`t`, this group's rows of a `batch`-row result along dim 0, as
        the whole batch on every rank: the data groups' blocks in group
        order."""
        if self._rows(batch) is None:
            return t
        return self.dp.all_gather(t, dim=0)

    # -- pieces -------------------------------------------------------------

    def _splice(self, input_ids: torch.Tensor, images, seq_lens
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(spliced embeddings (B, S, D), spliced lengths (B,))."""
        width = input_ids.shape[1]
        mask = torch.arange(width, device=self.device)[None, :] \
            < seq_lens[:, None]
        spliced = prepare_multimodal_inputs(
            self.params, self.cfg, input_ids, images, attention_mask=mask,
            compute_dtype=self.compute_dtype,
            llama_params=self.llama_params,
            vision_packed=self._vision_packed)
        return spliced.inputs_embeds, spliced.seq_len

    def _new_cache(self, batch: int, cache_len: int) -> KVCache:
        return KVCache.create(self.cfg.llama, batch, cache_len,
                              dtype=self.cache_dtype, device=self.device,
                              heads=self.heads)

    def _prefill(self, input_ids: torch.Tensor, images, seq_lens, *,
                 batch: int, cache_len: int) -> Tuple[torch.Tensor, KVCache]:
        """Splice and prefill a bucketed batch into a new cache: the
        monolithic prefill, or `_chunked_prefill` with `prefill_chunk`."""
        if self.prefill_chunk:
            return self._chunked_prefill(input_ids, images, seq_lens,
                                         batch=batch, cache_len=cache_len)
        emb, spl_len = self._splice(input_ids, images, seq_lens)
        return llama_prefill(self.llama_params, self.cfg.llama,
                             self._new_cache(batch, cache_len),
                             inputs_embeds=emb, prompt_len=spl_len,
                             compute_dtype=self.compute_dtype, tp=self.tp)

    def _continue_embeds(self, cache: KVCache, embeds, suffix_len, start,
                         return_all_logits: bool = False):
        return llama_prefill_continue(
            self.llama_params, self.cfg.llama, cache, inputs_embeds=embeds,
            suffix_len=suffix_len, start=start,
            compute_dtype=self.compute_dtype,
            return_all_logits=return_all_logits, tp=self.tp)

    def _prefill_continue(self, cache: KVCache, suffix_ids: torch.Tensor,
                          suffix_len, start):
        """Prefill token ids (B, W) past `start` rows of `cache`."""
        embeds = self.llama_params["embed_tokens"][suffix_ids.clamp(min=0)
                                                   .long()]
        return self._continue_embeds(cache, embeds, suffix_len, start)

    def _chunked_prefill(self, input_ids, images, seq_lens, *, batch: int,
                         cache_len: int) -> Tuple[torch.Tensor, KVCache]:
        """Splice once, then run the decoder over `prefill_chunk`-wide
        slices of the spliced embeddings through the continuation prefill.
        Each row's logits come from the slice that holds its last valid
        row; a row whose prompt ended in an earlier slice writes nothing
        in the later ones."""
        emb, spl_len = self._splice(input_ids, images, seq_lens)
        w = self.prefill_chunk
        s = emb.shape[1]
        n_chunks = -(-s // w)
        emb = torch.nn.functional.pad(emb, (0, 0, 0, n_chunks * w - s))
        cache = self._new_cache(batch, cache_len)
        last_chunk = (spl_len.cpu().numpy() - 1).clip(min=0) // w
        per_chunk = {}
        for c in range(n_chunks):
            logits_c, cache = self._continue_embeds(
                cache, emb[:, c * w:(c + 1) * w],
                (spl_len - c * w).clamp(0, w), spl_len.clamp(max=c * w))
            if (last_chunk == c).any():
                per_chunk[c] = logits_c
        logits = torch.stack([per_chunk[int(c)][r]
                              for r, c in enumerate(last_chunk)])
        return logits, cache

    def _speculate(self, cache: KVCache, window_ids: torch.Tensor, valid,
                   start):
        """Verify a speculative window: its `valid` tokens (padded to the
        window's width) through the continuation prefill; the logits at
        every window position (B, W, V)."""
        embeds = self.llama_params["embed_tokens"][window_ids.clamp(min=0)
                                                   .long()]
        return self._continue_embeds(cache, embeds, valid, start,
                                     return_all_logits=True)

    def _decode_step(self, cache: KVCache, tokens: torch.Tensor):
        embeds = self.llama_params["embed_tokens"][tokens.long()][:, None]
        return llama_decode_step(self.llama_params, self.cfg.llama, cache,
                                 inputs_embeds=embeds,
                                 compute_dtype=self.compute_dtype, tp=self.tp)

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

    @staticmethod
    def _image_count(images) -> int:
        """Images a row: 0, 1 for (B, H, W, 3), K for (B, K, H, W, 3)."""
        return (0 if images is None
                else images.shape[1] if np.ndim(images) == 5 else 1)

    def _start(self, input_ids, seq_lens, images, gen_cfg, cache_len=None):
        """Bucket, clamp and pad a request, then prefill it. Returns
        (first-token logits, cache, clamped gen_cfg): the logits and the
        cache of this data group's rows (`_rows`). `cache_len` replaces the
        bucketed cache length (a session's first turn takes
        max_seq_len)."""
        batch, t = input_ids.shape
        k_img = self._image_count(images)
        n_img = k_img * self.cfg.pooler.num_query
        width, bucketed = self._bucketed(t, n_img, gen_cfg.max_new_tokens)
        cache_len = cache_len or bucketed
        seq_lens = np.minimum(np.asarray(seq_lens), width)
        gen_cfg = self._clamp_new_tokens(
            gen_cfg,
            int(seq_lens.max()) + k_img * (self.cfg.pooler.num_query - 1),
            cache_len)
        ids = self._pad_ids(np.asarray(input_ids), width,
                            gen_cfg.pad_token_id)
        rows = self._rows(batch)
        if rows is not None:  # this data group's block of the batch
            ids, seq_lens = ids[rows], seq_lens[rows]
            images = None if images is None else images[rows]
            batch = rows.stop - rows.start
        dev = self.device
        logits, cache = self._prefill(
            torch.as_tensor(ids, device=dev),
            None if images is None else torch.as_tensor(images, device=dev),
            torch.as_tensor(seq_lens, device=dev),
            batch=batch, cache_len=cache_len)
        return logits, cache, gen_cfg

    # -- public API ---------------------------------------------------------

    def warmup(
        self,
        *,
        batch_sizes: Sequence[int] = (1,),
        prompt_lens: Sequence[int] = (64, 256),
        max_new_tokens: Sequence[int] = (128,),
        with_image: bool = True,
        gen_cfg: Optional[GenerationConfig] = None,
    ) -> int:
        """Run `generate` once for each expected request shape at start-up,
        with the caller's `gen_cfg`, so the kernels' build and the
        allocations happen before the first user. Returns the number of
        (batch, width) prefills run."""
        gen_cfg = gen_cfg or GenerationConfig()
        n = 0
        img_hw = self.cfg.vit.image_size
        for b in batch_sizes:
            for t in prompt_lens:
                for mnt in max_new_tokens:
                    ids = np.full((b, min(t, 4)), 5, np.int32)
                    imgs = (np.zeros((b, img_hw, img_hw, 3), np.uint8)
                            if with_image else None)
                    if imgs is not None:
                        ids[:, 0] = IMAGE_TOKEN_INDEX
                    self.generate(
                        self._pad_ids(ids, t, 0),
                        np.full((b,), ids.shape[1], np.int32), images=imgs,
                        gen_cfg=dataclasses.replace(gen_cfg,
                                                    max_new_tokens=mnt))
                    n += 1
        return n

    def generate(
        self,
        input_ids: np.ndarray,  # (B, T) right-padded
        seq_lens: np.ndarray,  # (B,)
        images: Optional[np.ndarray] = None,  # (B, [K,] H, W, 3) uint8
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
        # a data group's rows draw what they draw in the whole batch
        draw = self._draw(input_ids.shape[0])
        tok = self._agree(_sample_token(logits, generator, gen_cfg, draw))
        toks = [tok]
        done = tok == gen_cfg.eos_token_id
        for _ in range(gen_cfg.max_new_tokens - 1):
            logits, cache = self._decode_step(cache, tok)
            nxt = self._agree(_sample_token(logits, generator, gen_cfg,
                                            draw))
            tok = torch.where(done, torch.full_like(nxt, gen_cfg.pad_token_id),
                              nxt)
            done = done | (tok == gen_cfg.eos_token_id)
            toks.append(tok)
        all_toks = self._gather_rows(torch.stack(toks, dim=1),
                                     input_ids.shape[0]).cpu().numpy()

        out: List[List[int]] = []
        for row in all_toks:
            ids = []
            for t in row.tolist():
                if t == gen_cfg.eos_token_id:
                    break
                ids.append(t)
            out.append(ids)
        return out

    @staticmethod
    def _image_fp(images) -> Optional[bytes]:
        if images is None:
            return None
        return hashlib.sha1(np.ascontiguousarray(images)).digest()

    def reset_session(self) -> None:
        """Drop the multi-turn state (a new chat, a new image)."""
        self._session = None

    def _session_match(self, raw: np.ndarray, fp) -> Optional[int]:
        """The common prefix (in tokens) of the new prompt and the ids the
        session cache holds, when a continuation applies: the same image,
        at least 8 tokens in common, at least one suffix token, and a
        suffix of text only (an image splice can only sit in the matched
        prefix). None otherwise."""
        st = self._session
        if st is None or st["image_fp"] != fp:
            return None
        old = st["raw_ids"]
        n = min(len(old), len(raw) - 1)
        if n <= 0:
            return None
        neq = np.nonzero(raw[:n] != old[:n])[0]
        common = int(neq[0]) if neq.size else n
        if common < 8 or np.any(raw[common:] < 0):
            return None
        return common

    def stream(
        self,
        input_ids: np.ndarray,  # (1, T)
        seq_len: int,
        images: Optional[np.ndarray] = None,
        gen_cfg: Optional[GenerationConfig] = None,
        generator: Optional[torch.Generator] = None,
        stop_fn: Optional[Callable[[List[int]], bool]] = None,
        session: bool = False,
        speculative: int = 0,  # prompt-lookup window (greedy only)
    ) -> Iterator[int]:
        """Single-sequence streaming: yields one token id per step.

        session=True keeps the KV cache across calls: the next turn's
        prompt is matched against the ids the cache holds (the last
        prompt and the answer's appended tokens) and only the new suffix
        is prefilled (`llama_prefill_continue`). speculative=N (greedy
        only) verifies up to N prompt-lookup tokens a step in one
        continuation prefill; the ids are plain greedy's in float32 (see
        the module docstring for bf16)."""
        gen_cfg = gen_cfg or GenerationConfig()
        if generator is None and gen_cfg.do_sample:
            generator = torch.Generator(self.device).manual_seed(0)
        dev = self.device
        nq = self.cfg.pooler.num_query
        raw = np.asarray(input_ids)[0, :int(seq_len)].astype(np.int32)
        fp = self._image_fp(images) if session else None
        common = self._session_match(raw, fp) if session else None
        if common is not None:
            # every image marker in the matched prefix expands by nq - 1
            start_spl = common + (nq - 1) * int((raw[:common] < 0).sum())
            if start_spl + self.prompt_bucket > self.max_seq_len:
                common = None  # the cache is about full: no room for a suffix

        if common is not None:
            st, self._session = self._session, None  # claim the cache
            sfx = raw[common:]
            width = min(-(-len(sfx) // self.prompt_bucket)
                        * self.prompt_bucket, self.max_seq_len - start_spl)
            need = -(-(start_spl + width + gen_cfg.max_new_tokens)
                     // self.cache_bucket) * self.cache_bucket
            cache_len = min(max(need, st["cache"].k.shape[3]),
                            self.max_seq_len)
            n_sfx = min(len(sfx), width)
            gen_cfg = self._clamp_new_tokens(gen_cfg, start_spl + n_sfx,
                                             cache_len)
            ids = self._pad_ids(sfx[None, :], width, gen_cfg.pad_token_id)
            logits, cache = self._prefill_continue(
                st["cache"].resized(cache_len),
                torch.as_tensor(ids, device=dev),
                torch.tensor([n_sfx], dtype=torch.int32, device=dev),
                torch.tensor([start_spl], dtype=torch.int32, device=dev))
            raw = raw[:common + n_sfx]
        else:
            if session:
                self._session = None  # a failed prefill leaves no session
            # a session's first turn is sized to the full context: a later
            # turn then never pays a whole-cache copy (resized)
            logits, cache, gen_cfg = self._start(
                input_ids, np.asarray([seq_len]), images, gen_cfg,
                cache_len=self.max_seq_len if session else None)
            width = self._bucketed(input_ids.shape[1],
                                   self._image_count(images) * nq, 0)[0]
            raw = raw[:width]

        emitted: List[int] = []
        # the cache and how many emitted tokens have their K/V rows in it
        state = {"cache": cache, "appended": 0}
        spec = int(speculative) if not gen_cfg.do_sample else 0
        try:
            if spec:
                yield from self._stream_speculative(
                    logits, raw, gen_cfg, stop_fn, spec, emitted, state)
                return
            for i in range(gen_cfg.max_new_tokens):
                tok_arr = self._agree(_sample_token(logits, generator,
                                                    gen_cfg))
                tok = int(tok_arr[0])
                if tok == gen_cfg.eos_token_id:
                    return
                emitted.append(tok)
                yield tok
                if stop_fn is not None and stop_fn(emitted):
                    return
                if i + 1 == gen_cfg.max_new_tokens:
                    return  # the final token's cache append would be wasted
                logits, state["cache"] = self._decode_step(state["cache"],
                                                           tok_arr)
                state["appended"] += 1
        finally:
            if session:
                self._session = {
                    "raw_ids": np.concatenate(
                        [raw, np.asarray(emitted[:state["appended"]],
                                         np.int32)]),
                    "image_fp": fp, "cache": state["cache"]}

    def _stream_speculative(self, logits, raw, gen_cfg, stop_fn, spec: int,
                            emitted: List[int], state) -> Iterator[int]:
        """The greedy speculative loop of `stream`: after each emitted
        token, propose up to `spec` tokens from the history; with a
        proposal (and room in the cache) verify [token] + proposal in one
        continuation prefill, keep the agreeing prefix and rewind
        `cache.length` to the rows of the token and the accepted
        proposals; otherwise take one decode step. The host keeps the
        history and the cache's length, and proposes on the CPU (no device
        sync). `state` holds the cache and the count of emitted tokens
        whose rows it holds."""
        # serve/speculative imports this module (the top-p warp)
        from .speculative import NGRAM, accept_window, propose_from_history

        dev = self.device
        history = np.zeros((1, len(raw) + gen_cfg.max_new_tokens), np.int32)
        history[0, :len(raw)] = raw
        n_hist = len(raw)
        length = int(state["cache"].length[0])
        cache_room = state["cache"].k.shape[3]
        tok = int(self._agree(logits[0].argmax()))
        while True:
            if tok == gen_cfg.eos_token_id:
                return
            emitted.append(tok)
            history[0, n_hist] = tok
            n_hist += 1
            yield tok
            if stop_fn is not None and stop_fn(emitted):
                return
            if len(emitted) >= gen_cfg.max_new_tokens:
                return
            prop, n_prop = propose_from_history(
                torch.from_numpy(history), torch.tensor([n_hist]),
                ngram=NGRAM, width=spec)
            n = min(int(n_prop[0]), gen_cfg.max_new_tokens - len(emitted) - 1,
                    cache_room - length - 1 - 1)
            if n > 0 and length + 1 + spec <= cache_room:
                ids_w = np.zeros((1, spec + 1), np.int32)
                ids_w[0, 0] = tok
                ids_w[0, 1:1 + n] = prop[0, :n].numpy()
                window = torch.as_tensor(ids_w, device=dev)
                n_dev = torch.tensor([n], dtype=torch.int32, device=dev)
                logits_all, cache = self._speculate(
                    state["cache"], window, n_dev + 1,
                    torch.tensor([length], dtype=torch.int32, device=dev))
                p, corr = accept_window(
                    window[:, 1:], n_dev,
                    logits_all.argmax(dim=-1).to(torch.int32))
                p, tok = self._agree(torch.cat([p, corr])).tolist()
                length += 1 + p
                # the rejected rows stay past the new length; the next
                # append overwrites them
                state["cache"] = dataclasses.replace(cache, length=torch.tensor(
                    [length], dtype=torch.int32, device=dev))
                state["appended"] += 1 + p
                for t in ids_w[0, 1:1 + p].tolist():
                    if t == gen_cfg.eos_token_id:
                        return
                    emitted.append(t)
                    history[0, n_hist] = t
                    n_hist += 1
                    yield t
                    if stop_fn is not None and stop_fn(emitted):
                        return
                    if len(emitted) >= gen_cfg.max_new_tokens:
                        return
            else:
                logits, state["cache"] = self._decode_step(
                    state["cache"],
                    torch.tensor([tok], dtype=torch.int32, device=dev))
                length += 1
                state["appended"] += 1
                tok = int(self._agree(logits[0].argmax()))
