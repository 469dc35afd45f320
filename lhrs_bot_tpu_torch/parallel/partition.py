"""Which axis of each parameter splits over the mesh, and each rank's slice.

Counterpart of `lhrs_bot_tpu/parallel/partition.py`, with its spec tables:
a spec is a tuple with one entry a dimension, MODEL_AXIS where the model
group splits that dimension, DATA_AXIS where the data group does, None
elsewhere (JAX's PartitionSpec). The decoder is Megatron tensor parallel:
q/k/v and gate/up split their output columns ("column"), o and down their
input rows ("row"), so a block needs one all-reduce a sub-layer
(`models.llama._proj`). The vision tower and the perceiver are replicated.
Unlike JAX's table, `embed_tokens` stays whole on every rank (JAX splits
its hidden axis; a lookup of a whole row gives the same numbers), and the
lm_head splits its vocabulary, as JAX's does, its shards gathered before
the loss or the sampler.

Where JAX places a host tree on the devices (`device_put`), the port
slices it: `shard_params` and `shard_llama_for_serving` return this rank's
slice of a host (numpy or torch) tree, and `gather_params` the whole tree
back from the slices (a checkpoint keeps the single-rank layout).

Quantized leaves are quantized once at full size and then sliced by their
logical rows and columns, never by their storage axis, so each rank's
codes and scales are exactly the slice of the single-rank tree:
  * a column split slices the output axis of the codes and of the scales
    (int8 (L, 1, N), NF4 absmax (L, K/64, N), an int8 lm_head's (1, V));
  * a row split of int8 codes slices their rows; of packed int4 codes it
    unpacks them, takes rows [i K/tp, (i + 1) K/tp) and packs them again:
    a halves-packed ("4h") byte row r holds weight rows r and K/2 + r, so
    JAX's spec on the packed K/2 axis would give rank 0 two non-contiguous
    row ranges; here each rank's bytes are the halves of its own K/tp rows
    (the local K/2 = K/(2 tp));
  * an NF4 row split takes whole 64-row absmax blocks (ValueError where
    K/tp cuts one); the double-quantized absmax is sliced as stored, so it
    dequantizes to the single-rank values.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.quant import (NF4_BLOCK, QuantizedTensor, pack_int4,
                         pack_int4_halves, unpack_int4, unpack_int4_halves,
                         unpack_uint4)
from .mesh import DATA_AXIS, MODEL_AXIS, Axis, Mesh

Spec = Tuple[Optional[str], ...]
REPLICATED: Spec = ()

# Stacked llama layer tensors are (L, d_in, d_out) / (L, d)
_LLAMA_LAYER_SPECS: Dict[str, Spec] = {
    "input_norm": REPLICATED,
    "wq": (None, None, MODEL_AXIS),  # column: heads split
    "wk": (None, None, MODEL_AXIS),
    "wv": (None, None, MODEL_AXIS),
    "wo": (None, MODEL_AXIS, None),  # row
    "post_attn_norm": REPLICATED,
    "w_gate": (None, None, MODEL_AXIS),  # column: ffn split
    "w_up": (None, None, MODEL_AXIS),
    "w_down": (None, MODEL_AXIS, None),  # row
}

# LoRA A/B split so that A @ B has the base weight's split
_LORA_SPECS: Dict[str, Dict[str, Spec]] = {
    "wq": {"a": REPLICATED, "b": (None, None, MODEL_AXIS)},
    "wk": {"a": REPLICATED, "b": (None, None, MODEL_AXIS)},
    "wv": {"a": REPLICATED, "b": (None, None, MODEL_AXIS)},
    "wo": {"a": (None, MODEL_AXIS, None), "b": REPLICATED},
    "w_gate": {"a": REPLICATED, "b": (None, None, MODEL_AXIS)},
    "w_up": {"a": REPLICATED, "b": (None, None, MODEL_AXIS)},
    "w_down": {"a": (None, MODEL_AXIS, None), "b": REPLICATED},
}

# the projections whose input rows split (the others: output columns)
ROW_PARALLEL = ("wo", "w_down")


def split_axis(spec: Spec) -> Optional[int]:
    """The dimension the model group splits, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def llama_param_specs(params_llama) -> Any:
    """Spec tree matching init_llama_params' structure."""
    return {
        "embed_tokens": REPLICATED,  # whole rows: a lookup needs no gather
        "layers": {k: _LLAMA_LAYER_SPECS.get(k, REPLICATED)
                   for k in params_llama["layers"]},
        "final_norm": REPLICATED,
        "lm_head": (None, MODEL_AXIS),  # vocab split
    }


def _replicate(tree):
    if isinstance(tree, dict):
        return {k: _replicate(v) for k, v in tree.items()}
    return REPLICATED


def vlm_param_specs(params) -> Any:
    """Full VLM spec tree: decoder tensor parallel, vision replicated."""
    specs = {"vit": _replicate(params["vit"]),
             "pooler": _replicate(params["pooler"]),
             "llama": llama_param_specs(params["llama"])}
    if "lora" in params:
        specs["lora"] = {name: dict(_LORA_SPECS[name])
                         for name in params["lora"]}
    return specs


def batch_specs(batch: Dict[str, Any]) -> Any:
    """Every batch tensor splits its leading (batch) axis over the data
    group: each data index draws its own batch (`data.build_loader`'s
    rank and world size are the data index and dp)."""
    return {k: (DATA_AXIS,) for k in batch}


def kv_cache_spec(quantized: bool = False) -> Any:
    """KVCache(k, v, length): (L, B, H, S, D), heads on the model axis
    (each rank's cache holds H / tp heads, `KVCache.create(heads=)`); the
    int8 scale planes (L, B, H, S) split like K/V."""
    from ..models.llama import KVCache

    plane = (None, DATA_AXIS, MODEL_AXIS, None, None)
    splane = (None, DATA_AXIS, MODEL_AXIS, None)
    return KVCache(k=plane, v=plane, length=(DATA_AXIS,),
                   k_scale=splane if quantized else None,
                   v_scale=splane if quantized else None)


def llama_serving_specs(llama_params) -> Any:
    """Spec tree of a serving decoder (possibly quantized): a
    QuantizedTensor leaf takes the spec of the weight it stands for (its
    codes and scales are sliced by `shard_quantized`)."""
    return {"embed_tokens": REPLICATED, "final_norm": REPLICATED,
            "lm_head": (None, MODEL_AXIS),
            "layers": {k: _LLAMA_LAYER_SPECS.get(k, REPLICATED)
                       for k in llama_params["layers"]}}


# ---------------------------------------------------------------------------
# Slicing
# ---------------------------------------------------------------------------


def _bounds(n: int, parts: int, index: int, what: str) -> Tuple[int, int]:
    if n % parts:
        raise ValueError(f"{what}: {n} does not split into {parts} equal "
                         "parts")
    step = n // parts
    return index * step, (index + 1) * step


def shard_tensor(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    """This rank's contiguous slice of `t` along `dim` (a new tensor)."""
    lo, hi = _bounds(t.shape[dim], axis.size, axis.index,
                     f"dimension {dim} of {tuple(t.shape)}")
    return t.narrow(dim, lo, hi - lo).contiguous()


def _logical_codes(qt: QuantizedTensor) -> torch.Tensor:
    """The (..., K, N) codes of a packed weight, one a logical row."""
    if qt.bits == 4:
        return unpack_int4(qt.q)
    if qt.bits == "4h":
        return unpack_int4_halves(qt.q)
    if qt.bits == "nf4":
        return unpack_uint4(qt.q)
    return qt.q


def _pack(codes: torch.Tensor, bits) -> torch.Tensor:
    if bits == "4h":
        return pack_int4_halves(codes)
    if bits in (4, "nf4"):
        return pack_int4(codes)
    return codes.contiguous()


def shard_quantized(qt: QuantizedTensor, dim: int, axis: Axis
                    ) -> QuantizedTensor:
    """This rank's slice of a quantized weight along its logical `dim`
    (the output axis: -1; the input rows: -2), as the module docstring
    sets out. ValueError where an NF4 row split cuts an absmax block."""
    nd = qt.q.dim()
    dim = dim % nd
    if dim == nd - 1:  # output columns: codes and scales alike
        return QuantizedTensor(shard_tensor(qt.q, dim, axis),
                               shard_tensor(qt.scale, dim, axis), qt.bits)
    if dim != nd - 2:
        raise ValueError(f"a quantized weight splits along its rows or "
                         f"columns, not dimension {dim}")
    codes = _logical_codes(qt)
    k = codes.shape[-2]
    lo, hi = _bounds(k, axis.size, axis.index, f"rows of {tuple(codes.shape)}")
    if qt.bits == "nf4":
        if lo % NF4_BLOCK or hi % NF4_BLOCK:
            raise ValueError(
                f"an NF4 row split must keep whole {NF4_BLOCK}-row absmax "
                f"blocks: K = {k} over {axis.size} ranks gives {hi - lo} "
                f"rows a rank")
        scale = qt.scale.narrow(-2, lo // NF4_BLOCK,
                                (hi - lo) // NF4_BLOCK).contiguous()
    else:  # per-output-column scales: every rank's rows share them
        scale = qt.scale.clone()
    local = codes.narrow(-2, lo, hi - lo)
    if qt.bits in (4, "4h", "nf4") and (hi - lo) % 2:
        raise ValueError(f"{hi - lo} rows a rank do not pack two a byte")
    return QuantizedTensor(_pack(local, qt.bits), scale, qt.bits)


def unshard_quantized(pieces, dim: int) -> QuantizedTensor:
    """The inverse of `shard_quantized`: the weight whose slices along
    `dim` are `pieces`, in rank order."""
    bits = pieces[0].bits
    nd = pieces[0].q.dim()
    dim = dim % nd
    if dim == nd - 1:
        return QuantizedTensor(torch.cat([p.q for p in pieces], dim),
                               torch.cat([p.scale for p in pieces], dim),
                               bits)
    codes = torch.cat([_logical_codes(p) for p in pieces], dim)
    scale = (torch.cat([p.scale for p in pieces], dim) if bits == "nf4"
             else pieces[0].scale)
    return QuantizedTensor(_pack(codes, bits), scale, bits)


def _as_tensor(leaf):
    if isinstance(leaf, (QuantizedTensor, torch.Tensor)):
        return leaf
    if isinstance(leaf, dict):  # a checkpoint's quantized leaf
        return QuantizedTensor(torch.as_tensor(np.asarray(leaf["q"])),
                               torch.as_tensor(np.asarray(leaf["scale"])),
                               leaf["bits"])
    if hasattr(leaf, "q") and hasattr(leaf, "bits"):
        return QuantizedTensor(torch.as_tensor(np.asarray(leaf.q)),
                               torch.as_tensor(np.asarray(leaf.scale)),
                               leaf.bits)
    return torch.as_tensor(np.asarray(leaf))


def shard_leaf(leaf, spec: Spec, axis: Optional[Axis]):
    """This rank's slice of one leaf (a tensor, numpy array or quantized
    weight) under `spec`; the leaf itself where nothing splits it."""
    dim = split_axis(spec)
    if dim is None or axis is None or axis.size == 1:
        return leaf
    leaf = _as_tensor(leaf)
    if isinstance(leaf, QuantizedTensor):
        return shard_quantized(leaf, dim - len(spec), axis)
    return shard_tensor(leaf, dim, axis)


def _map_specs(fn: Callable, tree, specs, path=()):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k], path + (k,))
                for k, v in tree.items()}
    return fn(tree, specs, path)


def spec_of(specs, path) -> Spec:
    node = specs
    for k in path:
        node = node[k]
    return node


def shard_params(mesh: Mesh, params) -> Any:
    """This rank's slice of a VLM parameter tree under `vlm_param_specs`.
    A trainable leaf (requires_grad) gives a new trainable leaf; a frozen
    float leaf keeps the leaf it was loaded from
    (`core.convert.source_of`), so a checkpoint writes the whole leaf."""
    from ..core.convert import _remember_source, source_of

    axis = mesh.tp_axis

    def one(leaf, spec, path):
        out = shard_leaf(leaf, spec, axis)
        if out is leaf or not isinstance(leaf, torch.Tensor):
            return out
        if leaf.requires_grad:
            return out.detach().requires_grad_(True)
        src = source_of(leaf)
        _remember_source(out, src)
        return out

    return _map_specs(one, params, vlm_param_specs(params))


def shard_llama_for_serving(mesh: Mesh, llama_params) -> Any:
    """This rank's slice of a (possibly quantized) serving decoder."""
    axis = mesh.tp_axis
    return _map_specs(lambda leaf, spec, path: shard_leaf(leaf, spec, axis),
                      llama_params, llama_serving_specs(llama_params))


def gather_leaf(leaf, spec: Spec, axis: Optional[Axis]):
    """The whole leaf from this rank's slice: an all-gather over the
    model group along the split dimension (a quantized weight's pieces
    joined by `unshard_quantized`). Every rank of the group must call it."""
    dim = split_axis(spec)
    if dim is None or axis is None or axis.size == 1:
        return leaf
    if isinstance(leaf, QuantizedTensor):
        pieces_q = _gather_list(leaf.q, axis)
        pieces_s = _gather_list(leaf.scale, axis)
        return unshard_quantized(
            [QuantizedTensor(q, s, leaf.bits)
             for q, s in zip(pieces_q, pieces_s)], dim - len(spec))
    t = leaf.detach()
    if not t.is_floating_point():
        return torch.cat(_gather_list(t, axis), dim)
    return axis.all_gather(t.float(), dim).to(t.dtype)


def _gather_list(t: torch.Tensor, axis: Axis):
    """Every rank's `t` (same shape), in axis order; integer tensors go
    through float32, which holds int8 codes exactly."""
    full = axis.all_gather(t.float()[None], dim=0)
    return [p.to(t.dtype) for p in full]


def gather_params(mesh: Mesh, params) -> Any:
    """The single-rank tree from this rank's slice (`shard_params`'s
    inverse): frozen leaves that remember their loaded source give it,
    the others are gathered over the model group."""
    from ..core.convert import source_of

    axis = mesh.tp_axis

    def one(leaf, spec, path):
        if split_axis(spec) is None or axis is None:
            return leaf
        src = source_of(leaf)
        if src is not leaf:
            return src
        return gather_leaf(leaf, spec, axis)

    return _map_specs(one, params, vlm_param_specs(params))
