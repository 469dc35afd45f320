"""The port's mesh and partition layer (lhrs_bot_tpu_torch.parallel) in one
process: the mesh's shape rules, `init_distributed`'s backend choice, the
spec tables against the JAX package's, each rank's slice of quantized
weights (int8, interleaved and halves-packed int4, NF4 with double
quantization, an int8 lm_head) against the logical slice of the
single-rank tree, exactly, and the ZeRO flat shard's bookkeeping. The
multi-process runs are in tests/test_torch_parallel_{serve,train}.py."""

import numpy as np
import pytest
import torch

from lhrs_bot_tpu.parallel import partition as j_partition
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.parallel import distribute, partition, zero
from lhrs_bot_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Axis,
                                              make_mesh)


def _axis(tp, i):
    return Axis(MODEL_AXIS, list(range(tp)), i)


def test_single_process_mesh_and_sizes():
    """A world of one: the (1, 1) mesh; any other product raises, as
    JAX's make_mesh refuses more devices than it has."""
    mesh = make_mesh()
    assert (mesh.dp, mesh.tp, mesh.shape) == (1, 1, {DATA_AXIS: 1,
                                                     MODEL_AXIS: 1})
    assert mesh.tp_axis is None and mesh.dp_axis is None
    assert make_mesh(dp=1, tp=1).data.all_reduce(torch.ones(2)).sum() == 2
    for dp, tp in ((2, 1), (1, 2), (2, 2)):
        with pytest.raises(ValueError, match="world size"):
            make_mesh(dp=dp, tp=tp)


def test_init_distributed_backend_is_the_callers(monkeypatch):
    """NCCL with fewer cards than local ranks raises and names the flag;
    an unknown backend raises; nothing switches to gloo on its own."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    joined = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: joined.append(kw))
    with pytest.raises(RuntimeError, match="--dist-backend gloo"):
        distribute.init_distributed("nccl")
    with pytest.raises(ValueError, match="--dist-backend"):
        distribute.init_distributed("mpi")
    assert joined == []
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: joined.append(i))
    distribute.init_distributed("gloo")  # both ranks share card 0
    assert joined[0] == 0 and joined[1]["backend"] == "gloo"


def _spec(p):
    return tuple(p)


def test_spec_tables_match_jax():
    """The decoder's column / row split and the LoRA factors' follow
    JAX's tables; the vision side is replicated; embed_tokens stays whole
    (JAX splits its hidden axis: the same rows either way)."""
    for k, v in j_partition._LLAMA_LAYER_SPECS.items():
        assert partition._LLAMA_LAYER_SPECS[k] == _spec(v), k
    for k, ab in j_partition._LORA_SPECS.items():
        assert {n: partition._LORA_SPECS[k][n] for n in ab} == {
            n: _spec(s) for n, s in ab.items()}, k
    llama = {"layers": {k: None for k in partition._LLAMA_LAYER_SPECS}}
    specs = partition.llama_param_specs(llama)
    assert specs["lm_head"] == (None, MODEL_AXIS)
    assert specs["embed_tokens"] == partition.REPLICATED
    cache = partition.kv_cache_spec(quantized=True)
    assert cache.k[2] == MODEL_AXIS and cache.k_scale[2] == MODEL_AXIS
    assert partition.batch_specs({"input_ids": 0}) == {
        "input_ids": (DATA_AXIS,)}


def _weight(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g) * 0.02


QUANTIZERS = {
    "int8": lambda w: t_quant.quantize_int8(w, axis=1),
    "int4": lambda w: t_quant.quantize_int4(w, axis=1),
    "4h": lambda w: t_quant.quantize_int4h(w, axis=1),
    "nf4": lambda w: t_quant.quantize_nf4(w, axis=1, double_quant=True),
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", list(QUANTIZERS))
@pytest.mark.parametrize("dim", [-1, -2], ids=["column", "row"])
def test_quantized_slices_are_the_logical_slice(kind, dim, tp):
    """Quantize once at full size, then slice: each rank's codes (by
    logical row / column) and scales equal the single-rank tree's slice
    exactly, its dequantized weight equals the slice of the whole
    dequantized weight (NF4's double-quantized absmax included), and the
    pieces join back to the whole weight byte for byte."""
    full = QUANTIZERS[kind](_weight((2, 512, 96), 3))
    codes = partition._logical_codes(full)
    deq = t_quant.dequantize(full)
    pieces = []
    for i in range(tp):
        got = partition.shard_quantized(full, dim, _axis(tp, i))
        pieces.append(got)
        n = codes.shape[dim] // tp
        sl = [slice(None)] * 3
        sl[dim] = slice(i * n, (i + 1) * n)
        assert torch.equal(partition._logical_codes(got), codes[tuple(sl)])
        assert torch.equal(t_quant.dequantize(got), deq[tuple(sl)])
        if dim == -1 or kind == "nf4":
            ss = [slice(None)] * 3
            m = full.scale.shape[dim] // tp
            ss[dim] = slice(i * m, (i + 1) * m)
            assert torch.equal(got.scale, full.scale[tuple(ss)])
        else:
            assert torch.equal(got.scale, full.scale)
    back = partition.unshard_quantized(pieces, dim)
    assert torch.equal(back.q, full.q) and torch.equal(back.scale, full.scale)


def test_int8_lm_head_slices_the_vocabulary():
    head = t_quant.quantize_int8(_weight((64, 256), 4), axis=0)
    for i in range(2):
        got = partition.shard_leaf(head, (None, MODEL_AXIS), _axis(2, i))
        assert torch.equal(got.q, head.q[:, i * 128:(i + 1) * 128])
        assert torch.equal(got.scale, head.scale[:, i * 128:(i + 1) * 128])


def test_packed_axis_slice_is_not_the_logical_slice():
    """JAX's spec on the packed K/2 axis of a halves-packed weight gives
    rank 0 rows [0, K/4) and [K/2, 3K/4): not its logical rows."""
    full = QUANTIZERS["4h"](_weight((1, 128, 32), 5))
    codes = partition._logical_codes(full)
    wrong = t_quant.QuantizedTensor(full.q[:, :32].contiguous(), full.scale,
                                    "4h")
    right = partition.shard_quantized(full, -2, _axis(2, 0))
    assert torch.equal(partition._logical_codes(right), codes[:, :64])
    assert not torch.equal(partition._logical_codes(wrong), codes[:, :64])
    assert torch.equal(partition._logical_codes(wrong),
                       torch.cat([codes[:, :32], codes[:, 64:96]], 1))


def test_nf4_row_split_that_cuts_a_block_raises():
    full = QUANTIZERS["nf4"](_weight((1, 192, 32), 6))  # 3 blocks of 64
    with pytest.raises(ValueError, match="absmax"):
        partition.shard_quantized(full, -2, _axis(2, 0))
    with pytest.raises(ValueError, match="equal parts"):
        partition.shard_tensor(torch.zeros(3, 5), 1, _axis(2, 0))


@pytest.mark.parametrize("dp", [1, 2, 3, 8])
def test_flat_shard_covers_every_element_once(dp):
    numels = [7, 1, 12, 5]
    seen = np.zeros(sum(numels), int)
    leaves = [torch.arange(n, dtype=torch.float32) + 100 * i
              for i, n in enumerate(numels)]
    flat = torch.cat(leaves)
    for r in range(dp):
        fs = zero.FlatShard(numels, dp, r)
        pieces = fs.pieces(leaves)
        for (i, a, b), p in zip(fs.segments, pieces):
            seen[fs.starts[i] + a:fs.starts[i] + b] += 1
            assert torch.equal(p, leaves[i][a:b])
        assert fs.flatten(leaves).numel() == dp * fs.per
        got = fs.gather(pieces, None, "cpu")
        assert torch.equal(got[:fs.hi - fs.lo], flat[fs.lo:fs.hi])
    assert (seen == 1).all()
    parts = zero.FlatShard(numels, dp, 0).unflatten(flat, leaves)
    assert all(torch.equal(a, b) for a, b in zip(parts, leaves))
