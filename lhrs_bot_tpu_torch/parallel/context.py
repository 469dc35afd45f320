"""Context parallelism: the decoder's sequence split over a ring of ranks.

Counterpart of `lhrs_bot_tpu/parallel/context.py`. The ranks form a
("data", "seq") grid, rank = d * cp + c (the seq axis fastest, as JAX's
`reshape(dp, cp)` of its devices):

  "data" - each data index takes its own batch rows;
  "seq"  - the cp ranks of a data index hold the same rows, each its
           contiguous chunk of S / cp tokens: index c holds tokens
           [c * S_loc, (c + 1) * S_loc).

Every rank holds the whole weights (replicated, as JAX's P() in-spec) and
S / cp of the activations, so activation memory, the binding constraint
at long context, falls with the ring. Attention is exact through the K/V
ring (`ops.ring_attention`, `Axis.shift` between neighbours), and RoPE
takes global positions: `start + arange(S_loc)` with start = c * S_loc.

Gradients: a rank's loss is the negative log-likelihood of its chunk's
tokens over the valid-token count of the whole seq and data groups
(`context_parallel_loss`), so the ranks' losses sum to the global batch's
mean. The gradient of a replicated weight is then the sum over the seq
group (the transpose of JAX's P() in-spec, which shard_map supplies) and
over the data group of each rank's: `reduce_gradients` sums them, and the
train step (`train.trainer.make_train_step(cp_mesh=)`) calls it before the
optimizer.

Layout contract, as in JAX: right-padded batches, contiguous chunks; the
(B, S_loc) attention-mask chunk travels the ring with its K/V chunk. Not
composed with tensor parallelism or sequence packing (neither is in JAX).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..models.constants import IGNORE_INDEX
from .distribute import get_rank, get_world_size
from .mesh import DATA_AXIS, Axis

SEQ_AXIS = "seq"


class CpMesh:
    """A dp x cp grid of the world's ranks. `data` and `seq` are this
    rank's two `Axis`es; `dp_axis` is `data` where dp is above 1, else
    None. `reduce_seq` = False plants a fault for a check: the gradients
    are not summed over the seq group."""

    def __init__(self, dp: int, cp: int, rank: int, data: Axis, seq: Axis):
        self.dp, self.cp, self.rank = dp, cp, rank
        self.data, self.seq = data, seq
        self.reduce_seq = True

    @property
    def shape(self):
        return {DATA_AXIS: self.dp, SEQ_AXIS: self.cp}

    @property
    def dp_axis(self) -> Optional[Axis]:
        return self.data if self.dp > 1 else None

    @property
    def data_index(self) -> int:
        return self.data.index

    @property
    def seq_index(self) -> int:
        return self.seq.index

    def __repr__(self):  # pragma: no cover
        return f"CpMesh(dp={self.dp}, cp={self.cp}, rank={self.rank})"


def make_cp_mesh(cp: Optional[int] = None, dp: int = 1) -> CpMesh:
    """The ("data", "seq") mesh over the world's ranks (the process group
    `distribute.init_distributed` joined; a world of 1 without one). `cp`
    defaults to the world size over `dp`; dp * cp must equal the world
    size, else ValueError. Every rank must call it, in the same order as
    any other group it makes."""
    world, rank = get_world_size(), get_rank()
    dp = int(dp)
    cp = world // dp if cp is None else int(cp)
    if dp < 1 or cp < 1 or dp * cp != world:
        raise ValueError(f"dp ({dp}) x cp ({cp}) must equal the world size "
                         f"({world}): start dp * cp ranks (torchrun "
                         "--nproc-per-node)")
    d, c = divmod(rank, cp)
    seq_groups = [[i * cp + j for j in range(cp)] for i in range(dp)]
    data_groups = [[i * cp + j for i in range(dp)] for j in range(cp)]
    mine = {}
    # every rank makes every group, in one order (torch.distributed's rule)
    for name, groups in ((SEQ_AXIS, seq_groups), (DATA_AXIS, data_groups)):
        for ranks in groups:
            if len(ranks) > 1:
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[name] = g
    return CpMesh(dp, cp, rank,
                  data=Axis(DATA_AXIS, data_groups[c], d,
                            mine.get(DATA_AXIS)),
                  seq=Axis(SEQ_AXIS, seq_groups[d], c, mine.get(SEQ_AXIS)))


def seq_chunk(t: torch.Tensor, mesh: CpMesh, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous chunk of `t` along `dim` (the sequence),
    which must divide by the ring size (ValueError otherwise, JAX's
    message)."""
    s, cp = t.shape[dim], mesh.cp
    if s % cp:
        raise ValueError(f"sequence length {s} not divisible by the "
                         f"{SEQ_AXIS}-axis size {cp}")
    n = s // cp
    return t.narrow(dim, mesh.seq_index * n, n)


def seq_positions(mesh: CpMesh, b: int, s_loc: int,
                  device) -> torch.Tensor:
    """(B, S_loc) global RoPE positions of this rank's chunk: start +
    arange(S_loc), start = seq index * S_loc (not the cumsum-of-mask
    default; the two agree on a right-padded batch's valid rows)."""
    start = mesh.seq_index * s_loc
    return (start + torch.arange(s_loc, device=device)).expand(b, s_loc)


def context_parallel_apply(params, cfg, mesh: CpMesh, *,
                           input_ids: Optional[torch.Tensor] = None,
                           inputs_embeds: Optional[torch.Tensor] = None,
                           attention_mask: Optional[torch.Tensor] = None,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           remat: bool = False) -> torch.Tensor:
    """The sequence-split `llama_apply`: `input_ids` (B, S) or
    `inputs_embeds` (B, S, D) and `attention_mask` (B, S) of this data
    index, the same on every rank of the seq group; each rank takes its
    chunk and returns its float32 logits (B, S / cp, V). S must divide by
    the ring size. Weights enter whole; their gradients on a rank are its
    share, summed by `reduce_gradients`."""
    from ..models.llama import llama_apply

    if (input_ids is None) == (inputs_embeds is None):
        raise ValueError("exactly one of input_ids/inputs_embeds")
    x = inputs_embeds
    if x is None:
        x = params["embed_tokens"][input_ids.long()]
    x = seq_chunk(x, mesh)
    mask = (None if attention_mask is None
            else seq_chunk(attention_mask, mesh).to(torch.bool))
    b, s_loc = x.shape[:2]
    return llama_apply(params, cfg, inputs_embeds=x, attention_mask=mask,
                       positions=seq_positions(mesh, b, s_loc, x.device),
                       compute_dtype=compute_dtype, remat=remat,
                       cp_axis=mesh.seq)


def shifted_targets(labels: torch.Tensor) -> torch.Tensor:
    """The next-token targets of the whole sequence: labels[:, t + 1] at t,
    IGNORE_INDEX at the last position. Shifting before chunking gives the
    last row of a chunk the first label of the next one."""
    tail = torch.full_like(labels[:, :1], IGNORE_INDEX)
    return torch.cat([labels[:, 1:], tail], dim=1)


def context_parallel_loss(logits: torch.Tensor, labels: torch.Tensor,
                          mesh: CpMesh) -> torch.Tensor:
    """This rank's share of the global causal LM loss: `logits` its chunk
    (B, S / cp, V), `labels` the whole (B, S) of its data index. The
    negative log-likelihood of its chunk's valid targets over the valid
    count of the seq and data groups, so the sum over the ranks is JAX's
    `causal_lm_loss` of the whole batch; no logits are gathered."""
    from ..models.llama import token_lm_loss

    targets = seq_chunk(shifted_targets(labels), mesh)
    return token_lm_loss(logits, targets,
                         axes=[a for a in (mesh.seq, mesh.data)
                               if a.size > 1])


def reduce_gradients(grads: Sequence[torch.Tensor], mesh: CpMesh
                     ) -> List[torch.Tensor]:
    """The gradients of the replicated weights summed over the seq group
    (unless `mesh.reduce_seq` is off, a planted fault) and the data group,
    in float32 in one flat vector; returned in each gradient's dtype."""
    grads = list(grads)
    if not grads:
        return grads
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    if mesh.reduce_seq:
        mesh.seq.all_reduce(flat)
    mesh.data.all_reduce(flat)
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].view(g.shape).to(g.dtype))
        off += g.numel()
    return out
