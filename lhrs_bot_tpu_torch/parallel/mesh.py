"""The ("data", "model") mesh over torch.distributed process groups.

Counterpart of `lhrs_bot_tpu/parallel/mesh.py`. One process a rank (as
torchrun starts them); the ranks form a dp x tp grid, rank = d * tp + m
(the model axis fastest, as JAX's `reshape(dp, tp)` of its devices):

  "data"  - data parallel: each data index takes its own batch; gradients
            are summed over the data group (the loss is normalized by the
            global token count, `models.llama.causal_lm_loss`), and the
            optimizer's slots are sharded over it (`parallel.zero`);
  "model" - tensor parallel (Megatron): the decoder's attention heads and
            MLP width split over the model group (`parallel.partition`).

`Axis` is one axis as a rank sees it: the process group of the ranks that
share its other coordinate, with the collectives the port runs over it.
The autograd functions give the tensor-parallel layers their backward:
`copy_to_model` (identity forward, all-reduce backward) opens a
column-parallel product, `reduce_from_model` (all-reduce forward, identity
backward) closes a row-parallel one, and `gather_from_model` assembles the
lm_head's vocabulary shards (all-gather forward, the rank's slice of the
gradient backward). Each reduces in float32 whatever the dtype it is
given, and gives back that dtype.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .distribute import get_rank, get_world_size
from .distribute import is_main_process as _is_main

DATA_AXIS = "data"
MODEL_AXIS = "model"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Axis:
    """One axis of the mesh from this rank: `ranks` (global, in axis
    order) share this rank's other coordinate; `index` is this rank's
    place among them. Collectives on an axis of size 1 return their input
    (no process group is made for it)."""

    def __init__(self, name: str, ranks: List[int], index: int, group=None):
        self.name = name
        self.ranks = list(ranks)
        self.index = index
        self.size = len(ranks)
        self.group = group

    @property
    def src(self) -> int:
        """The global rank of index 0, which decides what is broadcast."""
        return self.ranks[0]

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced in place over the axis (op "sum" or "max")."""
        if self.size > 1:
            dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The axis's tensors concatenated along `dim`, in axis order."""
        if self.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Index 0's `t` on every rank of the axis, in place."""
        if self.size > 1:
            dist.broadcast(t, src=self.src, group=self.group)
        return t

    def broadcast_object(self, obj=None):
        """Index 0's picklable `obj` on every rank of the axis."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]

    def shift(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """JAX's `ppermute` with perm [(i, (i + 1) % n)]: this rank sends
        each of `tensors` to the next index of the axis and returns the
        previous index's, in the same order, shapes and dtypes. Every rank
        posts its sends and receives together (one `batch_isend_irecv`), so
        the ring cannot deadlock. Over gloo the tensors are staged through
        host memory (gloo's point-to-point calls take host buffers) and the
        received ones moved back to each tensor's device; over NCCL they
        stay on the card."""
        if self.size == 1:
            return list(tensors)
        dst = self.ranks[(self.index + 1) % self.size]
        src = self.ranks[(self.index - 1) % self.size]
        staged = dist.get_backend(self.group) == "gloo"
        sends = [t.detach().contiguous() for t in tensors]
        if staged:
            sends = [t.cpu() for t in sends]
        recvs = [torch.empty_like(t) for t in sends]
        ops = []
        for tag, (s, r) in enumerate(zip(sends, recvs)):
            ops.append(dist.P2POp(dist.isend, s, dst, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, r, src, self.group, tag))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(t.device) for r, t in zip(recvs, tensors)]

    def with_timeout(self, timeout) -> "Axis":
        """The same ranks over a gloo group of their own whose collectives
        wait up to `timeout` (a datetime.timedelta): for a rank that idles
        until another calls, while the axis's own group keeps its shorter
        wait. Every rank of the world calls it, in the same order as any
        other group it makes."""
        group = (dist.new_group(self.ranks, timeout=timeout, backend="gloo")
                 if self.size > 1 else None)
        return Axis(self.name, self.ranks, self.index, group)

    def __repr__(self):  # pragma: no cover
        return f"Axis({self.name!r}, ranks={self.ranks}, index={self.index})"


class Mesh:
    """A dp x tp grid of the world's ranks. `data` and `model` are this
    rank's two `Axis`es; `tp_axis` / `dp_axis` are them where their size
    is above 1, else None (the models take None as "not split")."""

    def __init__(self, dp: int, tp: int, rank: int, data: Axis, model: Axis):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.data, self.model = data, model

    @property
    def shape(self):
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}

    @property
    def tp_axis(self) -> Optional[Axis]:
        return self.model if self.tp > 1 else None

    @property
    def dp_axis(self) -> Optional[Axis]:
        return self.data if self.dp > 1 else None

    @property
    def world(self) -> Axis:
        """Every rank of the mesh as one axis over the default process
        group, in rank order (a server's lockstep channel across both
        axes)."""
        return Axis("world", list(range(self.dp * self.tp)), self.rank)

    @property
    def data_index(self) -> int:
        return self.data.index

    @property
    def model_index(self) -> int:
        return self.model.index

    def __repr__(self):  # pragma: no cover
        return f"Mesh(dp={self.dp}, tp={self.tp}, rank={self.rank})"


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None) -> Mesh:
    """The ("data", "model") mesh over the world's ranks (the process
    group `distribute.init_distributed` joined; a world of 1 without one).
    Defaults as JAX's: all ranks on the model axis when neither is given,
    the other axis taking the rest when one is. dp * tp must equal the
    world size, else ValueError. Every rank must call it, in the same
    order as any other group it makes."""
    world, rank = get_world_size(), get_rank()
    if dp is None and tp is None:
        dp, tp = 1, world
    elif dp is None:
        dp = world // tp
    elif tp is None:
        tp = world // dp
    dp, tp = int(dp), int(tp)
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"dp ({dp}) x tp ({tp}) must equal the world size "
                         f"({world}): start dp * tp ranks (torchrun "
                         "--nproc-per-node)")
    d, m = divmod(rank, tp)
    model_groups = [[i * tp + j for j in range(tp)] for i in range(dp)]
    data_groups = [[i * tp + j for i in range(dp)] for j in range(tp)]
    mine = {}
    # every rank makes every group, in one order (torch.distributed's rule)
    for name, groups in (("model", model_groups), ("data", data_groups)):
        for ranks in groups:
            if len(ranks) > 1:
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[name] = g
    return Mesh(dp, tp, rank,
                data=Axis(DATA_AXIS, data_groups[m], d, mine.get("data")),
                model=Axis(MODEL_AXIS, model_groups[d], m,
                           mine.get("model")))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    dp = mesh.dp
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"dp={dp}")
    return global_batch // dp


def process_index() -> int:
    return get_rank()


def process_count() -> int:
    return get_world_size()


def is_main_process() -> bool:
    return _is_main()


# ---------------------------------------------------------------------------
# Tensor-parallel autograd functions
# ---------------------------------------------------------------------------


def _reduced(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of `t` over the axis, reduced in float32, in t's dtype."""
    buf = t.float().clone() if t.dtype == torch.float32 else t.float()
    return axis.all_reduce(buf).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _reduced(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        return axis.all_gather(x.float(), dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def copy_to_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The input of a column-parallel product: x forward, the sum of the
    model group's gradients backward."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The output of a row-parallel product: the sum of the model group's
    partial products forward (in float32, then x's dtype), the gradient
    as it is backward."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The model group's last-axis shards concatenated in order forward;
    this rank's slice of the gradient backward (the loss above is the
    same on every rank of the group)."""
    return x if axis is None else _GatherFromModel.apply(x, axis)
