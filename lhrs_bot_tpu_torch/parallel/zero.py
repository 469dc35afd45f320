"""ZeRO-2 optimizer-state sharding over the data axis.

Counterpart of `lhrs_bot_tpu/parallel/zero.py` and of the reference's
DeepSpeed ZeRO-2 partitioning (SURVEY.md §2.4 P2): the optimizer's slots
are not replicated on every data-parallel rank. As DeepSpeed does, the
trainable leaves this rank holds (its tensor-parallel slices) are laid end
to end in one flat float32 vector, which is cut into dp equal shards
(padded at the end); data index r owns shard r:

  * the step's gradients are summed over the data group (one all-reduce of
    the flat vector; DeepSpeed's reduce-scatter gives the owner the same
    sums), and each rank keeps its shard's;
  * each rank holds the slots and the accumulated gradients of its shard
    only, updates its shard of the parameters, and the data group's
    shards are all-gathered back into every rank's leaves, so the leaves
    stay the same, bit for bit, on every data rank;
  * slots of tensor-parallel leaves follow their leaf: they are slices of
    the slots of the whole leaf, as the leaf is a slice of it.

JAX shards each replicated leaf's moments along its first dimension that
dp divides (`_dp_shard_spec`); the flat cut gives every rank the same
share whatever the leaves' shapes. `FlatShard` is the bookkeeping: where
each leaf lies in the flat vector, and which pieces of which leaves make
up this rank's shard (`segments`: the update runs over them leaf by leaf,
so each piece keeps its leaf's weight-decay rule).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .mesh import Axis


class FlatShard:
    """The flat layout of leaves of `numels` elements and the shard of
    data index `index` of `size`: [lo, hi) of the flat vector, padded to
    size * per elements."""

    def __init__(self, numels: Sequence[int], size: int, index: int):
        self.numels = list(numels)
        self.starts = [0]
        for n in self.numels:
            self.starts.append(self.starts[-1] + n)
        self.total = self.starts[-1]
        self.size, self.index = size, index
        self.per = -(-self.total // size)
        self.lo = min(index * self.per, self.total)
        self.hi = min(self.lo + self.per, self.total)

    @property
    def segments(self) -> List[Tuple[int, int, int]]:
        """(leaf, start, end) offsets inside each leaf that this shard
        covers, in flat order."""
        out = []
        for i, n in enumerate(self.numels):
            a = max(self.lo, self.starts[i])
            b = min(self.hi, self.starts[i] + n)
            if a < b:
                out.append((i, a - self.starts[i], b - self.starts[i]))
        return out

    def flatten(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The leaves end to end, float32, padded to size * per."""
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        pad = self.size * self.per - self.total
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def pieces(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This shard's pieces of the leaves (views into them)."""
        return [tensors[i].detach().reshape(-1)[a:b]
                for i, a, b in self.segments]

    def gather(self, pieces: Sequence[torch.Tensor], axis: Optional[Axis],
               device) -> torch.Tensor:
        """The whole flat vector from every rank's pieces of its shard
        (all-gathered over the data axis), without the padding."""
        mine = torch.zeros(self.per, dtype=torch.float32, device=device)
        if pieces:
            joined = torch.cat([p.float() for p in pieces])
            mine[:joined.numel()] = joined
        flat = mine if axis is None else axis.all_gather(mine, dim=0)
        return flat[:self.total]

    def unflatten(self, flat: torch.Tensor,
                  like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The flat vector cut into tensors shaped as `like`'s."""
        return [flat[s:s + n].reshape(t.shape)
                for s, n, t in zip(self.starts, self.numels, like)]
