"""Ring attention: exact attention over a sequence split across ranks.

Counterpart of `lhrs_bot_tpu/ops/ring_attention.py`. Each rank of a
sequence axis (`parallel.mesh.Axis`, the "seq" axis of
`parallel.context.make_cp_mesh`) holds one contiguous chunk of the
sequence: index i holds rows [i * S_loc, (i + 1) * S_loc). Q stays on its
rank; the K/V chunks travel the ring (`Axis.shift`, rank i to rank i + 1),
n steps for a ring of n, and the softmax is accumulated over the blocks as
flash attention accumulates it over tiles. The causal mask uses global row
and column ids, and a (B, S_loc) `kv_mask` chunk travels with its K/V
chunk, so a right-padded batch gives the attention of the whole sequence.
At step t a rank holds the chunk of owner (i - t) mod n.

CPU tensors (and `plain=True`) run the JAX math step by step: float32
scores per block, the (o, m, l) merge. CUDA tensors run one launch of the
flash forward (K1, `ops.attention.flash_attention_fwd`) a block with its
float32 log-sum-exp: causal for the rank's own block, not causal for an
earlier owner's, and no launch for a later owner's, which the causal mask
hides whole (JAX computes it and masks it; the result is the same), so
under `causal` rank i launches i + 1 blocks. The blocks' bf16 outputs are
merged by their log-sum-exps in float32, a block whose row has no valid
key (K1's LSE of 1e30) taking weight 0. There is no fallback: what K1 or
the backward kernels do not take raises.

`RingAttention` (a `torch.autograd.Function`) gives the ring its backward,
which torch cannot derive through point-to-point calls. It saves q, k, v,
the mask, the output and the global log-sum-exp, and walks the ring again:
with delta = rowsum(dO O) in float32, each block's probabilities are
recomputed from the global LSE, dQ accumulates on the rank, and dK / dV
accumulate in float32 buffers that travel the ring with their K/V chunk;
one more shift after the last step brings each buffer to its owner. On
CUDA tensors a block is one launch of the dQ kernel and one of the dK/dV
kernel (`flash_attention_bwd_dq` / `_dkv`), each over the tile pairs of
`bwd_tile_table` of that block (built per block); on CPU tensors it is the
same recurrence in plain float32.

`fault` plants a fault for a check: "mask_stays" (the rank's own mask is
used at every step instead of the travelling one) or "owner_fixed" (the
owner index is not decremented as the chunks travel).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from . import attention as _attn

_NEG_INF = -1e30
_LSE_EMPTY = 1e30  # K1's log-sum-exp of a row with no valid key
FAULTS = ("mask_stays", "owner_fixed")


def _owners(n: int, idx: int, causal: bool, fault: Optional[str]
            ) -> List[Tuple[int, bool]]:
    """(owner, run) of each ring step: whose chunk the rank holds, and
    whether the causal mask leaves anything of it to compute."""
    steps = []
    for step in range(n):
        owner = idx if fault == "owner_fixed" else (idx - step) % n
        steps.append((owner, not (causal and owner > idx)))
    return steps


def _block_bias(q_pos, kv_pos, mask, causal: bool):
    """(B or 1, 1, Sq, Sk) float32 bias, 0 where a pair attends and -1e30
    where it does not, or None."""
    bias = None
    if causal:
        bias = torch.where(q_pos[:, None] >= kv_pos[None, :], 0.0,
                           _NEG_INF)[None, None]
    if mask is not None:
        mb = torch.where(mask, 0.0, _NEG_INF)[:, None, None, :]
        bias = mb if bias is None else bias + mb
    return bias


def _row(bias, bi: int):
    """Batch row `bi` of a bias that may broadcast over the batch."""
    if bias is None or bias.shape[0] == 1:
        return bias
    return bias[bi:bi + 1]


def _block_scores(qf, kb, bias, sm_scale):
    scores = torch.matmul(qf, kb.transpose(-1, -2)) * sm_scale
    return scores if bias is None else scores + bias


def _plain_forward(q, k, v, kv_mask, axis, causal, sm_scale, fault):
    """JAX's ring step by step: float32 (o, m, l) per block, merged as the
    blocks arrive. Returns (out in q.dtype, float32 lse, 1e30 for a row
    with no valid key)."""
    n, idx = axis.size, axis.index
    b, h, s_loc, d = q.shape
    qf = q.float()
    q_pos = idx * s_loc + torch.arange(s_loc, device=q.device)
    o = torch.zeros(b, h, s_loc, d, dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros_like(m)
    kb, vb, mb = k.float(), v.float(), kv_mask
    for step, (owner, run) in enumerate(_owners(n, idx, causal, fault)):
        if run:
            kv_pos = owner * s_loc + torch.arange(s_loc, device=q.device)
            bias = _block_bias(q_pos, kv_pos, mb, causal)
            for bi in range(b):  # one row's scores at a time
                scores = _block_scores(qf[bi:bi + 1], kb[bi:bi + 1],
                                       _row(bias, bi), sm_scale)
                m_b = scores.amax(dim=-1)
                p = torch.where(scores <= _NEG_INF / 2, 0.0,
                                torch.exp(scores - m_b[..., None]))
                l_b = p.sum(dim=-1)
                o_b = torch.matmul(p, vb[bi:bi + 1])
                m_new = torch.maximum(m[bi:bi + 1], m_b)
                alpha = torch.exp(m[bi:bi + 1] - m_new)
                beta = torch.exp(m_b - m_new)
                o[bi:bi + 1] = o[bi:bi + 1] * alpha[..., None] \
                    + o_b * beta[..., None]
                l_sum[bi:bi + 1] = l_sum[bi:bi + 1] * alpha + l_b * beta
                m[bi:bi + 1] = m_new
        if step + 1 < n:
            kb, vb, mb = _rotate(axis, kb, vb, mb, fault)
    out = o / torch.clamp(l_sum, min=1e-30)[..., None]
    lse = torch.where(l_sum > 0, m + torch.log(l_sum),
                      torch.full_like(m, _LSE_EMPTY))
    return out.to(q.dtype), lse


def _rotate(axis, kb, vb, mb, fault, *extra):
    """The held K/V chunk (with its mask and any buffers) passed on one
    step; under the "mask_stays" fault the mask is not passed."""
    travel = [kb, vb, *extra]
    if mb is not None and fault != "mask_stays":
        travel.append(mb)
    got = axis.shift(travel)
    if mb is not None and fault != "mask_stays":
        mb = got.pop()
    return (got[0], got[1], mb, *got[2:])


def _merge_blocks(outs: List[torch.Tensor], lses: List[torch.Tensor],
                 out_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocks' outputs (B, H, S, D) and float32 log-sum-exps (B, H, S)
    merged in float32: out = sum_b exp(lse_b - lse) o_b with lse the
    logsumexp of the lse_b, a block whose row had no valid key (lse 1e30)
    taking weight 0. Returns (out in `out_dtype`, lse, 1e30 where no block
    had a valid key)."""
    stacked = torch.stack(lses)
    valid = stacked < _LSE_EMPTY / 2
    masked = torch.where(valid, stacked, float("-inf"))
    lse = torch.logsumexp(masked, dim=0)
    any_valid = valid.any(dim=0)
    safe = torch.where(any_valid, lse, torch.zeros_like(lse))
    out = torch.zeros(outs[0].shape, dtype=torch.float32,
                      device=outs[0].device)
    for o_b, m_b in zip(outs, masked):
        out += torch.exp(m_b - safe)[..., None] * o_b.float()
    lse = torch.where(any_valid, lse, torch.full_like(lse, _LSE_EMPTY))
    return out.to(out_dtype), lse


def _kernel_forward(q, k, v, kv_mask, axis, causal, sm_scale, fault):
    """One K1 launch a block that the causal mask leaves anything of, with
    its log-sum-exp, then the merge."""
    n, idx = axis.size, axis.index
    b, h, s_loc, _ = q.shape
    outs, lses = [], []
    kb, vb, mb = k.contiguous(), v.contiguous(), kv_mask
    for step, (owner, run) in enumerate(_owners(n, idx, causal, fault)):
        if run:
            lse = torch.empty(b, h, s_loc, dtype=torch.float32,
                              device=q.device)
            outs.append(_attn.flash_attention_fwd(
                q, kb, vb, mb, causal and owner == idx, sm_scale, lse=lse))
            lses.append(lse)
        if step + 1 < n:
            kb, vb, mb = _rotate(axis, kb, vb, mb, fault)
    return _merge_blocks(outs, lses, q.dtype)


def _plain_block_grads(qf, kb, vb, bias, lse, delta, do, sm_scale):
    """One block's (dq, dk, dv) in float32 from the global lse."""
    scores = _block_scores(qf, kb, bias, sm_scale)
    p = torch.where(scores <= _NEG_INF / 2, 0.0,
                    torch.exp(scores - lse[..., None]))
    dp = torch.matmul(do, vb.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    return (torch.matmul(ds, kb), torch.matmul(ds.transpose(-1, -2), qf),
            torch.matmul(p.transpose(-1, -2), do))


def _backward(q, k, v, kv_mask, out, lse, d_out, axis, causal, sm_scale,
              fault, plain):
    """The ring walked again: dQ on the rank, dK / dV in float32 buffers
    that travel with their chunk and come home by one more shift."""
    n, idx = axis.size, axis.index
    b, h, s_loc, d = q.shape
    delta = (d_out.float() * out.float()).sum(dim=-1)
    dq = torch.zeros(b, h, s_loc, d, dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    if plain:
        qf, do = q.float(), d_out.float()
        kb, vb = k.float(), v.float()
        q_pos = idx * s_loc + torch.arange(s_loc, device=q.device)
    else:
        kb, vb = k.contiguous(), v.contiguous()
        d_out = d_out.contiguous()
    mb = kv_mask
    for step, (owner, run) in enumerate(_owners(n, idx, causal, fault)):
        if run:
            diag = causal and owner == idx
            if plain:
                kv_pos = owner * s_loc + torch.arange(s_loc, device=q.device)
                bias = _block_bias(q_pos, kv_pos, mb, causal)
                for bi in range(b):
                    sl = slice(bi, bi + 1)
                    g = _plain_block_grads(qf[sl], kb[sl], vb[sl],
                                           _row(bias, bi), lse[sl],
                                           delta[sl], do[sl], sm_scale)
                    dq[sl] += g[0]
                    dk[sl] += g[1]
                    dv[sl] += g[2]
            else:
                runs = _attn.bwd_tile_table(mb, None, b, s_loc, s_loc, diag,
                                            q.device)
                dq += _attn.flash_attention_bwd_dq(
                    q, kb, vb, mb, None, lse, delta, d_out, diag, sm_scale,
                    runs).float()
                dk_b, dv_b = _attn.flash_attention_bwd_dkv(
                    q, kb, vb, mb, None, lse, delta, d_out, diag, sm_scale,
                    runs)
                dk += dk_b.float()
                dv += dv_b.float()
        if step + 1 < n:
            kb, vb, mb, dk, dv = _rotate(axis, kb, vb, mb, fault, dk, dv)
    dk, dv = axis.shift([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, kv_mask, axis):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention takes q, k, v of one (B, H, S_loc, "
                         f"D) shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if kv_mask is not None and (kv_mask.dtype != torch.bool
                                or kv_mask.shape != (q.shape[0], q.shape[2])):
        raise ValueError("kv_mask must be a (B, S_loc) bool tensor")
    if axis is None:
        raise ValueError("ring attention needs the sequence axis")


class RingAttention(torch.autograd.Function):
    """The ring with its backward (module docstring): the same object on
    both devices, only the per-block work differs."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, axis, causal, sm_scale, fault, plain):
        fwd = _plain_forward if plain else _kernel_forward
        out, lse = fwd(q, k, v, kv_mask, axis, causal, sm_scale, fault)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.args = (axis, causal, sm_scale, fault, plain)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, kv_mask, out, lse, d_out, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor] = None, *, axis,
                   causal: bool = False, sm_scale: Optional[float] = None,
                   plain: bool = False, fault: Optional[str] = None
                   ) -> torch.Tensor:
    """Exact attention of this rank's (B, H, S_loc, D) q over the whole
    sequence, whose K/V (and `kv_mask`, (B, S_loc) bool, True = attend)
    chunks travel the ring of `axis`. Returns this rank's rows
    (B, H, S_loc, D) in q's dtype. CUDA tensors launch the flash kernels
    (bf16, D 64 or 128, as `flash_attention`), CPU tensors and `plain` run
    the plain ring. Every rank of the axis must call it, in the same order
    as its other collectives."""
    _check(q, k, v, kv_mask, axis)
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no ring attention path for device {q.device}")
    if kv_mask is not None:
        kv_mask = kv_mask.contiguous()
    return RingAttention.apply(q, k, v, kv_mask, axis, causal,
                               float(sm_scale), fault,
                               bool(plain or not q.is_cuda))


def ring_self_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor,
                        kv_mask: Optional[torch.Tensor] = None, *,
                        causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """The JAX `ring_self_attention` wrapper: q / k / v (B, H, S, D) and
    `kv_mask` (B, S) of the whole sequence on every rank of `mesh` (a
    `parallel.context.CpMesh`); returns this rank's rows (B, H, S / cp, D)
    of the whole sequence's attention (the chunk its seq index owns). S
    must divide by the ring size."""
    from ..parallel.context import seq_chunk

    q, k, v = (seq_chunk(t, mesh, dim=2) for t in (q, k, v))
    if kv_mask is not None:
        kv_mask = seq_chunk(kv_mask, mesh, dim=1)
    return ring_attention(q, k, v, kv_mask, axis=mesh.seq, causal=causal,
                          sm_scale=sm_scale)
