"""The flash backward's tile-skip rule, on the CPU.

`bwd_tile_ranges` and `bwd_tile_pairs` (lhrs_bot_tpu_torch/ops/attention.py)
decide which (q tile, kv tile) pairs the backward kernels run;
`bwd_tile_table` is that rule at 64 x 64 tiles, the byte table that both
kernels of csrc/flash_bwd.cu read and obey. A skipped pair must hold no pair
that attends, so that skipping it changes no gradient: for random shapes,
tile heights, causal flags, kv_masks with holes and unsorted segment ids
with zeros, every pair that `_allowed` (the plain versions' mask) lets
attend lies in a tile pair the rule runs. At the packed decoder batch's
segment layout the rule skips most causal tile pairs. The kernels
themselves are held to the plain backward on the card by chip_smoke.py,
which also shows that they run exactly the pairs the table sets.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lhrs_bot_tpu_torch.ops import attention as a


def _run_pairs(kv_mask, seg, sq, skv, causal, tile_q, tile_kv):
    q_ranges, _ = a.bwd_tile_ranges(kv_mask, seg, tile_q)
    _, kv_ranges = a.bwd_tile_ranges(kv_mask, seg, tile_kv)
    return a.bwd_tile_pairs(q_ranges, kv_ranges, -(-sq // tile_q),
                            -(-skv // tile_kv), causal, tile_q, tile_kv)


def _assert_covers(run, kv_mask, seg, b, sq, skv, causal, tile_q, tile_kv):
    """Every pair the masks let attend lies in a tile pair that runs."""
    allowed = a._allowed(sq, skv, kv_mask, seg, causal, torch.device("cpu"))
    if allowed is None:
        allowed = torch.ones(1, 1, sq, skv, dtype=torch.bool)
    allowed = allowed.expand(b, 1, sq, skv)[:, 0]
    per_pair = (run.expand(b, *run.shape[1:])
                .repeat_interleave(tile_q, 1)[:, :sq]
                .repeat_interleave(tile_kv, 2)[:, :, :skv])
    missed = allowed & ~per_pair
    assert not bool(missed.any()), (
        f"{int(missed.sum())} attending pairs in skipped tile pairs")


def _runs(rng, s, n_ids):
    """(S,) int32 segment ids in runs of random ids 0..n_ids (unsorted, 0
    for padding anywhere)."""
    out = np.zeros(s, np.int32)
    pos = 0
    while pos < s:
        n = int(rng.integers(1, max(2, s // 3)))
        out[pos:pos + n] = rng.integers(0, n_ids + 1)
        pos += n
    return out


def _mask_with_holes(rng, s):
    """(S,) bool: valid except a few random holes, some of them long."""
    out = np.ones(s, bool)
    for _ in range(int(rng.integers(0, 4))):
        lo = int(rng.integers(0, s))
        out[lo:lo + int(rng.integers(1, 140))] = False
    return out


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), b=st.integers(1, 3),
       sq=st.integers(1, 300), skv=st.integers(1, 300),
       tile_q=st.sampled_from([16, 32, 64, 128]),
       tile_kv=st.sampled_from([16, 32, 64, 128]), causal=st.booleans(),
       use_mask=st.booleans(), use_seg=st.booleans())
def test_skipped_tile_pairs_hold_no_attending_pair(seed, b, sq, skv, tile_q,
                                                   tile_kv, causal, use_mask,
                                                   use_seg):
    rng = np.random.default_rng(seed)
    if use_seg:
        skv = sq
    kv_mask = seg = None
    if use_mask:
        kv_mask = torch.from_numpy(np.stack(
            [_mask_with_holes(rng, skv) for _ in range(b)]))
    if use_seg:
        seg = torch.from_numpy(np.stack(
            [_runs(rng, sq, int(rng.integers(1, 5))) for _ in range(b)]))
    run = _run_pairs(kv_mask, seg, sq, skv, causal, tile_q, tile_kv)
    _assert_covers(run, kv_mask, seg, b, sq, skv, causal, tile_q, tile_kv)


def _packed_segments(s=2048, lengths=(600, 500, 400, 291)):
    """The packed decoder batch's layout (chip_smoke.py's decoder_segments):
    4 segments and a padding tail of segment 0."""
    seg = torch.zeros(1, s, dtype=torch.int32)
    pos = 0
    for i, n in enumerate(lengths):
        seg[:, pos:pos + n] = i + 1
        pos += n
    return seg


@pytest.mark.parametrize("tile", [64, 32])
def test_packed_layout_skips_most_causal_tile_pairs(tile):
    seg = _packed_segments()
    run = _run_pairs(None, seg, 2048, 2048, True, tile, tile)
    n = 2048 // tile
    causal_pairs = n * (n + 1) // 2
    assert run.shape == (1, n, n)
    assert not bool(run[0].triu(1).any())  # nothing above the diagonal
    skipped = 1 - int(run.sum()) / causal_pairs
    assert skipped >= 0.5, f"skips {skipped:.3f} of the causal tile pairs"
    _assert_covers(run, None, seg, 1, 2048, 2048, True, tile, tile)


def test_tile_key_ranges_values():
    keys = torch.tensor([[0, 0, 0, 0, 3, 1, 0, 2, 5, 0],
                         [1, 1, 1, 1, 0, 0, 0, 0, 0, 0]], dtype=torch.int32)
    r = a.tile_key_ranges(keys, 4)
    empty = [2 ** 31 - 1, 0]
    assert r.dtype == torch.int32 and r.shape == (2, 3, 2)
    assert r.is_contiguous()
    assert r[0].tolist() == [empty, [1, 3], [5, 5]]
    assert r[1].tolist() == [[1, 1], empty, empty]


def test_bwd_tile_ranges_sides():
    """The q side carries segment ids only; the kv side the ids (or 1)
    times kv_mask; None on a side that every key passes."""
    seg = torch.tensor([[1, 1, 2, 2, 0, 0, 3, 3]], dtype=torch.int32)
    mask = torch.tensor([[True, False, False, True, True, True, False,
                          False]])
    assert a.bwd_tile_ranges(None, None, 4) == (None, None)
    q_r, kv_r = a.bwd_tile_ranges(None, seg, 4)
    assert q_r is kv_r and q_r.tolist() == [[[1, 2], [3, 3]]]
    q_r, kv_r = a.bwd_tile_ranges(mask, None, 4)
    assert q_r is None and kv_r.tolist() == [[[1, 1], [1, 1]]]
    q_r, kv_r = a.bwd_tile_ranges(mask, seg, 4)
    assert q_r.tolist() == [[[1, 2], [3, 3]]]
    assert kv_r.tolist() == [[[1, 2], [2 ** 31 - 1, 0]]]
    # the second kv tile's keys are all masked or padding: it never runs
    run = a.bwd_tile_pairs(q_r, kv_r, 2, 2, False, 4, 4)
    assert run.tolist() == [[[True, False], [False, False]]]


def test_causal_rule_without_masks_is_the_diagonal():
    run = a.bwd_tile_pairs(None, None, 3, 5, True, 64, 64)
    assert run.tolist() == [[[True, False, False, False, False],
                             [True, True, False, False, False],
                             [True, True, True, False, False]]]
    assert bool(a.bwd_tile_pairs(None, None, 3, 5, False).all())


@pytest.mark.parametrize("use_mask,use_seg,causal", [
    (False, False, True), (False, False, False), (True, False, True),
    (False, True, True), (True, True, False)])
def test_bwd_tile_table_is_the_rule_at_64(use_mask, use_seg, causal):
    """The table the kernels read: (B, nq, nk) contiguous bool on the
    requested device, equal to the rule at 64 x 64 tiles for every batch
    row, and covering every pair that attends."""
    rng = np.random.default_rng(3)
    b, sq = 3, 200
    skv = sq if use_seg else 330
    kv_mask = (torch.from_numpy(np.stack([_mask_with_holes(rng, skv)
                                          for _ in range(b)]))
               if use_mask else None)
    seg = (torch.from_numpy(np.stack([_runs(rng, sq, 3) for _ in range(b)]))
           if use_seg else None)
    table = a.bwd_tile_table(kv_mask, seg, b, sq, skv, causal,
                             torch.device("cpu"))
    nq, nk = -(-sq // 64), -(-skv // 64)
    assert table.dtype == torch.bool and table.shape == (b, nq, nk)
    assert table.is_contiguous() and table.device.type == "cpu"
    rule = _run_pairs(kv_mask, seg, sq, skv, causal, 64, 64)
    assert torch.equal(table, rule.expand(b, nq, nk))
    _assert_covers(table, kv_mask, seg, b, sq, skv, causal, 64, 64)
