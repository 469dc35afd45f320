"""The split decode kernels of the paged int8 pool (csrc/paged_decode_q.cu)
and of the int8-dots variant (5b, csrc/fused_decode_q.cu) on the CPU.

Both kernels run only on the card (`chip_smoke.py`); the pieces of their
design that live in Python are held here against the JAX package and the
port's own plain paths:

- the paged split: the pool gathered through the table, then the split
  softmax (`paged_fused_decode_q_split_plain`) at C = 1, 2, 4, 8 against
  JAX `paged_fused_decode_q` in interpret mode (pages of 32 and 128: the
  JAX int8 kernel takes pages that are multiples of 32), and equal to the
  contiguous split (`fused_decode_attention_q_split_plain`) on the gathered
  cache, which the kernel must match bit for bit on the card;
- the producer's bulk copies (`stage_page_pieces`) at pages of 16, 48, 128
  and 256: every row copied once, no page past the last valid one;
- the int8-dots split (`int8_dots_attention_split`) at C = 1, 2, 4, 8 and
  block_s 32, 96, 512, with rows that are not a multiple of 4: its q codes,
  p codes and int32 P.V sums equal (not close) at every C, its output within
  1e-6 of `int8_dots_attention` (the same function, the sum of p in float64
  instead of float32), and within tests/test_torch_int8_dots.py's bounds of
  JAX's `int8_dots=True` kernel in interpret mode;
- the launch plans' shared memory and the wrappers' argument checks.

Tolerances: against the JAX paged kernel 1e-2 absolute + relative, as
tests/test_torch_paged.py holds the int8 pool (the kernel rounds q *
sm_scale and p * v_scale to bf16 where the plain path keeps float32);
against the port's float32 plain paths 1e-5 (sums in another order).
Pools, scale pages, caches, codes and integer sums are exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.ops import fused_decode as j_fused
from lhrs_bot_tpu.ops import paged_fused as j_paged
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu_torch.ops import fused_decode as t_fused
from lhrs_bot_tpu_torch.ops import paged_fused as t_paged

KERNEL_TOL = dict(rtol=1e-2, atol=1e-2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- the paged split ----------------------------------------------------------

# (lengths, pages a row) per page size: rows that end mid-page, on a page's
# last row and alone in a new page; at page 128 a row past C = 2's share
# boundary (two blocks of 128: 255, 300)
PAGED = {32: ((37, 95, 32), 4), 128: ((37, 255, 300), 3)}
PAGED_LAYER = 1


def _paged_inputs(page):
    lengths, pps = PAGED[page]
    rng = np.random.default_rng(page)
    nl, h, d, b = 2, 2, 128, len(lengths)
    n_pages = 1 + b * pps + 2
    table = rng.permutation(np.arange(1, n_pages))[:b * pps].reshape(
        b, pps).astype(np.int32)
    shape = (nl, n_pages, h, page, d)
    return dict(q=rng.standard_normal((b, h, 1, d)).astype(np.float32),
                kp=rng.integers(-127, 128, shape).astype(np.int8),
                vp=rng.integers(-127, 128, shape).astype(np.int8),
                ks=rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32),
                vs=rng.uniform(0.01, 0.03, shape[:-1]).astype(np.float32),
                kn=rng.integers(-127, 128, (b, h, 1, d)).astype(np.int8),
                vn=rng.integers(-127, 128, (b, h, 1, d)).astype(np.int8),
                kns=rng.uniform(0.01, 0.03, (b, h, 1)).astype(np.float32),
                vns=rng.uniform(0.01, 0.03, (b, h, 1)).astype(np.float32),
                table=table, lengths=np.asarray(lengths, np.int32))


@pytest.fixture(scope="module")
def paged_cases():
    """Per page size: the inputs and JAX `paged_fused_decode_q`'s output and
    pools, in interpret mode."""
    cases = {}
    for page in PAGED:
        x = _paged_inputs(page)
        x["jax"] = j_paged.paged_fused_decode_q(
            jnp.asarray(x["q"], jnp.bfloat16),
            *map(jnp.asarray, (x["kn"], x["kns"], x["vn"], x["vns"], x["kp"],
                               x["vp"], x["ks"], x["vs"], x["table"],
                               x["lengths"])), jnp.int32(PAGED_LAYER),
            interpret=True)
        cases[page] = x
    return cases


ROWS = ("q", "kn", "kns", "vn", "vns")
POOLS = ("kp", "vp", "ks", "vs")


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("page", sorted(PAGED))
def test_paged_split_plain_matches_jax_and_contiguous(paged_cases, page,
                                                      splits):
    x = paged_cases[page]
    want, *jpools = x["jax"]
    pools = [_t(x[k]) for k in POOLS]
    table, lens = _t(x["table"]), _t(x["lengths"])
    got, *after = t_paged.paged_fused_decode_q_split_plain(
        *(_t(x[k]) for k in ROWS), *pools, table, lens, PAGED_LAYER,
        splits=splits)
    assert all(a is p for a, p in zip(after, pools))  # in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **KERNEL_TOL)
    for mine, theirs in zip(pools, jpools):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    plain = t_paged.paged_fused_decode_q_plain(
        *(_t(x[k]) for k in ROWS), *(_t(x[k]) for k in POOLS), table, lens,
        PAGED_LAYER)[0]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    # the contiguous split on the rows gathered from the pages (before the
    # append): the same function, so the same bits
    gathered = [t_paged._gather_pages(_t(x[k])[PAGED_LAYER], table)[None]
                .contiguous() for k in POOLS]
    cont = t_fused.fused_decode_attention_q_split_plain(
        *(_t(x[k]) for k in ROWS), *gathered, lens, 0, splits=splits)[0]
    np.testing.assert_array_equal(got.numpy(), cont.numpy())


def test_paged_split_fault_leaves_out_the_last_rank(paged_cases):
    """The planted merge fault moves a row whose last rank holds rows (300
    at C = 2) and leaves the one-share rows as they were."""
    x = paged_cases[128]
    vp = x["vp"].copy()
    row = x["table"][2]
    vp[PAGED_LAYER, row[2]] = 120  # rows 256.. of row 2: rank 1 at C = 2
    outs = []
    for fault in (0, 1):
        pools = [_t(x[k]) for k in POOLS]
        pools[1] = _t(vp)
        outs.append(t_paged.paged_fused_decode_q_split_plain(
            *(_t(x[k]) for k in ROWS), *pools, _t(x["table"]),
            _t(x["lengths"]), PAGED_LAYER, splits=2, fault=fault)[0])
    err = (outs[1] - outs[0]).abs()
    assert float(err[2].min()) > 0.1
    assert float(err[0].max()) == 0.0  # 38 rows: one share


def _pieces_ok(n_valid, splits, page, stage_rows):
    """Check the producer's copies of every rank for a head of n_valid
    rows; returns the rows covered."""
    seen = np.zeros(n_valid, np.int32)
    last_entry = -(-n_valid // page) - 1
    for rank in range(splits):
        s0, s1 = t_fused.decode_shares(n_valid, splits)[rank]
        stages = t_paged.stage_page_pieces(n_valid, splits, rank, page,
                                           stage_rows)
        assert len(stages) == -(-(s1 - s0) // stage_rows)
        for t, pieces in enumerate(stages):
            r0 = s0 + t * stage_rows
            n = max(0, min(r0 + stage_rows, s1, n_valid - 1) - r0)
            assert sum(p[2] for p in pieces) == n
            at = 0
            for entry, off, rows, dst in pieces:
                assert 0 <= entry <= last_entry
                assert dst == at and rows > 0
                assert off % 16 == 0 and dst % 16 == 0  # 16-byte aligned
                assert off + rows <= page
                # the scales' 16-byte words stay inside the page and stage
                assert off + -(-rows // 4) * 4 <= page
                assert dst + -(-rows // 4) * 4 <= stage_rows
                first = entry * page + off
                assert first == r0 + dst
                seen[first:first + rows] += 1
                at += rows
            # the announced scale bytes are the pieces' padded ones
            assert sum(-(-p[2] // 4) * 16 for p in pieces) == -(-n // 4) * 16
    return seen


@pytest.mark.parametrize("stage_rows", [128, 256])
@pytest.mark.parametrize("page", [16, 48, 128, 256])
def test_stage_page_pieces_cover_each_row_once(page, stage_rows):
    for n_valid in (1, 2, 16, 17, 128, 129, 300, 2192, 2304):
        for splits in t_fused.SPLITS:
            seen = _pieces_ok(n_valid, splits, page, stage_rows)
            # rows before the appended one, once each; the appended row
            # comes from k_new, never from a copy
            np.testing.assert_array_equal(seen[:-1], 1)
            assert seen[-1] == 0


def test_paged_plan_keeps_two_ctas_an_sm():
    """The paged kernel stages a row's page ids (8 KB more than K4), and
    still two of its CTAs fit an SM, so K4's plan holds for it."""
    for d in (64, 128):
        paged = t_fused.decode_smem_bytes(d, 1, paged=True)
        assert paged == t_fused.decode_smem_bytes(d, 1) + 4 * t_fused.MAX_PAGES
        assert (t_fused._resident(paged, 132)
                == t_fused.decode_resident_ctas(d, 1, 132) == 2 * 132)


def test_paged_kernel_arguments_are_checked():
    """A cluster size outside 1, 2, 4, 8, CPU tensors and a table of more
    than MAX_PAGES entries raise before anything launches."""
    x = _paged_inputs(32)
    args = [_t(x[k]) for k in ROWS + POOLS] + [_t(x["table"]),
                                                _t(x["lengths"])]
    with pytest.raises(ValueError, match="splits"):
        t_paged.paged_fused_decode_q_kernel(*args, 0, 0.125, splits=3)
    with pytest.raises(ValueError, match="CUDA"):
        t_paged.paged_fused_decode_q_kernel(*args, 0, 0.125, splits=2)
    wide = torch.zeros(3, t_fused.MAX_PAGES + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="entries"):
        t_paged._shapes(args[0], args[5], args[6], wide, args[-1], 0)


# -- the int8-dots split ------------------------------------------------------

# rows 303 and 614 (not multiples of 4): block 512 splits the longer row into
# one whole block and a short one; block 32 leaves a 15-row last block (four
# ranks of 4 rows, the last 3, at C = 4)
DOTS_S, DOTS_LENGTHS, DOTS_LAYER = 640, (302, 613), 1


def _codes(rng, shape):
    c, s = j_quant.quantize_activation(
        jnp.asarray(rng.normal(size=shape), jnp.float32))
    return np.asarray(c), np.asarray(s[..., 0])


@pytest.fixture(scope="module")
def dots_inputs():
    rng = np.random.default_rng(17)
    nl, b, h, d = 2, len(DOTS_LENGTHS), 2, 128
    kc, ks = _codes(rng, (nl, b, h, DOTS_S, d))
    vc, vs = _codes(rng, (nl, b, h, DOTS_S, d))
    kn, kns = _codes(rng, (b, h, 1, d))
    vn, vns = _codes(rng, (b, h, 1, d))
    x = dict(q=rng.normal(size=(b, h, 1, d)).astype(np.float32), kn=kn,
             kns=kns, vn=vn, vns=vns, kc=kc, vc=vc, ks=ks, vs=vs,
             lens=np.asarray(DOTS_LENGTHS, np.int32))
    x["jax"] = {}
    return x


DOT_ARGS = ("q", "kn", "kns", "vn", "vns", "kc", "vc", "ks", "vs")


def _jax_dots(x, block_s):
    if block_s not in x["jax"]:
        x["jax"][block_s] = j_fused.fused_decode_attention_q(
            *(jnp.asarray(x[k]) for k in DOT_ARGS + ("lens",)),
            jnp.int32(DOTS_LAYER), interpret=True, block_s=block_s,
            int8_dots=True)
    return x["jax"][block_s]


def _dots_split(x, splits, block_s, fault=0, trace=None):
    """The port's split int8-dots attention (appends included, in place on
    copies) and the caches after it."""
    caches = [_t(x[k]) for k in ("kc", "vc", "ks", "vs")]
    kl = t_fused._write_at(caches[0][DOTS_LAYER], _t(x["kn"]), _t(x["lens"]))
    vl = t_fused._write_at(caches[1][DOTS_LAYER], _t(x["vn"]), _t(x["lens"]))
    ksl = t_fused._write_scale_at(caches[2][DOTS_LAYER], _t(x["kns"]),
                                  _t(x["lens"]))
    vsl = t_fused._write_scale_at(caches[3][DOTS_LAYER], _t(x["vns"]),
                                  _t(x["lens"]))
    out = t_fused.int8_dots_attention_split(
        _t(x["q"]), kl, vl, ksl, vsl, _t(x["lens"]) + 1,
        sm_scale=128 ** -0.5, block_s=block_s, splits=splits, fault=fault,
        trace=trace)
    return out, caches


@pytest.mark.parametrize("block_s", [32, 96, 512])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_int8dots_split_matches_unsplit_and_jax(dots_inputs, splits,
                                                block_s):
    x = dots_inputs
    trace, trace1 = {}, {}
    got, caches = _dots_split(x, splits, block_s, trace=trace)
    _dots_split(x, 1, block_s, trace=trace1)
    # the unsplit plain version (float32 sum of p) on the same inputs
    plain = t_fused.fused_decode_attention_q_int8dots_plain(
        *(_t(x[k]) for k in DOT_ARGS), _t(x["lens"]), DOTS_LAYER,
        block_s=block_s)[0]
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6)
    # the wrapper's split plain version is the same function
    wrapped = t_fused.fused_decode_attention_q_int8dots_split_plain(
        *(_t(x[k]) for k in DOT_ARGS), _t(x["lens"]), DOTS_LAYER,
        splits=splits, block_s=block_s)[0]
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    # JAX's int8-dots kernel in interpret mode, at test_torch_int8_dots.py's
    # bounds (an exp an ulp apart can move a p code across a tie)
    want, *j_caches = _jax_dots(x, block_s)
    err = np.abs(got.numpy() - np.asarray(want))
    assert np.median(err) <= 1e-5 and err.max() <= 2e-3, (np.median(err),
                                                          err.max())
    for mine, theirs in zip(caches, j_caches):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    # codes and integer sums: equal at every C, the sums those of the whole
    # block's p codes against its V codes
    vl = caches[1][DOTS_LAYER].numpy().astype(np.int64)
    qf = x["q"][:, :, 0] * np.float32(128 ** -0.5)
    for bi in range(len(DOTS_LENGTHS)):
        qs = (np.abs(qf[bi]).max(-1, keepdims=True) / np.float32(127.0)
              + np.float32(1e-12))
        np.testing.assert_array_equal(trace[bi]["q_codes"].numpy(),
                                      np.round(qf[bi] / qs).astype(np.int8))
        assert len(trace[bi]["blocks"]) == -(-(DOTS_LENGTHS[bi] + 1)
                                             // block_s)
        for i, ((codes, pv), (codes1, pv1)) in enumerate(
                zip(trace[bi]["blocks"], trace1[bi]["blocks"])):
            assert codes.dtype == torch.int8 and pv.dtype == torch.int64
            np.testing.assert_array_equal(codes.numpy(), codes1.numpy())
            np.testing.assert_array_equal(pv.numpy(), pv1.numpy())
            rows = vl[bi, :, i * block_s:i * block_s + codes.shape[-1]]
            whole = np.einsum("hn,hnd->hd", codes.numpy().astype(np.int64),
                              rows)
            np.testing.assert_array_equal(pv.numpy(), whole)


def test_int8dots_split_fault_drops_the_last_part(dots_inputs):
    """The planted exchange fault (the last rank's int32 P.V left out)
    moves the output past the kernel's 1e-5 bound at C >= 2 and is nothing
    at C = 1."""
    x = dots_inputs
    for splits in (1, 2, 4, 8):
        ok, _ = _dots_split(x, splits, 96)
        bad, _ = _dots_split(x, splits, 96, fault=1)
        err = float((bad - ok).abs().max())
        assert err == 0.0 if splits == 1 else err > 1e-3, (splits, err)


def test_int8dots_parts():
    """Each rank's part of a block starts at a multiple of 4 rows, the parts
    cover the block once, and trailing ranks may be empty."""
    for rows in range(1, 600):
        for splits in t_fused.SPLITS:
            parts = t_fused.int8dots_parts(rows, splits)
            assert parts[0][0] == 0 and parts[-1][1] == rows
            for (a0, a1), (b0, _) in zip(parts, parts[1:]):
                assert a1 == b0
            for a0, a1 in parts:
                assert a0 <= a1 and (a0 == a1 or a0 % 4 == 0)


def test_int8dots_smem_and_plan():
    """A CTA of the int8-dots kernel fits an SM for every block up to
    MAX_BLOCK_S at every C, and two do up to blocks of 1024; the plan's C is
    1 wherever B * H reaches the SM count and keeps its grid resident
    otherwise."""
    for d in (64, 128):
        for c in t_fused.SPLITS:
            for block_s in (1, 32, 96, 512, 1024, t_fused.MAX_BLOCK_S):
                smem = t_fused.int8dots_smem_bytes(d, block_s, c)
                assert smem <= 232448, (d, c, block_s, smem)
                if block_s <= 1024:
                    assert 2 * (smem + 1024) <= 233472, (d, c, block_s)
    for b in (1, 2, 3, 4, 5, 7, 8):
        for block_s in (32, 96, 512, 4096):
            c = t_fused.int8dots_split_plan(b, 32, 2304, 128, block_s, 132)
            assert c in t_fused.INT8DOTS_PLAN_SPLITS
            assert c == 1 or -(-block_s // c) >= t_fused.INT8DOTS_PART_ROWS
            assert c == 1 or b * 32 < 132
            per_sm = 233472 // (t_fused.int8dots_smem_bytes(
                128, min(block_s, 2304), c) + 1024)
            assert c == 1 or c * b * 32 <= min(per_sm, 2) * 132


def test_int8dots_plan_on_the_h100():
    """The plan's C for 32 heads of 128 dims at S 2304 on 132 SMs, as the
    card's sweep settled it: at block_s 512, 4 at B = 1-2 and 2 at B = 3-4;
    at block_s 96, 2 at B = 1-4 (parts of 24 rows lose at C = 4); 1 from
    B = 5 on."""
    got = {block_s: [t_fused.int8dots_split_plan(b, 32, 2304, 128, block_s,
                                                 132)
                     for b in (1, 2, 3, 4, 5, 7)] for block_s in (512, 96)}
    assert got == {512: [4, 4, 2, 2, 1, 1], 96: [2, 2, 2, 2, 1, 1]}


def test_int8dots_kernel_arguments_are_checked():
    x = torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16)
    cache = torch.zeros(1, 1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="splits"):
        t_fused.fused_decode_attention_q_int8dots_kernel(
            x, x, x, x, x, cache, cache, cache, cache,
            torch.zeros(1, dtype=torch.int32), 0, 0.125, 8, splits=16)
    with pytest.raises(ValueError, match="CUDA"):
        t_fused.fused_decode_attention_q_int8dots_kernel(
            x, x, x, x, x, cache, cache, cache, cache,
            torch.zeros(1, dtype=torch.int32), 0, 0.125, 8, splits=2)
