"""The fused vision blocks' softmax modes (`LHRS_VIT_SOFTMAX`) and int4
vision weights, against the JAX package on the CPU.

The JAX kernels read their mode from `lhrs_bot_tpu.ops.vit_block.
_SOFTMAX_MODE` when they are traced, so each case sets it with
monkeypatch and clears JAX's caches; the port reads the variable at each
call. Weights, inputs and sizes are tests/test_torch_vision.py's (a ViT of
width 128 with 2 heads on 5 tokens padded to 16, the matching perceiver),
the JAX kernels in interpret mode, the port's blocks through their plain
versions (CPU tensors). Both take the port's packed layers, which equal
JAX's byte for byte.

Tolerances, and why:
  * the ViT block in each mode: max-abs within 5e-3 of max|ref|, the bound
    of JAX's own grouped-vs-ungrouped test (tests/test_ops.py:442). The
    rounding points are the same in each mode; float32 sums run in another
    order, so an activation code may flip by one where a quotient lies
    within rounding of a half;
  * the attention alone, each mode's plain version against JAX's
    `_attn_probs_and_norm` on the same scores, at 16 tokens, ViT-L/14's
    257 and the perceiver's 64 x 320 under each group's mask: 1e-5
    relative (the same bf16 roundings; exp and exp2 of another library).
    Measured: 0 to 1.5e-7; a port mode against another JAX mode reads
    1.6e-3 to 0.15. At 257 and 320 keys a few probabilities sit within an
    ulp or two of a bf16 rounding boundary, where the two libraries'
    float32 exp and sums round them one bf16 step apart: those are held to
    one step and a 1e-3 share, and their rows' outputs are left out of
    the 1e-5 check;
  * the perceiver block: its kernel takes `jax.nn.softmax` in every mode,
    and so does the port's; the same 5e-3;
  * int4 codes and scales: exact (tests/test_torch_vision.py's
    `test_quantize_vision_layers_byte_identical`); a forward over them
    raises.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lhrs_bot_tpu.ops import perceiver_block as j_pb
from lhrs_bot_tpu.ops import quant as j_quant
from lhrs_bot_tpu.ops import vit_block as j_vb
from lhrs_bot_tpu_torch.core import params_from_numpy
from lhrs_bot_tpu_torch.models import vit as t_vit
from lhrs_bot_tpu_torch.ops import attention as t_att
from lhrs_bot_tpu_torch.ops import perceiver_block as t_pb
from lhrs_bot_tpu_torch.ops import quant as t_quant
from lhrs_bot_tpu_torch.ops import vit_block as t_vb

from .cpu_budget import module_budget
from .test_torch_vision import (BLOCK_TOL, POOL, VIT, _block_input, _close,
                                _images, _layer0, _pool_params, _t,
                                _t_vit_cfg, _vit_params)

# the three modes, and a value the JAX kernels read as exp2_post
MODES = {"jnn": "jnn", "exp2_pre": "exp2_pre", "exp2_post": "exp2_post",
         "other": "exp2_post"}


@pytest.fixture(scope="module", params=list(MODES))
def mode(request):
    """Both packages in `request.param`'s mode (module-scoped, so pytest
    runs each mode's cases together). JAX's caches are cleared where the
    mode its kernels trace changes, and after a mode other than its
    default, so that no later test meets a kernel traced in it."""
    value = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LHRS_VIT_SOFTMAX", value)
        mp.setattr(j_vb, "_SOFTMAX_MODE", value)
        if MODES[value] != "jnn":
            jax.clear_caches()
        yield MODES[value]
    if MODES[value] != "jnn":
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _cpu_budget():
    yield from module_budget()


def test_softmax_mode_is_read_at_each_call(mode):
    assert t_vb.softmax_mode() == mode
    assert t_vb.q_fold(0.125, mode) == j_vb._q_fold(0.125)


def _group_mask(nq, image_tokens=256):
    """(1, 64 + image_tokens) bool: the perceiver's kv mask of a group of
    `nq` queries (64 query slots, the first `nq` valid, then its image
    tokens), as the block builds it."""
    return t_pb._kv_mask(1, 64, 64 + image_tokens, (nq,),
                         (nq + image_tokens,), "cpu")


# (Sq, Skv, kv mask or None, scale of q): the 16-token case (11 valid
# keys); ViT-L/14's 257 tokens, one past four 64-key tiles; the perceiver's
# 64 query rows (past each group's count too) over its 320 keys under each
# group's mask; ViT-L/14 at 336 px (577 tokens, one past nine 64-key tiles;
# the block's 592 padded keys, 577 valid) and its perceiver's 64 + 576 = 640
# keys under each group's mask, the rows of the split path; ViT-L/14 at 504
# px (1,297 tokens, 17 past twenty tiles; the block's 1,312 padded keys,
# 1,297 valid) and its perceiver's 64 + 1,296 = 1,360 keys under each
# group's mask, the rows of the cluster path. The larger cases scale q by
# the block's 1 / sqrt(64).
ATTN_CASES = {
    "s16_valid11": (16, 16, (torch.arange(16) < 11)[None], 1.0),
    "vit_s257": (257, 257, None, 0.125),
    "perceiver_g0": (64, 320, _group_mask(64), 0.125),
    "perceiver_g1": (64, 320, _group_mask(48), 0.125),
    "perceiver_g2": (64, 320, _group_mask(32), 0.125),
    "vit336_s577": (577, 577, None, 0.125),
    "vit336_block_s592": (592, 592, (torch.arange(592) < 577)[None], 0.125),
    "perceiver336_g0": (64, 640, _group_mask(64, 576), 0.125),
    "perceiver336_g1": (64, 640, _group_mask(48, 576), 0.125),
    "perceiver336_g2": (64, 640, _group_mask(32, 576), 0.125),
    "vit504_s1297": (1297, 1297, None, 0.125),
    "vit504_block_s1312": (1312, 1312, (torch.arange(1312) < 1297)[None],
                           0.125),
    "perceiver504_g0": (64, 1360, _group_mask(64, 1296), 0.125),
    "perceiver504_g1": (64, 1360, _group_mask(48, 1296), 0.125),
    "perceiver504_g2": (64, 1360, _group_mask(32, 1296), 0.125),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_plain_matches_jax_probs_and_norm(mode, case):
    """`attention_plain` against the JAX kernels' `_attn_probs_and_norm`
    and P V on the same bf16 q, k, v and the same float32 scores (already
    scaled, masked keys -1e30), at the shapes the normalize-first kernel
    serves. Both take the scores of one float32 product (the libraries'
    products sum in other orders, up to 1e-6 apart at 257 keys). Each
    probability (times 1 / sum in exp2_post), read through an identity V,
    equals JAX's or sits one bf16 step from it: a float32 value within an
    ulp or two of a rounding boundary, where the libraries' exp and sums
    decide the rounding; at most 1e-3 of them do. The outputs of the rows
    where none does hold within 1e-5. A row with no valid key would take
    uniform weights in JAX and 0 in the port (the TPU kernels' convention
    is not the port's), so such rows are left out; these cases' masks are
    per key and leave every row a valid key."""
    sq, skv, mask, q_scale = ATTN_CASES[case]
    rng = np.random.default_rng(21)
    d = 64
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal((n, d)) * sc,
                                      jnp.bfloat16).astype(jnp.float32))
               for n, sc in ((sq, q_scale), (skv, 1.0), (skv, 1.0)))
    tq, tk, tv = (_t(a).to(torch.bfloat16)[None, None] for a in (q, k, v))
    scores = jnp.asarray(torch.matmul(tq.float(), tk.float().transpose(
        -1, -2))[0, 0].numpy())
    if mask is not None:
        scores = jnp.where(jnp.asarray(mask.numpy()), scores, -1e30)
    probs, post = j_vb._attn_probs_and_norm(scores)
    p_jax = probs.astype(jnp.float32)
    want = p_jax @ jnp.asarray(v, jnp.bfloat16).astype(jnp.float32)
    if post is not None:
        want = want * jnp.transpose(post)
        p_jax = p_jax * jnp.transpose(post)

    def port(values):
        return t_vb.attention_plain(tq, tk, values, mask, 1.0, torch.float32,
                                    mode)[0, 0].numpy()

    rows = (np.ones(sq, bool) if mask is None
            else np.broadcast_to(mask.numpy().any(-1), (sq,)))
    p_port = port(torch.eye(skv, dtype=torch.bfloat16)[None, None])[rows]
    p_jax = np.asarray(p_jax)[rows]
    step = np.abs(p_port - p_jax)
    apart = step > 1e-6 * np.abs(p_jax)
    assert np.all(step[apart] <= 2.0 ** -7 * np.abs(p_jax[apart]) * 1.001)
    assert apart.mean() <= 1e-3, f"{apart.sum()} probabilities apart"
    same = ~apart.any(-1)
    want = np.asarray(want)[rows][same]
    np.testing.assert_allclose(port(tv)[rows][same], want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


# (D, keys, path) at two Q tiles of queries; (D, query rows, keys, path)
# where the query rows decide
_BY_LENGTH = [(64, 197, "resident"), (64, 257, "resident"),
              (64, 320, "resident"), (64, 321, "split"), (64, 577, "split"),
              (64, 592, "split"), (64, 640, "split"), (64, 641, "cluster"),
              (64, 704, "cluster"), (64, 1024, "cluster"),
              (64, 1025, "two_pass"), (64, 1088, "two_pass"),
              (64, 1089, "cluster"), (64, 1280, "cluster"),
              (64, 1281, "two_pass"), (64, 1297, "two_pass"),
              (64, 1312, "two_pass"), (64, 1344, "two_pass"),
              (64, 1345, "cluster"), (64, 1600, "cluster"),
              (64, 1601, "two_pass"), (64, 1664, "two_pass"),
              (64, 1665, "cluster"),
              (64, 1360, "cluster"), (64, 2560, "cluster"),
              (64, 2561, "two_pass"), (128, 256, "resident"),
              (128, 257, "two_pass"), (128, 577, "two_pass"),
              (128, 2560, "two_pass")]
_BY_QUERIES = [(64, 64, 1360, "two_pass"), (64, 1, 641, "two_pass"),
               (64, 64, 2560, "two_pass"), (64, 65, 641, "cluster"),
               (64, 65, 1360, "cluster"), (64, 64, 640, "split"),
               (64, 64, 320, "resident"), (64, 65, 2560, "cluster"),
               (64, 1297, 1297, "two_pass"), (128, 577, 577, "two_pass")]


@pytest.mark.parametrize(
    "d, sq, skv, path",
    [pytest.param(d, 128, skv, path, id=f"{d}-{skv}-{path}")
     for d, skv, path in _BY_LENGTH]
    + [pytest.param(d, sq, skv, path, id=f"{d}-{sq}x{skv}-{path}")
       for d, sq, skv, path in _BY_QUERIES])
def test_normalized_forward_path_by_row_length(monkeypatch, d, sq, skv,
                                               path):
    """`flash_attention_fwd_normalized` launches the resident kernel for
    rows of at most NORM_RESIDENT_KEYS[D] keys (320 at D64, 256 at D128),
    hands rows of up to NORM_SPLIT_KEYS[D] keys (640, D64 only) to the split
    wrapper, rows of up to NORM_CLUSTER_KEYS[D] (2,560, D64 only: eight CTAs
    of five 64-key tiles) to the cluster wrapper where the queries fill
    more than one Q tile of 64, but rows of NORM_TWO_PASS_TILES[D] tiles
    of 64 keys (17, 21 and 26: 21 at ViT-L/14 504 px) and the 504-px
    perceiver's 64 queries over 1,360 keys go to the two-pass wrapper, as
    do longer rows
    (D128 past 256 keys: 577 too); each counts its own launches. The
    launch itself is recorded (no kernel runs on the CPU)."""
    assert t_att.NORM_RESIDENT_KEYS == {64: 320, 128: 256}
    assert t_att.NORM_SPLIT_KEYS == {64: 640}
    assert t_att.NORM_CLUSTER_KEYS == {64: 2560}
    assert t_att.NORM_TWO_PASS_TILES == {64: (17, 21, 26)}
    assert t_att.norm_path(skv, d, sq) == path
    taken = []
    monkeypatch.setattr(t_att, "_flash_fwd_norm",
                        lambda *a, path="resident", **kw: taken.append(path))
    wrappers = {"resident": t_att.flash_attention_fwd_normalized,
                "split": t_att.flash_attention_fwd_normalized_split,
                "cluster": t_att.flash_attention_fwd_normalized_cluster,
                "two_pass": t_att.flash_attention_fwd_normalized_two_pass}
    for fn in wrappers.values():
        monkeypatch.setattr(fn, "launches", 0)
    q = torch.zeros(1, 2, sq, d, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, skv, d, dtype=torch.bfloat16)
    t_att.flash_attention_fwd_normalized(q, kv, kv, None, 0.125)
    assert taken == [path]
    assert {name: fn.launches for name, fn in wrappers.items()} == {
        name: int(name == path) for name in wrappers}


def test_normalized_forward_rejects_cpu_tensors():
    """The normalize-first wrappers take CUDA tensors only (on the CPU the
    vision blocks run `attention_plain`), and count nothing they refuse."""
    x = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    wrappers = (t_att.flash_attention_fwd_normalized,
                t_att.flash_attention_fwd_normalized_split,
                t_att.flash_attention_fwd_normalized_cluster,
                t_att.flash_attention_fwd_normalized_two_pass)
    before = [fn.launches for fn in wrappers]
    for fn in wrappers:
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, x, x, None, 0.125)
    assert [fn.launches for fn in wrappers] == before


def test_norm_cluster_plan():
    """The cluster path's split of a row's 64-key tiles over the cluster's
    CTAs: the fewest CTAs of at most four tiles (two CTAs an SM; six at
    ViT-L/14 504 px's 21 tiles), of five past 32 tiles, every CTA N =
    ceil(tiles / C) slots (4 or 5), contiguous slices covering every tile
    once, the first C N - tiles ranks one tile short (their last slot a
    masked dummy, so that every CTA runs the same code), no plan past
    eight CTAs (the portable cluster size); rows the path does not take
    raise."""
    assert t_att.norm_cluster_plan(1297) == (
        6, [(0, 3), (3, 3), (6, 3), (9, 4), (13, 4), (17, 4)])
    assert t_att.norm_cluster_plan(1312) == t_att.norm_cluster_plan(1297)
    assert t_att.norm_cluster_plan(1360) == (
        6, [(0, 3), (3, 3), (6, 4), (10, 4), (14, 4), (18, 4)])
    assert t_att.norm_cluster_plan(641) == (3, [(0, 3), (3, 4), (7, 4)])
    assert t_att.norm_cluster_plan(2560) == (
        8, [(5 * r, 5) for r in range(8)])
    for skv in range(641, 2561, 7):
        nt = -(-skv // 64)
        c, slices = t_att.norm_cluster_plan(skv)
        n = -(-nt // c)
        assert c == -(-nt // (4 if nt <= 32 else 5)) and len(slices) == c
        assert c <= 8 and 4 <= n <= 5
        assert [c0 for c0, _ in slices] == list(np.cumsum(
            [0] + [k for _, k in slices[:-1]]))
        assert sum(k for _, k in slices) == nt
        assert all(k in (n - 1, n) for _, k in slices)
        assert slices[-1][1] == n  # the row's last tile in a full CTA
        assert [k for _, k in slices] == sorted(k for _, k in slices)
    for skv in (320, 640, 2561, 4096):
        with pytest.raises(ValueError, match="cluster"):
            t_att.norm_cluster_plan(skv)


@pytest.mark.parametrize("sq, skv, d, want", [
    # the 504-px perceiver's 64 x 1,360: one Q tile a head, its warpgroups
    # split 22 key tiles, K resident beside four V slots
    (64, 1360, 64, (1, 1, 22, 4, 224448, (None, True))),
    # ViT-L/14 at 504 px: ten Q-tile pairs and an odd last tile a head,
    # 21 key tiles resident (the split CTA's dummy reads the last) beside
    # four V slots (even: the launch has split CTAs)
    (1297, 1297, 64, (11, 2, 21, 4, 224432, (True, True))),
    (1312, 1312, 64, (11, 2, 21, 4, 224432, (True, True))),
    # ViT-L/14 at 336 px: five pairs, ten key tiles beside eight V slots
    (577, 577, 64, (5, 2, 10, 8, 167008, (True, None))),
    # D128 at 577 keys: ten 16 KB key tiles do not fit beside three V
    # slots, so K passes through an eight-slot ring twice
    (577, 577, 128, (5, 2, 8, 3, 216160, (False, None))),
    # streamed with split CTAs: K and V rings of even sizes (25 slots fit:
    # one goes unused)
    (64, 2561, 64, (1, 1, 22, 4, 224592, (None, False))),
    (2561, 2561, 64, (21, 2, 20, 4, 216400, (False, False))),
    (704, 704, 64, (6, 2, 11, 8, 175200, (True, True))),
    (1, 17, 64, (1, 1, 1, 8, 85008, (None, True))),
])
def test_norm_two_pass_plan(sq, skv, d, want):
    """The two-pass kernel's plan (`norm_two_pass_plan`, whose K and V
    slots the launch passes to csrc/flash_fwd_norm.cu, where
    `two_pass_plan` checks them): Q-tile pairs a head, Q, K and V slots, the
    shared memory, and whether the pair CTAs' and the split CTAs' K stays
    resident; every plan within the block's 232,448 bytes, with at least
    three V slots and, where K is streamed, three K slots; where the launch
    has split CTAs (an odd Q-tile count), rings of an even size."""
    plan = t_att.norm_two_pass_plan(sq, skv, d)
    assert (plan["pairs"], plan["q_slots"], plan["k_slots"], plan["v_slots"],
            plan["smem"], plan["resident"]) == want
    nt = -(-skv // 64)
    assert plan["smem"] <= 232448 and plan["v_slots"] >= 3
    assert plan["k_slots"] == nt or plan["k_slots"] >= 3
    if -(-sq // 64) % 2:
        assert plan["v_slots"] % 2 == 0
        assert plan["k_slots"] == nt or plan["k_slots"] % 2 == 0


def test_norm_two_pass_plan_bounds():
    """Every row length up to 8,192 keys has a plan at both head dims, K
    resident exactly while the row's key tiles fit beside the V ring, the
    slots filling the shared memory a tile short at most (two where a
    launch with split CTAs rounds its rings to even sizes), those rings
    even; a row too long for its key bits beside six slots raises."""
    for d in (64, 128):
        tile = 128 * d
        for skv in range(1, 8193, 37):
            for sq in (64, 128, 192):
                plan = t_att.norm_two_pass_plan(sq, skv, d)
                odd = -(-sq // 64) % 2
                assert 232448 - (1 + odd) * tile < plan["smem"] <= 232448 or (
                    plan["v_slots"] >= 8 - odd)
                assert all(r is None or r == (plan["k_slots"] == -(-skv // 64))
                           for r in plan["resident"])
                if odd:
                    assert plan["v_slots"] % 2 == 0 and plan["v_slots"] >= 4
                    assert plan["resident"][1] or (
                        plan["k_slots"] % 2 == 0 and plan["k_slots"] >= 4)
    with pytest.raises(ValueError, match="two-pass"):
        t_att.norm_two_pass_plan(64, 64 * 20000, 128)


@functools.lru_cache(maxsize=None)
def _packed(pack, params):
    """Layer 0 of `params()`'s layers packed by the port's `pack`, and the
    same arrays for JAX's kernels: the two packages' packings are byte for
    byte equal (tests/test_torch_vision.py), so no JAX packing runs here
    (arrays: JAX's cache clears leave them)."""
    layer = _layer0(pack(params_from_numpy(params()["layers"])), "torch")
    return {k: jnp.asarray(v.numpy()) for k, v in layer.items()}, layer


# "other" reads as exp2_post (the test above)
@pytest.mark.parametrize("mode", ["jnn", "exp2_pre", "exp2_post"],
                         indirect=True)
def test_fused_vit_block_matches_jax_in_each_mode(mode):
    jlp, tlp = _packed(t_vb.pack_vit_layers_fused, _vit_params)
    jx, tx = _block_input(1, 22)
    kw = dict(heads=VIT.heads, s_valid=VIT.seq_len, quick_gelu=True)
    want = j_vb.fused_vit_block(jx, jlp, interpret=True, **kw)
    got = t_vb.fused_vit_block(tx, tlp, **kw)
    assert torch.equal(got, t_vb.fused_vit_block_plain(tx, tlp, **kw))
    _close(got, np.asarray(want, np.float32), BLOCK_TOL, f"mode {mode}")


@pytest.mark.parametrize("mode", ["jnn"], indirect=True)
def test_fused_vit_block_504_matches_jax(mode):
    """The fused ViT block at ViT-L/14 504 px's token count (1,297 tokens
    padded to 1,312, one image, the narrow ViT's two heads of 64): on the
    card its attention takes the two-pass path; here the plain version,
    against JAX's kernel in interpret mode, within the block bound."""
    jlp, tlp = _packed(t_vb.pack_vit_layers_fused, _vit_params)
    rng = np.random.default_rng(24)
    s_valid, s_pad = 1297, 1312
    x = np.zeros((1, s_pad, VIT.width), np.float32)
    x[:, :s_valid] = rng.standard_normal((1, s_valid, VIT.width)) * 0.5
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    assert t_att.norm_path(s_pad, VIT.width // VIT.heads,
                           s_pad) == "two_pass"
    kw = dict(heads=VIT.heads, s_valid=s_valid, quick_gelu=True)
    want = j_vb.fused_vit_block(jx, jlp, interpret=True, **kw)
    got = t_vb.fused_vit_block(tx, tlp, **kw)
    _close(got[:, :s_valid], np.asarray(want, np.float32)[:, :s_valid],
           BLOCK_TOL, "1,297 tokens")


# the default mode's case is tests/test_torch_vision.py's
@pytest.mark.parametrize("mode", ["exp2_pre", "exp2_post"], indirect=True)
def test_fused_perceiver_block_normalises_first_in_every_mode(mode):
    jlp, tlp = _packed(t_pb.pack_perceiver_layers_fused, _pool_params)
    rng = np.random.default_rng(23)
    # one group (the first level's 6 queries): the softmax is per group
    q_pad, kv_pad, nq = 16, 32, POOL.stage_num[:1]
    kv_valid = tuple(n + 8 for n in nq)
    q = np.zeros((1, 1, q_pad, 128), np.float32)
    kv = np.zeros((1, 1, kv_pad, 128), np.float32)
    for g, n in enumerate(nq):
        q[:, g, :n] = rng.standard_normal((1, n, 128)) * 0.5
        kv[:, g, :n] = q[:, g, :n]
        kv[:, g, q_pad:q_pad + 8] = rng.standard_normal((1, 8, 128)) * 0.5
    jq, jkv = jnp.asarray(q, jnp.bfloat16), jnp.asarray(kv, jnp.bfloat16)
    kw = dict(heads=POOL.heads, group_nq=nq, kv_valid=kv_valid)
    want = j_pb.fused_perceiver_block(jq, jkv, jlp, interpret=True, **kw)
    got = t_pb.fused_perceiver_block(
        _t(np.asarray(jq.astype(jnp.float32))).to(torch.bfloat16),
        _t(np.asarray(jkv.astype(jnp.float32))).to(torch.bfloat16), tlp,
        **kw)
    _close(got, want, BLOCK_TOL, f"perceiver, mode {mode}")


def test_int4_vision_forward_raises():
    """A tower over int4 vision weights: the port raises ValueError naming
    the cause; JAX's W8A8 product, where its tower reaches the first
    projection, fails on the packed (in / 2, out) shape."""
    params = _vit_params()
    imgs = _images(1, 24)
    jq = j_quant.quantize_int4(jnp.asarray(params["layers"]["wq"][0]))
    with pytest.raises(TypeError):
        j_quant.w8a8_matmul(jnp.ones((2, VIT.width)), jq)
    tparams = params_from_numpy(params)
    tparams["layers"] = t_quant.quantize_vision_layers(tparams["layers"],
                                                       bits=4)
    with pytest.raises(ValueError, match="int8 weights"):
        t_vit.vit_encode(tparams, _t(imgs), _t_vit_cfg())
    with pytest.raises(ValueError, match="int8 weights"):
        t_quant.w8a8_matmul(torch.ones(2, VIT.width),
                            tparams["layers"]["wq"][0])
