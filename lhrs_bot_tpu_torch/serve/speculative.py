"""Prompt-lookup speculation for the continuous-batching scheduler and
the engine's speculative stream (which runs these on one row).

Counterpart of `lhrs_bot_tpu/serve/speculative.py`. Each round a slot
proposes the tokens that followed the most recent earlier occurrence of the
last n-gram of its history (`propose_from_history`), the whole window is
verified by one continuation prefill (`llama_prefill_continue` with
`return_all_logits`), and the agreeing prefix plus one correction token is
kept (`accept_window`, or `accept_window_sampled` for rows that sample).
Greedy rows emit exactly the plain tick's tokens where the window and
the decode step compute the same logits (in float32). Everything here runs on
the device with no host sync, so a tick of k rounds reads its tokens once.

Sampled rows draw from a `torch.Generator`, so their tokens differ from the
JAX scheduler's draws; the acceptance rule and its distribution are the
same (the tests hold its marginal to plain sampling).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .engine import _multinomial, _top_p_logits, _uniform

_NO_TOKEN = -(1 << 31)  # a pattern token past the history: matches nothing
NGRAM = 2  # the engine's and the scheduler's lookup pattern length


def propose_from_history(hist: torch.Tensor, hist_len: torch.Tensor, *,
                         ngram: int, width: int, min_token: int = 3
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of `hist` (B, S) int32, valid up to hist_len (B,): the
    most recent position where the last `ngram` tokens occurred earlier
    (ending strictly before the history's end), and the `width` tokens that
    followed it, cut at the first special token (< min_token). Returns
    (proposals (B, width) int32, n_prop (B,) int32); a row with no usable
    match gets n_prop 0. Proposal columns at or past n_prop are not
    meaningful."""
    b, s = hist.shape
    dev = hist.device
    hist_len = hist_len.to(dev).long()
    pos_pat = hist_len[:, None] - ngram + torch.arange(ngram, device=dev)
    pat = torch.where(pos_pat < s,
                      hist.gather(1, pos_pat.clamp(0, s - 1)),
                      torch.full_like(pos_pat, _NO_TOKEN, dtype=hist.dtype))
    p = s - ngram + 1
    match = torch.ones((b, p), dtype=torch.bool, device=dev)
    for j in range(ngram):
        match &= hist[:, j:j + p] == pat[:, j:j + 1]
    pos = torch.arange(p, device=dev)[None, :]
    valid = (match & (pos + ngram <= hist_len[:, None] - 1)
             & (hist_len[:, None] >= ngram + 1))
    best = torch.where(valid, pos, -1).amax(dim=1)  # (B,)
    histp = torch.nn.functional.pad(hist, (0, width))
    first = (best.clamp(min=0) + ngram).clamp(max=s)
    follow = histp.gather(
        1, first[:, None] + torch.arange(width, device=dev)[None, :])
    avail = (hist_len - (best + ngram)).clamp(0, width)
    iota = torch.arange(width, device=dev)[None, :]
    bad = (follow < min_token) & (iota < avail[:, None])
    first_bad = torch.where(bad, iota, width).amin(dim=1)
    n = torch.where(best >= 0, torch.minimum(avail, first_bad), 0)
    return follow.to(torch.int32), n.to(torch.int32)


def _warp_logits(logits: torch.Tensor, temps: torch.Tensor,
                 top_ps: torch.Tensor) -> torch.Tensor:
    """Temperature + top-p of (B, W1, V) verify logits: the plain tick's
    warp (`_sample_token_per_slot`) at every window position, so sampled
    speculation targets the same distribution."""
    b, w1, v = logits.shape
    return _top_p_logits(logits.reshape(b * w1, v),
                         temps.repeat_interleave(w1),
                         top_ps.repeat_interleave(w1)).reshape(b, w1, v)


def accept_window(prop: torch.Tensor, n_prop: torch.Tensor,
                  preds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy acceptance: prop (B, W), n_prop (B,), preds (B, W + 1) the
    verify logits' argmaxes (preds[:, i] follows window position i, whose
    position 0 is the slot's last real token). Returns (p (B,) accepted
    proposals, corr (B,) the token after them), int32."""
    width = prop.shape[1]
    iota = torch.arange(width, device=prop.device)[None, :]
    agree = (prop == preds[:, :width]) & (iota < n_prop[:, None])
    p = agree.int().cumprod(dim=1).sum(dim=1)
    corr = preds.gather(1, p[:, None].long())[:, 0]
    return p.to(torch.int32), corr.to(torch.int32)


def accept_window_sampled(prop: torch.Tensor, n_prop: torch.Tensor,
                          logits_all: torch.Tensor,
                          generator: Optional[torch.Generator],
                          temps: torch.Tensor, top_ps: torch.Tensor,
                          draw=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative sampling for a deterministic draft (JAX
    `accept_window_sampled`): a sampling row (temp > 0) accepts proposal i
    with probability p_i(x_i) under the warped verify distribution, and at
    the first rejection draws the correction from p with x's mass removed
    (from p at the next position when every proposal was accepted), so its
    tokens are distributed as plain sampling's. Greedy rows (temp <= 0)
    give `accept_window`'s result exactly. prop (B, W), n_prop (B,),
    logits_all (B, W + 1, V) float32; draws from `generator` (`draw`: a
    data group's rows of the whole batch's draws, `engine._multinomial`)."""
    b, width = prop.shape
    dev = prop.device
    iota = torch.arange(width, device=dev)[None, :]
    in_window = iota < n_prop[:, None]
    greedy_preds = logits_all.argmax(dim=-1).to(torch.int32)
    ok_greedy = (prop == greedy_preds[:, :width]) & in_window

    probs = torch.softmax(_warp_logits(logits_all, temps, top_ps), dim=-1)
    p_tok = probs[:, :width].gather(
        -1, prop.clamp(min=0).long()[..., None])[..., 0]
    u = _uniform((b, width), generator, dev, draw)
    ok_sample = (u < p_tok) & in_window

    sampling = temps > 0
    ok = torch.where(sampling[:, None], ok_sample, ok_greedy)
    p = ok.int().cumprod(dim=1).sum(dim=1)

    probs_p = probs.gather(
        1, p.long()[:, None, None].expand(b, 1, probs.shape[-1]))[:, 0]
    rejected = p < n_prop
    rej_tok = prop.gather(1, p.clamp(max=width - 1).long()[:, None])[:, 0]
    drop = (torch.arange(probs.shape[-1], device=dev)[None, :]
            == rej_tok[:, None]) & rejected[:, None]
    dist = torch.where(drop, 0.0, probs_p)
    corr_sampled = _multinomial(dist + 1e-30, generator, draw)
    corr_greedy = greedy_preds.gather(1, p.long()[:, None])[:, 0]
    corr = torch.where(sampling, corr_sampled.to(torch.int32), corr_greedy)
    return p.to(torch.int32), corr.to(torch.int32)
