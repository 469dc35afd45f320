"""Continuous-batching scheduler for multi-user serving.

Counterpart of `lhrs_bot_tpu/serve/scheduler.py` (`Request`,
`ContinuousBatchingScheduler`):

  * requests enter a queue; up to `max_batch` active sequences sit in fixed
    slots of one shared static KV cache (slot = row);
  * prefill runs per admission, split into power-of-two chunks of similar
    prompt widths, and installs the rows into the free slots of the cache,
    in place; decode runs over the whole slot array every tick (idle slots
    are masked, so one decode step serves every user);
  * a finished sequence frees its slot for the next queued request:
    admission happens between ticks;
  * a tick is `tokens_per_tick` decode steps. A slot freezes the moment it
    emits EOS or exhausts its budget (its cache length stops growing, later
    emissions are masked), so a k-step tick gives the tokens of k
    single-step ticks for greedy decoding. The tokens, the active mask and
    the budgets stay on the device through the tick; the host reads the
    (k, B) tokens and live flags once per tick.

Parameters arrive placed and cast: `params` (the vision side) and
`llama_params` as a `GenerationEngine` holds them (`engine.params`,
`engine.llama_params`). Sampled rows draw from a `torch.Generator`, so
sampled tokens differ from the JAX scheduler's; greedy rows and the top-p
mask are the same. Not ported: speculative ticks (`speculative > 0`,
`set_speculative`), meshes, and multi-image requests ((K, H, W, 3) with K >
1): each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import KVCache, llama_decode_step, llama_prefill
from ..models.vlm import VLMConfig, prepare_multimodal_inputs
from .engine import GenerationConfig, _sample_token_per_slot

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    input_ids: np.ndarray  # (T,) prompt token ids (may contain -200)
    image: Optional[np.ndarray] = None  # (H, W, 3) uint8
    max_new_tokens: int = 128
    # per-request sampling (None -> the scheduler's GenerationConfig
    # defaults); temperature 0 means greedy regardless of top_p
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # filled by the scheduler:
    output_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    cancelled: bool = False
    error: Optional[str] = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ContinuousBatchingScheduler:
    def __init__(
        self,
        cfg: VLMConfig,
        params,
        llama_params,
        *,
        max_batch: int = 8,
        max_seq_len: int = 1024,
        compute_dtype: torch.dtype = torch.bfloat16,
        cache_dtype: torch.dtype = torch.bfloat16,
        eos_token_id: int = 2,
        pad_token_id: int = 0,
        prompt_bucket: int = 64,
        tokens_per_tick: int = 8,
        gen_cfg: Optional[GenerationConfig] = None,
        generator: Optional[torch.Generator] = None,
        device="cuda",
        mesh=None,
        speculative: int = 0,
        adaptive_tick: bool = False,  # shrink ticks near completions
    ):
        if mesh is not None or speculative:
            raise NotImplementedError("meshes and speculative ticks are not "
                                      "ported to lhrs_bot_tpu_torch yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.adaptive_tick = bool(adaptive_tick)
        self.params = {k: v for k, v in params.items()
                       if k not in ("llama", "lora")}
        self.llama_params = llama_params
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.compute_dtype = compute_dtype
        self.gen_cfg = gen_cfg or GenerationConfig(
            eos_token_id=eos_token_id, pad_token_id=pad_token_id)
        self.eos = self.gen_cfg.eos_token_id
        self.pad = self.gen_cfg.pad_token_id
        self.generator = (generator if generator is not None else
                          torch.Generator(self.device).manual_seed(0))
        self.prompt_bucket = prompt_bucket
        self.tokens_per_tick = max(1, int(tokens_per_tick))

        self.cache_dtype = cache_dtype
        self.cache = self._make_cache()
        # per-slot host state
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_budget = np.zeros(max_batch, np.int32)
        self.last_tokens = np.full(max_batch, self.pad, np.int32)
        self.active = np.zeros(max_batch, bool)
        # per-slot sampling knobs (temp <= 0 -> greedy row)
        g = self.gen_cfg
        self._default_temp = float(g.temperature) if g.do_sample else 0.0
        self._default_top_p = float(g.top_p)
        self.slot_temp = np.zeros(max_batch, np.float32)
        self.slot_top_p = np.ones(max_batch, np.float32)
        # the k of the last step() (observability, and the adaptive tests)
        self.last_tick_k = 0

    @staticmethod
    def _bucket_sizes(n: int):
        """Split an admission of n requests into power-of-two chunks,
        largest first, so a trickle of one request prefills a (1, width)
        batch, not a (max_batch, width) one."""
        out = []
        b = 1
        while b * 2 <= n:
            b *= 2
        while n:
            while b > n:
                b //= 2
            out.append(b)
            n -= b
        return out

    def set_speculative(self, width: int) -> None:
        raise NotImplementedError("speculative ticks are not ported to "
                                  "lhrs_bot_tpu_torch yet")

    def set_tokens_per_tick(self, k: int) -> None:
        """Change the number of decode steps per tick."""
        self.tokens_per_tick = max(1, int(k))

    # a masked (all-frozen) step costs one weight read, an extra tick one
    # host round trip: overshooting the target by a few masked steps is
    # cheaper than cascading another tick
    _TICK_OVERSHOOT_MAX = 4

    def _tick_k(self, waiting: bool) -> int:
        """Adaptive tick size: never run far past the point every slot is
        frozen, and shrink to the earliest scheduled completion when
        requests wait for a slot (a freed slot is admittable only between
        ticks). Snapped to a power of two: up when the overshoot is at most
        _TICK_OVERSHOOT_MAX masked steps, down otherwise. EOS cannot be
        predicted, so this only tightens budget-limited completions."""
        k = self.tokens_per_tick
        if not self.adaptive_tick:
            return k
        budgets = self.slot_budget[self.active]
        if k <= 1 or budgets.size == 0:
            return 1
        cap = max(1, int(budgets.min() if waiting else budgets.max()))
        if cap >= k:
            return k
        up = 1 << (cap - 1).bit_length()  # pow2 >= cap
        if up - cap <= self._TICK_OVERSHOOT_MAX:
            return min(k, up)
        return up // 2

    # -- cache-strategy hooks (overridden by the paged scheduler) ------------

    def _make_cache(self):
        return KVCache.create(self.cfg.llama, self.max_batch,
                              self.max_seq_len, dtype=self.cache_dtype,
                              device=self.device)

    def _decode(self, cache, embeds):
        return llama_decode_step(self.llama_params, self.cfg.llama, cache,
                                 inputs_embeds=embeds,
                                 compute_dtype=self.compute_dtype)

    @staticmethod
    def _freeze_lengths(new_cache, old_cache, act):
        """Frozen slots must not grow their cache."""
        return dataclasses.replace(
            new_cache, length=torch.where(act, new_cache.length,
                                          old_cache.length))

    def _admission_capacity(self, requests, free) -> int:
        """How many of `requests` (FIFO prefix) fit this admission."""
        return len(free)

    def _reserve_rows(self, slots, batch, spliced, budgets, width):
        """Reserve per-slot cache room before prefill; returns the extra
        prefill argument (page-table rows for the paged subclass)."""
        return None

    def _room(self, slot: int, spliced: int, req=None) -> int:
        """Cache room left for new tokens after a spliced prompt."""
        return self.max_seq_len - spliced

    def _packed_ids(self, req):
        """Token ids to pack into the prefill for this request (the paged
        scheduler packs only the suffix its prefix cache lacks)."""
        return req.input_ids

    def _release_slot(self, slot: int) -> None:
        """Free per-slot cache resources on completion or cancel."""

    # -- device work ---------------------------------------------------------

    def _splice(self, input_ids, images, seq_lens):
        """The spliced decoder inputs of a bucketed (b, width) batch."""
        width = input_ids.shape[1]
        return prepare_multimodal_inputs(
            self.params, self.cfg, input_ids, images,
            attention_mask=torch.arange(width, device=self.device)[None, :]
            < seq_lens[:, None],
            compute_dtype=self.compute_dtype, llama_params=self.llama_params)

    def _prefill(self, input_ids, images, slot_idx, seq_lens, temps, top_ps,
                 extra, *, width: int):
        """Prefill a bucketed (b, width) batch into the slots named by
        slot_idx, in place (the other slots keep their rows); returns the
        first tokens (b,) and the cache."""
        spliced = self._splice(input_ids, images, seq_lens)
        logits, cache = llama_prefill(
            self.llama_params, self.cfg.llama, self.cache,
            inputs_embeds=spliced.inputs_embeds, prompt_len=spliced.seq_len,
            compute_dtype=self.compute_dtype, slots=slot_idx)
        return _sample_token_per_slot(logits, self.generator, temps,
                                      top_ps), cache

    def _tick(self, k: int, sample: bool):
        """`k` decode steps over all slots; returns the (k, B) tokens and
        the (k, B) flags of which emissions were live, on the host. Slots
        that sample draw from the generator in step order."""
        dev = self.device
        toks = torch.as_tensor(self.last_tokens, device=dev)
        act = torch.as_tensor(self.active, device=dev)
        budg = torch.as_tensor(self.slot_budget, device=dev)
        temps = torch.as_tensor(self.slot_temp, device=dev)
        top_ps = torch.as_tensor(self.slot_top_p, device=dev)
        embed = self.llama_params["embed_tokens"]
        cache = self.cache
        emitted, live = [], []
        for _ in range(k):
            logits, new_cache = self._decode(cache,
                                             embed[toks.long()][:, None])
            if sample:
                nxt = _sample_token_per_slot(logits, self.generator, temps,
                                             top_ps)
            else:
                nxt = logits.argmax(dim=-1).to(torch.int32)
            emit = torch.where(act, nxt, self.pad)
            budg = torch.where(act, budg - 1, budg)
            new_act = act & (nxt != self.eos) & (budg > 0)
            cache = self._freeze_lengths(new_cache, cache, act)
            emitted.append(emit)
            live.append(act)
            toks, act = emit, new_act
        self.cache = cache
        return (torch.stack(emitted).cpu().numpy(),
                torch.stack(live).cpu().numpy())

    # -- host-side scheduling ------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch) if not self.active[i]]

    def admit(self, requests: List[Request]) -> int:
        """Pack as many requests as fit into free slots; returns #admitted.
        FIFO decides who is admitted; within the admitted set, prompts are
        sorted by length so each power-of-two chunk packs similar widths."""
        for req in requests:
            if self._image_count(req) > 1:
                raise NotImplementedError(
                    f"request {req.uid}: multi-image requests are not ported "
                    "to lhrs_bot_tpu_torch yet")
        free = self._free_slots()
        batch = requests[:self._admission_capacity(requests, free)]
        if not batch:
            return 0
        batch = sorted(batch, key=lambda r: len(self._packed_ids(r)),
                       reverse=True)
        done = 0
        for b in self._bucket_sizes(len(batch)):
            self._admit_chunk(batch[done:done + b], free[done:done + b])
            done += b
        return len(batch)

    @staticmethod
    def _image_count(req) -> int:
        """0, 1, or K (for a (K, H, W, 3) request)."""
        if req.image is None:
            return 0
        return req.image.shape[0] if req.image.ndim == 4 else 1

    def _admit_chunk(self, batch: List[Request], slots: List[int]) -> None:
        b = len(batch)
        t = max(len(self._packed_ids(r)) for r in batch)
        has_img = any(r.image is not None for r in batch)
        # an image marker expands the spliced prefill by num_query - 1
        # tokens, so the prompt width must leave that room in the cache
        nq = self.cfg.pooler.num_query
        width_cap = self.max_seq_len - has_img * (nq - 1)
        width = min(_round_up(t, self.prompt_bucket), width_cap)
        if t > width:
            logger.warning("prompt length %d exceeds admissible width %d "
                           "(max_seq_len=%d) - truncating", t, width,
                           self.max_seq_len)
        ids = np.full((b, width), self.pad, np.int32)
        lens = np.zeros(b, np.int32)
        imgs = None
        if has_img:
            h = self.cfg.vit.image_size
            imgs = np.zeros((b, h, h, 3), np.uint8)
        for row, req in enumerate(batch):
            pids = self._packed_ids(req)
            n = min(len(pids), width)
            ids[row, :n] = pids[:n]
            lens[row] = n
            # markers beyond the request's own image count must not splice
            # another row's zero image: they become token 0
            neg = np.flatnonzero(ids[row, :n] < 0)
            for j in neg[self._image_count(req):]:
                ids[row, j] = 0
            if req.image is not None:
                im = req.image
                imgs[row] = im[0] if im.ndim == 4 else im

        temps = np.asarray(
            [self._default_temp if r.temperature is None else r.temperature
             for r in batch], np.float32)
        top_ps = np.asarray(
            [self._default_top_p if r.top_p is None else r.top_p
             for r in batch], np.float32)
        self.slot_temp[slots] = temps
        self.slot_top_p[slots] = top_ps

        # spliced prompt lengths and budgets clamped to the cache room,
        # before the prefill: the paged subclass reserves pages from them
        spliced_lens, budgets = [], []
        for row, req in enumerate(batch):
            spliced = int(lens[row])
            if req.image is not None and (ids[row, :spliced] < 0).any():
                spliced += nq - 1
            room = max(1, self._room(slots[row], spliced, req))
            if req.max_new_tokens > room:
                logger.warning(
                    "request %d: max_new_tokens %d exceeds cache room %d "
                    "after a %d-token spliced prompt - clamping",
                    req.uid, req.max_new_tokens, room, spliced)
            spliced_lens.append(spliced)
            budgets.append(min(req.max_new_tokens, room))
        extra = self._reserve_rows(slots, batch, spliced_lens, budgets, width)

        dev = self.device
        first, self.cache = self._prefill(
            torch.as_tensor(ids, device=dev),
            None if imgs is None else torch.as_tensor(imgs, device=dev),
            torch.as_tensor(np.asarray(slots, np.int32), device=dev),
            torch.as_tensor(lens, device=dev),
            torch.as_tensor(temps, device=dev),
            torch.as_tensor(top_ps, device=dev), extra, width=width)
        first_host = first.cpu().numpy()
        for row, (slot, req) in enumerate(zip(slots, batch)):
            self.slot_req[slot] = req
            self.slot_budget[slot] = budgets[row]
            self.active[slot] = True
            self._push_token(slot, int(first_host[row]))

    def _push_token(self, slot: int, tok: int) -> None:
        req = self.slot_req[slot]
        self.slot_budget[slot] -= 1
        if tok == self.eos or self.slot_budget[slot] <= 0:
            if tok != self.eos:
                req.output_ids.append(tok)
            req.done = True
            self.active[slot] = False
            self.slot_req[slot] = None
            self.last_tokens[slot] = self.pad
            self._release_slot(slot)
        else:
            req.output_ids.append(tok)
            self.last_tokens[slot] = tok

    def cancel(self, uid: int) -> bool:
        """Abort an in-flight request: mark it done and cancelled and free
        its slot at once (the next tick masks it, and it is admittable
        right away). Tokens already emitted stay on the request. Returns
        False if no active slot holds `uid`."""
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.uid == uid:
                req.cancelled = True
                req.done = True
                self.active[slot] = False
                self.slot_req[slot] = None
                self.slot_budget[slot] = 0
                self.last_tokens[slot] = self.pad
                self._release_slot(slot)
                return True
        return False

    def fail_all(self) -> None:
        """Free every slot and its cache resources after a fatal batch
        error (the serving worker's recovery path)."""
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or self.active[slot]:
                self.slot_req[slot] = None
                self._release_slot(slot)
        self.active[:] = False

    def step(self, waiting: int = 0) -> int:
        """One tick (up to `tokens_per_tick` tokens per active slot) over
        all slots; returns #still-active. `waiting` is the number of
        requests queued for a slot: the adaptive tick then shrinks to the
        earliest scheduled completion (see _tick_k)."""
        if not self.active.any():
            self.last_tick_k = 0
            return 0
        k = self._tick_k(waiting > 0)
        self.last_tick_k = k
        toks_host, live_host = self._tick(
            k, sample=bool(self.slot_temp[self.active].max(initial=0.0) > 0))
        for i in range(toks_host.shape[0]):
            for slot in range(self.max_batch):
                if live_host[i, slot] and self.active[slot]:
                    self._push_token(slot, int(toks_host[i, slot]))
        return int(self.active.sum())

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a request list to completion (admission interleaved with
        ticks: later requests join as slots free up)."""
        pending = list(requests)
        n = self.admit(pending)
        pending = pending[n:]
        while self.active.any() or pending:
            if pending and self._free_slots():
                n = self.admit(pending)
                pending = pending[n:]
            self.step(waiting=len(pending))
        return requests
