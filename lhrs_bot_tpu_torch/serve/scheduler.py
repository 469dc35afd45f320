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
mask are the same. A request carries no image, one (H, W, 3) or K (K, H,
W, 3) images, marker k taking image k; markers beyond a request's image
count become token 0.

`speculative=N` (or `set_speculative(N)`) turns each tick into k
speculative rounds over all slots (serve/speculative.py): a slot proposes
up to N tokens from its own history (prompt + output), the windows are
verified in one continuation prefill, and each slot advances by the
accepted proposals plus one token, with EOS and budget freezing as in the
plain tick; a slot that is not active writes no row. Greedy slots emit the
plain tick's tokens in float32; in bf16 they may part from them where the
top-2 margin lies within bf16 rounding, since a round attends through
plain PyTorch and a plain tick through the decode kernel. Every round
verifies a window for every active slot, a proposal or none, so a round
costs more than a decode step. The rounds are a Python loop whose tokens stay on the
device; the host reads them once, at the end of the tick. The history is
the host's, uploaded each tick.

`mesh` (a `parallel.mesh.Mesh`; the parameters an engine's over the same
mesh, already sliced) serves over JAX's ("data", "model") mesh, one
process a rank, as the JAX scheduler runs over its mesh. On the model axis
the decoder runs tensor parallel: each rank's cache (or page pool) holds
H / tp heads, the vision tower runs replicated, and every device token is
broadcast from the model group's first rank. On the data axis slot s
lives on data group s // (max_batch / dp), as JAX's `kv_cache_spec` places
it (`max_batch` must be a multiple of dp): each group's cache holds its
max_batch / dp slots, an admitted row is prefilled (vision tower
included) by the group that owns its slot only, a tick and a speculative
round run over the group's own slots, and the tokens, live flags and
accepted proposals are gathered over the data axis in slot order
(`_gather_slots`) before the host reads them. The paged scheduler keeps
the whole pool on every data group (JAX shards it over "model" only), so
there every group runs every slot. Either way the host's state and its
decisions (admission, stops, slots, pages) are the same on every rank as
long as every rank makes the same calls. `run(requests)` on every rank
does that; for a server, the rank that serves calls `lead()`, after which
each of its `admit`, `step`, `cancel` and `fail_all` is broadcast (the
requests pickled) to every rank of the mesh before it runs, and the other
ranks call `follow()`, which runs what the leader broadcasts until its
`release_followers()`.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.llama import (KVCache, llama_decode_step, llama_prefill,
                            llama_prefill_continue)
from ..models.vlm import VLMConfig, prepare_multimodal_inputs
from .engine import (GenerationConfig, _multinomial, _sample_token_per_slot,
                     check_serving_mesh)
from .speculative import (NGRAM, accept_window, accept_window_sampled,
                          propose_from_history)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    input_ids: np.ndarray  # (T,) prompt token ids (may contain -200)
    image: Optional[np.ndarray] = None  # (H, W, 3) or (K, H, W, 3) uint8
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


def check_image_room(n_ids: int, k: int, num_query: int,
                     max_seq_len: int) -> None:
    """Raise ValueError when a prompt of `n_ids` tokens with `k` images
    (each marker spliced into `num_query` rows) leaves no room below
    `max_seq_len`: its admission width would be cut below the prompt, or
    to nothing."""
    if k and n_ids + k * (num_query - 1) >= max_seq_len:
        raise ValueError(
            f"{k} image(s) expand the {n_ids}-token prompt by "
            f"{k * (num_query - 1)} tokens, leaving no room in a cache of "
            f"{max_seq_len} tokens")


class ContinuousBatchingScheduler:
    _supports_spec = True  # the paged subclass's rows live behind a table
    _splits_slots = True  # over the data axis (the paged pool is whole)

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
        speculative: int = 0,  # prompt-lookup window per round (greedy)
        adaptive_tick: bool = False,  # shrink ticks near completions
    ):
        check_serving_mesh(mesh, max_batch if self._splits_slots else None)
        self.mesh = mesh
        self.tp = mesh.tp_axis if mesh is not None else None
        # the data axis the slots are split over: this group's slots are
        # [slot0, slot0 + n_local)
        self.dp = (mesh.dp_axis if mesh is not None and self._splits_slots
                   else None)
        self.n_local = max_batch // (1 if self.dp is None else self.dp.size)
        self.slot0 = 0 if self.dp is None else self.dp.index * self.n_local
        # the axis the leader's calls go out on (`lead` / `follow`): the
        # whole mesh under a data axis; a server gives it a group that
        # waits as long as it idles
        self.channel = (mesh.world if mesh is not None and mesh.dp > 1
                        else self.tp)
        self._leading = False
        self._check_spec(speculative)
        self.speculative = int(speculative)
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

    def _check_spec(self, width: int) -> None:
        if width and not self._supports_spec:
            raise ValueError(
                "speculative decoding needs the contiguous KV cache (the "
                "paged scheduler's rows live behind a page table)")

    def set_speculative(self, width: int) -> None:
        """Speculative ticks of `width` proposals a round (0: plain)."""
        self._check_spec(width)
        self.speculative = int(width)

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

    # -- tensor-parallel lockstep --------------------------------------------

    @property
    def heads(self) -> int:
        """The attention heads this rank's cache holds."""
        return self.cfg.llama.num_attention_heads // (
            1 if self.tp is None else self.tp.size)

    def _agree(self, t: torch.Tensor) -> torch.Tensor:
        """The model group's first rank's device tokens on every rank."""
        return t if self.tp is None else self.tp.broadcast(t.contiguous())

    def _local(self, a: np.ndarray) -> np.ndarray:
        """This data group's slots of a per-slot host array."""
        return a[self.slot0:self.slot0 + self.n_local]

    def _slot_draw(self):
        """The random draws' share of this data group's slots
        (`engine._multinomial`): None without a data axis."""
        if self.dp is None:
            return None
        return slice(self.slot0, self.slot0 + self.n_local), self.max_batch

    def _gather_slots(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """`t`, whose `dim` runs over this group's slots, with every slot
        on every rank: the data groups' slots concatenated in group order,
        which is slot order."""
        return t if self.dp is None else self.dp.all_gather(t, dim=dim)

    def lead(self) -> None:
        """From now on broadcast each public call to the ranks that
        `follow()` (the serving rank of a server over a mesh)."""
        self._leading = self.channel is not None

    def _publish(self, op: str, *args) -> None:
        if self._leading:
            self.channel.broadcast_object((op, args))

    def release_followers(self) -> None:
        """End the followers' `follow()` loops."""
        self._publish("stop")

    def follow(self) -> None:
        """Run the leader's calls, as it broadcasts them, until it
        releases the followers. An error in a call ends the loop and
        propagates: the ranks may then stand at different collectives,
        which no rank can mend, so the follower's process exits non-zero
        (torchrun then ends the group) and a rank left waiting on it
        raises at its group's timeout."""
        while True:
            op, args = self.channel.broadcast_object()
            if op == "stop":
                return
            getattr(self, "_" + op)(*args)

    # -- cache-strategy hooks (overridden by the paged scheduler) ------------

    def _make_cache(self):
        return KVCache.create(self.cfg.llama, self.n_local,
                              self.max_seq_len, dtype=self.cache_dtype,
                              device=self.device, heads=self.heads)

    def _decode(self, cache, embeds):
        return llama_decode_step(self.llama_params, self.cfg.llama, cache,
                                 inputs_embeds=embeds,
                                 compute_dtype=self.compute_dtype, tp=self.tp)

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
                 extra, *, width: int, draw=None):
        """Prefill a bucketed (b, width) batch into the slots named by
        slot_idx, in place (the other slots keep their rows); returns the
        first tokens (b,) and the cache. `draw`: the rows' share of the
        admitted batch's random draws (`engine._multinomial`)."""
        spliced = self._splice(input_ids, images, seq_lens)
        logits, cache = llama_prefill(
            self.llama_params, self.cfg.llama, self.cache,
            inputs_embeds=spliced.inputs_embeds, prompt_len=spliced.seq_len,
            compute_dtype=self.compute_dtype, slots=slot_idx, tp=self.tp)
        return _sample_token_per_slot(logits, self.generator, temps,
                                      top_ps, draw), cache

    def _tick(self, k: int, sample: bool):
        """`k` decode steps over this group's slots; returns the (k, B)
        tokens and the (k, B) flags of which emissions were live, of every
        slot, on the host. Slots that sample draw from the generator in
        step order."""
        dev = self.device
        toks = torch.as_tensor(self._local(self.last_tokens), device=dev)
        act = torch.as_tensor(self._local(self.active), device=dev)
        budg = torch.as_tensor(self._local(self.slot_budget), device=dev)
        temps = torch.as_tensor(self._local(self.slot_temp), device=dev)
        top_ps = torch.as_tensor(self._local(self.slot_top_p), device=dev)
        embed = self.llama_params["embed_tokens"]
        cache = self.cache
        emitted, live = [], []
        for _ in range(k):
            logits, new_cache = self._decode(cache,
                                             embed[toks.long()][:, None])
            if sample:
                nxt = _sample_token_per_slot(logits, self.generator, temps,
                                             top_ps, self._slot_draw())
            else:
                nxt = logits.argmax(dim=-1).to(torch.int32)
            nxt = self._agree(nxt)
            emit = torch.where(act, nxt, self.pad)
            budg = torch.where(act, budg - 1, budg)
            new_act = act & (nxt != self.eos) & (budg > 0)
            cache = self._freeze_lengths(new_cache, cache, act)
            emitted.append(emit)
            live.append(act)
            toks, act = emit, new_act
        self.cache = cache
        both = self._gather_slots(torch.stack(
            [torch.stack(emitted), torch.stack(live).to(torch.int32)]), 2)
        both = both.cpu().numpy()
        return both[0], both[1].astype(bool)

    def _spec_tick(self, rounds: int, sample: bool):
        """`rounds` speculative rounds over all slots (serve/
        speculative.py). Each round a slot proposes up to `speculative`
        tokens from its history, the windows [last token] + proposals are
        verified by one continuation prefill at each slot's cache length
        (an inactive slot's suffix is 0: it writes no row), and the slot
        emits its accepted proposals and the correction token, clamped to
        its budget; its cache length then counts only the rows of the
        emitted tokens (the rejected ones are overwritten later). Returns
        the (rounds, B, width + 1) tokens and live flags of every slot, on
        the host; a group runs its own slots."""
        dev = self.device
        width = self.speculative
        hist_np, hlen_np = self._history_arrays()
        hist = torch.as_tensor(self._local(hist_np), device=dev)
        hlen = torch.as_tensor(self._local(hlen_np), device=dev).long()
        toks = torch.as_tensor(self._local(self.last_tokens), device=dev)
        act = torch.as_tensor(self._local(self.active), device=dev)
        budg = torch.as_tensor(self._local(self.slot_budget), device=dev)
        temps = torch.as_tensor(self._local(self.slot_temp), device=dev)
        top_ps = torch.as_tensor(self._local(self.slot_top_p), device=dev)
        embed = self.llama_params["embed_tokens"]
        cache = self.cache
        s_max = cache.k.shape[3]
        s_hist = hist.shape[1]
        i2 = torch.arange(width + 1, device=dev)[None, :]
        emitted, lives = [], []
        for _ in range(rounds):
            prop, n_prop = propose_from_history(hist, hlen, ngram=NGRAM,
                                                width=width)
            # the verify writes 1 + n rows at the cache length: proposals
            # are clamped to the cache's room and to the budget (past
            # budget - 1 none could be emitted)
            room = s_max - cache.length - 1
            n_prop = torch.minimum(
                n_prop, torch.minimum(room, budg - 1).clamp(0, width))
            window = torch.cat([toks[:, None], prop], dim=1)
            suffix = torch.where(act, 1 + n_prop, 0).to(torch.int32)
            logits_all, new_cache = llama_prefill_continue(
                self.llama_params, self.cfg.llama, cache,
                inputs_embeds=embed[window.clamp(min=0).long()],
                suffix_len=suffix, start=cache.length,
                compute_dtype=self.compute_dtype, return_all_logits=True,
                tp=self.tp)
            if sample:
                p, corr = accept_window_sampled(prop, n_prop, logits_all,
                                                self.generator, temps,
                                                top_ps, self._slot_draw())
            else:
                p, corr = accept_window(
                    prop, n_prop, logits_all.argmax(dim=-1).to(torch.int32))
            if self.tp is not None:
                p, corr = self._agree(torch.stack([p.to(corr.dtype), corr]))
            # emitted: the accepted proposals, then the correction token,
            # up to the budget (the token that exhausts it is emitted)
            e = torch.where(act, torch.minimum(p + 1, budg), 0)
            tok_out = torch.where(i2 < p[:, None],
                                  torch.nn.functional.pad(prop, (0, 1)),
                                  corr[:, None])
            live = (i2 < e[:, None]) & act[:, None]
            emit = torch.where(live, tok_out, self.pad)
            budg = budg - e
            eos_corr = (e == p + 1) & (corr == self.eos)
            new_act = act & (budg > 0) & ~eos_corr
            cache = dataclasses.replace(
                new_cache, length=torch.where(act, cache.length + e,
                                              cache.length).to(torch.int32))
            # the history gains the emitted tokens but a final EOS; writes
            # past its end go to a spare column that is dropped
            nk = e - eos_corr.to(e.dtype)
            dest = torch.where((i2 < nk[:, None]) & act[:, None],
                               hlen[:, None] + i2, s_hist).clamp(max=s_hist)
            hist = torch.nn.functional.pad(hist, (0, 1)).scatter(
                1, dest, emit)[:, :s_hist]
            hlen = hlen + nk
            emitted.append(emit)
            lives.append(live)
            toks = torch.where(new_act, corr, self.pad)
            act = new_act
        self.cache = cache
        both = self._gather_slots(torch.stack(
            [torch.stack(emitted), torch.stack(lives).to(torch.int32)]), 2)
        both = both.cpu().numpy()
        return both[0], both[1].astype(bool)

    # -- host-side scheduling ------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i in range(self.max_batch) if not self.active[i]]

    def admit(self, requests: List[Request]) -> int:
        """Pack as many requests as fit into free slots; returns #admitted.
        FIFO decides who is admitted; within the admitted set, prompts are
        sorted by length so each power-of-two chunk packs similar widths."""
        self._publish("admit", requests)
        return self._admit(requests)

    def _admit(self, requests: List[Request]) -> int:
        free = self._free_slots()
        batch = requests[:self._admission_capacity(requests, free)]
        if not batch:
            return 0
        for r in batch:  # before any state changes
            check_image_room(len(r.input_ids), self._image_count(r),
                             self.cfg.pooler.num_query, self.max_seq_len)
        batch = sorted(batch, key=lambda r: len(self._packed_ids(r)),
                       reverse=True)
        done = 0
        for b in self._bucket_sizes(len(batch)):
            self._admit_chunk(batch[done:done + b], free[done:done + b])
            done += b
        return len(batch)

    @staticmethod
    def _image_count(req) -> int:
        """0, 1, or K (for a (K, H, W, 3) multi-image request)."""
        if req.image is None:
            return 0
        return req.image.shape[0] if req.image.ndim == 4 else 1

    def _admit_chunk(self, batch: List[Request], slots: List[int]) -> None:
        b = len(batch)
        t = max(len(self._packed_ids(r)) for r in batch)
        k_max = max(self._image_count(r) for r in batch)
        # each image marker expands the spliced prefill by num_query - 1
        # tokens, so the prompt width must leave that room in the cache
        nq = self.cfg.pooler.num_query
        width_cap = self.max_seq_len - k_max * (nq - 1)
        width = min(_round_up(t, self.prompt_bucket), width_cap)
        if t > width:
            logger.warning("prompt length %d exceeds admissible width %d "
                           "(max_seq_len=%d%s) - truncating", t, width,
                           self.max_seq_len,
                           f", image expansion {k_max * (nq - 1)}"
                           if k_max else "")
        ids = np.full((b, width), self.pad, np.int32)
        lens = np.zeros(b, np.int32)
        imgs = None
        if k_max:
            h = self.cfg.vit.image_size
            # (b, H, W, 3) when every request has at most one image;
            # (b, K, H, W, 3) for a chunk with a multi-image request
            imgs = np.zeros((b, h, h, 3) if k_max == 1
                            else (b, k_max, h, h, 3), np.uint8)
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
                if k_max == 1:
                    imgs[row] = im[0] if im.ndim == 4 else im
                elif im.ndim == 4:
                    imgs[row, :im.shape[0]] = im
                else:
                    imgs[row, 0] = im

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
            # every marker left (surplus ones became token 0) has an image
            spliced = int(lens[row])
            spliced += int((ids[row, :spliced] < 0).sum()) * (nq - 1)
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
        # the rows whose slots this data group holds (every row without a
        # data axis): each row is prefilled by its slot's group alone
        own = np.asarray([row for row, slot in enumerate(slots)
                          if 0 <= slot - self.slot0 < self.n_local], np.int64)
        first = torch.zeros(b, dtype=torch.int32, device=dev)
        # a group's rows draw what they draw in the whole admitted batch
        draw = (None if self.dp is None
                else (torch.as_tensor(own, dtype=torch.long, device=dev), b))
        if own.size:
            first_own, self.cache = self._prefill(
                torch.as_tensor(ids[own], device=dev),
                None if imgs is None else torch.as_tensor(imgs[own],
                                                          device=dev),
                torch.as_tensor(np.asarray(slots, np.int32)[own]
                                - self.slot0, device=dev),
                torch.as_tensor(lens[own], device=dev),
                torch.as_tensor(temps[own], device=dev),
                torch.as_tensor(top_ps[own], device=dev), extra, width=width,
                draw=draw)
            first[torch.as_tensor(own, device=dev)] = self._agree(first_own)
        elif self.dp is not None:  # the batch's draw all the same
            _multinomial(torch.ones((0, self.cfg.llama.vocab_size),
                                    device=dev), self.generator, draw)
        if self.dp is not None:  # each row comes from one group: the sum
            self.dp.all_reduce(first)
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
        self._publish("cancel", uid)
        return self._cancel(uid)

    def _cancel(self, uid: int) -> bool:
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
        self._publish("fail_all")
        self._fail_all()

    def _fail_all(self) -> None:
        for slot in range(self.max_batch):
            if self.slot_req[slot] is not None or self.active[slot]:
                self.slot_req[slot] = None
                self._release_slot(slot)
        self.active[:] = False

    def _history_arrays(self):
        """(B, S) token history (prompt + emitted) of each active slot and
        its length, S = max_seq_len + speculative + 1: the proposal source
        of the speculative tick, rebuilt from the host's record each tick.
        A history longer than S keeps its most recent tokens."""
        s_hist = self.max_seq_len + self.speculative + 1
        hist = np.zeros((self.max_batch, s_hist), np.int32)
        hlen = np.zeros(self.max_batch, np.int32)
        for slot, req in enumerate(self.slot_req):
            if req is None or not self.active[slot]:
                continue
            toks = np.concatenate([
                np.asarray(req.input_ids, np.int64),
                np.asarray(req.output_ids, np.int64)]).astype(np.int32)
            toks = toks[-s_hist:]
            hist[slot, :len(toks)] = toks
            hlen[slot] = len(toks)
        return hist, hlen

    def _step_speculative(self, waiting: bool) -> int:
        # each round advances an active slot by at least one token, so the
        # adaptive tick's budget-based size never under-serves
        rounds = self._tick_k(waiting)
        self.last_tick_k = rounds
        toks_host, live_host = self._spec_tick(
            rounds, sample=bool(self.slot_temp[self.active].max(initial=0.0)
                                > 0))
        for r in range(toks_host.shape[0]):
            for i in range(toks_host.shape[2]):
                for slot in range(self.max_batch):
                    if live_host[r, slot, i] and self.active[slot]:
                        self._push_token(slot, int(toks_host[r, slot, i]))
        return int(self.active.sum())

    def step(self, waiting: int = 0) -> int:
        """One tick (up to `tokens_per_tick` tokens per active slot, or as
        many speculative rounds) over all slots; returns #still-active. `waiting` is the number of
        requests queued for a slot: the adaptive tick then shrinks to the
        earliest scheduled completion (see _tick_k)."""
        self._publish("step", waiting)
        return self._step(waiting)

    def _step(self, waiting: int = 0) -> int:
        if not self.active.any():
            self.last_tick_k = 0
            return 0
        if self.speculative > 0:
            return self._step_speculative(waiting > 0)
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
