"""The two-pass kernel's rings (csrc/flash_fwd_norm.cu: `two_pass_produce`,
`two_pass_walk` and the kernel's prologue) walked by a model on the CPU: a
producer thread, two consumer warpgroups and TMA loads that complete in any
order, under mbarrier waits that tell a barrier's phases apart by parity
alone, and the pair CTAs' turns on named barriers. With the K and V slots
that `norm_two_pass_plan` gives, no schedule lets a warpgroup read a slot
before its tile has landed or after the slot was refilled, and none
deadlocks; a ring of an odd size in a launch with split CTAs (an odd
Q-tile count) is caught."""
import random

import pytest

from lhrs_bot_tpu_torch.ops.attention import norm_two_pass_plan

IN_FLIGHT = "in flight"


class MBar:
    """An mbarrier: `c` phases completed; a wait on parity p returns once
    the current phase's parity is not p."""

    def __init__(self, count):
        self.count, self.pending, self.c = count, count, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.c, self.pending = self.c + 1, self.count

    def done(self, parity):
        return (self.c & 1) != parity


class Cursor:
    """csrc's TwoCursor: a slot of a ring of `size`, `step` slots a move."""

    def __init__(self, slot, size, step):
        self.slot, self.size, self.step, self.par = slot, size, step, 0

    def moved(self):
        c = Cursor(self.slot + self.step, self.size, self.step)
        c.par = self.par
        if c.slot >= c.size:
            c.slot, c.par = c.slot - c.size, c.par ^ 1
        return c


def _tile(j, split, length, nt):
    """csrc's two_pass_tile: the key tile at position j of a CTA's stream."""
    if not split:
        return j
    t = (j & 1) * (length >> 1) + (j >> 1)
    return min(t, nt - 1)


def _walk_cta(nt, split, kslots, vslots, rng):
    """One CTA under one random schedule: the list of faults seen (a slot
    read while its load was in flight or held another tile) and whether the
    CTA deadlocked."""
    length = 2 * -(-nt // 2) if split else nt
    resident = nt <= kslots
    readers = 1 if split else 2  # warpgroups that free each slot
    nk = nt if resident else kslots
    full = {"k": [MBar(1) for _ in range(nk)],
            "v": [MBar(1) for _ in range(vslots)]}
    empty = {"k": [MBar(readers) for _ in range(nk)],
             "v": [MBar(readers) for _ in range(vslots)]}
    data = {"k": [None] * nk, "v": [None] * vslots}
    loads, faults = [], []
    named = {i: [0, 0] for i in (1, 2, 3)}  # [arrived, generation]

    def issue(kind, slot, value):
        data[kind][slot] = IN_FLIGHT
        loads.append((kind, slot, value))

    def bar_arrive(i):
        named[i][0] += 1
        if named[i][0] == 2:
            named[i][0], named[i][1] = 0, named[i][1] + 1

    def bar_sync(i):
        gen = named[i][1]
        bar_arrive(i)
        while named[i][1] == gen:
            yield

    if resident:  # the prologue: each key tile once, in a slot of its own
        for j in range(nt):
            issue("k", j, ("k", j))

    def producer():
        jv = 0

        def load_v():
            nonlocal jv
            s = jv % vslots
            while not empty["v"][s].done(((jv // vslots) & 1) ^ 1):
                yield
            issue("v", s, ("v", jv))
            jv += 1

        if not resident:
            for pos in range(2 * length):
                s = pos % kslots
                while not empty["k"][s].done(((pos // kslots) & 1) ^ 1):
                    yield
                issue("k", s, ("k", pos))
                last = ((pos if pos < vslots else -1) if pos < length
                        else pos - length + vslots - 2)
                while jv < length and jv <= last:
                    yield from load_v()
        while jv < length:
            yield from load_v()

    def consumer(w):
        n = length // 2 if split else length
        step, off = (2, w) if split else (1, 0)
        tile0 = w * n if split else 0
        turns = not split

        def k_first():
            return (Cursor(tile0, 1 << 30, 1) if resident
                    else Cursor(off, kslots, step))

        def k_want(pss, i):
            if resident:
                return "k", min(tile0 + i, nt - 1)
            return "k", off + step * i + (length if pss == 2 else 0)

        def k_slot(at):
            return min(at.slot, nt - 1) if resident else at.slot

        def read(kind, slot, at, want):  # wait on the slot's phase, read
            while not full[kind][slot].done(at.par):
                yield
            if data[kind][slot] != want:
                faults.append((kind, "read", w, slot, data[kind][slot], want))

        def release(kind, slot, want):  # the product done: still there?
            if data[kind][slot] != want:
                faults.append((kind, "refilled", w, slot, data[kind][slot],
                               want))
            if kind == "v" or not resident:
                empty[kind][slot].arrive()

        def take_turn():
            if turns:
                yield from bar_sync(1 + w)

        def give_turn():
            if turns:
                bar_arrive(2 - w)

        if turns and w == 1:
            bar_arrive(1)  # warpgroup 0 goes first
        yield
        kc, vc = k_first(), Cursor(off, vslots, step)
        for pss in (1, 2):
            if pss == 2 and resident:
                kc = k_first()
            i = 0
            while i < n:
                m = 2 if i + 1 < n else 1
                ks, vs = [], []
                for j in range(m):
                    ks.append((k_slot(kc), kc, k_want(pss, i + j)))
                    kc = kc.moved()
                    if pss == 2:
                        vs.append((vc.slot, vc, ("v", off + step * (i + j))))
                        vc = vc.moved()
                yield from take_turn()
                for slot, at, want in ks:
                    yield from read("k", slot, at, want)
                give_turn()
                yield
                release("k", ks[0][0], ks[0][2])
                for j in range(m):
                    if pss == 2:
                        yield from take_turn()
                        yield from read("v", *vs[j])
                        give_turn()
                        yield
                    if j == 0 and m == 2:
                        release("k", ks[1][0], ks[1][2])
                    if pss == 2:
                        yield
                        release("v", vs[j][0], vs[j][2])
                i += m
            if pss == 1 and split:  # the row stats' exchange
                yield from bar_sync(3)
        if turns and w == 0:
            yield from bar_sync(1)
        if split:  # the partial outputs' exchange
            yield from bar_sync(3)
            yield from bar_sync(3)

    agents = [producer(), consumer(0), consumer(1)]
    idle = 0
    while agents or loads:
        pick = rng.randrange(len(agents) + (1 if loads else 0))
        if pick == len(agents):  # a load lands, in any order
            kind, slot, value = loads.pop(rng.randrange(len(loads)))
            data[kind][slot] = value
            full[kind][slot].arrive()
            idle = 0
            continue
        try:
            next(agents[pick])
        except StopIteration:
            agents.pop(pick)
        idle += 1
        if idle > 20000 and not loads:
            return faults, True
    return faults, False


def _walk(sq, skv, kslots, vslots, schedules):
    """Every kind of CTA the launch has (pairs; a split CTA where the
    Q-tile count is odd) under `schedules` random schedules each: the
    faults seen and the deadlocks."""
    nq, nt = -(-sq // 64), -(-skv // 64)
    kinds = ([False] if nq > 1 else []) + ([True] if nq % 2 else [])
    rng = random.Random(0)
    faults, deadlocks = [], 0
    for split in kinds:
        for _ in range(schedules):
            f, dead = _walk_cta(nt, split, kslots, vslots, rng)
            faults += f
            deadlocks += dead
    return faults, deadlocks


@pytest.mark.parametrize("sq, skv, d", [
    (64, 1360, 64),  # the 504-px perceiver: one Q tile a head
    (1297, 1297, 64),  # ViT-L/14 504 px: pairs and an odd last Q tile
    (1312, 1312, 64),
    (577, 577, 64),  # ViT-L/14 336 px
    (577, 577, 128),  # K streamed
    (64, 2561, 64),  # K streamed, split CTAs only
    (2561, 2561, 64),  # K streamed, pairs and split CTAs
    (704, 704, 64),
    (1, 17, 64),  # one key tile: the split CTA's dummy reads it again
    (192, 300, 128),
])
def test_two_pass_plan_rings_hold(sq, skv, d):
    plan = norm_two_pass_plan(sq, skv, d)
    faults, deadlocks = _walk(sq, skv, plan["k_slots"], plan["v_slots"], 40)
    assert faults == [] and deadlocks == 0


@pytest.mark.parametrize("sq, skv, kslots, vslots", [
    (1297, 1297, 21, 3),  # a V ring of three beside resident K
    (64, 2561, 23, 4),  # a streamed K ring of 23
])
def test_two_pass_odd_ring_with_split_ctas_is_caught(sq, skv, kslots,
                                                     vslots):
    """The model has teeth: in a launch with split CTAs, an odd ring hands
    a slot between the warpgroups at every phase, and some schedule reads a
    tile still in flight or one the other warpgroup's phase left."""
    faults, _ = _walk(sq, skv, kslots, vslots, 40)
    assert faults
