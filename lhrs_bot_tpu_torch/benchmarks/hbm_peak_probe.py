"""What device-memory read rate can a hand-written kernel reach on the card?

Counterpart of `benchmarks/hbm_peak_probe.py` (the JAX package's TPU probe):
`hbm_read(x)` and `hbm_dual_read(x, y)` stream every byte of one or two
contiguous int8 or bf16 arrays and return float32 (1,): max(x), and
max(x) + max(y). The TPU readers took the max of each block's first row
only, to keep their DMA loop live; here a load that feeds nothing would be
removed, so every element counts (on inputs whose every block holds its
max in its first row, and whose two largest values share a block, the two
definitions agree). CPU tensors take the plain versions; CUDA tensors the
kernel (csrc/hbm_probe.cu).

`main()` (`python -m lhrs_bot_tpu_torch.benchmarks.hbm_peak_probe` on the
card) reports GB/s for int8 and bf16 buffers of 1.4 GB, the single and the
dual reader over a sweep of CTAs per SM and 16-byte loads in flight per
thread, each grid first held to the plain version by `check_reader` (the TPU probe's block_rows / slots are its pipelining, not its
result), and `torch.amax` over the same buffers as the library yardstick,
as one JSON line with the card's name and power limit. The rate is a
reading of what this kernel reached, not a bound.
"""

from __future__ import annotations

import json
import random
import sys

import torch

from ..ops import cuda_lib

GB = 1024 ** 3
UNROLLS = (1, 2, 4, 8)
# the kernel's grid, unless the caller names one: CTAs per SM, loads in
# flight per thread
CTAS_PER_SM, UNROLL = 4, 4
THREADS = 256  # a CTA of csrc/hbm_probe.cu
# `buffers` fill below these; `check_reader` plants its maxima from them
# (x's, y's), one step up per place
FILL_MAX = {torch.int8: 100, torch.bfloat16: 8.0}
PLANT = {torch.int8: (101, 115), torch.bfloat16: (16.0, 48.0)}


def hbm_read_plain(x: torch.Tensor) -> torch.Tensor:
    return x.float().amax().reshape(1)


def hbm_dual_read_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float().amax() + y.float().amax()).reshape(1)


def _words(t: torch.Tensor, name: str) -> int:
    if t.dtype not in (torch.int8, torch.bfloat16):
        raise ValueError(f"{name} must be int8 or bf16, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    n = t.numel() * t.element_size()
    if n == 0 or n % 16:
        raise ValueError(f"{name} must hold a positive multiple of 16 bytes, "
                         f"got {n}")
    return n // 16


def hbm_read_kernel(x: torch.Tensor, y: torch.Tensor = None, *,
                    ctas_per_sm: int = CTAS_PER_SM,
                    unroll: int = UNROLL) -> torch.Tensor:
    """Launch the reader over x (and y, of x's dtype and size): float32 (1,)
    max(x) (+ max(y)). Counts its launches in `hbm_read_kernel.launches`."""
    if not x.is_cuda or (y is not None and y.device != x.device):
        raise ValueError("hbm_read_kernel takes CUDA tensors on one device")
    n16 = _words(x, "x")
    if y is not None and (y.dtype != x.dtype or _words(y, "y") != n16):
        raise ValueError("y must match x's dtype and size")
    if unroll not in UNROLLS or ctas_per_sm < 1:
        raise ValueError(f"unroll must be one of {UNROLLS} and ctas_per_sm "
                         f">= 1")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ctas = ctas_per_sm * sms
    partial = torch.empty(2 * ctas, dtype=torch.float32, device=x.device)
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    lib = cuda_lib.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lhrs_hbm_read(x.data_ptr(),
                                None if y is None else y.data_ptr(), n16,
                                int(x.dtype == torch.bfloat16), unroll, ctas,
                                partial.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(err, "hbm_read_kernel")
    hbm_read_kernel.launches += 1
    return out


hbm_read_kernel.launches = 0


def hbm_read(x: torch.Tensor, **grid) -> torch.Tensor:
    """float32 (1,) max of every element of x."""
    if x.is_cuda:
        return hbm_read_kernel(x, **grid)
    return hbm_read_plain(x)


def hbm_dual_read(x: torch.Tensor, y: torch.Tensor, **grid) -> torch.Tensor:
    """float32 (1,) max(x) + max(y), x and y read in one pass."""
    if x.is_cuda:
        return hbm_read_kernel(x, y, **grid)
    return hbm_dual_read_plain(x, y)


def event_ms(fn, reps: int = 8) -> float:
    """Device ms of one call: CUDA events around `reps` calls after a
    warm-up, the least of three such runs divided by reps."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def buffers(dev, gen: torch.Generator):
    """A 1.4 GB int8 buffer (rows of 512, as the TPU probe's) and a bf16
    buffer of the same bytes, random and below `FILL_MAX` (int8 codes in
    [-100, 100], bf16 N(0, 1) clipped to +-8), so that `check_reader` can
    plant a unique maximum above them."""
    cols = 512
    rows8 = int(1.4 * GB) // cols
    rows8 -= rows8 % 2048
    top8 = FILL_MAX[torch.int8]
    x8 = torch.randint(-top8, top8 + 1, (rows8, cols), generator=gen,
                       device=dev, dtype=torch.int8)
    topb = FILL_MAX[torch.bfloat16]
    xb = torch.randn((rows8 // 2, cols), generator=gen, device=dev,
                     dtype=torch.bfloat16).clamp_(-topb, topb)
    return x8, xb


def check_reader(x: torch.Tensor, y: torch.Tensor = None, *, seed: int = 0,
                 plants: int = 4, read=None, **grid) -> int:
    """Hold the reader (or `read`, given x or x and y) to the plain version
    with a unique maximum planted in x, and a second one in y, at each of
    `plants` places in turn: x's first element, its last, one in the
    grid's last stride, then seeded ones (y's mirrored). Each place gets
    its own value above the buffer's (`PLANT`), so the result names the
    words that were read, and a reader that skips one of them returns
    another number. Every planted element is restored. Returns the number
    of calls checked; raises AssertionError on a wrong one."""
    arrays = (x,) if y is None else (x, y)
    lo = PLANT[x.dtype]
    if plants > 127 - lo[1] or any(a.dtype != x.dtype for a in arrays):
        raise ValueError(f"check_reader plants at most {127 - lo[1]} values "
                         "into arrays of one dtype")
    for a in arrays:
        if float(a.amax()) >= lo[0]:
            raise ValueError(f"the array's max {float(a.amax())} must lie "
                             f"below the planted values ({lo[0]})")
    if read is None:
        def read(*a):
            return (hbm_read(*a, **grid) if y is None
                    else hbm_dual_read(*a, **grid))
    n = x.numel()
    tail = n
    if x.is_cuda:
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        words = (grid.get("ctas_per_sm", CTAS_PER_SM) * sms * THREADS
                 * grid.get("unroll", UNROLL))
        tail = min(n, words * 16 // x.element_size())
    rng = random.Random(seed)

    def place(k):
        if k < 2:
            return (0, n - 1)[k]
        return n - 1 - rng.randrange(tail) if k == 2 else rng.randrange(n)

    for k in range(plants):
        spots = [(x.view(-1), place(k), lo[0] + k)]
        if y is not None:
            spots.append((y.view(-1), place(k ^ 1), lo[1] + k))
        olds = [(flat, i, flat[i].clone()) for flat, i, _ in spots]
        for flat, i, v in spots:
            flat[i] = v
        try:
            got = float(read(*arrays))
            plain = float(hbm_read_plain(x) if y is None
                          else hbm_dual_read_plain(x, y))
        finally:
            for flat, i, old in olds:
                flat[i] = old
        want = float(sum(v for *_, v in spots))
        if not got == plain == want:
            raise AssertionError(
                f"reader over {x.dtype} {'x, y' if y is not None else 'x'} "
                f"with maxima planted at {[i for _, i, _ in spots]}: {got}, "
                f"plain {plain}, planted {want}")
    return plants


def main(argv=None) -> dict:
    from ..bench import device_line

    del argv
    if not torch.cuda.is_available():
        raise SystemExit("hbm_peak_probe: no CUDA device visible; this probe "
                         "runs on the card")
    dev = torch.device("cuda", 0)
    x8, xb = buffers(dev, torch.Generator(device=dev).manual_seed(0))
    out = {}
    for name, x in (("int8", x8), ("bf16", xb)):
        n = x.numel() * x.element_size()
        out[f"amax_{name}_gbs"] = n / event_ms(lambda: torch.amax(x)) / 1e6
        for cps in (1, 2, 4, 8):
            for unroll in UNROLLS:
                check_reader(x, seed=cps * 10 + unroll, plants=3,
                             ctas_per_sm=cps, unroll=unroll)
                ms = event_ms(lambda: hbm_read(x, ctas_per_sm=cps,
                                               unroll=unroll))
                out[f"read_{name}_c{cps}_u{unroll}_gbs"] = n / ms / 1e6
        half, half2 = x[:x.shape[0] // 2], x[x.shape[0] // 2:]
        for cps, unroll in ((2, 2), (4, 2), (4, 4), (8, 1)):
            check_reader(half, half2, seed=cps * 10 + unroll, plants=3,
                         ctas_per_sm=cps, unroll=unroll)
            ms = event_ms(lambda: hbm_dual_read(half, half2, ctas_per_sm=cps,
                                                unroll=unroll))
            out[f"dual_{name}_c{cps}_u{unroll}_gbs"] = n / ms / 1e6
    out["device"] = device_line()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
