"""Where the port's tensors live: on the card, unless the caller names the
CPU.

The port's entry points (`GenerationEngine`, the schedulers,
`KVCache.create`, `PagedKVCache.create`, `init_vlm_params`) take
`device="cuda"` by default. With no card visible they raise rather than
run on the CPU: a CPU run is asked for with `device="cpu"`, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device with no card visible
    raises RuntimeError."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device visible; "
                           "pass device='cpu' to run on the CPU")
    return dev
