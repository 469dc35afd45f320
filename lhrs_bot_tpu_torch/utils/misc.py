"""Misc utilities (counterpart of lhrs_bot_tpu/utils/misc.py `collect_env`,
reporting torch, CUDA and the card in place of the JAX backend)."""

from __future__ import annotations

import platform
import sys

import numpy as np
import torch


def collect_env() -> str:
    """Platform / torch / CUDA / card summary printed at start-up."""
    lines = [
        f"python: {sys.version.split()[0]} ({platform.platform()})",
        f"numpy: {np.__version__}",
        f"torch: {torch.__version__} (CUDA {torch.version.cuda})",
    ]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        lines.append(f"devices: {n} x {torch.cuda.get_device_name(0)}, "
                     f"capability {torch.cuda.get_device_capability(0)}")
    else:
        lines.append("devices: no CUDA device visible")
    return "\n".join(lines)
