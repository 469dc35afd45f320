"""Windowed metric buffers for training observability.

Counterpart of `lhrs_bot_tpu/train/metric.py`: named scalar streams with a
smoothing window, global averages and latest values, read by the logger
hook.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional


class HistoryBuffer:
    def __init__(self, window_size: int = 20):
        self._window = deque(maxlen=window_size)
        self._count = 0
        self._sum = 0.0
        self._latest = 0.0

    def update(self, value: float) -> None:
        value = float(value)
        self._window.append(value)
        self._count += 1
        self._sum += value
        self._latest = value

    @property
    def latest(self) -> float:
        return self._latest

    @property
    def values(self):
        """The values in the window, oldest first."""
        return list(self._window)

    @property
    def avg(self) -> float:
        return sum(self._window) / max(len(self._window), 1)

    @property
    def global_avg(self) -> float:
        return self._sum / max(self._count, 1)

    @property
    def count(self) -> int:
        return self._count


class MetricStorage:
    """Dict of named HistoryBuffers with a per-key smoothing preference."""

    def __init__(self, window_size: int = 20):
        self._window_size = window_size
        self._buffers: Dict[str, HistoryBuffer] = {}
        self._smooth: Dict[str, bool] = {}
        self._iter = 0

    def update(self, iter_num: Optional[int] = None, smooth: bool = True,
               **values: float) -> None:
        if iter_num is not None:
            self._iter = iter_num
        for key, value in values.items():
            if key not in self._buffers:
                self._buffers[key] = HistoryBuffer(self._window_size)
                self._smooth[key] = smooth
            self._buffers[key].update(value)

    def __getitem__(self, key: str) -> HistoryBuffer:
        return self._buffers[key]

    def __contains__(self, key: str) -> bool:
        return key in self._buffers

    def keys(self):
        return self._buffers.keys()

    @property
    def iter(self) -> int:
        return self._iter

    def values_maybe_smooth(self) -> Dict[str, float]:
        return {k: (b.avg if self._smooth[k] else b.latest)
                for k, b in self._buffers.items()}

    def state_dict(self) -> dict:
        return {"iter": self._iter,
                "global": {k: (b._sum, b._count)
                           for k, b in self._buffers.items()}}

    def load_state_dict(self, state: dict) -> None:
        self._iter = state.get("iter", 0)
        for k, (s, c) in state.get("global", {}).items():
            buf = self._buffers.setdefault(k, HistoryBuffer(self._window_size))
            buf._sum, buf._count = s, c
            self._smooth.setdefault(k, True)
