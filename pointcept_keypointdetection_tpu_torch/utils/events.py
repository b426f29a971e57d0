"""Scalar histories for training telemetry: the port's copy of
``HistoryBuffer`` and ``EventStorage`` (``pointcept_keypointdetection_tpu/
utils/events.py``), cut to what the hooks read."""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Dict


class HistoryBuffer:
    """A series of scalars with a bounded smoothing window."""

    def __init__(self, window_size: int = 20):
        self._window = deque(maxlen=window_size)
        self._count = 0
        self._global_sum = 0.0
        self._latest = float("nan")

    def update(self, value: float):
        value = float(value)
        self._window.append(value)
        self._count += 1
        self._global_sum += value
        self._latest = value

    @property
    def latest(self) -> float:
        return self._latest

    def avg(self) -> float:
        return sum(self._window) / len(self._window) if self._window else float("nan")

    def global_avg(self) -> float:
        return self._global_sum / self._count if self._count else float("nan")


class EventStorage:
    """Named scalar histories; a trainer owns one for its run."""

    def __init__(self, window_size: int = 20):
        self._history: Dict[str, HistoryBuffer] = defaultdict(lambda: HistoryBuffer(window_size))

    def put_scalar(self, name: str, value) -> None:
        self._history[name].update(value)

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"No history metric '{name}'")
        return self._history[name]

    def histories(self) -> Dict[str, HistoryBuffer]:
        return dict(self._history)

    def reset_histories(self) -> None:
        self._history.clear()
