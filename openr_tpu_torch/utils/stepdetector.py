"""Step detection over a noisy time series (RTT change detection).

Behavioral parity with the reference ``openr/common/StepDetector.h``:
fast and slow sliding-window means; when their relative difference rises
above ``upper_threshold`` percent we are on a step's rising edge, and when
it falls back below ``lower_threshold`` percent the step is confirmed and
reported via callback with the fast mean. A small absolute threshold
catches staircase drift the relative test misses. Spark uses this to
re-advertise adjacency RTT metrics only on genuine changes.

Port note: a copy of ``openr_tpu/utils/stepdetector.py``; nothing left out.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Tuple


@dataclass
class StepDetectorConfig:
    """reference: StepDetectorConfig in openr/if/OpenrConfig.thrift"""

    fast_window_size: int = 10
    slow_window_size: int = 60
    lower_threshold: float = 2.0  # percent
    upper_threshold: float = 5.0  # percent
    abs_threshold: float = 500.0  # same unit as the samples

    def __post_init__(self) -> None:
        assert self.lower_threshold < self.upper_threshold
        assert self.fast_window_size < self.slow_window_size


class _SlidingWindow:
    def __init__(self, max_samples: int):
        self._samples: Deque[float] = deque(maxlen=max_samples)
        self._max = max_samples

    def add(self, value: float) -> None:
        self._samples.append(value)

    def avg(self) -> float:
        if not self._samples:
            return 0.0
        return sum(self._samples) / len(self._samples)

    def count(self) -> int:
        return len(self._samples)


class StepDetector:
    def __init__(
        self,
        config: StepDetectorConfig,
        step_cb: Callable[[float], None],
    ):
        self._config = config
        self._fast = _SlidingWindow(config.fast_window_size)
        self._slow = _SlidingWindow(config.slow_window_size)
        self._step_cb = step_cb
        self._in_transit = False
        self._last_avg = 0.0
        self._last_avg_init = False

    def add_value(self, value: float) -> None:
        self._fast.add(value)
        self._slow.add(value)
        fast_avg = self._fast.avg()
        slow_avg = self._slow.avg()

        if (
            not self._last_avg_init
            and self._slow.count() >= self._config.slow_window_size // 2
        ):
            self._last_avg = slow_avg
            self._last_avg_init = True

        if slow_avg == 0:
            return
        diff_pct = abs((fast_avg - slow_avg) / slow_avg) * 100.0

        if self._in_transit:
            if diff_pct <= self._config.lower_threshold:
                # falling edge: the step is confirmed
                self._in_transit = False
                self._report(fast_avg)
        else:
            if diff_pct >= self._config.upper_threshold:
                self._in_transit = True
            elif (
                self._last_avg_init
                and abs(fast_avg - self._last_avg) >= self._config.abs_threshold
            ):
                # staircase drift: many small steps the ratio test misses
                self._report(fast_avg)

    def _report(self, new_mean: float) -> None:
        self._step_cb(new_mean)
        self._last_avg = new_mean
        self._last_avg_init = True
