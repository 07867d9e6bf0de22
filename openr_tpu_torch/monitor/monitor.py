"""Monitor: structured event-log drain + system metrics.

Behavioral parity with the reference ``openr/monitor/``:
- ``LogSample`` structured JSON-style event records with common fields
  merged in (monitor/LogSample.h)
- a Monitor module draining the log-sample queue, retaining a bounded
  history and forwarding to a pluggable backend (monitor/MonitorBase.h:32)
- ``SystemMetrics``: process RSS / CPU sampling (monitor/SystemMetrics.h)

Port note: a copy of ``openr_tpu/monitor/monitor.py``; nothing left out.
KvStore and Fib push their event-log samples through ``push_log_sample``.
"""

from __future__ import annotations

import json
import os
import resource
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from openr_tpu_torch.messaging.queue import ReplicateQueue
from openr_tpu_torch.telemetry import get_registry
from openr_tpu_torch.utils.eventbase import OpenrEventBase


class LogSample:
    """Structured event record (reference: monitor/LogSample.h)."""

    def __init__(self, **values):
        self._values: Dict[str, object] = dict(values)
        self._values.setdefault("time", int(time.time()))

    def add_string(self, key: str, value: str) -> "LogSample":
        self._values[key] = value
        return self

    def add_int(self, key: str, value: int) -> "LogSample":
        self._values[key] = int(value)
        return self

    def get(self, key: str):
        return self._values.get(key)

    def to_json(self) -> str:
        return json.dumps(self._values, sort_keys=True)

    @staticmethod
    def from_json(raw: str) -> "LogSample":
        return LogSample(**json.loads(raw))


def push_log_sample(queue: Optional[ReplicateQueue], **fields) -> None:
    """Push one structured event sample toward the Monitor; no-op when
    the producing module runs without a wired log queue. The single
    shared helper for every module's event-log site (reference pattern:
    logSampleQueue_.push in KvStore.cpp:3104, LinkMonitor.cpp:1287,
    Fib.cpp:891, PrefixAllocator.cpp logPrefixEvent)."""
    if queue is not None:
        queue.push(LogSample(**fields))


class SystemMetrics:
    """reference: monitor/SystemMetrics.h — RSS/CPU snapshots."""

    @staticmethod
    def rss_bytes() -> int:
        """CURRENT resident set size. ru_maxrss is the process's *peak*
        RSS — reporting it as current hides every memory release, so on
        Linux read /proc/self/statm (field 2, pages); the rusage peak
        stays available as rss_peak_bytes and as the fallback here."""
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, IndexError, ValueError):
            # /proc/self/statm unreadable or malformed (non-Linux):
            # count the fallback — peak-RSS-as-current hides memory
            # releases, so a dashboard reading this metric should be
            # able to see it is degraded
            get_registry().counter_bump("monitor.statm_fallbacks")
            return SystemMetrics.rss_peak_bytes()

    @staticmethod
    def rss_peak_bytes() -> int:
        # ru_maxrss is KiB on Linux
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    @staticmethod
    def cpu_seconds() -> float:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return ru.ru_utime + ru.ru_stime


class Monitor:
    """Drains the log-sample queue; merges common fields; keeps a bounded
    history; forwards to an optional backend callback.
    reference: monitor/MonitorBase.h:32, Monitor.h:27."""

    def __init__(
        self,
        node_name: str,
        log_sample_queue: ReplicateQueue,
        max_history: int = 1024,
        backend: Optional[Callable[[LogSample], None]] = None,
        common_fields: Optional[Dict[str, object]] = None,
    ):
        self.node_name = node_name
        self.evb = OpenrEventBase(name=f"monitor:{node_name}")
        self._history: Deque[LogSample] = deque(maxlen=max_history)
        self._backend = backend
        self._common = dict(common_fields or {})
        self._common.setdefault("node_name", node_name)
        self.num_processed = 0
        self.evb.add_queue_reader(
            log_sample_queue.get_reader(f"monitor:{node_name}"),
            self._process_event_log,
        )

    def start(self) -> None:
        self.evb.run_in_thread()

    def stop(self) -> None:
        self.evb.stop()
        self.evb.join()

    def _process_event_log(self, sample: LogSample) -> None:
        """reference: Monitor::processEventLog."""
        for key, value in self._common.items():
            if sample.get(key) is None:
                sample.add_string(key, value) if isinstance(
                    value, str
                ) else sample.add_int(key, value)
        self._history.append(sample)
        self.num_processed += 1
        if self._backend is not None:
            try:
                self._backend(sample)
            except Exception:
                # a broken backend must not take the drain loop down,
                # but the drop has to be countable (was a silent pass)
                get_registry().counter_bump("monitor.backend_errors")

    def get_event_logs(self, limit: int = 100) -> List[LogSample]:
        return self.evb.call_and_wait(
            lambda: list(self._history)[-limit:]
        )

    def get_counters(self) -> Dict[str, object]:
        def collect() -> Dict[str, object]:
            # the process-wide registry snapshot (telemetry spine) +
            # monitor-local and system gauges, one flat fb303 dict
            out: Dict[str, object] = dict(get_registry().snapshot())
            out.update(
                {
                    "monitor.log_samples_processed": self.num_processed,
                    "process.rss_bytes": SystemMetrics.rss_bytes(),
                    "process.rss_peak_bytes": SystemMetrics.rss_peak_bytes(),
                    "process.cpu_seconds": SystemMetrics.cpu_seconds(),
                }
            )
            return out

        return self.evb.call_and_wait(collect)
