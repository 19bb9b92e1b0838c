"""First-class system metrics, wired into the live path
(counterpart of ``video_quierer_tpu/engine/metrics.py``).

The reference *defined* this subsystem but never connected it
(``SystemMetrics``, src/utils/metrics.py — dead path; SURVEY.md §5 says the
rebuild should make it live). Thread-safe counters / gauges / histograms
with percentile summaries and Prometheus text export under the
``video_search_`` namespace. A histogram's count and sum run over every
sample it was given; its minimum, maximum, mean and percentiles over the
last ``HISTOGRAM_CAP``.

What the engine records (``/metrics``, ``/api/metrics``):

- counters: ``searches``, ``search_cache_hits``, ``ann_searches``,
  ``similar_searches``, ``pipelined_flushes`` (the coalescer's flushes
  handed to a resolver), ``frames_embedded``, ``ingest_batches``,
  ``ivf_builds``, ``embed_fallbacks`` and ``fused_search_fallbacks``
  (always 0 on the port);
- gauge: ``frames_indexed``;
- histograms (ms unless named otherwise): ``startup_ms``, ``ingest_ms``,
  ``embed_batch_ms``, ``ivf_build_ms``, ``search_latency_ms``,
  ``text_encode_ms``, ``index_scan_ms``, ``batch_search_latency_ms``
  (``search_batch``), ``video_search_latency_ms``, ``flush_latency_ms``
  (a coalesced flush, dispatch to answers), ``coalesced_batch_size``
  (requests).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np

HISTOGRAM_CAP = 10_000


class SystemMetrics:
    def __init__(self, namespace: str = "video_search"):
        self.namespace = namespace
        self._lock = threading.RLock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, deque] = {}
        self._totals: Dict[str, list] = {}     # name: [count, sum]
        self._started = time.time()

    # -- recording -------------------------------------------------------

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = deque(maxlen=HISTOGRAM_CAP)
                self._totals[name] = [0, 0.0]
            hist.append(float(value))
            total = self._totals[name]
            total[0] += 1
            total[1] += float(value)

    @contextmanager
    def timer(self, name: str):
        """Observe a duration in milliseconds under ``<name>_ms``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(f"{name}_ms", (time.perf_counter() - t0) * 1000.0)

    # -- reading ---------------------------------------------------------

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def histogram_stats(self, name: str) -> Dict[str, float]:
        """``count`` and ``sum`` of every sample; the rest of the last
        ``HISTOGRAM_CAP``."""
        with self._lock:
            values = list(self._histograms.get(name, ()))
            count, total = self._totals.get(name, (0, 0.0))
        if not values:
            return {}
        arr = np.asarray(values)
        return {
            "count": int(count),
            "sum": float(total),
            "min": float(arr.min()),
            "max": float(arr.max()),
            "mean": float(arr.mean()),
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "p99": float(np.percentile(arr, 99)),
        }

    def snapshot(self) -> Dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hist_names = list(self._histograms)
        return {
            "uptime_seconds": time.time() - self._started,
            "counters": counters,
            "gauges": gauges,
            "histograms": {n: self.histogram_stats(n) for n in hist_names},
        }

    # -- export ----------------------------------------------------------

    def export_prometheus(self) -> str:
        """Prometheus text exposition format."""
        ns = self.namespace
        lines = []
        snap = self.snapshot()
        for name, val in sorted(snap["counters"].items()):
            lines.append(f"# TYPE {ns}_{name} counter")
            lines.append(f"{ns}_{name} {val}")
        for name, val in sorted(snap["gauges"].items()):
            lines.append(f"# TYPE {ns}_{name} gauge")
            lines.append(f"{ns}_{name} {val}")
        for name, stats in sorted(snap["histograms"].items()):
            if not stats:
                continue
            lines.append(f"# TYPE {ns}_{name} summary")
            for q in ("p50", "p95", "p99"):
                lines.append(
                    f'{ns}_{name}{{quantile="{q[1:]}"}} {stats[q]}')
            lines.append(f"{ns}_{name}_count {stats['count']}")
            lines.append(f"{ns}_{name}_sum {stats['sum']}")
        lines.append(f"# TYPE {ns}_uptime_seconds gauge")
        lines.append(f"{ns}_uptime_seconds {snap['uptime_seconds']}")
        return "\n".join(lines) + "\n"
