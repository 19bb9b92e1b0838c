"""The traced slice: ``torch.profiler`` over a steady part of the window,
reduced to an ordered list of device operations, the device's busy time,
the heaviest operations and the longest idle gaps.

No Chrome trace is written. Device operations (kernels, copies, sets) and
host operations come from the profiler's Kineto events; a gap in which no
device operation ran is named by the innermost host operation that was
running at its middle, preferring the benchmark's own ranges
(``portbench.*``, :func:`label`).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

_GEMM_ACT = re.compile(r"gemm_wgmma<\s*\d+\s*,\s*\d+\s*,\s*(\d+)\s*>")


def label(name: str):
    """A host range that names what the host was doing (a no-op context
    outside a profile)."""
    return torch.profiler.record_function(f"portbench.{name}")


@dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclass
class Slice:
    """What one traced slice saw."""
    ops: List[DeviceOp]
    window_s: float
    busy_s: float
    device_ops: List[list]
    idle_gaps: List[list]
    units: int = 0                      # flushes, batches or steps issued


def is_copy_htod(name: str) -> bool:
    return "HtoD" in name


def is_copy_dtoh(name: str) -> bool:
    return "DtoH" in name


def is_scan(name: str) -> bool:
    return "cand_kernel" in name


def gemm_act(name: str) -> Optional[int]:
    """The epilogue activation code of a ``gemm_wgmma`` kernel (0: none,
    else a GELU), or None for any other kernel."""
    m = _GEMM_ACT.search(name)
    return int(m.group(1)) if m else None


def _ev(e, what):
    fn = getattr(e, what, None)
    return fn() if callable(fn) else fn


def _add(dev: list, host: list, name: str, on_device: bool, start: float,
         end: float) -> None:
    """File one event: the profiler's step range is neither; the
    benchmark's own ranges appear on the device's timeline too, as
    annotations, and are host ops only."""
    if name.startswith("ProfilerStep#"):
        return
    if not on_device:
        host.append((name, start, end))
    elif not name.startswith("portbench."):
        dev.append(DeviceOp(name, start, end - start))


def _raw_events(prof):
    """``(device ops, host ops)`` of a finished profile, each host op a
    ``(name, start_us, end_us)``."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if hasattr(e, "start_ns"):
                start, dur = _ev(e, "start_ns") / 1e3, _ev(e,
                                                          "duration_ns") / 1e3
            else:
                start, dur = _ev(e, "start_us"), _ev(e, "duration_us")
            _add(dev, host, _ev(e, "name"), _ev(e, "device_type") == cuda,
                 float(start), float(start + dur))
    else:
        for e in prof.events():
            _add(dev, host, e.name, e.device_type == cuda,
                 float(e.time_range.start), float(e.time_range.end))
    dev.sort(key=lambda o: o.start_us)
    return dev, host


def _busy(ops: List[DeviceOp]) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds covered by at least one op, and the idle gaps between
    the covered intervals, in microseconds."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for o in ops:
        if cur_e is None:
            cur_s, cur_e = o.start_us, o.end_us
        elif o.start_us <= cur_e:
            cur_e = max(cur_e, o.end_us)
        else:
            busy += cur_e - cur_s
            gaps.append((cur_e, o.start_us))
            cur_s, cur_e = o.start_us, o.end_us
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6, gaps


def _gap_label(host, mid: float) -> str:
    best, best_len, own = "host", None, False
    for name, s, e in host:
        if not s <= mid <= e:
            continue
        mine = name.startswith("portbench.")
        if mine and not own:
            best, best_len, own = name, e - s, True
        elif mine == own and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def short(name: str, n: int = 100) -> str:
    return name if len(name) <= n else name[:n]


def summarize(prof, window_s: float, units: int) -> Slice:
    ops, host = _raw_events(prof)
    busy_s, gaps = _busy(ops)
    by_name = {}
    for o in ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur_us / 1e6
    device_ops = sorted(([short(k), v] for k, v in by_name.items()),
                        key=lambda kv: -kv[1])[:10]
    host.sort(key=lambda h: h[1])
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle_gaps = [[_gap_label(host, (a + b) / 2), (b - a) / 1e6]
                 for a, b in longest]
    return Slice(ops=ops, window_s=window_s, busy_s=busy_s,
                 device_ops=device_ops, idle_gaps=idle_gaps, units=units)


def _all_threads():
    """A profiler config that records every thread's host ops where this
    torch has the option, else None (the calling thread's); a copy of
    ``video_quierer_tpu_torch/api/routes.py:_all_threads``."""
    from torch._C._profiler import _ExperimentalConfig
    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


class Tracer:
    """Profiles one slice of the window, from ``start_at`` to ``stop_at``
    seconds after the window opened; off when ``enabled`` is false.
    The profiler starts ``WARM_S`` earlier in its schedule's warm-up, so
    that the tracer's own start (CUPTI's set-up, which stalls the host
    for a fraction of a second) falls outside the slice. ``tick(t)``
    (called at unit boundaries by a loop, or by a waiting thread) moves
    it on; ``units`` counts the units begun while the slice ran."""

    WARM_S = 0.5

    def __init__(self, enabled: bool, start_at: float, stop_at: float):
        self.enabled = enabled
        self.start_at, self.stop_at = start_at, stop_at
        self.prof = None
        self.t_on = self.t_off = None
        self.units = 0
        self.done = False
        self.slice: Optional[Slice] = None

    @property
    def active(self) -> bool:
        return self.t_on is not None and self.t_off is None

    def next_at(self) -> float:
        """Seconds into the window of the next change of phase."""
        if self.prof is None:
            return self.start_at - self.WARM_S
        return self.stop_at if self.active else self.start_at

    def tick(self, elapsed: float) -> None:
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed >= self.start_at - self.WARM_S:
            from torch.profiler import ProfilerActivity, profile, schedule
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts,
                                schedule=schedule(wait=0, warmup=1,
                                                  active=1, repeat=1),
                                experimental_config=_all_threads())
            self.prof.__enter__()
        if self.prof is not None and self.t_on is None \
                and elapsed >= self.start_at:
            self.prof.step()
            self.t_on = time.perf_counter()
        elif self.active and elapsed >= self.stop_at:
            self.stop()

    def unit(self) -> None:
        if self.active:
            self.units += 1

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof, self.done = self.prof, None, True
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self.t_on is None:       # the window closed in the warm-up
            prof.__exit__(None, None, None)
            return
        self.t_off = time.perf_counter()
        prof.__exit__(None, None, None)
        self.slice = summarize(prof, self.t_off - self.t_on, self.units)
