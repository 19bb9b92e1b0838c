"""The port's span log (``video_quierer_tpu_torch/utils/stageprof.py``):
off, a span is the shared no-op and nothing is logged; on, each span
logs its name, bounds on ``time.time_ns()``'s clock, thread, parent and
unit, beside the ``{name: (calls, seconds)}`` accumulators; a full log
counts what it drops; and a torch op's Kineto event lies within the
span around it, so the log and a profiler trace share one clock."""

import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from video_quierer_tpu_torch.utils import stageprof


@pytest.fixture
def spans_on():
    """Spans on over an empty log; the switch put back and the log
    emptied after. Other test modules import this fixture."""
    was = stageprof.ENABLED
    stageprof.reset()
    stageprof.enable(True)
    try:
        yield stageprof
    finally:
        stageprof.enable(was)
        stageprof.reset()


@pytest.fixture
def spans_off():
    was = stageprof.ENABLED
    stageprof.reset()
    stageprof.enable(False)
    try:
        yield
    finally:
        stageprof.enable(was)
        stageprof.reset()


def test_off_logs_nothing_and_returns_the_shared_no_op(spans_off):
    assert stageprof.span("a") is stageprof._NULL
    assert stageprof.unit(3) is stageprof._NULL
    with stageprof.unit(3), stageprof.span("a"):
        pass
    assert stageprof.events() == ([], 0)
    assert stageprof.snapshot() == {}


def test_on_each_event_carries_name_parent_thread_and_unit(spans_on):
    def work(uid):
        with stageprof.unit(uid):
            with stageprof.span("outer"):
                with stageprof.span("inner"):
                    pass
        with stageprof.span("loose"):
            pass

    t = threading.Thread(target=work, args=(7,))
    t.start()
    t.join(10)
    assert not t.is_alive()
    work(5)
    evs, dropped = spans_on.events()
    assert dropped == 0 and len(evs) == 6
    assert all(e.t0_ns <= e.t1_ns for e in evs)
    threads = [e.thread for e in evs]
    assert threads[:3] == [t.native_id] * 3
    assert threads[3:] == [threading.get_native_id()] * 3
    for first, uid in ((0, 7), (3, 5)):
        inner, outer, loose = evs[first:first + 3]
        assert (inner.name, inner.parent, inner.unit) == ("inner", "outer",
                                                          uid)
        assert (outer.name, outer.parent, outer.unit) == ("outer", None, uid)
        assert (loose.name, loose.parent, loose.unit) == ("loose", None,
                                                          None)
        assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    # ``since_ns``: the events that ended at or after it
    assert spans_on.events(evs[3].t1_ns)[0] == evs[3:]


def test_snapshot_keeps_its_shape(spans_on):
    for _ in range(3):
        with stageprof.span("a"):
            pass
    with stageprof.span("b"):
        pass
    snap = stageprof.snapshot()
    assert set(snap) == {"a", "b"}
    for name, calls in (("a", 3), ("b", 1)):
        assert isinstance(snap[name], tuple) and len(snap[name]) == 2
        assert snap[name][0] == calls and snap[name][1] >= 0.0
    stageprof.reset()
    assert stageprof.snapshot() == {} and stageprof.events() == ([], 0)


def test_a_full_log_counts_what_it_drops(spans_on):
    over = 10
    for i in range(stageprof.LOG_CAP + over):
        with stageprof.unit(i), stageprof.span("s"):
            pass
    evs, dropped = stageprof.events()
    assert dropped == over and len(evs) == stageprof.LOG_CAP
    assert evs[0].unit == over and evs[-1].unit == stageprof.LOG_CAP + over - 1
    assert stageprof.snapshot()["s"][0] == stageprof.LOG_CAP + over


def test_threads_lose_no_span(spans_on):
    n_threads, per = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(uid):
            for _ in range(per):
                with stageprof.unit(uid), stageprof.span("s"):
                    with stageprof.span("t"):
                        pass
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = stageprof.snapshot()
    assert snap["s"][0] == snap["t"][0] == n_threads * per
    evs, dropped = stageprof.events()
    assert dropped == 0 and len(evs) == 2 * n_threads * per
    by_thread = {}
    for e in evs:
        by_thread.setdefault(e.thread, set()).add(e.unit)
        assert e.parent == ("s" if e.name == "t" else None)
    assert sorted(len(u) for u in by_thread.values()) == [1] * n_threads


def test_kineto_events_fall_inside_their_spans(spans_on):
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            with stageprof.span("mm"):
                torch.mm(a, a)
    spans = [e for e in stageprof.events()[0] if e.name == "mm"]
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(spans) == len(ops) == 5
    slack = 50_000
    for s, (t0, t1) in zip(spans, sorted(ops)):
        assert s.t0_ns - slack <= t0 <= t1 <= s.t1_ns + slack
