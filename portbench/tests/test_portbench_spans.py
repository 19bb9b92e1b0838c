"""The readers of the program's spans (``portbench/spans.py``): in a
traced run on the CPU the ingest cells' span readers read numbers that
agree with the harness's own clocks, and the slice readers, given a
slice of device operations laid over the fine-tuning run's logged steps,
read what those steps' spans say; a program without the log, or a log
that dropped events inside the slice, reads None."""

import types

import pytest

from portbench import run, spans
from portbench.tests import tiny
from portbench.trace import DeviceOp, Slice

CELLS = {"clip-b32.ingest": "clip-vit-b-32",
         "clip-l14.ingest": "clip-vit-l-14",
         "clip-b32.finetune": "clip-vit-b-32"}


@pytest.fixture(scope="module", autouse=True)
def program():
    from video_quierer_tpu_torch.utils import stageprof
    run.prepare_environment(tiny.ROOT, trace=True)
    tiny.register()
    was = stageprof.ENABLED
    stageprof.enable(True)
    yield stageprof
    stageprof.enable(was)


def traced(cell):
    result, _ = run.run_cell(tiny.ROOT, cell, tiny.SEED, 1.0, True,
                             device="cpu", overrides=tiny.OVERRIDES,
                             config=tiny.config(CELLS[cell]),
                             manifest=tiny.manifest())
    assert result["failed"] == 0
    return {k: v["value"] for k, v in result["metrics"].items()}


@pytest.mark.parametrize("cell,suffix", [("clip-b32.ingest", ""),
                                         ("clip-l14.ingest", ".l14")])
def test_ingest_span_readers_read_numbers(cell, suffix):
    m = traced(cell)
    for name in ("ingest.stack_ms", "ingest.fetch_ms", "ingest.index_ms"):
        assert m[name + suffix] > 0, name
    # the stack runs inside the loop's wait for its batch; the appends'
    # span holds the harness's timed calls
    assert m["ingest.stack_ms" + suffix] <= m["ingest.frame_wait_ms"
                                              + suffix]
    assert m["ingest.index_ms" + suffix] >= m["ingest.append_ms" + suffix]


def _steps(stageprof):
    """The logged training steps, by step number: ``{name: event}``."""
    steps = {}
    for e in stageprof.events()[0]:
        if e.name in spans.STEP:
            steps.setdefault(e.unit, {})[e.name] = e
    return [steps[u] for u in sorted(steps)]


def _readings(ops):
    return types.SimpleNamespace(
        slice=Slice(ops=ops, window_s=1.0, busy_s=0.5, device_ops=[],
                    idle_gaps=[], units=len(ops)),
        spans={}, host={})


def test_step_readers_read_the_logged_steps(program):
    traced("clip-b32.finetune")
    steps = _steps(program)
    assert len(steps) >= 5 and all(len(s) == 4 for s in steps)
    # one device op a step, over its backward span: the slice runs from
    # the first step's backward to the last one's, so only the steps
    # between lie whole within it
    ops = [DeviceOp("k", s["train.backward"].t0_ns / 1e3,
                    (s["train.backward"].t1_ns - s["train.backward"].t0_ns)
                    / 1e3) for s in steps]
    r = _readings(ops)
    whole = steps[1:-1]

    def mean_ms(names):
        return sum((s[n].t1_ns - s[n].t0_ns) for s in whole
                   for n in names) / 1e6 / len(whole)

    launch = run.load_reader(tiny.ROOT, "train.launch_ms")(r)
    sync = run.load_reader(tiny.ROOT, "train.sync_ms")(r)
    assert launch == pytest.approx(mean_ms(spans.LAUNCH))
    assert sync == pytest.approx(mean_ms(("train.loss_fetch",)))
    # each gap, from a step's backward to the next one's, holds the
    # optimizer and the next forward (launch spans) and the loss fetch
    inside = sum(a["train.optimizer"].t1_ns - a["train.optimizer"].t0_ns
                 + b["train.forward"].t1_ns - b["train.forward"].t0_ns
                 for a, b in zip(steps, steps[1:]))
    idle = sum(b["train.backward"].t0_ns - a["train.backward"].t1_ns
               for a, b in zip(steps, steps[1:]))
    share = run.load_reader(tiny.ROOT, "train.idle_in_launch_pct")(r)
    assert share == pytest.approx(100.0 * inside / idle)
    assert 0 < share < 100


def test_readers_read_none_without_the_log_or_past_a_drop(program,
                                                          monkeypatch):
    traced("clip-b32.finetune")
    steps = _steps(program)
    first, last = steps[1]["train.forward"], steps[-2]["train.loss_fetch"]
    ops = [DeviceOp("k", first.t0_ns / 1e3, 1.0),
           DeviceOp("k", (last.t1_ns - 1000) / 1e3, 1.0)]
    r = _readings(ops)
    names = ("train.launch_ms", "train.sync_ms", "train.idle_in_launch_pct",
             "ingest.idle_in_frames_pct")
    read = {n: run.load_reader(tiny.ROOT, n) for n in names}
    assert read["train.launch_ms"](r) is not None
    assert read["ingest.idle_in_frames_pct"](r) is None   # no such span
    evs, _ = program.events()
    # the log dropped events that ended after the slice began
    late = [e for e in evs if e.t1_ns > first.t0_ns]
    monkeypatch.setattr(program, "events", lambda since_ns=0: (late, 1))
    assert all(read[n](r) is None for n in names)
    # ... and events that ended before it: the slice is whole
    monkeypatch.setattr(program, "events", lambda since_ns=0: (evs, 1))
    assert read["train.launch_ms"](r) is not None
    # a program without the log (the parent of the log's change)
    monkeypatch.delattr(program, "events")
    assert all(read[n](r) is None for n in names)
    assert spans.ms_per_batch(r, "frames.stack") is None
