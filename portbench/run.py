"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration file and a traffic mix
(``portbench/traffic/<mix>.json``, whose ``driver`` is a module of
``portbench/drivers``); the limits of its correctness check are in
``portbench/limits/<cell>.json``, and each per-layer metric is read by
``portbench/metrics/<metric>.py`` (a metric split by cell, such as
``ingest_mfu.l14``, by its quantity's reader). Nothing here names a
cell.

A run loads and warms up (``setup_s``, from the start of this process to
the window's first request, step or batch), measures for ``--seconds``,
then reads the device's memory peak, frees the program and checks what
the window produced against the plain reference. With ``--trace 1`` a
slice of the window is profiled and the per-layer metrics are reported
instead of the end-to-end ones. The last line of standard output is the
result; the numbers compared are the last lines of standard error, each
beside its limit, and the result's last key.

Exits non-zero, printing no result, where CUDA is missing or has fewer
cards than the cell asks for, where the program cannot be imported, or
where ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "video_quierer_tpu")


def prepare_environment(root: Path, trace: bool) -> None:
    """Before anything imports the program: its knobs at their defaults,
    its caches inside the checkout, its stage spans on for a traced
    run."""
    for k in [k for k in os.environ if k.startswith("VQT_")]:
        del os.environ[k]
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if trace:
        os.environ["VQT_SERVING_PROFILE"] = "1"
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Context:
    """One run: the cell, its configuration and traffic, the device, and
    what the driver keeps between its phases. ``overrides`` shrink named
    sizes (tests at a size a CPU holds)."""

    def __init__(self, cell, cfg, traffic, seed, seconds, device,
                 overrides=None):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds = seed, seconds
        self.device = device
        self.overrides = overrides or {}
        self.state, self.notes = {}, {}
        self.t_window = None

    def size(self, key: str, default):
        return self.overrides.get(key, default)

    def mark_window_start(self, t: float) -> None:
        self.t_window = t


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find_cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def load_cell(root: Path, name: str, manifest=None):
    manifest = manifest or load_json(root / "BENCHMARK.json")
    cell = find_cell(manifest, name)
    cfg_entry = next(c for c in manifest["configs"]
                     if c["name"] == cell["config"])
    cfg = load_json(root / cfg_entry["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{cell['traffic']}.json")
    return manifest, cell, cfg, traffic


def cell_metrics(manifest: dict, cell: str, kind: str) -> list:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
    e2e = [m["name"] for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def reader_path(root: Path, name: str) -> Path:
    """``portbench/metrics/<name>.py``, else the reader of the name
    without its last dotted part, and so on: a quantity split by cell
    (``ingest.attn_roofline.l14``) is read as the quantity is."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "portbench" / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return path
    raise FileNotFoundError(f"portbench: no reader for metric {name!r}")


def load_reader(root: Path, name: str):
    path = reader_path(root, name)
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class GcPauses:
    """The collector's full (oldest-generation) passes from now until
    :meth:`close`: how many, their seconds, the longest."""

    def __init__(self):
        self.passes, self.t0 = [], None
        gc.callbacks.append(self._on)

    def _on(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            self.passes.append(time.perf_counter() - self.t0)
            self.t0 = None

    def close(self) -> dict:
        gc.callbacks.remove(self._on)
        return {"full_passes": len(self.passes),
                "seconds": sum(self.passes),
                "longest_s": max(self.passes, default=0.0)}


class Readings:
    """What the per-layer readers read: the window's counters, stage
    spans and host clocks, the traced slice, the cell's sizes."""

    def __init__(self, ctx: Context, win: dict, slice_):
        self.cell, self.cfg, self.traffic = ctx.cell, ctx.cfg, ctx.traffic
        self.seconds = ctx.seconds
        self.state = ctx.state
        self.counters = win.get("counters", {})
        self.spans = win.get("spans", {})
        self.host = win.get("host", {})
        self.encode_log = win.get("encode_log", [])
        self.slice = slice_


def device_info(device, trace_slice) -> dict:
    import torch
    if device.type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1,
                "memory_peak_bytes": int(
                    torch.cuda.max_memory_allocated(device))}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace_slice is not None:
        info["busy_s"] = trace_slice.busy_s
        info["window_s"] = trace_slice.window_s
    return info


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device=None, overrides=None, config=None,
             limits=None, manifest=None) -> tuple:
    """One run; returns ``(result, checks)``. ``device`` None: the first
    CUDA card. ``config`` and ``limits`` replace the cell's files, and
    ``manifest`` BENCHMARK.json (tests on the CPU at a size it holds)."""
    import torch
    from portbench.reference.clip import no_tf32
    from portbench.trace import Tracer

    manifest, cell, cfg, traffic = load_cell(root, workload, manifest)
    cfg = config or cfg
    limits = limits or load_limits(root, workload)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    device = torch.device("cuda", 0) if device is None \
        else torch.device(device)
    ctx = Context(workload, cfg, traffic, seed, seconds, device, overrides)
    sl = traffic["trace_slice"]
    start = sl["start"] * seconds
    tracer = Tracer(trace, start, start + min(sl["seconds"],
                                              sl["max_share"] * seconds))
    driver.setup(ctx)
    failed_run = None
    pauses = GcPauses()
    try:
        win = driver.window(ctx, tracer)
    except Exception:
        failed_run = traceback.format_exc()
        win = {"e2e": {}, "attempted": 1, "failed": 1}
    tracer.stop()
    ctx.notes["gc"] = pauses.close()
    slice_ = tracer.slice
    info = device_info(device, slice_)
    setup_s = (ctx.t_window or time.perf_counter()) - T_PROCESS
    readings = Readings(ctx, win, slice_)
    metrics = {}
    if trace:
        for m in cell_metrics(manifest, workload, "per_layer"):
            value = load_reader(root, m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # a driver names each quantity once (``ingest_fps``); a cell may
        # report it under a name of its own (``ingest_fps.l14``)
        e2e = dict(win["e2e"], setup_s=setup_s)
        for m in cell_metrics(manifest, workload, "end_to_end"):
            value = e2e.get(m["name"], e2e.get(m["name"].split(".")[0]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the reference runs once the window has closed, the peak has been
    # read and the program's state is freed
    checks = {}
    try:
        driver.release(ctx)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        no_tf32()
        if failed_run is None:
            checks = driver.check(ctx)
    except Exception:
        failed_run = (failed_run or "") + traceback.format_exc()
    if failed_run:
        print(failed_run, file=sys.stderr)
    within, checks = judge(checks, limits)
    correct = failed_run is None and win["failed"] == 0 and within
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": info}
    if trace and slice_ is not None:
        result["breakdown"] = {"device_ops": slice_.device_ops,
                               "idle_gaps": slice_.idle_gaps}
    result["notes"] = dict(ctx.notes)
    result["checks"] = {n: {"value": finite(checks[n]),
                            "limit": limits["limits"][n]} for n in checks}
    return result, checks


def judge(checks: dict, limits: dict) -> tuple:
    """Whether every number of ``limits`` is within its limit, and the
    numbers by name (a number that never came reads infinite)."""
    names = list(limits["limits"])
    checks = {n: checks.get(n, math.inf) for n in names}
    return all(checks[n] <= limits["limits"][n] for n in names), checks


def load_limits(root: Path, workload: str) -> dict:
    return load_json(root / "portbench" / "limits" / f"{workload}.json")


def finite(x: float):
    """A number as JSON carries it: None for a reading that never came."""
    return x if math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = ROOT
    prepare_environment(root, bool(args.trace))
    import torch
    _, cell, _, _ = load_cell(root, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        import video_quierer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program does not import: {e}",
              file=sys.stderr)
        return 2
    result, _ = run_cell(root, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"portbench check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
