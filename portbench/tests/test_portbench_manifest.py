"""BENCHMARK.json against the benchmark's contract: names, units,
bounds, and a file for every configuration, traffic mix, limit and
per-layer metric."""

import json
import re

import pytest

from portbench import run
from portbench.tests import tiny
from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module", params=["committed", "with held cells"])
def manifest(request):
    """BENCHMARK.json, and the same with the cells held out of it
    (``portbench/held/``) put back, as a later PR would."""
    if request.param == "committed":
        return json.loads((ROOT / "BENCHMARK.json").read_text())
    return tiny.manifest()


def test_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


def test_names_and_units(manifest):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for key in ("why", "layer"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(set(names)) == len(names)
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)


def test_end_to_end(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in manifest["workloads"]}
    for cell in cells:
        mine = [m for m in e2e.values()
                if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine}
        assert len(mine) >= 2


def test_files_exist(manifest):
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert cfg["source"] == c["source"] and c["reduced"] == []
    for w in manifest["workloads"]:
        assert w["chips"] == 1
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()
    for m in manifest["per_layer"]:
        assert run.reader_path(ROOT, m["name"]).exists()


def test_per_layer(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", cells)
        for cell in m["workloads"]:
            assert cell in cells and cell in moved
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = [m for m in manifest["per_layer"]
                    if cell in m["workloads"]]
        assert reported and any("mfu" in m["name"] for m in reported)
