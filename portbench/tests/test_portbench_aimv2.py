"""The ``aimv2-l14.ingest`` cell's harness at a size a CPU holds: a dry
run (untraced and traced), the benchmark's AIMv2 reference against
``transformers.Aimv2Model``, the planted faults (a dropped append, the
fp8 control) read not correct, the three new readers on a synthetic
slice, and the manifest's new entries.

The tiny tower keeps AIMv2's shape of block (RMSNorm, gated MLP, 128-wide
heads, the pooling head) at width 256, 2 heads, MLP width 512, depth 1,
224 px frames in 56 px patches (S = 16), projection 64; the traffic and
the driver are the cell's own."""

import copy
import json
import math

import pytest
import torch

from portbench import control, gen_aimv2, run
from portbench.readers_aimv2 import halves
from portbench.reference import aimv2 as ref_aimv2
from portbench.tests import tiny
from portbench.tests.test_portbench_dryrun import _drop_appends, loose
from portbench.trace import DeviceOp, Slice

CELL = "aimv2-l14.ingest"
CONFIG = "aimv2-large-patch14-224-lit"
PORT_NAME = "portbench-tiny-aimv2"


def tiny_config() -> dict:
    cfg = copy.deepcopy(json.loads(
        (tiny.ROOT / "portbench" / "configs" / f"{CONFIG}.json").read_text()))
    cfg.update(port_model=PORT_NAME, projection_dim=64)
    for tower in ("text_config", "vision_config"):
        cfg[tower].update(hidden_size=256, intermediate_size=512,
                          num_attention_heads=2, num_hidden_layers=1)
    cfg["vision_config"]["patch_size"] = 56
    return cfg


@pytest.fixture(scope="module", autouse=True)
def program():
    run.prepare_environment(tiny.ROOT, trace=True)
    from video_quierer_tpu_torch.models.aimv2 import config as ac
    ac.register_config(PORT_NAME, lambda: ac.from_hf(
        dict(tiny_config(), name=PORT_NAME)))


def dry(trace=False, limits=None):
    return run.run_cell(tiny.ROOT, CELL, tiny.SEED, 1.0, trace, device="cpu",
                        overrides=tiny.OVERRIDES, config=tiny_config(),
                        limits=limits, manifest=tiny.manifest())


@pytest.mark.parametrize("trace", [False, True])
def test_dry_run(trace):
    result, checks = dry(trace)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(math.isfinite(v) for v in checks.values()), checks
    assert checks["missing_rows"] == 0
    metrics = result["metrics"]
    if trace:
        # no device operations on the CPU: no device metric is read
        assert not any("roofline" in m or "mfu" in m or "idle" in m
                       for m in metrics)
    else:
        assert set(metrics) == {"setup_s", "ingest_fps.l14"}
    assert run.forbidden_modules() == []


def test_reference_matches_transformers():
    """The benchmark's reference at f32 against ``Aimv2Model`` (its
    all-ones attention mask makes the text tower causal), on the seeded
    weights of ``gen_aimv2``; atol 2e-5 on unit rows (f32 sums in
    another order)."""
    from transformers import Aimv2Config, Aimv2Model
    cfg = tiny_config()
    sd = gen_aimv2.weights(cfg, "cpu", torch.float32, 5)
    hf = Aimv2Model(Aimv2Config(
        projection_dim=64,
        text_config={k: v for k, v in cfg["text_config"].items()},
        vision_config={k: v for k, v in cfg["vision_config"].items()}))
    hf.config._attn_implementation = "eager"
    hf.load_state_dict(sd)
    hf.eval()
    px = torch.randn(3, 224, 224, 3, generator=torch.Generator()
                     .manual_seed(1))
    ids = torch.randint(1, 49406, (4, 16), generator=torch.Generator()
                        .manual_seed(2))
    ids[:, 7:] = 49407
    with torch.no_grad():
        out = hf(input_ids=ids, pixel_values=px.permute(0, 3, 1, 2),
                 attention_mask=torch.ones_like(ids))
        img = ref_aimv2.encode_image(sd, cfg, px)
        txt = ref_aimv2.encode_text(sd, cfg, ids)
    torch.testing.assert_close(img, out.image_embeds, atol=2e-5, rtol=0)
    torch.testing.assert_close(txt, out.text_embeds, atol=2e-5, rtol=0)


def test_dropped_append_is_not_correct(monkeypatch):
    _, checks = dry()
    limits = loose(checks)
    assert dry(limits=limits)[0]["correct"]
    _drop_appends(monkeypatch)
    broken, _ = dry(limits=limits)
    assert not broken["correct"]


def test_fp8_control_is_not_correct():
    cfg = tiny_config()
    _, reading = dry()
    limits = loose(reading, factor=3.0)
    assert run.judge(reading, limits)[0]
    low = control.read(tiny.ROOT, CELL, tiny.SEED, "fp8", "cpu",
                       tiny.OVERRIDES, cfg, limits, tiny.manifest())
    assert not low["correct"], (low, reading)


def _readings(cfg):
    """A synthetic slice of 2 batches: per block, the attention half's
    four kernels and the gated half's three, under the names the
    profiler gives them, each 1 ms."""
    names = ["void (anonymous namespace)::rms_bf16<4>(...)",
             "void (anonymous namespace)::gemm_wgmma<128, 128, 3>(...)",
             "(anonymous namespace)::attn_bf16<128>(...)",
             "void (anonymous namespace)::gemm_wgmma<128, 128, 3>(...)",
             "void (anonymous namespace)::rms_bf16<4>(...)",
             "void (anonymous namespace)::gemm_wgmma<128, 128, 4>(...)",
             "void (anonymous namespace)::gemm_wgmma<128, 128, 3>(...)"]
    ops = [DeviceOp(n, 1000.0 * i, 1000.0)
           for i, n in enumerate(names * 48)]
    s = Slice(ops=ops, window_s=0.4, busy_s=0.336, device_ops=[],
              idle_gaps=[], units=2)

    class R:
        pass
    r = R()
    r.cfg, r.traffic, r.slice = cfg, {"batch_frames": 256}, s
    return r


def test_new_readers_read_a_synthetic_slice():
    cfg = json.loads((tiny.ROOT / "portbench" / "configs"
                      / f"{CONFIG}.json").read_text())
    r = _readings(cfg)
    attn, mlp = halves(r.slice.ops)
    assert len(attn) == len(mlp) == 48
    values = {}
    for name in ("ingest.attn_roofline.aimv2", "ingest.mlp_roofline.aimv2",
                 "ingest_mfu.aimv2"):
        values[name] = run.load_reader(tiny.ROOT, name)(r)
        assert isinstance(values[name], float) and values[name] > 0
    # 1 ms a kernel: the gated half's 3.0 ms against its least time at
    # 65,536 tokens (1.13 ms)
    t = 256 * 256
    least = 6 * t * 1024 * 2816 / 989e12
    assert values["ingest.mlp_roofline.aimv2"] == pytest.approx(
        100 * least / 3e-3)
    # a CLIP slice reads nothing
    r.slice.ops = [DeviceOp(o.name.replace("rms_bf16", "ln_bf16")
                            .replace(", 3>", ", 0>").replace(", 4>", ", 1>"),
                            o.start_us, o.dur_us) for o in r.slice.ops]
    assert all(run.load_reader(tiny.ROOT, n)(r) is None for n in values)


def test_manifest_adds_one_config_one_cell_and_only_new_entries():
    m = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    mine = {g: [e for e in m[g] if "aimv2" in e["name"]]
            for g in ("configs", "workloads", "end_to_end", "per_layer")}
    assert [e["name"] for e in mine["configs"]] == [CONFIG]
    assert mine["configs"][0]["reduced"] == []
    assert mine["workloads"] == [{
        "name": CELL, "config": CONFIG, "traffic": "ingest_aimv2",
        "chips": 1, "why": mine["workloads"][0]["why"]}]
    # no end-to-end metric of its own: the cell reports the card-paced
    # L/14 ingest rate, appended to that metric's cells
    assert mine["end_to_end"] == []
    fps = [e for e in m["end_to_end"] if CELL in e.get("workloads", [])]
    assert [(e["name"], e["bound"], e["workloads"]) for e in fps] == [
        ("ingest_fps.l14", 0.15, ["clip-l14.ingest", CELL])]
    assert sorted(e["name"] for e in mine["per_layer"]) == sorted([
        "ingest.attn_roofline.aimv2", "ingest.mlp_roofline.aimv2",
        "ingest_mfu.aimv2", "ingest.fetch_ms.aimv2",
        "ingest.device_idle_pct.aimv2"])
    assert all(e["moves"] == "ingest_fps.l14" and e["workloads"] == [CELL]
               for e in mine["per_layer"])
    # appended at the end of each list, and no earlier entry names the
    # new cell, but for the metric it reports
    for g, entries in mine.items():
        earlier = m[g][:len(m[g]) - len(entries)]
        assert m[g][len(earlier):] == entries
        for e in earlier:
            if e in fps:
                continue
            assert CELL not in e.get("workloads", []) and \
                "aimv2" not in json.dumps(e)
    # the traffic is the CLIP ingest cells', parameter for parameter
    tr = {n: json.loads((tiny.ROOT / "portbench" / "traffic"
                         / f"{n}.json").read_text())
          for n in ("ingest", "ingest_aimv2")}
    assert tr["ingest_aimv2"] == dict(tr["ingest"], driver="ingest_aimv2")
