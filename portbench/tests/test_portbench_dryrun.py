"""Each cell run end to end at a size a CPU holds, and the check seeing
the faults a cell can have: a run with the timed path broken underneath
comes out not correct, where the same run unbroken is correct under the
same limits."""

import math

import pytest
import torch

from portbench import run
from portbench.tests import tiny

CELLS = {"clip-b32.search": "clip-vit-b-32",
         "clip-b32.ingest": "clip-vit-b-32",
         "clip-l14.ingest": "clip-vit-l-14",
         "clip-b32.finetune": "clip-vit-b-32"}


@pytest.fixture(scope="module", autouse=True)
def program():
    run.prepare_environment(tiny.ROOT, trace=True)
    tiny.register()


def dry(cell, trace=False, limits=None, seconds=1.0):
    return run.run_cell(tiny.ROOT, cell, tiny.SEED, seconds, trace,
                        device="cpu", overrides=tiny.OVERRIDES,
                        config=tiny.config(CELLS[cell]), limits=limits,
                        manifest=tiny.manifest())


# the least room over a sound tiny run's reading: the tiny towers' leaves
# are 64 wide, so one element of a LayerNorm scale near 1 that rounds
# the other way in f32 moves its change's norm by some 1e-4, and the
# end stretch's reading varies with the steps the window took
FLOOR = {"change_gap": 1e-3}


def loose(checks, factor=4.0):
    """Limits a few times over a sound tiny run's readings."""
    return {"limits": {k: (0 if k == "missing_rows"
                           else factor * v + FLOOR.get(k, 1e-6))
                       for k, v in checks.items()}}


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_dry_run(cell, trace):
    result, checks = dry(cell, trace)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert all(math.isfinite(v) for v in checks.values()), checks
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    metrics = result["metrics"]
    if trace:
        assert "setup_s" not in metrics
        # no device operations on the CPU: no device metric is read
        assert not any("roofline" in m or "mfu" in m or "idle" in m
                       for m in metrics)
    else:
        assert metrics["setup_s"]["value"] > 0 and len(metrics) == 2
    assert run.forbidden_modules() == []


def _shift_rows(monkeypatch):
    from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
    inner = DeviceVideoIndex._rows_from

    def rows_from(self, vals, idxs):
        return inner(self, vals, (idxs + 1) % max(1, self.count))
    monkeypatch.setattr(DeviceVideoIndex, "_rows_from", rows_from)


def _drop_appends(monkeypatch):
    from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
    inner = DeviceVideoIndex.add_batch

    def add_batch(self, embeddings, video_name, stamps):
        if not video_name.startswith("new_"):
            return inner(self, embeddings, video_name, stamps)
    monkeypatch.setattr(DeviceVideoIndex, "add_batch", add_batch)


def _alter_rows(monkeypatch):
    from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
    inner = CLIPEmbedder.embed_frames_device

    def embed(self, frames):
        # the device rows and their host copy alike (on the CPU the
        # re-rank store shares the host rows' memory)
        dev, host = inner(self, frames)
        n = host.shape[0]
        dev = dev.clone()
        dev[:n] = dev[:n].flip(0)
        return dev, host[::-1].copy()
    monkeypatch.setattr(CLIPEmbedder, "embed_frames_device", embed)


def _unchanged_state(monkeypatch):
    from video_quierer_tpu_torch.train.trainer import CLIPTrainer
    monkeypatch.setattr(CLIPTrainer, "_apply", lambda self, g: None)


def _half_batch(monkeypatch):
    from video_quierer_tpu_torch.train.trainer import CLIPTrainer
    inner = CLIPTrainer._loss_and_grads

    def loss_and_grads(self, images, ids):
        n = images.shape[0] // 2
        return inner(self, images[:n], ids[:n])
    monkeypatch.setattr(CLIPTrainer, "_loss_and_grads", loss_and_grads)


def _late_unchanged_state(monkeypatch):
    """Steps past the first few leave the state unchanged: a fault that
    only the end of the window shows."""
    from video_quierer_tpu_torch.train.trainer import CLIPTrainer
    inner = CLIPTrainer._apply

    def apply(self, g):
        if self.state.opt_state["count"] < 4:
            inner(self, g)
    monkeypatch.setattr(CLIPTrainer, "_apply", apply)


def _altered_loss(monkeypatch):
    from video_quierer_tpu_torch.train.trainer import CLIPTrainer
    inner = CLIPTrainer.step
    monkeypatch.setattr(CLIPTrainer, "step",
                        lambda self, i, t: inner(self, i, t) * 1.01)


FAULTS = [("clip-b32.search", _shift_rows),
          ("clip-b32.ingest", _drop_appends),
          ("clip-b32.ingest", _alter_rows),
          ("clip-b32.finetune", _unchanged_state),
          ("clip-b32.finetune", _half_batch),
          ("clip-b32.finetune", _late_unchanged_state),
          ("clip-b32.finetune", _altered_loss)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    sound, checks = dry(cell)
    limits = loose(checks)
    assert dry(cell, limits=limits)[0]["correct"]
    fault(monkeypatch)
    broken, _ = dry(cell, limits=limits)
    assert not broken["correct"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_dry_run_on_the_card(cell, cuda):
    result, checks = run.run_cell(
        tiny.ROOT, cell, tiny.SEED, 1.0, True, device=cuda,
        overrides=tiny.OVERRIDES, config=tiny.config(CELLS[cell]),
        manifest=tiny.manifest())
    assert result["failed"] == 0
    assert result["device"]["busy_s"] > 0
    assert all(math.isfinite(v) for v in checks.values())
