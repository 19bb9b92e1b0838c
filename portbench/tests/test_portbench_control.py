"""The control of each cell's check: the reference in the precision
below the configuration's (fp8 for the bf16 towers, TF32 for f32
training), and the half-batch fault, put in the program's place and
judged as a run is, comes out not correct. On the CPU at a tiny size,
under limits set from that size's sound run as a cell's are set from
its own (a few times its readings); on a card at the cells' own sizes,
under the cells' limits files (``python3 portbench/control.py`` prints
the same per seed)."""

import pytest
import torch

from portbench import control, run
from portbench.tests import tiny
from portbench.tests.test_portbench_dryrun import CELLS, loose

CONTROLS = [("clip-b32.search", "fp8"), ("clip-b32.ingest", "fp8"),
            ("clip-l14.ingest", "fp8"), ("clip-b32.finetune", "tf32"),
            ("clip-b32.finetune", "half-batch")]


@pytest.fixture(scope="module", autouse=True)
def program():
    run.prepare_environment(tiny.ROOT, trace=False)
    tiny.register()


@pytest.mark.parametrize("cell,prec", CONTROLS)
def test_control_is_not_correct(cell, prec):
    cfg = tiny.config(CELLS[cell])
    sound, program_reading = run.run_cell(
        tiny.ROOT, cell, tiny.SEED, 1.0, False, device="cpu",
        overrides=tiny.OVERRIDES, config=cfg, manifest=tiny.manifest())
    limits = loose(program_reading, factor=3.0)
    assert run.judge(program_reading, limits)[0]
    low = control.read(tiny.ROOT, cell, tiny.SEED, prec, "cpu",
                       tiny.OVERRIDES, cfg, limits, tiny.manifest())
    assert not low["correct"], (low, program_reading)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,prec", CONTROLS)
def test_control_is_not_correct_on_the_card(cell, prec):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        low = control.read(tiny.ROOT, cell, seed, prec,
                           manifest=tiny.manifest())
        assert not low["correct"], (seed, low)
