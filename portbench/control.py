"""The control of a cell's correctness check: the plain reference put in
the program's place, computed in the precision below the one the
configuration states, read as the program's answers are.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 \
        --prec fp8

runs at the cell's own size on the first CUDA card and prints one JSON
line a seed: the readings, each beside its limit from
``portbench/limits/<cell>.json``, and ``correct`` as a run judges it
(a control has to come out not correct). ``--prec f32`` reads the
reference against itself; ``--prec half-batch`` (fine-tuning) reads the
fault of a step that leaves half of its batch out. The benchmark's runs
never run it; ``portbench/tests/test_portbench_control.py`` runs it at a
size a CPU holds, and at the cells' own sizes on a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


def read(root: Path, workload: str, seed: int, prec: str, device=None,
         overrides=None, config=None, limits=None, manifest=None) -> dict:
    """The control's readings judged as a run's are: ``{"correct",
    "checks": {name: {"value", "limit"}}}``. ``limits`` and ``manifest``
    replace the cell's file and BENCHMARK.json (tests at a size a CPU
    holds)."""
    import torch
    from portbench.reference.clip import no_tf32
    _, _, cfg, traffic = run.load_cell(root, workload, manifest)
    device = torch.device("cuda", 0) if device is None \
        else torch.device(device)
    ctx = run.Context(workload, config or cfg, traffic, seed, 0.0, device,
                      overrides)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    no_tf32()
    driver.control_setup(ctx)
    limits = limits or run.load_limits(root, workload)
    correct, checks = run.judge(driver.control(ctx, prec), limits)
    return {"correct": correct,
            "checks": {n: {"value": run.finite(v),
                           "limit": limits["limits"][n]}
                       for n, v in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--prec", required=True,
                    choices=("f32", "tf32", "fp8", "half-batch"))
    args = ap.parse_args(argv)
    run.prepare_environment(ROOT, False)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = read(ROOT, args.workload, seed, args.prec)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "prec": args.prec, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
