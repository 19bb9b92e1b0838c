"""A tower and sizes a CPU holds, for the benchmark's own tests: every
width cut, depth 1, a 20,000-row library; the cells' traffic and
drivers as they are."""

from __future__ import annotations

import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PORT_NAME = "portbench-tiny"
OVERRIDES = dict(rows=20000, clients=4, check_searches=16, pool_videos=2,
                 headroom_rows=5000, batch=8, batches=4, check_videos=2)
SEED = 2 ** 31 + 12345


def manifest() -> dict:
    """BENCHMARK.json with the cells held out of it merged in
    (``portbench/held/<cell>.json``: the entries a cell had, for a later
    PR to bring back), so that their harness stays tested."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((ROOT / "portbench" / "held").glob("*.json")):
        for key, entries in json.loads(f.read_text()).items():
            m[key] = m[key] + entries
    return m


def register() -> None:
    """The tiny tower under ``PORT_NAME`` in the program's registry."""
    from video_quierer_tpu_torch.models.clip import config as pc
    pc.register_config(PORT_NAME, lambda: pc.CLIPConfig(
        name=PORT_NAME, projection_dim=32,
        vision=pc.CLIPVisionConfig(hidden_size=64, num_layers=1,
                                   num_heads=1),
        text=pc.CLIPTextConfig(hidden_size=64, num_layers=1, num_heads=1)))


def config(name: str = "clip-vit-b-32") -> dict:
    cfg = copy.deepcopy(json.loads(
        (ROOT / "portbench" / "configs" / f"{name}.json").read_text()))
    cfg.update(port_model=PORT_NAME, projection_dim=32)
    for tower in ("text_config", "vision_config"):
        cfg[tower].update(hidden_size=64, intermediate_size=256,
                          num_attention_heads=1, num_hidden_layers=1)
    cfg["vision_config"]["patch_size"] = 32
    cfg.setdefault("train", {"dtype": "float32", "tf32": False,
                             "learning_rate": 1e-5, "weight_decay": 0.01})
    return cfg
