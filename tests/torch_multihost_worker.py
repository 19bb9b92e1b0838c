"""One process of a multi-process run of the port on the CPU, started by
``tests/test_torch_multihost.py`` with ``VQT_COORDINATOR``,
``VQT_NUM_PROCESSES`` and ``VQT_PROCESS_ID`` set:

    PYTHONPATH=. python tests/torch_multihost_worker.py {scans|engine} \
        WORKDIR TIMEOUT_S

It joins the gloo group through the port's ``initialize_distributed``
(a rendezvous or collective that takes longer than TIMEOUT_S raises),
reads its inputs from WORKDIR, and writes what it got to
``WORKDIR/<scenario>_out_<rank>.*``. It imports torch and the port only
(no JAX), as a process of a multi-host deployment does.

- ``scans``: the sharded scans of ``index/sharded.py`` over 8 shards, 4 a
  process, on meshes of 1, 2 and 4 slices (the 1-slice mesh spans both
  processes, so every shard's list crosses; on 2 and 4 slices each
  process holds its slices whole).
- ``engine``: a port engine per mirror tier (and one with the IVF tier
  over the bf16 mirror, one replica a process) over 8 shards in 2 slices,
  started from the pickle cache in a videos dir shared by both processes,
  with one new video to ingest; its searches, video ranking and removal.
  The IVF tier's k-means seed rows are the JAX package's, handed over in
  ``ivf_init.json``.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from video_quierer_tpu_torch.engine import config as engine_config
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index import ivf, sharded
from video_quierer_tpu_torch.models.clip import config as clip_config
from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
from video_quierer_tpu_torch.ops import topk
from video_quierer_tpu_torch.parallel import mesh as mesh_mod

SHARDS, LOCAL = 8, 4
CPU4 = ["cpu"] * LOCAL
# the engine's tower: tests/torch_parity.py:TINY_224_FULL_VOCAB's widths
TOWER = "torch-parity-tiny-224-vocab"
TIERS = ("bfloat16", "int8", "float32", "ivf")
QUERIES = ["a dog in the park", "the same deterministic query",
           "night city " * 30]
BATCH = [f"batch query {i}" for i in range(5)]


def tiny_tower():
    return clip_config.CLIPConfig(
        name=TOWER, projection_dim=64,
        vision=clip_config.CLIPVisionConfig(image_size=224, patch_size=56,
                                            hidden_size=128, num_layers=2,
                                            num_heads=2),
        text=clip_config.CLIPTextConfig(vocab_size=49408, context_length=77,
                                        hidden_size=128, num_layers=2,
                                        num_heads=2))


def mesh(slices: int):
    return mesh_mod.multislice_corpus_mesh(slices, SHARDS, devices=CPU4)


def scan_case(case: dict, data, m) -> tuple:
    """One case of ``scans_in``: the process-spanning scan over this
    process's shards."""
    int8 = case["int8"]
    bf16 = torch.bfloat16 if case.get("bf16") else None
    if int8:
        ops = [sharded.shard_corpus(torch.from_numpy(data["codes"]), m),
               sharded.shard_corpus(torch.from_numpy(data["scales"]), m)]
        fn = sharded.multislice_cosine_topk_int8
    else:
        ops = [sharded.shard_corpus(torch.from_numpy(data[case["rows"]]), m,
                                    bf16)]
        fn = sharded.multislice_cosine_topk
    perm = None
    if case["perm"]:
        perm = sharded.shard_corpus_vec(torch.from_numpy(data["perm"]), m)
    vals, idxs = fn(*ops, torch.from_numpy(data[case["queries"]]),
                    case["valid"], k=case["k"], mesh=m, impl=case["impl"],
                    perm=perm)
    return vals.numpy(), idxs.numpy()


def run_scans(work: Path, rank: int) -> None:
    topk.CAND_BUCKET = 128
    data = np.load(work / "scans_in.npz")
    cases = json.loads((work / "scans_cases.json").read_text())
    meshes = {s: mesh(s) for s in sorted({c["slices"] for c in cases})}
    out = {}
    for i, case in enumerate(cases):
        m = meshes[case["slices"]]
        assert m.multiprocess and m.n_shards == SHARDS
        out[f"vals{i}"], out[f"idxs{i}"] = scan_case(case, data, m)
    np.savez(work / f"scans_out_{rank}.npz", **out)


def rows(results) -> list:
    return [[r["video_name"], r["frame_id"], r["score"],
             r["formatted_time"]] for r in results]


def run_engine(work: Path, rank: int) -> None:
    os.environ["VQT_RERANK_FETCH"] = "40"
    topk.CAND_BUCKET = 128
    clip_config.register_config(TOWER, tiny_tower)
    tower = CLIPEmbedder(TOWER, dtype=torch.float32, device="cpu",
                         state_dict=torch.load(work / "tower.pt"))
    vec = np.load(work / "vector.npy")
    seeds = json.loads((work / "ivf_init.json").read_text())
    ivf.init_indices = lambda n, k, seed: np.asarray(
        seeds[f"{n},{k},{seed}"])
    out = {}
    for dtype in TIERS:
        cfg = engine_config.EngineConfig(
            videos_dir=str(work / dtype),
            api=engine_config.ApiConfig(max_frames=10))
        cfg.index.embed_dim = 64
        cfg.model.dtype = "float32"
        cfg.index.device_dtype = "bfloat16" if dtype == "ivf" else dtype
        if dtype == "ivf":
            cfg.index.kind = "ivf"
            cfg.index.ivf_min_rows = 64
            cfg.index.ivf_nlist = 8
            cfg.index.ivf_nprobe = 3
        cfg.index.corpus_shards = SHARDS
        cfg.index.corpus_slices = 2
        engine = VideoSearchEngine(str(work / dtype), config=cfg,
                                   embedder=tower, device="cpu",
                                   corpus_mesh=mesh(2))
        engine.startup()
        got = {"count": len(engine.index),
               "layout": engine.index._mirror_layout_cur,
               "local_shards": len(engine.index._device_emb),
               "ann": engine.ann_stats(),
               "ivf_replica": engine._ivf is not None
               and engine._ivf.mesh is None,
               "singles": [rows(engine.search_ex(q, k=5, use_cache=False)[0])
                           for q in QUERIES],
               "batch": [rows(r) for r in engine.search_batch(BATCH, k=4)],
               "vector": rows(engine.search_by_vector_ex(
                   vec, k=6, use_cache=False)[0]),
               "videos": engine.search_videos(QUERIES[0], k=3)}
        got["removed"] = engine.remove_video("vid0.mp4")
        got["after"] = rows(engine.search_ex(QUERIES[1], k=5,
                                             use_cache=False)[0])
        out[dtype] = got
    (work / f"engine_out_{rank}.json").write_text(json.dumps(out))


def main() -> int:
    scenario, work, timeout_s = sys.argv[1], Path(sys.argv[2]), \
        float(sys.argv[3])
    torch.set_num_threads(1)
    assert mesh_mod.initialize_distributed("cpu", timeout_s=timeout_s)
    rank = torch.distributed.get_rank()
    try:
        {"scans": run_scans, "engine": run_engine}[scenario](work, rank)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
