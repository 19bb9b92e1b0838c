"""Multi-process serving on the CPU: two processes of the port, each with
4 ``"cpu"`` shards of an 8-shard corpus mesh, joined by the port's
``initialize_distributed`` from ``VQT_COORDINATOR`` /
``VQT_NUM_PROCESSES`` / ``VQT_PROCESS_ID`` over gloo
(``tests/torch_multihost_worker.py``), held against the JAX package on
its 8 virtual CPU devices in this process (its Pallas kernels in
interpret mode, ``CAND_BUCKET`` 128 in both packages).

- The scans: ``multislice_cosine_topk`` and ``multislice_cosine_topk_int8``
  over meshes of 1 slice (every shard's list crosses processes), 2 and 4
  slices (each process merges its slices whole, then the slices' winners
  cross), exact (B8 on f32 and bf16 rows, B9) and the perm-layout
  candidate stages (B10, B11): every process returns the same rows,
  equal to JAX's, scores within rtol 1e-5; equal rows on shards of
  different slices come back in global row order
  (``tests/test_multislice.py:70``). The inputs make every score exact.
- The engine, in the bfloat16, int8 and float32 tiers and the IVF tier
  (over bf16, one replica a process, B12's plain version; its k-means
  seed rows JAX's, as ``tests/test_torch_engine_mesh.py`` hands them
  over): both processes
  start from one pickle cache in one videos dir, ingest a new video, save
  the cache (process 0 alone), then run ``search_ex(use_cache=False)``,
  ``search_batch``, a vector search and ``search_videos``, remove a video
  and search again; the JAX engine over a ``(dcn, corpus)`` mesh of the
  same 8 shards does the same. Rows: the same frames in the same order on
  every process (bit for bit) and in JAX, scores within rtol 1e-5 (the
  two packages' f32 towers differ in summation order).

Each run spawns two processes once (a module fixture) and gives every
spawn, rendezvous, collective and join its own timeout, so a hang fails
its tests instead of the suite.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_multihost_worker as w
from tests.helpers import make_synthetic_video
from tests.torch_parity import (
    TINY_224_FULL_VOCAB,
    jax_kmeans_init,
    port_state_dict,
    unit_rows,
)
from video_quierer_tpu.engine import config as jax_config
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu.index import sharded as jax_sh
from video_quierer_tpu.models.clip.embedder import \
    CLIPEmbedder as JaxEmbedder
from video_quierer_tpu.ops import topk as jax_topk
from video_quierer_tpu.parallel import mesh as jax_mesh
from video_quierer_tpu_torch.index import sharded as port_sh
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.ingest import frames as port_frames

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_multihost_worker.py"
PROCS, SHARDS, SHARD_ROWS, D = 2, 8, 4096, 128
N_PAD = SHARDS * SHARD_ROWS
# a rendezvous or collective in a child; the whole run of the children
COLLECTIVE_S, RUN_S = 60, 300
TIERS = w.TIERS
ENGINE_D = 64


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario: str, work: Path) -> list:
    """Start the two processes on a port bound just before."""
    port = free_port()
    procs = []
    for rank in range(PROCS):
        env = dict(os.environ, VQT_COORDINATOR=f"127.0.0.1:{port}",
                   VQT_NUM_PROCESSES=str(PROCS), VQT_PROCESS_ID=str(rank),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), scenario, str(work),
             str(COLLECTIVE_S)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def join(procs: list) -> None:
    """Wait for both (each within the run's timeout, killed past it);
    either failing fails the run with its output."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=RUN_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0] + "\n(killed: timed out)")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


# -- the scans --------------------------------------------------------------


def _rows(seed):
    """Multiples of 1/64 in [-1/8, 1/8]; rows repeated on shards of other
    slices."""
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-8, 9, (N_PAD, D)) / 64).astype(np.float32)
    for s in (3, 6):
        rows[s * SHARD_ROWS + 10: s * SHARD_ROWS + 60] = rows[10:60]
    return rows


def _ties():
    """Equal best rows on shards 0, 3 and 7 (slices 0 and 1 of two)."""
    rows = np.zeros((N_PAD, D), np.float32)
    for r in TIE_ROWS:
        rows[r, 0] = 1.0
    return rows


TIE_ROWS = (7, 3 * SHARD_ROWS + 2, 7 * SHARD_ROWS + 11)


def _inputs() -> dict:
    rng = np.random.default_rng(6)
    codes = rng.integers(-127, 128, (N_PAD, D)).astype(np.int8)
    codes[5 * SHARD_ROWS: 5 * SHARD_ROWS + 50] = codes[:50]
    scales = (2.0 ** -rng.integers(7, 9, (N_PAD, 1))).astype(np.float32)
    c = rng.integers(-126, 127, (3, D))
    c[:, 0] = 127
    tie_q = np.zeros((1, D), np.float32)
    tie_q[0, 0] = 1.0
    return {
        "rows": _rows(1), "ties": _ties(),
        "q": (np.random.default_rng(2).integers(-1024, 1025, (3, D))
              / 4096).astype(np.float32),
        "tie_q": tie_q, "codes": codes, "scales": scales,
        "q8": (c / 1024).astype(np.float32),
        "perm": np.random.default_rng(3).permutation(N_PAD).astype(
            np.int32)}


def _case(name, slices, impl="exact", rows="rows", queries="q", int8=False,
          bf16=False, perm=False, valid=N_PAD - 321, k=40):
    return dict(name=name, slices=slices, impl=impl, rows=rows,
                queries=queries, int8=int8, bf16=bf16, perm=perm,
                valid=valid, k=k)


CASES = [
    *[_case(f"exact f32, {s} slices", s) for s in (1, 2, 4)],
    _case("exact f32, shards 4-7 without a live row", 2,
          valid=3 * SHARD_ROWS + 100),
    _case("exact bf16 (B8 on bf16 rows)", 2, bf16=True),
    *[_case(f"cand bf16 perm (B10), {s} slices", s, impl="cand", bf16=True,
            perm=True, valid=20000) for s in (1, 2, 4)],
    _case("int8 exact (B9)", 2, int8=True, queries="q8", valid=20000),
    *[_case(f"int8 cand perm (B11), {s} slices", s, impl="cand", int8=True,
            queries="q8", perm=True, valid=20000) for s in (1, 2)],
    *[_case(f"ties across slices, {s} slices", s, rows="ties",
            queries="tie_q", valid=N_PAD, k=3) for s in (1, 2)],
]


def _jax_scan(case: dict, data: dict):
    m = (jax_mesh.corpus_mesh(SHARDS) if case["slices"] == 1
         else jax_mesh.multislice_corpus_mesh(case["slices"], SHARDS))
    if case["int8"]:
        ops = [jax_sh.shard_corpus(jnp.asarray(data["codes"]), m),
               jax_sh.shard_corpus(jnp.asarray(data["scales"]), m)]
        fn = jax_sh.multislice_cosine_topk_int8
    else:
        ops = [jax_sh.shard_corpus(jnp.asarray(
            data[case["rows"]], jnp.bfloat16 if case["bf16"] else None), m)]
        fn = jax_sh.multislice_cosine_topk
    perm = (jax_sh.shard_corpus_vec(jnp.asarray(data["perm"]), m)
            if case["perm"] else None)
    vals, idxs = fn(*ops, jnp.asarray(data[case["queries"]]), case["valid"],
                    k=case["k"], mesh=m, impl=case["impl"], perm=perm)
    return np.asarray(vals), np.asarray(idxs)


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """The two processes' lists for every case, and JAX's (computed while
    the processes run)."""
    work = tmp_path_factory.mktemp("scans")
    data = _inputs()
    np.savez(work / "scans_in.npz", **data)
    (work / "scans_cases.json").write_text(json.dumps(CASES))
    procs = spawn("scans", work)
    want = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQT_PALLAS_INTERPRET", "1")
        mp.setattr(jax_topk, "CAND_BUCKET", 128)
        try:
            want = [_jax_scan(case, data) for case in CASES]
        finally:
            join(procs)
    got = [np.load(work / f"scans_out_{r}.npz") for r in range(PROCS)]
    return got, want


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c["name"] for c in CASES])
def test_process_spanning_scan_matches_jax(scans, i):
    got, want = scans
    wv, wi = want[i]
    for out in got:
        np.testing.assert_array_equal(out[f"idxs{i}"], wi)
        np.testing.assert_allclose(out[f"vals{i}"], wv, rtol=1e-5, atol=0)
    # every process returns the same lists, bit for bit
    for name in (f"vals{i}", f"idxs{i}"):
        assert np.array_equal(got[0][name], got[1][name], equal_nan=True)


@pytest.mark.parametrize("slices", [1, 2])
def test_ties_across_slices_come_back_in_row_order(scans, slices):
    got, _ = scans
    i = next(j for j, c in enumerate(CASES) if c["rows"] == "ties"
             and c["slices"] == slices)
    for out in got:
        assert out[f"idxs{i}"][0].tolist() == list(TIE_ROWS)


@pytest.mark.parametrize("n_procs,n_local,per,want", [
    (2, 4, 4, [[("slice", 0)], [("slice", 1)]]),
    (2, 4, 2, [[("slice", 0), ("slice", 1)], [("slice", 2), ("slice", 3)]]),
    (2, 4, 8, [[("shard", i) for i in range(4)],
               [("shard", i) for i in range(4, 8)]]),
    (4, 1, 2, [[("shard", 0)], [("shard", 1)], [("shard", 2)],
               [("shard", 3)]]),
    (2, 3, 2, [[("slice", 0), ("shard", 2)], [("shard", 3), ("slice", 2)]]),
])
def test_exchange_plan(n_procs, n_local, per, want):
    """What crosses processes: a slice held whole goes as its winners, a
    slice that spans processes as its shards' lists."""
    mesh = types.SimpleNamespace(process_count=n_procs, n_local=n_local,
                                 per_slice=per)
    assert port_sh.exchange_plan(mesh) == want


# -- the engine -------------------------------------------------------------


def _cache(path: Path) -> None:
    """A v1.0 cache of 4 videos x 100 unit rows (10 rows repeated)."""
    emb = unit_rows(np.random.default_rng(0), 400, ENGINE_D)
    emb[300:310] = emb[10:20]
    index = DeviceVideoIndex(dim=ENGINE_D, device="cpu")
    for v in range(4):
        index.add_batch(emb[v * 100:(v + 1) * 100], f"vid{v}.mp4",
                        [float(t) for t in range(100)])
        index.video_hashes[f"vid{v}.mp4"] = f"hash{v}"
    assert index.save_to_disk(path)


def _jax_rows(results) -> list:
    return [[r["video_name"], r["frame_id"], r["score"],
             r["formatted_time"]] for r in results]


def _jax_engine(work: Path, dtype: str, emb) -> dict:
    videos = work / f"jax_{dtype}"
    cfg = jax_config.EngineConfig(videos_dir=str(videos),
                                  api=jax_config.ApiConfig(max_frames=10))
    cfg.index.embed_dim = ENGINE_D
    cfg.model.dtype = "float32"
    cfg.index.device_dtype = "bfloat16" if dtype == "ivf" else dtype
    if dtype == "ivf":
        cfg.index.kind = "ivf"
        cfg.index.ivf_min_rows = 64
        cfg.index.ivf_nlist = 8
        cfg.index.ivf_nprobe = 3
    cfg.index.corpus_shards = SHARDS
    cfg.index.corpus_slices = 2
    engine = JaxEngine(str(videos), config=cfg, embedder=emb)
    engine.startup()
    assert dict(engine.index.mesh.shape) == {"dcn": 2, "corpus": 4}
    vec = np.load(work / "vector.npy")
    got = {"count": len(engine.index), "ann": engine.ann_stats(),
           "singles": [_jax_rows(engine.search(q, k=5, use_cache=False))
                       for q in w.QUERIES],
           "batch": [_jax_rows(r) for r in engine.search_batch(w.BATCH,
                                                               k=4)],
           "vector": _jax_rows(engine.search_by_vector_ex(
               vec, k=6, use_cache=False)[0]),
           "videos": engine.search_videos(w.QUERIES[0], k=3)}
    got["removed"] = engine.remove_video("vid0.mp4")
    got["after"] = _jax_rows(engine.search(w.QUERIES[1], k=5,
                                           use_cache=False))
    return got


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both processes' results per tier, and the JAX engine's."""
    work = tmp_path_factory.mktemp("engine")
    jax_emb = JaxEmbedder(TINY_224_FULL_VOCAB, dtype=jnp.float32)
    torch.save(port_state_dict(jax_emb.params, TINY_224_FULL_VOCAB),
               work / "tower.pt")
    np.save(work / "vector.npy", np.random.default_rng(3).standard_normal(
        ENGINE_D).astype(np.float32))
    video = make_synthetic_video(work / "new.mp4", n_frames=60)
    # the IVF tier is built over the loaded rows plus the new video's,
    # then again after a video of 100 rows goes
    n = 400 + len(port_frames.extract_frames(video, max_frames=10)[0])
    (work / "ivf_init.json").write_text(json.dumps({
        f"{m},8,0": jax_kmeans_init(m, 8).tolist() for m in (n, n - 100)}))
    for dtype in TIERS:
        for tag in (dtype, f"jax_{dtype}"):
            (work / tag).mkdir()
            _cache(work / tag / "video_search_cache.pkl")
            shutil.copy2(video, work / tag / "new.mp4")
    procs = spawn("engine", work)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VQT_PALLAS_INTERPRET", "1")
        mp.setenv("VQT_RERANK_FETCH", "40")
        mp.delenv("VQT_CANDIDATE_TOPK", raising=False)
        mp.delenv("VQT_COORDINATOR", raising=False)
        mp.setattr(jax_topk, "CAND_BUCKET", 128)
        try:
            want = {dtype: _jax_engine(work, dtype, jax_emb)
                    for dtype in TIERS}
        finally:
            join(procs)
    got = [json.loads((work / f"engine_out_{r}.json").read_text())
           for r in range(PROCS)]
    return work, got, want


def _same(got: list, want: list) -> None:
    assert [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-5, atol=0)
    assert [r[3] for r in got] == [r[3] for r in want]


@pytest.mark.parametrize("dtype", TIERS)
def test_two_process_engine_matches_jax(engines, dtype):
    work, got, want = engines
    assert got[0][dtype] == got[1][dtype]       # every process agrees
    g, w = got[0][dtype], want[dtype]
    assert g["count"] == w["count"] > 400       # the new video's rows
    assert g["local_shards"] == SHARDS // PROCS
    assert g["layout"] == ("id" if dtype == "float32" else "perm")
    assert g["ann"] == w["ann"]
    if dtype == "ivf":                          # one replica a process
        assert g["ann"]["active"] and "devices" not in g["ann"]
        assert g["ivf_replica"]
    for gs, ws in zip(g["singles"], w["singles"]):
        assert len(gs) == 5
        _same(gs, ws)
    for gb, wb in zip(g["batch"], w["batch"]):
        _same(gb, wb)
    _same(g["vector"], w["vector"])
    assert [r["video_name"] for r in g["videos"]] == \
        [r["video_name"] for r in w["videos"]]
    np.testing.assert_allclose([r["score"] for r in g["videos"]],
                               [r["score"] for r in w["videos"]],
                               rtol=1e-5, atol=0)
    assert g["removed"] == w["removed"] == 100
    _same(g["after"], w["after"])


@pytest.mark.parametrize("dtype", TIERS)
def test_the_shared_cache_was_saved_whole(engines, dtype):
    """Process 0 alone rewrote the shared cache after the ingest: it loads
    with its checksum, holding the grown corpus."""
    work, got, _ = engines
    index = DeviceVideoIndex(dim=ENGINE_D, device="cpu")
    assert index.load_from_disk(work / dtype / "video_search_cache.pkl")
    assert len(index) == got[0][dtype]["count"]
    assert "new.mp4" in index.video_hashes
