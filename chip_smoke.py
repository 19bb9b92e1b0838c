#!/usr/bin/env python3
"""Smoke run of the PyTorch port (video_quierer_tpu_torch) on one NVIDIA
GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py [--seed 0] [--videos 10000] [--frames 200]

Run from the root of a checkout. Phases (any failure raises, and the
script exits non-zero without its last line):

1. environment: torch, CUDA and nvcc versions; the card's name and power
   limit as nvidia-smi gives them;
2. build: the CUDA kernels from video_quierer_tpu_torch/csrc into
   build/kernels/<hash of the sources>/ (nvcc, sm_90a);
3. kernels vs plain: each kernel of the text-search path against its
   plain PyTorch version at the path's shapes, with the tolerance and
   both times (CUDA events, the second of two timed loops);
4. end to end: a seeded corpus of 10,000 videos x 200 frames (2,000,000
   unit rows x 512) written as the pickle v1.0 cache, the port's HTTP
   server started through ``engine.startup()`` on a free local port, then
   single, coalesced, 77-token and batch searches over HTTP. Every
   response's schema is checked; single and batch rows are checked
   against a host exact top-10 over the f32 corpus with the query vector
   the port's encoder gives; every kernel of the path must have launched
   and both fallback counters must read 0;
5. a JSON line of the kernels, the nvidia-smi line, and the result line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Needs one CUDA card; without one it exits non-zero and prints no result.
Uses no network beyond its own localhost server, and stops what it starts.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from video_quierer_tpu_torch.api.server import create_server
from video_quierer_tpu_torch.engine.config import EngineConfig
from video_quierer_tpu_torch.engine.system import VideoSearchEngine
from video_quierer_tpu_torch.index.device_index import (
    DeviceVideoIndex,
    _device_exact_rerank,
    _round_capacity,
)
from video_quierer_tpu_torch.models.clip.embedder import (
    CLIPEmbedder,
    trim_text_ids,
)
from video_quierer_tpu_torch.ops import fused_layer as fl
from video_quierer_tpu_torch.ops import kernels, topk
from video_quierer_tpu_torch.ops.attention import attention, attention_ref

ROOT = Path(__file__).resolve().parent
DIM = 512
K = 10
RESPONSE_KEYS = {"results", "search_time_ms", "from_cache", "query_id",
                 "performance"}
ROW_KEYS = {"video_name", "timestamp", "frame_id", "score",
            "formatted_time"}
ATTN_ATOL = 2e-2        # bf16 attention vs plain, valid rows
MIN_COS = 0.999         # bf16 tower rows vs plain
SCORE_ATOL = 1e-5       # returned scores vs host exact f32


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call of ``fn`` on the card: one warm-up call, then two
    timed loops of ``iters`` calls between CUDA events; the second counts."""
    fn()
    torch.cuda.synchronize()
    ms = 0.0
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / iters
    return ms


def words(rng: np.random.Generator, n: int) -> str:
    """``n`` random lowercase words (one token each for the hash
    tokenizer)."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return " ".join("".join(rng.choice(letters, size=rng.integers(4, 9)))
                    for _ in range(n))


# -- phases 1-2 ---------------------------------------------------------------

def phase_environment() -> str:
    nvcc = subprocess.run([kernels._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc {nvcc.strip().splitlines()[-1]}")
    log(f"card: {smi}  ({torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible)")
    # the exact re-rank and the plain versions are f32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.lib()
    log(f"build: {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s"
        + ("" if kernels.last_build else " (cached)"))
    for line in kernels.last_build.get("ptxas", "").splitlines():
        if "Used" in line or "spill stores" in line:
            log("  ptxas: " + line.strip())


# -- phase 3: kernels vs plain ------------------------------------------------

def compare_attention(dev) -> dict:
    out = {}
    for b, s in ((1, 8), (64, 8), (1, 77), (64, 77)):
        g = torch.Generator(device=dev).manual_seed(1000 * s + b)
        q, k, v = ((0.5 * torch.randn(b, s, DIM, generator=g, device=dev))
                   .bfloat16() for _ in range(3))

        def kern():
            return attention(q, k, v, num_heads=8, causal=True)

        def plain():
            qs = (q.float() * 64 ** -0.5).bfloat16()
            return attention_ref(qs, k, v, num_heads=8, valid_len=s,
                                 causal=True)

        err = (kern().float() - plain().float()).abs().max().item()
        require(err <= ATTN_ATOL, f"B3 B={b} S={s}: max_abs_err {err}")
        ms, pms = cuda_ms(kern, 50), cuda_ms(plain, 50)
        log(f"B3 attention B={b} S={s}: max_abs_err {err:.3e} "
            f"(atol {ATTN_ATOL}) kernel {ms:.4f} ms plain {pms:.4f} ms")
        out[(b, s)] = {"max_abs_err": err, "ms": ms, "plain_ms": pms}
    return out[(64, 77)]


def compare_fused_layer(embedder: CLIPEmbedder, seed: int) -> dict:
    model = embedder.params
    ops = embedder._layer_ops(model)
    rng = np.random.default_rng(seed)
    out = {}
    for s, n_words in ((8, 4), (16, 11)):
        ids = trim_text_ids(embedder.tokenizer(
            [words(rng, n_words) for _ in range(64)]))
        require(ids.shape == (64, s), f"B2 ids shape {ids.shape}")
        ids_t = embedder.ids_tensor(ids)

        def kern():
            return fl.fused_text_encode(model, ids_t, ops)

        def plain():
            return fl.fused_text_encode(model, ids_t, ops,
                                        layer=fl.fused_layer_ref)

        with torch.inference_mode():
            a, p = kern(), plain()
            cos = torch.nn.functional.cosine_similarity(a, p, dim=-1)
            err = (a - p).abs().max().item()
            require(cos.min().item() >= MIN_COS,
                    f"B2 S={s}: min row cosine {cos.min().item()}")
            ms, pms = cuda_ms(kern, 10), cuda_ms(plain, 10)
        log(f"B2 fused text encode B=64 S={s} x{len(ops)} layers: min "
            f"cosine {cos.min().item():.6f} (>= {MIN_COS}) max_abs_err "
            f"{err:.3e} kernel {ms:.3f} ms plain {pms:.3f} ms")
        out[s] = {"max_abs_err": err, "ms": ms, "plain_ms": pms}
    return out[16]


def compare_cand_scan(dev, n_rows: int, seed: int) -> dict:
    n_pad = _round_capacity(n_rows)
    g = torch.Generator(device=dev).manual_seed(seed)
    # host rows (the re-rank store) and the live-prefix mirror: position
    # p holds host row perm[p], live rows first
    store = torch.randn(n_pad, DIM, generator=g, device=dev)
    store /= torch.linalg.vector_norm(store, dim=-1, keepdim=True)
    store[n_rows:] = 0
    perm = torch.cat([
        torch.randperm(n_rows, generator=g, device=dev),
        torch.arange(n_rows, n_pad, device=dev)]).int()
    mirror = store[perm.long()].bfloat16()
    out = {}
    for b in (1, 64, 256):
        q = torch.randn(b, DIM, generator=g, device=dev)
        q /= torch.linalg.vector_norm(q, dim=-1, keepdim=True)

        def kern():
            return topk.cand_scan_prefix(mirror, q, n_rows,
                                         bucket=topk.CAND_BUCKET,
                                         rounds=topk.CAND_ROUNDS)

        def plain():
            return topk.cand_scan_prefix_ref(
                mirror, q, n_rows, bucket=topk.CAND_BUCKET,
                rounds=topk.CAND_ROUNDS, block_rows=topk.CAND_BLOCK_ROWS)

        tops = []
        for vals, idxs in (kern(), plain()):
            _, cand = topk._cand_merge_cols(vals, idxs, perm, fetch=128)
            tops.append((vals, idxs) + _device_exact_rerank(
                store, q, cand, n_rows, K))
        (kv, ki, ks, kr), (pv, pi, ps, pr) = tops
        require(torch.equal(kr, pr), f"B1 B={b}: top-{K} rows differ")
        both = torch.isfinite(kv) & torch.isfinite(pv)
        require(torch.equal(torch.isfinite(kv), torch.isfinite(pv)),
                f"B1 B={b}: live winners differ")
        err = (kv[both] - pv[both]).abs().max().item()
        same = (ki == pi).float().mean().item()
        iters = 20 if b < 256 else 5
        ms, pms = cuda_ms(kern, iters), cuda_ms(plain, iters)
        log(f"B1 candidate scan N={n_rows} B={b}: top-{K} identical after "
            f"merge + re-rank; winner max_abs_err {err:.3e}, same "
            f"positions {same:.6f}; kernel {ms:.3f} ms plain {pms:.3f} ms")
        out[b] = {"max_abs_err": err, "ms": ms, "plain_ms": pms}
    del store, mirror
    torch.cuda.empty_cache()
    return out[64]


# -- phase 4: end to end --------------------------------------------------------

def build_corpus(seed: int, n_videos: int, n_frames: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    corpus = rng.standard_normal((n_videos * n_frames, DIM),
                                 dtype=np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    return corpus


def video_name(v: int) -> str:
    return f"video_{v:05d}.mp4"


def write_cache(corpus: np.ndarray, n_frames: int, path: Path) -> None:
    idx = DeviceVideoIndex(dim=DIM, device="cpu")   # host store only
    idx.reserve(len(corpus))
    stamps = [0.5 * t for t in range(n_frames)]
    for v in range(len(corpus) // n_frames):
        idx.add_batch(corpus[v * n_frames:(v + 1) * n_frames],
                      video_name(v), stamps)
    idx.save_to_disk(path)


def http(base: str, method: str, path: str, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        payload = json.loads(r.read())
        status = r.status
    return status, payload, time.perf_counter() - t0


def check_search_response(status: int, body: dict, k: int) -> None:
    require(status == 200, f"search status {status}")
    require(set(body) == RESPONSE_KEYS, f"response keys {sorted(body)}")
    require(body["from_cache"] is False, "answered from the query cache")
    require(len(body["results"]) == k, f"{len(body['results'])} rows")
    require(body["performance"] == {"results_count": k}, "performance")
    for r in body["results"]:
        require(set(r) == ROW_KEYS, f"row keys {sorted(r)}")


def check_exact(corpus: np.ndarray, n_frames: int, qs: np.ndarray,
                rows_per_query) -> float:
    """Returned rows == host exact top-K of the f32 corpus under the
    index's query normalisation; returns the max score error."""
    qn = qs / (np.linalg.norm(qs, axis=1, keepdims=True) + 1e-10)
    scores = corpus @ qn.T                                 # [N, Q]
    worst = 0.0
    for j, rows in enumerate(rows_per_query):
        s = scores[:, j]
        top = np.argpartition(-s, K)[:K]
        top = top[np.lexsort((top, -s[top]))]
        got = [r["frame_id"] for r in rows]
        require(got == top.tolist(),
                f"rows {got} != host exact top-{K} {top.tolist()}")
        require([r["video_name"] for r in rows]
                == [video_name(int(t) // n_frames) for t in top],
                "video names")
        err = np.abs(np.array([r["score"] for r in rows]) - s[top]).max()
        require(err <= SCORE_ATOL, f"score error {err}")
        worst = max(worst, float(err))
    return worst


def concurrent_phase(base: str, name: str, queries, k: int):
    with ThreadPoolExecutor(len(queries)) as pool:
        t0 = time.perf_counter()
        out = list(pool.map(
            lambda q: http(base, "POST", "/api/search",
                           {"query": q, "k": k, "use_cache": False}),
            queries))
        wall = time.perf_counter() - t0
    for status, body, _ in out:
        check_search_response(status, body, k)
    lat = [t for _, _, t in out]
    log(f"e2e {name}: {len(queries)} concurrent searches in {wall:.3f} s "
        f"= {len(queries) / wall:.1f} searches/s, p50 latency "
        f"{1e3 * float(np.median(lat)):.2f} ms")
    return [body["results"] for _, body, _ in out]


def phase_end_to_end(embedder: CLIPEmbedder, args, device) -> dict:
    n = args.videos * args.frames
    t0 = time.perf_counter()
    corpus = build_corpus(args.seed, args.videos, args.frames)
    log(f"corpus: {n} rows x {DIM} from seed {args.seed} in "
        f"{time.perf_counter() - t0:.1f} s")
    scratch = ROOT / "build" / "smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed + 1)
    with tempfile.TemporaryDirectory(dir=scratch) as videos:
        t0 = time.perf_counter()
        write_cache(corpus, args.frames,
                    Path(videos) / "video_search_cache.pkl")
        log(f"pickle v1.0 cache written in {time.perf_counter() - t0:.1f} s")
        engine = VideoSearchEngine(videos, config=EngineConfig(),
                                   embedder=embedder, device=device)
        t0 = time.perf_counter()
        engine.startup()
        require(len(engine.index) == n, "startup row count")
        log(f"engine.startup(): {len(engine.index)} rows, mirror + re-rank "
            f"store on the card, in {time.perf_counter() - t0:.1f} s")
        server = create_server(engine, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            for wrapper in (topk.cand_scan_prefix, fl.fused_layer,
                            attention):
                wrapper.launches = 0
            launches = drive(base, engine, embedder, corpus, args, rng)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(30)
            engine.close()
    metrics = engine.metrics
    for name in ("embed_fallbacks", "fused_search_fallbacks"):
        require(metrics.counter(name) == 0, f"{name} = "
                f"{metrics.counter(name)}")
    log("fallback counters: embed_fallbacks 0, fused_search_fallbacks 0")
    return launches


def drive(base, engine, embedder, corpus, args, rng) -> dict:
    """The main path over HTTP; returns the kernels' launch counts."""
    status, health, _ = http(base, "GET", "/api/health")
    require(status == 200 and health["status"] == "healthy", "health")
    # single queries: B=1, module tower (attention kernel B3)
    singles = [words(rng, 4) for _ in range(16)]
    rows, lat = [], []
    for q in singles:
        status, body, t = http(base, "POST", "/api/search",
                               {"query": q, "k": K, "use_cache": False})
        check_search_response(status, body, K)
        rows.append(body["results"])
        lat.append(t)
    log(f"e2e single: 16 sequential searches, p50 latency "
        f"{1e3 * float(np.median(lat)):.2f} ms (first "
        f"{1e3 * lat[0]:.2f} ms), {1 / float(np.median(lat)):.1f} "
        "searches/s")
    q_single = np.stack([embedder.embed_text(q) for q in singles])
    err = check_exact(corpus, args.frames, q_single, rows)
    log(f"e2e single: all 16 match the host exact top-{K} "
        f"(max score error {err:.2e})")
    # coalesced short queries (fused layer kernel B2 once a flush holds
    # >= 32 of them) and 77-token queries (attention kernel at S=77)
    for r in range(3):
        concurrent_phase(base, f"coalesced short, round {r}",
                         [words(rng, 4) for _ in range(64)], K)
    concurrent_phase(base, "coalesced 77-token",
                     [words(rng, 90) for _ in range(64)], K)
    # one batch of 64 (fused layer kernel B2)
    batch = [words(rng, 4) for _ in range(64)]
    status, body, t = http(base, "POST", "/api/search/batch",
                           {"queries": batch, "k": K})
    require(status == 200 and body["query_count"] == 64
            and body["total_results"] == 64 * K, "batch response")
    log(f"e2e batch: 64 queries in one request, {1e3 * t:.2f} ms = "
        f"{64 / t:.1f} searches/s")
    ids = trim_text_ids(embedder.tokenizer(batch))
    with torch.inference_mode():
        q_batch = embedder.text_encode_fn(
            embedder.params, embedder.ids_tensor(ids)).cpu().numpy()
    sample = list(range(0, 64, 8))
    err = check_exact(corpus, args.frames, q_batch[sample],
                      [body["results"][i]["results"] for i in sample])
    log(f"e2e batch: sampled {len(sample)} queries match the host exact "
        f"top-{K} (max score error {err:.2e})")
    launches = {"cand_scan_prefix": topk.cand_scan_prefix.launches,
                "fused_layer": fl.fused_layer.launches,
                "attention": attention.launches}
    log(f"launches during the main path: {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--videos", type=int, default=10_000)
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_environment()
    phase_build()
    embedder = CLIPEmbedder(dtype=torch.bfloat16, device=device,
                            seed=args.seed)
    b3 = compare_attention(device)
    b2 = compare_fused_layer(embedder, args.seed)
    b1 = compare_cand_scan(device, args.videos * args.frames, args.seed)
    launches = phase_end_to_end(embedder, args, device)
    kernels_line = {"kernels": [
        {"name": "cand_scan_prefix", "route": "cuda",
         "source": "video_quierer_tpu_torch/csrc/cand_scan.cu",
         "replaces": "video_quierer_tpu/ops/topk.py:1419",
         "launches": launches["cand_scan_prefix"], **b1},
        {"name": "fused_text_layer", "route": "cuda",
         "source": "video_quierer_tpu_torch/csrc/fused_layer.cu",
         "replaces": "video_quierer_tpu/ops/fused_layer.py:386",
         "launches": launches["fused_layer"], **b2},
        {"name": "attention", "route": "cuda",
         "source": "video_quierer_tpu_torch/csrc/attention.cu",
         "replaces": "video_quierer_tpu/ops/attention.py:143",
         "launches": launches["attention"], **b3},
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
