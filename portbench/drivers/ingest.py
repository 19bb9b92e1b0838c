"""A stream of videos onto the library, through the engine's ingest loop.

``VideoSearchEngine._ingest_batches`` (the loop ``_ingest`` runs under
the write lock) is fed by ``ingest.pipeline.batched_frames`` over an
endless list of new video names, with a seeded extractor in place of the
decoder (the card's machine has no OpenCV): video ``v`` yields the
``frames_per_video`` frames of pool video ``v % pool_videos``, made in
set-up, so making frames does not pace the loop. Batches of
``ingest.batch_size`` frames cross video boundaries, as in a real
ingest. The index is reserved in set-up for the library plus
``headroom_rows``, so the window appends without growing the index: the
index doubles its capacity when it grows, once per library's worth of
appends, so a growth inside a window of a few percent of the library
would weigh it many times over; the headroom also leaves a program many
times faster than today's room to run without one.

``ingest_fps`` counts the frames embedded and appended from the window's
first batch to the end of the batch in flight at the close.

Correctness: a sample of the videos whose every frame went to the engine
(drawn from the seed, with the last such one in it) is read back from
the index by name and timestamp, and each stored row compared with the
reference's f32 vision tower on the same frames: ``embed_gap``, the
widest L2 distance between a stored row and the reference's;
``missing_rows``, the frames whose row was not found under their video's
name and timestamp.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from portbench import gen, program
from portbench.reference import clip as ref_clip
from portbench.trace import label


def video_name(v: int) -> str:
    return f"new_{v:07d}.mp4"


def video_number(name) -> int:
    return int(str(name).rsplit("_", 1)[1].split(".")[0])


class _Extract:
    """The decode stage's stand-in: a video's pool frames and its
    timestamps."""

    def __init__(self, pool: np.ndarray, spacing: float):
        self.pool, self.spacing = pool, spacing

    def __call__(self, path):
        v = video_number(path)
        frames = self.pool[v % self.pool.shape[0]]
        return frames, program.timestamps(frames.shape[0], self.spacing)


def setup(ctx) -> None:
    from video_quierer_tpu_torch.ingest.pipeline import batched_frames
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    emb = program.embedder(cfg, dev, ctx.seed)
    eng = program.engine(cfg, emb, dev)
    rows = ctx.size("rows", cfg["library"]["rows"])
    headroom = ctx.size("headroom_rows", tr["headroom_rows"])
    ctx.notes["fill_s"] = program.fill_library(eng, cfg, dev, ctx.seed,
                                               rows, rows + headroom)
    t0 = time.perf_counter()
    fpv = tr["frames_per_video"]
    pool = gen.frame_pool(dev, ctx.size("pool_videos", tr["pool_videos"]),
                          fpv, ctx.seed)
    ctx.notes["frames_s"] = time.perf_counter() - t0
    ing = eng.config.ingest
    videos = [video_name(v) for v in range(tr["max_videos"])]
    stream = batched_frames(videos, batch_size=ing.batch_size,
                            num_workers=ing.num_decode_workers,
                            prefetch=ing.prefetch_videos,
                            extract_fn=_Extract(pool, tr["frame_spacing_s"]))
    # each batch's video indices, to tell which videos were sent whole
    emitted = []
    ctx.state.update(engine=eng, embedder=emb, rows=rows, pool=pool,
                     videos=videos, stream=stream, fpv=fpv, emitted=emitted)
    # warm-up: the window's own path over its first batches
    t0 = time.perf_counter()
    with eng.lock:
        eng._ingest_batches(videos, _take(stream, tr["warmup_batches"],
                                          emitted))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.notes["warm_s"] = time.perf_counter() - t0


def _take(stream, n: int, emitted: list):
    for _ in range(n):
        batch = next(stream)
        emitted.append(batch.video_indices)
        yield batch


def _timed(fn, log: list, name: str):
    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        with label(name):
            out = fn(*a, **kw)
        log.append(time.perf_counter() - t0)
        return out
    return wrapper


def window(ctx, tracer) -> dict:
    eng = ctx.state["engine"]
    index, stream = eng.index, ctx.state["stream"]
    emitted = ctx.state["emitted"]
    waits, appends = [], []
    t_start = [0.0]
    end = [0.0]

    def batches():
        while True:
            now = time.perf_counter()
            tracer.tick(now - t_start[0])
            if now >= end[0]:
                return
            with label("frame_wait"):
                batch = next(stream)
            waits.append(time.perf_counter() - now)
            emitted.append(batch.video_indices)
            tracer.unit()
            yield batch

    index.add_batch = _timed(index.add_batch, appends, "add_batch")
    index.stream_rows_device = _timed(index.stream_rows_device, appends,
                                      "stream_rows_device")
    before_c, before_s = program.counters(eng), program.spans()
    failed = 0
    t_start[0] = time.perf_counter()
    end[0] = t_start[0] + ctx.seconds
    ctx.mark_window_start(t_start[0])
    try:
        with eng.lock:
            eng._ingest_batches(ctx.state["videos"], batches())
    except Exception:
        failed = 1
        raise
    finally:
        tracer.stop()
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        elapsed = time.perf_counter() - t_start[0]
        del index.add_batch, index.stream_rows_device
        stream.close()
    delta_c = program.delta(program.counters(eng), before_c)
    frames = delta_c.get("frames_embedded", 0)
    n_batches = len(waits)
    return {
        "e2e": {"ingest_fps": frames / elapsed},
        "attempted": int(frames),
        "failed": failed,
        "counters": delta_c,
        "spans": program.delta(program.spans(), before_s),
        "host": {"frame_wait_s": sum(waits), "append_s": sum(appends),
                 "batches": n_batches, "frames": frames,
                 "elapsed_s": elapsed},
    }


def release(ctx) -> None:
    eng = ctx.state.pop("engine")
    ctx.state.pop("embedder")
    index = eng.index
    fpv = ctx.state["fpv"]
    # the videos whose every frame went to the engine; each should be in
    # the index whole
    sent = collections.Counter(v for ids in ctx.state["emitted"]
                               for v in ids)
    whole = [ctx.state["videos"][v] for v in sorted(sent)
             if sent[v] == fpv]
    r = gen.rng(ctx.seed, "check-sample")
    n = min(ctx.size("check_videos", ctx.traffic["check_videos"]),
            len(whole))
    pick = sorted(set(r.choice(len(whole), size=n, replace=False).tolist())
                  | ({len(whole) - 1} if whole else set()))
    stamps = program.timestamps(fpv, ctx.traffic["frame_spacing_s"])
    stored = []
    for i in pick:
        name = whole[i]
        rows, missing = np.zeros((fpv, index.dim), np.float32), 0
        first = index.nearest_frame(name, stamps[0])
        for j in range(fpv):
            r_ = None if first is None else first + j
            ok = (r_ is not None and r_ < len(index)
                  and index.frame_info(r_)["video_name"] == name
                  and abs(index.frame_info(r_)["timestamp"] - stamps[j])
                  < 1e-9)
            if ok:
                rows[j] = index.frame_embedding(r_)
            else:
                missing += 1
        stored.append((video_number(name), rows, missing))
    ctx.state["stored"] = stored
    eng.close()
    del eng, index


def _reference_rows(ctx, frames: np.ndarray, prec: str) -> torch.Tensor:
    sd = ctx.state.get("ref_weights")
    if sd is None:
        sd = ctx.state["ref_weights"] = gen.weights(
            ctx.cfg, ctx.device, program._DTYPES[ctx.cfg["dtype"]], ctx.seed)
    out = []
    block = ctx.traffic["check_block"]
    with torch.no_grad():
        for lo in range(0, frames.shape[0], block):
            px = gen.normalize_pixels(torch.from_numpy(
                frames[lo:lo + block]).to(ctx.device))
            out.append(ref_clip.encode_image(sd, ctx.cfg, px, prec))
    return torch.cat(out)


def _gaps(ctx, videos) -> dict:
    """``videos``: ``(video number, [fpv, D] rows, missing)``."""
    if not videos:
        return {"embed_gap": float("inf"), "missing_rows": float("inf")}
    pool = ctx.state["pool"]
    gap, missing = 0.0, 0
    for v, rows, miss in videos:
        want = _reference_rows(ctx, pool[v % pool.shape[0]], "f32")
        got = torch.from_numpy(rows).to(ctx.device)
        ok = torch.ones(rows.shape[0], dtype=torch.bool, device=ctx.device)
        if miss:
            ok = got.abs().sum(dim=1) > 0
        d = torch.linalg.vector_norm(got - want, dim=1)[ok]
        if d.numel():
            gap = max(gap, float(d.max()))
        missing += miss
    return {"embed_gap": gap, "missing_rows": float(missing)}


def check(ctx) -> dict:
    return _gaps(ctx, ctx.state["stored"])


def control(ctx, prec: str) -> dict:
    """The reference in ``prec`` in the program's place: its rows of a
    sample of pool videos, judged as the program's stored rows are."""
    pool = ctx.state["pool"]
    n = min(ctx.size("check_videos", ctx.traffic["check_videos"]),
            pool.shape[0])
    r = gen.rng(ctx.seed, "check-sample")
    videos = []
    for v in sorted(r.choice(pool.shape[0], size=n, replace=False).tolist()):
        rows = _reference_rows(ctx, pool[v], prec).cpu().numpy()
        videos.append((v, rows, 0))
    return _gaps(ctx, videos)


def control_setup(ctx) -> None:
    tr = ctx.traffic
    ctx.state["pool"] = gen.frame_pool(
        ctx.device, ctx.size("pool_videos", tr["pool_videos"]),
        tr["frames_per_video"], ctx.seed)
