"""The ingest stream of ``portbench/drivers/ingest.py`` with AIMv2-L/14
LiT's towers: the same window (``_ingest_batches`` fed by
``batched_frames`` over new video names, a seeded extractor over the
pool) and the same read-back of the videos sent whole (``release``);
set-up builds the program's AIMv2 embedder on the seeded weights of
``portbench/gen_aimv2.py``, and the check and the control hold the
stored rows to ``portbench/reference/aimv2.py`` instead of CLIP's.

Set-up notes, beside the CLIP cells' ``fill_s``, ``frames_s`` and
``warm_s``: ``load_s``, the seconds from the start of ``portbench/run.py``
(``setup_s``'s origin) to this set-up's entry (``entry``: the imports
and the cell's files), the embedder's build on the seeded weights
(``embedder``), the engine's (``engine``), and from the start to the
set-up's end (``end``).

Correctness, as in the CLIP cells: ``embed_gap``, the widest L2 distance
between a stored row and the f32 reference's row of the same frame
(computed in blocks of ``check_block`` frames); ``missing_rows``, the
frames whose row was not found under their video's name and timestamp.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import gen, gen_aimv2, program
from portbench.drivers import ingest
from portbench.reference import aimv2 as ref_aimv2

window = ingest.window
release = ingest.release
control_setup = ingest.control_setup

_SIZES = {
    "projection_dim": lambda c: c.projection_dim,
    "text.hidden_size": lambda c: c.text.hidden_size,
    "text.intermediate_size": lambda c: c.text.intermediate_size,
    "text.num_attention_heads": lambda c: c.text.num_heads,
    "text.num_hidden_layers": lambda c: c.text.num_layers,
    "text.max_position_embeddings": lambda c: c.text.context_length,
    "text.vocab_size": lambda c: c.text.vocab_size,
    "text.rms_norm_eps": lambda c: c.text.rms_norm_eps,
    "text.eos_token_id": lambda c: c.text.eos_token_id,
    "vision.hidden_size": lambda c: c.vision.hidden_size,
    "vision.intermediate_size": lambda c: c.vision.intermediate_size,
    "vision.num_attention_heads": lambda c: c.vision.num_heads,
    "vision.num_hidden_layers": lambda c: c.vision.num_layers,
    "vision.patch_size": lambda c: c.vision.patch_size,
    "vision.image_size": lambda c: c.vision.image_size,
    "vision.rms_norm_eps": lambda c: c.vision.rms_norm_eps,
}


def embedder(cfg: dict, device, seed: int):
    """The port's AIMv2 embedder on the seeded weights, in the served
    dtype, refused unless every size of the port's configuration equals
    the file's."""
    from video_quierer_tpu_torch.models.aimv2.config import get_config
    from video_quierer_tpu_torch.models.aimv2.embedder import AIMv2Embedder
    c = get_config(cfg["port_model"])
    want = {"projection_dim": cfg["projection_dim"]}
    for k in _SIZES:
        if "." in k:
            tower, key = k.split(".")
            want[k] = cfg[f"{tower}_config"][key]
    bad = {k: (f(c), want[k]) for k, f in _SIZES.items() if f(c) != want[k]}
    if bad:
        raise ValueError(f"{cfg['port_model']}: the port's sizes differ "
                         f"from the configuration file: {bad}")
    dtype = program._DTYPES[cfg["dtype"]]
    sd = gen_aimv2.weights(cfg, device, dtype, seed)
    return AIMv2Embedder(model_name=cfg["port_model"], dtype=dtype,
                         device=device, state_dict=sd)


def _since_start():
    """Seconds since ``portbench/run.py`` started, where it is the running
    program (else None)."""
    t = getattr(sys.modules.get("__main__"), "T_PROCESS", None)
    return None if t is None else time.perf_counter() - t


def setup(ctx) -> None:
    from video_quierer_tpu_torch.ingest.pipeline import batched_frames
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    load = ctx.notes["load_s"] = {"entry": _since_start()}
    t0 = time.perf_counter()
    emb = embedder(cfg, dev, ctx.seed)
    t1 = time.perf_counter()
    eng = program.engine(cfg, emb, dev)
    load.update(embedder=t1 - t0, engine=time.perf_counter() - t1)
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
    videos = [ingest.video_name(v) for v in range(tr["max_videos"])]
    stream = batched_frames(videos, batch_size=ing.batch_size,
                            num_workers=ing.num_decode_workers,
                            prefetch=ing.prefetch_videos,
                            extract_fn=ingest._Extract(
                                pool, tr["frame_spacing_s"]))
    emitted = []
    ctx.state.update(engine=eng, embedder=emb, rows=rows, pool=pool,
                     videos=videos, stream=stream, fpv=fpv, emitted=emitted)
    t0 = time.perf_counter()
    with eng.lock:
        eng._ingest_batches(videos, ingest._take(
            stream, tr["warmup_batches"], emitted))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.notes["warm_s"] = time.perf_counter() - t0
    load["end"] = _since_start()


def _reference_rows(ctx, frames: np.ndarray, prec: str) -> torch.Tensor:
    sd = ctx.state.get("ref_weights")
    if sd is None:
        sd = ctx.state["ref_weights"] = gen_aimv2.weights(
            ctx.cfg, ctx.device, program._DTYPES[ctx.cfg["dtype"]], ctx.seed)
    out = []
    block = ctx.traffic["check_block"]
    with torch.no_grad():
        for lo in range(0, frames.shape[0], block):
            px = gen.normalize_pixels(torch.from_numpy(
                frames[lo:lo + block]).to(ctx.device))
            out.append(ref_aimv2.encode_image(sd, ctx.cfg, px, prec))
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
