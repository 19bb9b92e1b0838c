"""The system under test, built from a configuration file: the port's
CLIP embedder on the benchmark's seeded weights, its engine over a
seeded library filled in memory, and its trainer.

The engine has no public start-up over an index filled in memory, so
:func:`fill_library` does what ``VideoSearchEngine.startup`` does after
its pickle load: ``index.sync_mirror()``, then ``_warm_up()``. No pickle
cache is read or written; the engine's videos dir is a directory under
``TMPDIR``.
"""

from __future__ import annotations

import tempfile
import time

import torch

from portbench import gen

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cfg: dict):
    """The port's tower configuration named by ``cfg["port_model"]``,
    refused unless every size equals the file's."""
    from video_quierer_tpu_torch.models.clip.config import get_config
    c = get_config(cfg["port_model"])
    t, v = cfg["text_config"], cfg["vision_config"]
    have = {
        "projection_dim": c.projection_dim,
        "text.hidden_size": c.text.hidden_size,
        "text.intermediate_size": c.text.hidden_size * c.text.mlp_ratio,
        "text.num_attention_heads": c.text.num_heads,
        "text.num_hidden_layers": c.text.num_layers,
        "text.max_position_embeddings": c.text.context_length,
        "text.vocab_size": c.text.vocab_size,
        "vision.hidden_size": c.vision.hidden_size,
        "vision.intermediate_size": c.vision.hidden_size * c.vision.mlp_ratio,
        "vision.num_attention_heads": c.vision.num_heads,
        "vision.num_hidden_layers": c.vision.num_layers,
        "vision.patch_size": c.vision.patch_size,
        "vision.image_size": c.vision.image_size,
    }
    want = {"projection_dim": cfg["projection_dim"]}
    for k in have:
        if "." in k:
            tower, key = k.split(".")
            want[k] = (t if tower == "text" else v)[key]
    bad = {k: (have[k], want[k]) for k in have if have[k] != want[k]}
    if bad:
        raise ValueError(f"{cfg['port_model']}: the port's sizes differ "
                         f"from the configuration file: {bad}")
    return c


def embedder(cfg: dict, device, seed: int):
    """The port's CLIP embedder on the seeded weights, in the served
    dtype."""
    from video_quierer_tpu_torch.models.clip.embedder import CLIPEmbedder
    port_config(cfg)
    dtype = _DTYPES[cfg["dtype"]]
    sd = gen.weights(cfg, device, dtype, seed)
    return CLIPEmbedder(model_name=cfg["port_model"], dtype=dtype,
                        device=device, state_dict=sd)


def engine(cfg: dict, emb, device):
    """The engine over ``emb``, configured by ``cfg["index"]``; its videos
    dir a fresh directory under ``TMPDIR``."""
    from video_quierer_tpu_torch.engine.config import EngineConfig
    from video_quierer_tpu_torch.engine.system import VideoSearchEngine
    ix = cfg["index"]
    config = EngineConfig()
    config.coalesce_width = ix["coalesce_width"]
    config.index.embed_dim = cfg["projection_dim"]
    config.index.device_dtype = ix["device_dtype"]
    config.index.device_rerank = ix["device_rerank"]
    config.index.rerank_store_dtype = ix["rerank_store_dtype"]
    config.model.name = cfg["port_model"]
    config.model.dtype = cfg["dtype"]
    videos = tempfile.mkdtemp(prefix="portbench-videos-")
    return VideoSearchEngine(videos_dir=videos, config=config, embedder=emb,
                             device=device)


def library_name(v: int) -> str:
    return f"lib_{v:06d}.mp4"


def timestamps(n: int, spacing: float) -> list:
    return [i * spacing for i in range(n)]


def fill_library(eng, cfg: dict, device, seed: int, rows: int,
                 reserve: int) -> dict:
    """Append the seeded library to the engine's index, one ``add_batch``
    a video of ``frames_per_video`` rows, then bring its mirrors up as
    ``startup`` does. Returns seconds by stage."""
    lib = cfg["library"]
    fpv, spacing = lib["frames_per_video"], lib["frame_spacing_s"]
    stamps = timestamps(fpv, spacing)
    index = eng.index
    t0 = time.perf_counter()
    index.reserve(reserve)
    v = 0
    for _, chunk in gen.corpus_chunks(device, rows, cfg["projection_dim"],
                                      seed):
        host = chunk.cpu().numpy()
        for lo in range(0, host.shape[0], fpv):
            part = host[lo:lo + fpv]
            index.add_batch(part, library_name(v), stamps[:part.shape[0]])
            v += 1
    t1 = time.perf_counter()
    index.sync_mirror()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    return {"append": t1 - t0, "mirror": t2 - t1}


def trainer(cfg: dict, device, seed: int):
    """The port's trainer on the seeded f32 weights, with the
    configuration's optimizer settings."""
    from video_quierer_tpu_torch.train.trainer import CLIPTrainer
    tr = cfg["train"]
    sd = gen.weights(cfg, device, _DTYPES[tr["dtype"]], seed)
    out = CLIPTrainer(cfg=port_config(cfg), dtype=_DTYPES[tr["dtype"]],
                      learning_rate=tr["learning_rate"],
                      weight_decay=tr["weight_decay"], params=sd,
                      device=device)
    del sd
    return out


def counters(eng) -> dict:
    return dict(eng.metrics.snapshot()["counters"])


def spans() -> dict:
    from video_quierer_tpu_torch.utils import stageprof
    return stageprof.snapshot()


def delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, tuple):
            b = b or (0, 0.0)
            out[k] = (v[0] - b[0], v[1] - b[1])
        else:
            out[k] = v - (b or 0)
    return out
