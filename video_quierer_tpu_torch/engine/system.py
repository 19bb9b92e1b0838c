"""Engine orchestration: startup, hash-diff ingest, search (counterpart of
``video_quierer_tpu/engine/system.py``).

One engine, one config, one index — on one device, or with its mirror
sharded over a corpus mesh (``corpus_mesh=``, or ``index.corpus_shards``
and ``index.corpus_slices``: ``parallel/mesh.py``, ``index/sharded.py``;
the IVF tier then spreads its clusters over the mesh, except on a
multi-slice one or one that spans processes, where it keeps one replica
on the first device of each process). ``mesh=`` (a data mesh,
``parallel/mesh.py:data_mesh``) is handed to the CLIP embedder it builds,
which then splits frame and text batches over its ``data`` axis (SigLIP's
embedder takes none, as in the JAX package).

**Multi-process serving** (``index.corpus_slices > 1`` with
``VQT_COORDINATOR``, ``VQT_NUM_PROCESSES`` and ``VQT_PROCESS_ID`` set):
the engine joins the process group (``initialize_distributed``, NCCL on
the card, gloo on the CPU) and its corpus mesh spans every process, each
holding its own shards. The engine is then SPMD, as the JAX one: every
process makes the same calls in the same order (startup, ingests,
searches, removals), since each search's merge is a collective. Writes to
the shared videos dir (the pickle cache, its config hash, the cache's
removal) are made by process 0 alone while the others wait
(``CorpusMesh.on_first_process``). The query cache's TTL and the
coalescer's flush timer decide by each process's clock, so they can skip
a collective on one process and not another: multi-process callers search
with ``use_cache=False`` and not through the coalescer (a mismatch ends
in the collectives' timeout, never in a silent wrong answer).

- ``startup``: load the pickle v1.0 cache, diff the videos dir by
  md5(name, size, mtime), ingest the new and changed videos (all of them
  without a cache) and save the cache; then bring the device mirrors up
  to date;
- the towers: ``model.family`` "clip" (``models/clip``), "siglip"
  (``models/siglip``: 768-wide rows, so ``index.embed_dim`` 512 becomes
  768) or "aimv2" (``models/aimv2``: ``index.embed_dim`` is its
  projection's width, 512; ``model.name`` left at the CLIP default serves
  AIMv2-L/14 LiT), seeded;
- ingest (``_ingest``, ``process_video``): the threaded decode pipeline
  (``ingest/pipeline.py``) yields cross-video batches of 256 frames, the
  frames sampled by the interval rule or, with ``ingest.sampling_strategy``
  other than "interval" or ``ingest.quality_filter`` set, by
  ``ingest/samplers.py`` (``strategy_extract``); each
  is embedded on the device (CLIP: the fused vision encode, kernels B5 +
  B6; AIMv2: the same halves with RMSNorm and the gated MLP; SigLIP: the
  module tower),
  appended to the host store per video, and streamed into the device
  mirrors from the embedder's device output in one step per batch
  (``DeviceVideoIndex.stream_rows_device``); ``cache.frame_memo_size > 0``
  wraps the tower in the frame memo (``MemoizedEmbedder``, which serves
  the host path, ``ingest.stream_mirror = false``);
- text search: tokenize on the host → the embedder's text tower, the
  candidate scan and the exact re-rank on the device
  (``DeviceVideoIndex.search_batch_fused_async``) → reference rows
  ``{video_name, timestamp, frame_id, score, formatted_time}``;
- ``search_ex`` (one query), ``search_coalesced_ex`` (through the request
  coalescer), ``search_batch`` (one device pass for many queries),
  ``search_by_vector_ex`` (a query vector), ``search_by_image_ex`` (an
  RGB image: resized and embedded by the vision tower),
  ``search_similar_ex`` (an indexed frame's own row as the query, the
  frame itself left out), ``search_videos`` (whole videos ranked by their
  mean rows, ``DeviceVideoIndex.search_videos``), and ``warm_cache``;
- maintenance: ``rebuild`` (clear and re-ingest the videos dir),
  ``clear``, ``save`` and ``load`` of the pickle cache;
- the IVF tier (``index.kind = "ivf"``, ``index/ivf.py``): built at the
  end of ``startup`` once the corpus holds ``ivf_min_rows`` rows, rebuilt
  after a removal, fed appended rows through its fresh buffer (rebuilt
  once that outgrows ``rebuild_fraction``); while it is live every search
  routes through it — the text tower, then the probe scan (kernel B12) —
  instead of the mirror's scan. The coalescer's flushes take that route
  too: it is chosen before dispatch (``_dispatch_batch``);
- ``api.use_clip = false``: no tower; frames are embedded by the
  visual-statistics embedder and queries by the keyword encoder
  (``engine/fallback.py``), on the host; text searches take the index's
  vector search (``DeviceVideoIndex.search_batch``) or the IVF tier.

The keyword and visual-statistics encoders serve ``use_clip = false``
only. Unlike the JAX engine, a failed CLIP encode or dispatch is not
degraded to them or to a two-step path: it raises. The
``embed_fallbacks`` and ``fused_search_fallbacks`` counters stay for
parity and read 0.
"""

from __future__ import annotations

import functools
import hashlib
import logging
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_quierer_tpu_torch.engine.cache import QueryResultCache
from video_quierer_tpu_torch.engine.config import (
    ApiConfig,
    EngineConfig,
    ModelConfig,
    load_engine_config,
)
from video_quierer_tpu_torch.engine.fallback import (
    KeywordQueryEncoder,
    VisualStatsEmbedder,
)
from video_quierer_tpu_torch.engine.metrics import SystemMetrics
from video_quierer_tpu_torch.index.device_index import DeviceVideoIndex
from video_quierer_tpu_torch.index.ivf import IVFIndex
from video_quierer_tpu_torch.ingest.frames import video_identity_hash
from video_quierer_tpu_torch.ingest.pipeline import (
    FrameBatch,
    batched_frames,
    group_by_video,
    strategy_extract,
)
from video_quierer_tpu_torch.models.clip.embedder import (
    TEXT_BUCKETS,
    _bucket_for,
)
from video_quierer_tpu_torch.ops.preprocess import \
    resize_shorter_side_and_crop
from video_quierer_tpu_torch.ops.topk import MAX_K
from video_quierer_tpu_torch.parallel.mesh import (
    CorpusMesh,
    DataMesh,
    corpus_mesh as make_corpus_mesh,
    initialize_distributed,
    multislice_corpus_mesh,
)
from video_quierer_tpu_torch.utils.env import resolve_device
from video_quierer_tpu_torch.utils.locks import RWLock
from video_quierer_tpu_torch.utils.stageprof import span, unit

logger = logging.getLogger(__name__)

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _aimv2_name(m: ModelConfig) -> str:
    """The AIMv2 tower ``model.name`` names; the CLIP default name (left
    unset) means the family's default tower."""
    from video_quierer_tpu_torch.models.aimv2.config import DEFAULT_NAME
    return DEFAULT_NAME if m.name == ModelConfig.name else m.name


def format_timestamp(ts: float) -> str:
    """``"{m}m{s}s"`` (reference result shaping)."""
    return f"{int(ts // 60)}m{int(ts % 60)}s"


class VideoSearchEngine:
    def __init__(self, videos_dir: str = "videos",
                 config: Optional[EngineConfig] = None,
                 embedder=None,
                 device: str | torch.device = "cuda",
                 corpus_mesh: Optional[CorpusMesh] = None,
                 mesh: Optional[DataMesh] = None):
        """``device``: the towers' (and an unsharded index's) device.
        ``corpus_mesh``: shard the index over it; None builds one from
        ``index.corpus_shards`` (> 0: the first that many CUDA devices,
        split into ``index.corpus_slices`` slices when > 1; then, with
        ``VQT_COORDINATOR`` set, over the devices of every process).
        ``mesh``: the CLIP embedder's data mesh."""
        self.config = config or load_engine_config()
        if self.config.model.family == "siglip" and \
                self.config.index.embed_dim == 512:
            # SigLIP towers are 768-wide (no projection head)
            self.config.index.embed_dim = 768
        if self.config.model.family == "aimv2":
            # AIMv2's rows are its projection's width
            from video_quierer_tpu_torch.models.aimv2.config import \
                get_config
            self.config.index.embed_dim = get_config(
                _aimv2_name(self.config.model)).projection_dim
        self.device = resolve_device(device)
        self.videos_dir = Path(videos_dir or self.config.videos_dir)
        self.videos_dir.mkdir(parents=True, exist_ok=True)
        self.cache_path = self.videos_dir / "video_search_cache.pkl"
        idx = self.config.index
        if corpus_mesh is None and idx.corpus_shards > 0:
            if idx.corpus_slices > 1:
                initialize_distributed(self.device)
                corpus_mesh = multislice_corpus_mesh(
                    idx.corpus_slices, n_devices=idx.corpus_shards)
            else:
                corpus_mesh = make_corpus_mesh(idx.corpus_shards)
        self.index = DeviceVideoIndex(
            dim=idx.embed_dim, device_dtype=idx.device_dtype,
            device=self.device, device_rerank=idx.device_rerank,
            rerank_store_dtype=idx.rerank_store_dtype, mesh=corpus_mesh)
        self.mesh = mesh
        self.metrics = SystemMetrics()
        for name in ("embed_fallbacks", "fused_search_fallbacks"):
            self.metrics.inc(name, 0)
        self.query_cache = QueryResultCache(
            max_size=self.config.cache.query_cache_size,
            ttl_seconds=self.config.cache.query_cache_ttl_s,
            similarity_threshold=self.config.cache.similarity_threshold)
        self._embedder = embedder        # injected (tests) or lazy CLIP
        self._fallback_visual = VisualStatsEmbedder(dim=idx.embed_dim)
        self._fallback_text = KeywordQueryEncoder(dim=idx.embed_dim)
        self._ready = False
        self._coalescer = None
        # the ANN tier (index.kind == "ivf"): built on the mutation paths
        # under the write lock, read by searches; None: the mirror serves
        self._ivf: Optional[IVFIndex] = None
        self._ivf_rows = 0
        # searches are reads (concurrent, pipelined on the device);
        # load, ingest and removal are exclusive
        self.lock = RWLock()

    # ------------------------------------------------------------------
    # Embedder
    # ------------------------------------------------------------------

    @property
    def use_clip(self) -> bool:
        return bool(self.config.api.use_clip)

    def _get_embedder(self):
        """The tower (None when ``use_clip`` is false), built on first use
        unless one was injected; a built one is wrapped in the frame memo
        when ``cache.frame_memo_size > 0``, as the JAX engine does."""
        if not self.use_clip:
            return None
        if self._embedder is None:
            m = self.config.model
            # an HF checkpoint dir (VQT_CLIP_CHECKPOINT); orbax_checkpoint
            # a checkpoint of the port's trainer (train/checkpoint.py)
            kw = dict(checkpoint_dir=Path(m.checkpoint_dir)
                      if m.checkpoint_dir else None,
                      orbax_checkpoint=Path(m.orbax_checkpoint)
                      if m.orbax_checkpoint else None,
                      dtype=_DTYPES[m.dtype], device=self.device)
            if m.family == "aimv2":
                if m.parallel != "none":
                    raise ValueError(
                        "model.parallel='pp' is implemented for the clip "
                        "family (parallel/pipeline.py)")
                from video_quierer_tpu_torch.models.aimv2.embedder import \
                    AIMv2Embedder
                self._embedder = AIMv2Embedder(model_name=_aimv2_name(m),
                                               **kw)
            elif m.family == "siglip":
                if m.parallel != "none":
                    raise ValueError(
                        "model.parallel='pp' is implemented for the clip "
                        "family (parallel/pipeline.py)")
                from video_quierer_tpu_torch.models.siglip.embedder import \
                    SigLIPEmbedder
                self._embedder = SigLIPEmbedder(**kw)
            else:
                from video_quierer_tpu_torch.models.clip.embedder import \
                    CLIPEmbedder
                self._embedder = CLIPEmbedder(
                    model_name=m.name, parallel=m.parallel,
                    pipeline_microbatches=m.pipeline_microbatches,
                    mesh=self.mesh, **kw)
            if self.config.cache.frame_memo_size > 0:
                from video_quierer_tpu_torch.models.clip.embedder import \
                    MemoizedEmbedder
                self._embedder = MemoizedEmbedder(
                    self._embedder,
                    max_size=self.config.cache.frame_memo_size)
        return self._embedder

    def _tower(self):
        """The tower the fused search paths drive (the frame memo
        unwrapped)."""
        emb = self._get_embedder()
        return getattr(emb, "inner", emb)

    def embed_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """Frames → ``[N, D]`` f32 unit rows (the visual statistics when
        ``use_clip`` is false; raises on failure)."""
        emb = self._get_embedder()
        if emb is None:
            return self._fallback_visual.embed_frames(frames_u8)
        return emb.embed_frames(frames_u8)

    def embed_frames_device(self, frames_u8: np.ndarray):
        """``(feats_dev, feats_np)``: the device-resident features and
        their host copy (one fetch); ``feats_dev`` is None when
        ``use_clip`` is false (the ingest then syncs the mirrors from the
        host); raises on failure."""
        emb = self._get_embedder()
        if emb is None:
            return None, self._fallback_visual.embed_frames(frames_u8)
        return emb.embed_frames_device(frames_u8)

    def encode_text(self, query: str) -> np.ndarray:
        """A text query → its ``[D]`` f32 embedding (the module text
        tower, or the keyword encoder when ``use_clip`` is false; raises
        on failure)."""
        emb = self._get_embedder()
        if emb is None:
            return self._fallback_text.embed_text(query)
        return emb.embed_text(query)

    def _encode_texts(self, queries: Sequence[str]) -> np.ndarray:
        """:meth:`encode_text` of each query, batched through the tower."""
        emb = self._get_embedder()
        if emb is None:
            return self._fallback_text.embed_texts(queries)
        return emb.embed_texts(list(queries))

    # ------------------------------------------------------------------
    # Startup / ingest
    # ------------------------------------------------------------------

    def _config_hash(self) -> str:
        cfg = self.config.api
        key = f"{cfg.sampling_mode}|{cfg.max_frames}|{cfg.use_clip}"
        return hashlib.md5(key.encode()).hexdigest()

    @property
    def _config_hash_path(self) -> Path:
        return Path(str(self.cache_path) + ".confighash")

    def current_videos(self) -> List[Path]:
        return [p for p in sorted(self.videos_dir.iterdir())
                if p.suffix.lower() in VIDEO_EXTENSIONS and p.is_file()]

    def _stale_videos(self, current: Sequence[Path]) -> List[Path]:
        return [v for v in current
                if self.index.video_hashes.get(v.name)
                != video_identity_hash(v)]

    def startup(self) -> None:
        logger.info("Engine starting up...")
        with self.lock, self.metrics.timer("startup"):
            loaded = self.index.load_from_disk(self.cache_path)
            if loaded and self.config.invalidate_on_config_change:
                stored = (self._config_hash_path.read_text().strip()
                          if self._config_hash_path.exists() else None)
                if stored != self._config_hash():
                    logger.info("Index-affecting config changed — full "
                                "reprocess")
                    self.index.clear()
                    loaded = False
            current = self.current_videos()
            stale = self._stale_videos(current) if loaded else current
            if stale:
                logger.info("%d videos new/changed — processing",
                            len(stale))
                self._ingest(stale)
            if stale or not loaded:
                self._write_once(
                    lambda: self.index.save_to_disk(self.cache_path))
            self._write_once(lambda: self._config_hash_path.write_text(
                self._config_hash()))
            self.index.sync_mirror()
            if self._ivf is None:
                self._maybe_build_ivf()
        self._warm_up()
        self._ready = True
        self.metrics.set_gauge("frames_indexed", len(self.index))
        logger.info("Startup complete: %d frames indexed", len(self.index))

    def _write_once(self, fn: Callable):
        """``fn()``, a write to the shared videos dir: on a corpus mesh
        that spans processes only process 0 makes it, the others waiting
        for it (the save writes the file in place, so two processes must
        not write one path); its result on every process."""
        mesh = self.index.mesh
        if mesh is None:
            return fn()
        return mesh.on_first_process(fn)

    def _warm_up(self) -> None:
        """Run the fused text-search path once for each shape its first
        requests meet, so that their one-time costs on the card (a first
        sort or kernel load at a new shape, allocator growth after
        ``torch.cuda.empty_cache()``) fall in startup: single queries (a
        short and a ~30-token one) at k = 1, ``default_results`` and 10,
        and every text bucket up to the coalescer's width at the largest
        of those k — the shapes the reference's boot warm-up
        (``VQT_WARMUP``, ``api/app.py``) compiles. On the card the
        embedder is built here if it was not yet; on the CPU the warm-up
        runs only when one is loaded. The results are dropped: no metric,
        cache or index state sees them. The IVF route is not warmed. As the
        reference's warm-up runs detached, a failure here is logged and
        startup goes on: the first request then meets it."""
        if (len(self.index) == 0 or not self.use_clip
                or self._ivf is not None
                or (self._embedder is None and self.device.type != "cuda")):
            return
        ks = sorted({1, self.config.api.default_results, 10})
        long_q = " ".join(["warmup"] * 28)
        try:
            with self.lock.read():
                for k in ks:
                    for query in ("warmup", long_q):
                        self._dispatch_batch_fused([query], k)()
                for bucket in TEXT_BUCKETS[1:]:
                    if bucket > max(64, self.config.coalesce_width):
                        break
                    self._dispatch_batch_fused(
                        [f"warmup {i}" for i in range(bucket)], ks[-1])()
        except Exception as e:
            logger.warning("search warm-up failed (%s: %s); the first "
                           "requests meet their one-time costs",
                           type(e).__name__, e)

    def _ingest(self, videos: Sequence[Path],
                api_cfg: Optional[ApiConfig] = None) -> int:
        """Batched cross-video ingest; returns the frames added.
        Re-ingesting a video replaces its rows."""
        if not videos:
            return 0
        cfg = api_cfg or self.config.api
        ing = self.config.ingest
        # the samplers (ingest/samplers.py) where the strategy or the
        # quality gate asks for them; a partial of a module-level function,
        # so that the process-pool decode tier can pickle it
        extract_fn = None
        if ing.sampling_strategy != "interval" or ing.quality_filter:
            extract_fn = functools.partial(
                strategy_extract, strategy=ing.sampling_strategy,
                max_frames=cfg.max_frames, sampling_mode=cfg.sampling_mode,
                target_size=ing.target_size,
                quality_filter=ing.quality_filter)
        with self.lock, self.metrics.timer("ingest"):
            removed = 0
            for video in videos:
                removed += self.index.remove_video(Path(video).name)
            added = self._ingest_batches(videos, batched_frames(
                list(videos), max_frames=cfg.max_frames,
                sampling_mode=cfg.sampling_mode, batch_size=ing.batch_size,
                num_workers=ing.num_decode_workers,
                prefetch=ing.prefetch_videos, extract_fn=extract_fn,
                num_procs=ing.num_decode_procs))
            for video in videos:
                if Path(video).exists():
                    self.index.video_hashes[Path(video).name] = \
                        video_identity_hash(video)
            self._ivf_after_ingest(removed)
        self.query_cache.invalidate_all()
        self.metrics.set_gauge("frames_indexed", len(self.index))
        return added

    def _ingest_batches(self, videos: Sequence[Path],
                        batches: Iterable[FrameBatch]) -> int:
        """The per-batch ingest loop (callers hold the write lock): embed
        each batch on the device, append its per-video runs to the host
        store, then stream the batch into the device mirrors from the
        embedder's output in one step (``ingest.stream_mirror``, the
        default; without a device output, ``use_clip = false``, the
        mirrors sync from the host store each batch) — or leave the
        mirrors to sync at the next search. Returns the frames added."""
        stream = self.config.ingest.stream_mirror
        added = 0
        it = iter(batches)
        # each batch's spans carry the engine's running batch number; the
        # last ``ingest.next`` is the wait that found the stream's end
        number = int(self.metrics.counter("ingest_batches"))
        while True:
            with unit(number):
                with span("ingest.next"):
                    batch = next(it, None)
                if batch is None:
                    break
                feats_dev = None
                with self.metrics.timer("embed_batch"):
                    if stream:
                        feats_dev, feats = self.embed_frames_device(
                            batch.frames)
                    else:
                        feats = self.embed_frames(batch.frames)
                runs = [(Path(videos[vidx]).name, stamps) for vidx, _, stamps
                        in group_by_video(batch)]
                with span("ingest.append"):
                    pos = 0
                    lo = len(self.index)
                    for name, stamps in runs:
                        n = len(stamps)
                        self.index.add_batch(feats[pos: pos + n], name,
                                             stamps)
                        pos += n
                    if feats_dev is not None:
                        self.index.stream_rows_device(feats_dev, offset=0,
                                                      n=pos, lo=lo)
                    elif stream:
                        self.index.sync_mirror()
            added += len(batch)
            number += 1
            self.metrics.inc("frames_embedded", len(batch))
            self.metrics.inc("ingest_batches")
        return added

    def process_video(self, video_path: Path,
                      api_cfg: Optional[ApiConfig] = None) -> int:
        """Ingest one video (the upload path)."""
        return self._ingest([Path(video_path)], api_cfg)

    def remove_video(self, video_name: str) -> int:
        """Drop a video's rows under the write lock; returns the count."""
        with self.lock:
            removed = self.index.remove_video(video_name)
            if removed and self.config.index.kind == "ivf":
                self._maybe_build_ivf()
        if removed:
            self.query_cache.invalidate_all()
            self.metrics.set_gauge("frames_indexed", len(self.index))
        return removed

    # ------------------------------------------------------------------
    # The IVF tier (index.kind == "ivf"): built on the mutation paths
    # (write lock held), only read by searches
    # ------------------------------------------------------------------

    def _maybe_build_ivf(self) -> None:
        """(Re)build the tier from the current corpus, or drop it when
        ``index.kind`` is not "ivf" or the corpus holds fewer than
        ``ivf_min_rows`` rows. Callers hold the write lock."""
        cfg = self.config.index
        self._ivf = None            # the old tiles go before the new come
        self._ivf_rows = 0
        if cfg.kind != "ivf" or self.index.count < cfg.ivf_min_rows:
            return
        mesh = self.index.mesh
        if mesh is not None and (mesh.multislice or mesh.multiprocess):
            mesh = None         # one replica on the index's first device
        ivf = IVFIndex(nlist=cfg.ivf_nlist or None, nprobe=cfg.ivf_nprobe,
                       mesh=mesh, device=self.index.device)
        with self.metrics.timer("ivf_build"):
            ivf.build(self.index._emb[: self.index.count])
        self._ivf = ivf
        self._ivf_rows = self.index.count
        self.metrics.inc("ivf_builds")

    def _ivf_absorb_appends(self) -> None:
        """Hand the rows appended since the last build to the fresh
        buffer (exactly scanned by every search); rebuild once it
        outgrows ``rebuild_fraction``. Write lock held."""
        if self._ivf is None:
            self._maybe_build_ivf()
            return
        n = self.index.count
        if n > self._ivf_rows:
            self._ivf.add(self.index._emb[self._ivf_rows: n])
            self._ivf_rows = n
        if self._ivf.needs_rebuild:
            self._maybe_build_ivf()

    def _ivf_after_ingest(self, removed: int) -> None:
        """The tier after an ingest (write lock held): rebuilt when the
        ingest removed rows (compaction shifted the ids), else fed the
        appended rows."""
        if self.config.index.kind != "ivf":
            return
        if removed:
            self._maybe_build_ivf()
        else:
            self._ivf_absorb_appends()

    def ann_stats(self) -> Dict:
        if self.config.index.kind != "ivf":
            return {"kind": "exact"}
        ivf = self._ivf
        if ivf is None:
            return {"kind": "ivf", "active": False,
                    "reason": f"below ivf_min_rows="
                              f"{self.config.index.ivf_min_rows}"}
        return {"kind": "ivf", "active": True, **ivf.stats()}

    def accuracy_mode(self) -> str:
        """The serving index's accuracy contract: ``approximate-ivf``
        while the IVF tier is live (``nprobe`` trades recall for
        traffic), else ``exact-f32-scan`` (the f32 mirror's exact scan)
        or ``exact-f32-rerank`` (a quantized mirror's candidates, every
        returned row re-ranked exactly in f32)."""
        ann = self.ann_stats()
        if ann.get("kind") == "ivf" and ann.get("active"):
            return "approximate-ivf"
        if self.config.index.device_dtype == "float32":
            return "exact-f32-scan"
        return "exact-f32-rerank"

    # ------------------------------------------------------------------
    # Search
    # ------------------------------------------------------------------

    def _format(self, results: List[Dict]) -> List[Dict]:
        """Reference result shaping (``formatted_time``), plus
        ``thumbnail_url`` when ``thumbnail_base_url`` is configured."""
        base = self.config.thumbnail_base_url
        for r in results:
            r["formatted_time"] = format_timestamp(r["timestamp"])
            if base:
                r["thumbnail_url"] = (
                    f"{base}/{r['video_name']}/"
                    f"thumbnail_{r['timestamp']:.2f}.jpg")
        return results

    @staticmethod
    def _dedup_by_video(results: List[Dict], k: int) -> List[Dict]:
        """Keep the best frame per video."""
        seen = set()
        out = []
        for r in results:
            if r["video_name"] in seen:
                continue
            seen.add(r["video_name"])
            out.append(r)
            if len(out) >= k:
                break
        return out

    # fetching at the next k bucket and trimming keeps the reference's
    # fetch depths (the over-fetch follows the bucketed k)
    _K_BUCKETS = (1, 5, 10, 16, 32, 64)

    @classmethod
    def _bucket_k(cls, k: int) -> int:
        for b in cls._K_BUCKETS:
            if b >= k:
                return b
        return cls._K_BUCKETS[-1]

    def search_ex(self, query: str, k: int = 5, use_cache: bool = True,
                  dedup_videos: bool = False, offset: int = 0
                  ) -> Tuple[List[Dict], bool]:
        """One query: ``(results, from_cache)``. ``offset`` pages through
        the ranking (``offset + k <= 64``; a paginated query fetches and
        caches the full top-64 once)."""
        offset = max(0, int(offset))
        if offset and offset + k > MAX_K:
            raise ValueError(f"offset + k must be <= {MAX_K}")
        self.metrics.inc("searches")
        cache_on = (use_cache and self.config.api.cache_search
                    and not dedup_videos)
        cache_k = MAX_K if offset else k
        if cache_on:
            hit = self.query_cache.get_text(query, cache_k)
            if hit is not None:
                self.metrics.inc("search_cache_hits")
                return [dict(r) for r in hit[offset: offset + k]], True
        if offset:
            fetch_k = MAX_K
        else:
            fetch_k = min(k * 2, MAX_K) if dedup_videos else k
        with self.lock.read(), self.metrics.timer("search_latency"):
            emb = self._tower()
            if self._ivf is not None or emb is None:
                with self.metrics.timer("text_encode"):
                    q = self.encode_text(query)
                with self.metrics.timer("index_scan"):
                    results = (self._search_ann(q, fetch_k)
                               if self._ivf is not None
                               else self.index.search(q, fetch_k))
            else:
                ids = emb.prepare_text_ids(emb.tokenizer([query]))
                results = self.index.search_batch_fused(
                    emb.text_encode_fn, emb.params, ids,
                    self._bucket_k(fetch_k))[0][:fetch_k]
            if dedup_videos:
                results = self._dedup_by_video(results, offset + k)
            results = self._format(results)
        if cache_on:
            self.query_cache.put_text(query, cache_k,
                                      [dict(r) for r in results])
        return results[offset: offset + k], False

    def search(self, query: str, k: int = 5, use_cache: bool = True,
               dedup_videos: bool = False, offset: int = 0) -> List[Dict]:
        return self.search_ex(query, k, use_cache, dedup_videos, offset)[0]

    def _search_ann(self, q: np.ndarray, k: int) -> List[Dict]:
        """One query vector through the IVF tier; rows through the
        index's metadata, as the mirror's scan gives them."""
        self.metrics.inc("ann_searches")
        vals, idxs = self._ivf.search(self.index.normalize_query(q), k=k)
        return self.index._rows_from(vals[None], idxs[None])[0]

    def search_batch(self, queries: Sequence[str], k: int = 5
                     ) -> List[List[Dict]]:
        """All queries in one device pass per text bucket."""
        self.metrics.inc("searches", len(queries))
        with self.lock.read(), self.metrics.timer("batch_search_latency"):
            batches = self._dispatch_batch(queries, k)()
        return [self._format(r) for r in batches]

    def _dispatch_batch(self, queries: Sequence[str], k: int
                        ) -> Callable[[], List[List[Dict]]]:
        """Dispatch phase of batched text search on the serving route —
        the IVF tier while it is live, else the mirror's fused scan, or
        with ``use_clip`` false the keyword vectors through the index's
        vector search — returning ``resolve() -> rows`` (unformatted,
        trimmed to ``k``). The caller holds the engine read lock from this
        call through ``resolve()``."""
        if self._ivf is not None:
            return self._dispatch_batch_ivf(queries, k)
        if not self.use_clip:
            q = self._encode_texts(queries)
            return lambda: self.index.search_batch(q, k)
        return self._dispatch_batch_fused(queries, k)

    def _dispatch_batch_ivf(self, queries: Sequence[str], k: int
                            ) -> Callable[[], List[List[Dict]]]:
        """The IVF route: the query vectors now (``_encode_texts``: host
        vectors); ``resolve()`` normalizes them, probes the tier and
        builds the rows."""
        q = self._encode_texts(queries)
        ivf = self._ivf

        def resolve() -> List[List[Dict]]:
            qn = np.stack([self.index.normalize_query(r) for r in q])
            self.metrics.inc("ann_searches", len(queries))
            vals, idxs = ivf.search(qn, k=k)
            return self.index._rows_from(vals, idxs)
        return resolve

    def _dispatch_batch_fused(self, queries: Sequence[str], k: int
                              ) -> Callable[[], List[List[Dict]]]:
        """Dispatch phase of batched text search: tokenize, trim to a seq
        bucket, pad to a batch bucket (``TEXT_BUCKETS``, chunking above the
        widest) and enqueue each chunk's device work. Returns ``resolve()
        -> rows`` (unformatted, trimmed to ``k``). The caller holds the
        engine read lock from this call through ``resolve()``."""
        emb = self._tower()
        step = TEXT_BUCKETS[-1]
        parts = []
        for lo in range(0, len(queries), step):
            chunk = list(queries[lo:lo + step])
            with span("tokenize"):
                ids = emb.prepare_text_ids(emb.tokenizer(chunk))
            n = ids.shape[0]
            bucket = _bucket_for(n, TEXT_BUCKETS)
            if n < bucket:
                ids = np.concatenate([ids, np.tile(ids[-1:],
                                                   (bucket - n, 1))])
            with span("dispatch"):
                parts.append((n, self.index.search_batch_fused_async(
                    emb.text_encode_fn, emb.params, ids,
                    self._bucket_k(k))))

        def resolve() -> List[List[Dict]]:
            out: List[List[Dict]] = []
            for n, part in parts:
                out.extend(rows[:k] for rows in part()[:n])
            return out
        return resolve

    def search_by_vector_ex(self, vector: np.ndarray, k: int = 5,
                            use_cache: bool = True
                            ) -> Tuple[List[Dict], bool]:
        """A query vector (an image's embedding, a frame's row):
        ``(results, from_cache)`` — through the IVF tier while it is
        live, else the mirror's scan."""
        self.metrics.inc("searches")
        vector = np.asarray(vector, np.float32)
        cache_on = use_cache and self.config.api.cache_search
        if cache_on:
            hit = self.query_cache.get_vector(vector, k)
            if hit is not None:
                self.metrics.inc("search_cache_hits")
                return [dict(r) for r in hit], True
        with self.lock.read(), self.metrics.timer("search_latency"):
            if self._ivf is not None:
                results = self._search_ann(vector, k)
            else:
                results = self.index.search_batch(vector[None], k)[0]
            results = self._format(results)
        if cache_on:
            self.query_cache.put_vector(vector, k,
                                        [dict(r) for r in results])
        return results, False

    def search_by_vector(self, vector: np.ndarray, k: int = 5,
                         use_cache: bool = True) -> List[Dict]:
        return self.search_by_vector_ex(vector, k, use_cache)[0]

    def search_by_image_ex(self, image_rgb_u8: np.ndarray, k: int = 5
                           ) -> Tuple[List[Dict], bool]:
        """Query by raw image: resize → embed → vector search."""
        img = resize_shorter_side_and_crop(np.asarray(image_rgb_u8))
        vec = self.embed_frames(img[None])[0]
        return self.search_by_vector_ex(vec, k)

    def search_by_image(self, image_rgb_u8: np.ndarray, k: int = 5
                        ) -> List[Dict]:
        return self.search_by_image_ex(image_rgb_u8, k)[0]

    def search_coalesced_ex(self, query: str, k: int = 5,
                            use_cache: bool = True
                            ) -> Tuple[List[Dict], bool]:
        """Search through the request coalescer: concurrent callers within
        the window share one device pass (the API's ``enhanced_mode``)."""
        if self._coalescer is None:
            from video_quierer_tpu_torch.engine.batching import \
                SearchCoalescer
            self._coalescer = SearchCoalescer(
                self, max_batch=self.config.coalesce_width)
        return self._coalescer.search_ex(query, k, use_cache)

    def search_coalesced(self, query: str, k: int = 5,
                         use_cache: bool = True) -> List[Dict]:
        return self.search_coalesced_ex(query, k, use_cache)[0]

    def warm_cache(self, queries: Sequence[str], k: int = 5) -> int:
        """Put each query's rows in the query cache; returns the count."""
        for q in queries:
            self.search(q, k=k, use_cache=True)
        return len(queries)

    def search_similar_ex(self, video_name: str, timestamp: float,
                          k: int = 5, use_cache: bool = True
                          ) -> Tuple[List[Dict], bool]:
        """'More like this': a vector search with the f32 row of
        ``video_name``'s indexed frame nearest ``timestamp`` as the query,
        that frame left out of the results. Raises ``KeyError`` when the
        video has no live rows."""
        with self.lock.read():
            row = self.index.nearest_frame(video_name, timestamp)
            if row is None:
                raise KeyError(video_name)
            vec = self.index.frame_embedding(row)
            seed = self.index.frame_info(row)
        # one more, so that dropping the seed still leaves k; the vector
        # search takes its own read lock (reads do not nest across a
        # waiting writer)
        results, from_cache = self.search_by_vector_ex(vec, k + 1,
                                                       use_cache)
        out = [r for r in results
               if not (r["video_name"] == seed["video_name"]
                       and r["frame_id"] == seed["frame_id"])][:k]
        self.metrics.inc("similar_searches")
        return out, from_cache

    def search_similar(self, video_name: str, timestamp: float,
                       k: int = 5, use_cache: bool = True) -> List[Dict]:
        return self.search_similar_ex(video_name, timestamp, k,
                                      use_cache)[0]

    def search_videos(self, query: str, k: int = 5) -> List[Dict]:
        """Whole videos ranked by the cosine of the query with their mean
        frame embedding: ``[{video_name, score, frame_count,
        best_timestamp}]``."""
        self.metrics.inc("searches")
        with self.lock.read(), self.metrics.timer("video_search_latency"):
            q = self.encode_text(query)
            return self.index.search_videos(q, k)

    # ------------------------------------------------------------------
    # Maintenance
    # ------------------------------------------------------------------

    def rebuild(self) -> int:
        """Clear the index and ingest the videos dir anew with the current
        config, then save the cache; returns the frames added. The IVF
        tier goes with the rows (rebuilt by the ingest when due)."""
        with self.lock:
            self.index.clear()
            self._ivf = None
            self._ivf_rows = 0
            self.query_cache.invalidate_all()
            added = self._ingest(self.current_videos())
            self._write_once(
                lambda: self.index.save_to_disk(self.cache_path))
        return added

    def clear(self) -> None:
        """Empty the index, the IVF tier and the query cache, and delete
        the cache file."""
        with self.lock:
            self.index.clear()
            self._ivf = None
            self._ivf_rows = 0
            self.query_cache.invalidate_all()
            self._write_once(lambda: self.cache_path.unlink(
                missing_ok=True))
        self.metrics.set_gauge("frames_indexed", 0)

    def save(self, path: Optional[Path] = None) -> bool:
        """Write the pickle cache (to ``path``, else the videos dir's)."""
        with self.lock:
            return self._write_once(lambda: self.index.save_to_disk(
                Path(path) if path else self.cache_path))

    def load(self, path: Optional[Path] = None) -> bool:
        """Load a pickle cache (from ``path``, else the videos dir's):
        the IVF tier is rebuilt and the query cache dropped. False when
        it does not load (the index is then left as it was)."""
        with self.lock:
            ok = self.index.load_from_disk(Path(path) if path
                                           else self.cache_path)
            if ok:
                self._maybe_build_ivf()
        if ok:
            self.query_cache.invalidate_all()
            self.metrics.set_gauge("frames_indexed", len(self.index))
        return ok

    def close(self) -> None:
        """Stop the coalescer's threads."""
        if self._coalescer is not None:
            self._coalescer.close()
            self._coalescer = None

    @property
    def ready(self) -> bool:
        return self._ready

    def stats(self) -> Dict:
        emb = self._embedder
        return {
            "video_count": len(self.index.video_names()),
            "total_frames_indexed": len(self.index),
            "processor_type": "CLIP" if self.use_clip else "Visual",
            "pretrained": bool(emb.pretrained) if emb is not None else None,
            "cache_exists": self.cache_path.exists(),
            "video_hashes_count": len(self.index.video_hashes),
            "query_cache": self.query_cache.stats(),
            "ann": self.ann_stats(),
            "index": {
                "kind": self.config.index.kind,
                "device_dtype": self.config.index.device_dtype,
                "accuracy_mode": self.accuracy_mode(),
            },
            "metrics": self.metrics.snapshot(),
        }
