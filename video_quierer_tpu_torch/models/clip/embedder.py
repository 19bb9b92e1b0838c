"""CLIP embedder: the engine's device-facing entry point for frames and
text (counterpart of ``video_quierer_tpu/models/clip/embedder.py``).

- Frames: uint8 ``[N, 224, 224, 3]`` RGB batches are cut into chunks of at
  most 256, each padded to an image bucket (32, 128, 256), moved to the
  device once, normalised there (``ops/preprocess.py``) and encoded: the
  fused vision encode (kernels B5 + B6, ``ops/fused_layer.py``) whenever
  the tower is eligible and ``B·S >= MIN_TOKENS`` — every image bucket of
  a dense CLIP tower — else the module tower (attention kernel B3), which
  a Switch-MoE tower always takes. An MoE row depends on the rest of its
  padded bucket (each expert's capacity counts every token of it), so the
  chunks and buckets are the JAX embedder's exactly. Every chunk is
  enqueued before any result is fetched.
- ``parallel="pp"`` (``model.parallel``): the image encode runs GPipe
  over a ``pipe`` of stages (``parallel/pipeline.py:
  pipelined_encode_image``, ``pipeline_microbatches`` microbatches; the
  fused vision encode is off), on ``pipe_devices`` when given, else on
  the largest count of CUDA cards that divides the encoder depth (one
  card: one stage; a CPU embedder: one stage on the CPU). The vision
  layers move to their stages' devices. A Switch-MoE tower raises
  ``ValueError``: the pipeline runs the dense block (the JAX embedder
  fails there too, at its first encode).
- Text: queries are tokenized on the host, trimmed to a seq bucket (exact
  for the causal tower), padded to a batch bucket, and encoded on the
  embedder's device. ``B·S >= MIN_TOKENS`` with S in the 8/16/32 buckets
  takes the fused-layer encode (kernel B2); everything else — single
  queries, small batches, the 77 bucket — takes the module tower
  (attention kernel B3).
- ``mesh`` (a :class:`~video_quierer_tpu_torch.parallel.mesh.DataMesh`,
  JAX ``CLIPEmbedder(mesh=..., data_axis="data")``): data-parallel
  serving. The module is replicated once per data row's first device; a
  batch that divides the ``data`` axis splits into equal parts, each
  encoded on its device against its replica
  (``ops/fused_layer.py:fused_encode_shards``): the fused encodes (B5 +
  B6, B2) where each PART clears the gates (``_fused_shard_ok``), else the
  module tower (B3) per part; the rows gather onto the embedder's device.
  A batch that does not divide the axis (a single query's bucket of 1)
  runs whole on the embedder's device on the module tower, as the JAX
  embedder leaves it unsharded. A Switch-MoE tower never splits (its
  rows depend on the whole bucket). ``parallel="pp"`` with a data mesh
  raises ``ValueError``.

``MemoizedEmbedder`` wraps any embedder in a frame-embedding memo
(``cache.frame_memo_size > 0``).

Weights, in the reference's order: ``orbax_checkpoint``, a checkpoint
directory of the port's trainer (``train/checkpoint.py``, the port's own
format: an orbax directory of the JAX package raises ``ValueError``),
whose ``params`` tree (the live weights, not the EMA, as the reference
reads) is served with ``pretrained`` True and the tokenizer of
``checkpoint_dir`` or of the checkpoint discovery finds; a state dict
handed in (e.g. from ``bridge.params_from_jax``) is used as it is; else
the HF checkpoint in ``checkpoint_dir``, or the one ``find_local_checkpoint``
finds (``$VQT_CLIP_CHECKPOINT``, ``./checkpoints/<short name>``, the HF
hub cache), read by ``convert.py`` into the JAX package's tree and
bridged (``pretrained`` is then True); else the port's seeded init
(``bridge.init_params`` from a ``torch.Generator``), with a warning. A
configured directory without weights raises ``FileNotFoundError``. The
tokenizer is the checkpoint's BPE (``vocab.json``/``merges.txt``) when
the directory holds one, else the deterministic ``HashTokenizer``.
``load_seconds`` splits a checkpoint load by stage.
"""

from __future__ import annotations

import copy
import hashlib
import logging
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from video_quierer_tpu_torch.models.clip import convert as convert_mod
from video_quierer_tpu_torch.models.clip.bridge import (
    init_params,
    params_from_jax,
)
from video_quierer_tpu_torch.models.clip.config import get_config
from video_quierer_tpu_torch.models.clip.model import CLIP
from video_quierer_tpu_torch.models.clip.tokenizer import (
    TokenizerBase,
    load_tokenizer,
)
from video_quierer_tpu_torch.ops.fused_layer import (
    LayerOps,
    _layer_operands,
    fused_batch_eligible,
    fused_encode_shards,
    fused_seq_eligible,
    fused_text_encode,
    fused_text_tower_eligible,
    fused_vision_encode,
    fused_vision_tower_eligible,
)
from video_quierer_tpu_torch.ops.preprocess import normalize_images
from video_quierer_tpu_torch.parallel import mesh as mesh_mod
from video_quierer_tpu_torch.parallel.pipeline import (
    pipelined_encode_image,
    shard_layers,
)
from video_quierer_tpu_torch.utils.env import resolve_device
from video_quierer_tpu_torch.utils.stageprof import span

logger = logging.getLogger(__name__)

# Frame-batch buckets: frames pad to the next one (the reference's).
IMAGE_BUCKETS = (32, 128, 256)
# Batch buckets (1 serves the latency path) and seq buckets of the causal
# text tower — the reference's, so both packages pad identically.
TEXT_BUCKETS = (1, 8, 32, 64, 128, 256, 512)
TEXT_SEQ_BUCKETS = (8, 16, 32, 77)


def trim_text_ids(ids: np.ndarray) -> np.ndarray:
    """Trim trailing pad columns of ``[B, 77]`` token ids to a seq bucket
    covering every row's EOT (exact for causal towers)."""
    ids = np.asarray(ids)
    if ids.ndim != 2 or 0 in ids.shape:
        return ids
    need = int(np.argmax(ids, axis=1).max()) + 1
    for b in TEXT_SEQ_BUCKETS:
        if need <= b <= ids.shape[1]:
            return ids[:, :b]
    return ids


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def read_trained(path: Path, seconds: dict) -> Dict[str, torch.Tensor]:
    """The ``params`` tree of a checkpoint of the port's trainer (JAX
    ``_load_orbax_params``; ``train/checkpoint.py:load_params``)."""
    from video_quierer_tpu_torch.train.checkpoint import load_params
    t0 = time.perf_counter()
    state_dict = load_params(Path(path))
    seconds.update(read_trained=time.perf_counter() - t0)
    return state_dict


def read_checkpoint(ckpt: Path, cfg, convert, bridge, seconds: dict
                    ) -> Dict[str, torch.Tensor]:
    """An HF checkpoint dir → the port's f32 state dict: ``convert`` (the
    file read, mapped, and the JAX package's numpy tree) then ``bridge``
    (``params_from_jax``); the tree is dropped on return."""
    t0 = time.perf_counter()
    tree = convert(ckpt, cfg)
    t1 = time.perf_counter()
    state_dict = bridge(tree, cfg)
    seconds.update(read_convert=t1 - t0, bridge=time.perf_counter() - t1)
    return state_dict


def place_module(module_cls, cfg, state_dict: Dict[str, torch.Tensor],
                 device: torch.device, dtype: torch.dtype,
                 seconds: dict) -> torch.nn.Module:
    """``module_cls(cfg)`` holding ``state_dict`` (every parameter, strict)
    in ``dtype`` on ``device``, in eval mode. The module is built on the
    meta device and takes the state dict's tensors, so no random init
    runs and no second host copy is made."""
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = module_cls(cfg)
    model.load_state_dict(state_dict, assign=True)
    t1 = time.perf_counter()
    model = model.to(device=device, dtype=dtype).eval()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds.update(load=t1 - t0, device=time.perf_counter() - t1)
    return model


class CLIPEmbedder:
    """CLIP image and text encoder with bucketed batching on one device,
    or over a data mesh's devices (``mesh``)."""

    def __init__(self,
                 model_name: str = "openai/clip-vit-base-patch32",
                 checkpoint_dir: Optional[Path] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda",
                 seed: int = 0,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 orbax_checkpoint: Optional[Path] = None,
                 parallel: str = "none",
                 pipeline_microbatches: int = 4,
                 pipe_devices: Optional[Sequence] = None,
                 mesh: Optional[mesh_mod.DataMesh] = None,
                 data_axis: str = mesh_mod.DATA_AXIS):
        """``mesh``: serve over a data mesh's devices (its ``data_axis``,
        the JAX embedder's argument, must be ``"data"``); results land on
        ``device``."""
        self._begin(get_config(model_name), device, dtype)
        if parallel not in ("none", "pp"):
            raise ValueError(f"unknown parallel mode {parallel!r}")
        if mesh is not None and data_axis not in mesh.shape:
            raise ValueError(f"the mesh has no {data_axis!r} axis: "
                             f"{mesh.shape}")
        if mesh is not None and parallel == "pp":
            raise ValueError(
                "model.parallel='pp' with a data mesh: the port's pipelined "
                "tower runs on its own pipe of cards (parallel/pipeline.py) "
                "and does not split batches over a data mesh as well")
        if parallel == "pp" and self.cfg.vision.moe_experts:
            raise ValueError(
                "model.parallel='pp' pipelines the dense encoder block; a "
                "Switch-MoE tower (vision.moe_experts > 0) cannot be "
                "pipelined")
        ckpt = checkpoint_dir
        if orbax_checkpoint is not None:
            # fine-tuned weights from the port's trainer: the train → serve
            # loop; the tokenizer is still the HF checkpoint's, if any
            logger.info("Loading fine-tuned params from %s",
                        orbax_checkpoint)
            state_dict = read_trained(orbax_checkpoint, self.load_seconds)
            ckpt = ckpt or convert_mod.find_local_checkpoint(model_name)
            self.pretrained = True
        elif state_dict is None:
            ckpt = ckpt or convert_mod.find_local_checkpoint(model_name)
            if ckpt is not None:
                logger.info("Loading CLIP weights from %s", ckpt)
                state_dict = read_checkpoint(
                    Path(ckpt), self.cfg, convert_mod.convert_hf_checkpoint,
                    params_from_jax, self.load_seconds)
                self.pretrained = True
            else:
                logger.warning(
                    "No local CLIP checkpoint found — using seeded random "
                    "init (set VQT_CLIP_CHECKPOINT to a local HF checkpoint "
                    "dir).")
                state_dict = init_params(self.cfg,
                                         torch.Generator().manual_seed(seed))
        params = place_module(CLIP, self.cfg, state_dict, self.device,
                              dtype, self.load_seconds)
        del state_dict
        stages = None
        if parallel == "pp":
            if pipe_devices is None:
                pipe_devices = mesh_mod.pipe_devices(
                    devices=None if self.device.type == "cuda"
                    else [self.device], depth=self.cfg.vision.num_layers)
            stages = shard_layers(params.vision.layers, pipe_devices)
        self._serve(params, load_tokenizer(ckpt), mesh=mesh,
                    pipe_stages=stages,
                    pipeline_microbatches=pipeline_microbatches)
        self._fused_text = fused_text_tower_eligible(self.cfg.text)
        self._fused_vision = (self._pipe_stages is None
                              and fused_vision_tower_eligible(
                                  self.cfg.vision))

    def _begin(self, cfg, device: str | torch.device,
               dtype: torch.dtype) -> None:
        """The state every family's embedder sets before it reads its
        weights: the tower config, the device, the dtype and the load
        record (``pretrained``, ``load_seconds``)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.pretrained = False
        self.load_seconds: Dict[str, float] = {}

    def _serve(self, params: torch.nn.Module, tokenizer: TokenizerBase, *,
               mesh: Optional[mesh_mod.DataMesh] = None,
               pipe_stages=None, pipeline_microbatches: int = 4) -> None:
        """The serving state every family's embedder sets once its module
        is placed, and which the methods here read: the module and its
        replicas over ``mesh``'s data rows, the tokenizer, the pipe
        stages, the layer-operand cache and the bound text encode. A
        family without a data mesh or a pipe passes neither."""
        self.params = params
        self.tokenizer = tokenizer
        self.mesh = mesh
        self._pipe_stages = pipe_stages
        self._pipe_microbatches = pipeline_microbatches
        self._ops: Dict[tuple, list] = {}
        # one module a data row: the parameters themselves on the
        # embedder's device, one copy on each other device
        self._replicas: List[torch.nn.Module] = [params]
        if mesh is not None:
            by_device = {self.device: params}
            for d in mesh.data_devices:
                if d not in by_device:
                    by_device[d] = copy.deepcopy(params).to(d)
            self._replicas = [by_device[d] for d in mesh.data_devices]
        # bound ONCE, as the reference's: callers hand it to the index
        self.text_encode_fn = self._encode_text_fn

    def _layer_ops(self, params: CLIP, tower: str = "text"
                   ) -> List[LayerOps]:
        """Fused-layer operands of ``params``' ``tower`` ("text" or
        "vision"), built once per module."""
        key = (id(params), tower)
        ops = self._ops.get(key)
        if ops is None:
            live = {id(params)} | {id(r) for r in self._replicas}
            self._ops = {k: v for k, v in self._ops.items() if k[0] in live}
            ops = self._ops[key] = [_layer_operands(block, self.dtype)
                                    for block in getattr(params,
                                                         tower).layers]
        return ops

    @property
    def embed_dim(self) -> int:
        return self.cfg.projection_dim

    def _fused_shard_ok(self, b: int, s: int) -> bool:
        """Data-mesh serving: the batch splits evenly over the ``data``
        axis and each PART clears the fused gate (JAX
        ``_fused_shard_ok``)."""
        n = len(self._replicas)
        return b % n == 0 and fused_batch_eligible(b // n, s)

    def _encode_parts(self, params: CLIP, x: torch.Tensor, fused, module,
                      splits: bool = True) -> torch.Tensor:
        """Under the data mesh: ``fused(replica, part)`` over the parts
        when ``fused`` is given, else ``module(replica, part)`` when the
        batch divides the axis and the tower ``splits``, else
        ``module(params, x)`` whole on the embedder's device; rows on the
        embedder's device."""
        if params is not self.params:
            raise ValueError("under a data mesh the embedder encodes with "
                             "its own replicated parameters")
        split = fused or (module if splits and x.shape[0] % len(
            self._replicas) == 0 else None)
        with torch.inference_mode():
            if split is None:
                return module(params, x.to(self.device))
            return fused_encode_shards(split, self._replicas, self.mesh,
                                       x).to(self.device)

    def _encode_image_mesh(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` uint8 (host or device) over the data mesh."""
        def norm(part):
            return normalize_images(part, dtype=self.dtype)
        fused = None
        if self._fused_vision and self._fused_shard_ok(
                frames_u8.shape[0], self.cfg.vision.seq_len):
            def fused(m, part):
                return fused_vision_encode(m, norm(part),
                                           self._layer_ops(m, "vision"))
        # a Switch-MoE row depends on its whole bucket: never split
        return self._encode_parts(
            self.params, frames_u8, fused,
            lambda m, part: m.encode_image(norm(part)),
            splits=not self.cfg.vision.moe_experts)

    def _encode_image_fn(self, params: CLIP,
                         frames_u8: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` uint8 on the device → ``[B, proj]`` f32 unit
        rows."""
        with torch.inference_mode():
            pixels = normalize_images(frames_u8, dtype=self.dtype)
            if self._pipe_stages is not None:
                return pipelined_encode_image(
                    params, pixels, stages=self._pipe_stages,
                    n_microbatches=self._pipe_microbatches)
            if self._fused_vision and fused_batch_eligible(
                    frames_u8.shape[0], self.cfg.vision.seq_len):
                return fused_vision_encode(params, pixels,
                                           self._layer_ops(params, "vision"))
            return params.encode_image(pixels)

    def embed_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        """``[N, 224, 224, 3] uint8 RGB`` → L2-normalised ``[N, D]`` f32."""
        return self.embed_frames_device(frames_u8)[1]

    def embed_frames_device(self, frames_u8: np.ndarray):
        """:meth:`embed_frames` that also hands back the device-resident
        features: ``(feats_dev [>= N, D], feats_np [N, D] f32)``.

        The ingest path feeds the index's device mirrors straight from
        ``feats_dev`` (``DeviceVideoIndex.stream_rows_device``): the
        embeddings the device just produced are never uploaded again.
        ``feats_dev`` is padded to the chunk-bucket total; rows past N
        are dead (the append's offsets never read them)."""
        frames_u8 = np.asarray(frames_u8, np.uint8)
        n = frames_u8.shape[0]
        if n == 0:
            return None, np.zeros((0, self.embed_dim), np.float32)
        # every chunk (at most the widest bucket, padded to its bucket)
        # moved and its encode enqueued before any result is fetched;
        # interior chunks are full, so device row r is frame r
        parts = []
        step = IMAGE_BUCKETS[-1]
        for pos in range(0, n, step):
            chunk = frames_u8[pos: pos + step]
            bucket = _bucket_for(chunk.shape[0], IMAGE_BUCKETS)
            if chunk.shape[0] < bucket:
                chunk = np.concatenate([chunk, np.zeros(
                    (bucket - chunk.shape[0],) + chunk.shape[1:], np.uint8)])
            batch = torch.from_numpy(np.ascontiguousarray(chunk))
            if self.mesh is not None:
                # each part goes from the host to its own device
                parts.append(self._encode_image_mesh(batch))
                continue
            parts.append(self._encode_image_fn(self.params,
                                               batch.to(self.device)))
        feats_dev = parts[0] if len(parts) == 1 else torch.cat(parts)
        with span("embed.fetch"):
            feats = feats_dev[:n].cpu().numpy()
        return feats_dev, feats

    def _encode_text_fn(self, params: CLIP,
                        input_ids: torch.Tensor) -> torch.Tensor:
        """``[B, S]`` ids on the device → ``[B, proj]`` f32 unit rows."""
        b, s = input_ids.shape
        if self.mesh is not None:
            fused = None
            if self._fused_text and fused_seq_eligible(s) \
                    and self._fused_shard_ok(b, s):
                def fused(m, part):
                    return fused_text_encode(m, part, self._layer_ops(m))
            return self._encode_parts(params, input_ids, fused,
                                      lambda m, part: m.encode_text(part))
        with torch.inference_mode():
            if self._fused_text and fused_seq_eligible(s) \
                    and fused_batch_eligible(b, s):
                return fused_text_encode(params, input_ids,
                                         self._layer_ops(params))
            return params.encode_text(input_ids)

    # engine fused paths call this before handing ids to the encoder
    prepare_text_ids = staticmethod(trim_text_ids)

    def ids_tensor(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(ids, np.int64)).to(
            self.device)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Text queries → L2-normalized ``[B, D]`` f32."""
        texts = list(texts)
        if len(texts) > TEXT_BUCKETS[-1]:
            step = TEXT_BUCKETS[-1]
            return np.concatenate([self.embed_texts(texts[i:i + step])
                                   for i in range(0, len(texts), step)])
        ids = self.prepare_text_ids(self.tokenizer(texts))
        n = ids.shape[0]
        bucket = _bucket_for(n, TEXT_BUCKETS)
        if n < bucket:
            ids = np.concatenate([ids, np.tile(ids[-1:], (bucket - n, 1))])
        feats = self.text_encode_fn(self.params, self.ids_tensor(ids))
        return feats.cpu().numpy()[:n]

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]


class MemoizedEmbedder:
    """Frame-embedding memo around any embedder (a copy of the JAX
    package's ``MemoizedEmbedder``).

    Keys frames by the md5 of every 16th pixel in each direction, so
    re-processing unchanged content (``/api/cache/rebuild`` with the same
    videos) skips the device; the least recently used entries go first
    past ``max_size``. ``hits`` and ``misses`` count frames.
    ``embed_frames_device`` passes straight through (the streamed mirror
    needs the features on the device), so the memo serves the host path
    (``ingest.stream_mirror = false``) only.
    """

    def __init__(self, inner, max_size: int = 50_000):
        self.inner = inner
        self.max_size = max_size
        self._memo: "OrderedDict[bytes, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def pretrained(self):
        return getattr(self.inner, "pretrained", False)

    @staticmethod
    def _key(frame: np.ndarray) -> bytes:
        return hashlib.md5(
            np.ascontiguousarray(frame[::16, ::16]).tobytes()).digest()

    def embed_frames(self, frames_u8: np.ndarray) -> np.ndarray:
        frames_u8 = np.asarray(frames_u8, np.uint8)
        n = frames_u8.shape[0]
        if n == 0:
            return self.inner.embed_frames(frames_u8)
        keys = [self._key(frames_u8[i]) for i in range(n)]
        dim = getattr(self.inner, "embed_dim", None)
        if dim is None:  # from any cached entry, else from this batch
            dim = (len(next(iter(self._memo.values())))
                   if self._memo else None)
        if dim is None:
            feats = self.inner.embed_frames(frames_u8)
            self.misses += n
            for i, key in enumerate(keys):
                self._memo[key] = feats[i]
            while len(self._memo) > self.max_size:
                self._memo.popitem(last=False)
            return feats
        out = np.empty((n, dim), np.float32)
        missing = []
        for i, key in enumerate(keys):
            cached = self._memo.get(key)
            if cached is not None:
                out[i] = cached
                self._memo.move_to_end(key)
                self.hits += 1
            else:
                missing.append(i)
                self.misses += 1
        if missing:
            feats = self.inner.embed_frames(frames_u8[missing])
            for j, i in enumerate(missing):
                out[i] = feats[j]
                self._memo[keys[i]] = feats[j]
            while len(self._memo) > self.max_size:
                self._memo.popitem(last=False)
        return out

    def embed_frames_device(self, frames_u8: np.ndarray):
        """The inner embedder's ``(feats_dev, feats_np)``, not memoized;
        ``(None, embed_frames(...))`` when it has no device path."""
        fn = getattr(self.inner, "embed_frames_device", None)
        if fn is None:
            return None, self.embed_frames(frames_u8)
        return fn(frames_u8)

    def embed_text(self, text: str) -> np.ndarray:
        return self.inner.embed_text(text)

    def embed_texts(self, texts) -> np.ndarray:
        return self.inner.embed_texts(texts)
