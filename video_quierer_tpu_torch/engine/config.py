"""Two-tier configuration (counterpart of
``video_quierer_tpu/engine/config.py``).

Tier 1 — :class:`ApiConfig`: the reference's flat ``config.json`` — the
same nine keys and defaults — as a dataclass whose fields take pydantic
v2's lax coercion, written by hand (:func:`lax_int`, :func:`lax_bool`,
:func:`lax_str`: the port does not depend on pydantic); the HTTP server
validates its request bodies with the same functions. Tier 2 —
:class:`EngineConfig`: the engine's typed knobs with the same ``VQT_*``
environment overrides. Semantics match the JAX package, the IVF tier's
fields included (``index.kind = "ivf"``, ``ivf_nlist``, ``ivf_nprobe``,
``ivf_min_rows``: the engine serves through ``index/ivf.py``) and the
corpus mesh's (``index.corpus_shards``, ``index.corpus_slices``,
``VQT_CORPUS_SHARDS``/``VQT_CORPUS_SLICES``: the engine shards its index,
``parallel/mesh.py``) and the model family's (``model.family`` "clip",
"siglip" or "aimv2" — the port's own, with no JAX counterpart —,
``VQT_MODEL_FAMILY``: the engine builds that family's towers)
and the HF checkpoint's (``model.checkpoint_dir``,
``VQT_CLIP_CHECKPOINT``: the towers load it, ``models/clip/convert.py``)
and the fine-tuned checkpoint's (``model.orbax_checkpoint``: a checkpoint
of the port's trainer, ``train/checkpoint.py``; an orbax directory of the
JAX package is refused) and the pipelined image tower's
(``model.parallel = "pp"``, ``model.pipeline_microbatches``,
``VQT_MODEL_PARALLEL``/``VQT_PIPELINE_MICROBATCHES``: the CLIP embedder
pipelines its vision blocks, ``parallel/pipeline.py``), so one
``config.json``/``engine.yaml`` serves both packages.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

SAMPLING_MODES = ("ultra_high", "high", "medium", "low")
SAMPLING_STRATEGIES = ("interval", "uniform", "adaptive", "hybrid", "auto")


class FieldError(ValueError):
    """A value pydantic v2 refuses in lax mode; ``type`` and ``msg`` are
    pydantic's error type and message."""

    def __init__(self, type_: str, msg: str):
        super().__init__(msg)
        self.type = type_
        self.msg = msg


# a decimal integer string as pydantic reads it: sign, digits with single
# underscores between them, and an optional fraction of zeros
_INT_STR = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")
_TRUE = frozenset(("1", "true", "yes", "on", "t", "y"))
_FALSE = frozenset(("0", "false", "no", "off", "f", "n"))
_I64 = 2 ** 63


def lax_int(value) -> int:
    """pydantic v2's lax ``int``: an int (a bool as 0/1), an integral
    finite float within int64, or a decimal string (surrounding whitespace
    ignored)."""
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    if isinstance(value, float):
        if not math.isfinite(value):
            raise FieldError("finite_number",
                             "Input should be a finite number")
        if not value.is_integer():
            raise FieldError("int_from_float", "Input should be a valid "
                             "integer, got a number with a fractional part")
        if abs(value) >= _I64:
            raise FieldError("int_parsing_size", "Unable to parse input "
                             "string as an integer, exceeded maximum size")
        return int(value)
    if isinstance(value, str):
        text = value.strip()
        if _INT_STR.fullmatch(text):
            return int(text.split(".")[0].replace("_", ""))
        raise FieldError("int_parsing", "Input should be a valid integer, "
                         "unable to parse string as an integer")
    raise FieldError("int_type", "Input should be a valid integer")


def lax_bool(value) -> bool:
    """pydantic v2's lax ``bool``: a bool, 0/1 (int or float), or one of
    true/false/1/0/yes/no/on/off/t/f/y/n in any case."""
    if isinstance(value, bool):
        return value
    if isinstance(value, float) and value.is_integer():
        value = int(value)
    if isinstance(value, int):
        if value in (0, 1):
            return bool(value)
        if abs(value) < _I64:
            raise FieldError("bool_parsing", "Input should be a valid "
                             "boolean, unable to interpret input")
    elif isinstance(value, str):
        low = value.lower()
        if low in _TRUE or low in _FALSE:
            return low in _TRUE
        raise FieldError("bool_parsing", "Input should be a valid boolean, "
                         "unable to interpret input")
    raise FieldError("bool_type", "Input should be a valid boolean")


def lax_str(value) -> str:
    """pydantic v2's lax ``str``: a str only."""
    if isinstance(value, str):
        return value
    raise FieldError("string_type", "Input should be a valid string")


LAX = {"int": lax_int, "bool": lax_bool, "str": lax_str}


@dataclasses.dataclass
class ApiConfig:
    """config.json schema — reference parity (same nine keys)."""

    sampling_mode: str = "high"
    max_frames: int = 300
    use_clip: bool = True
    enhanced_mode: bool = True
    default_results: int = 10
    cache_search: bool = True
    search_timeout: int = 30
    auto_save: bool = True
    log_level: str = "INFO"

    def __post_init__(self):
        # pydantic's lax coercion of each field, with its errors
        for f in dataclasses.fields(self):
            try:
                setattr(self, f.name, LAX[f.type](getattr(self, f.name)))
            except FieldError as e:
                raise FieldError(e.type, f"{f.name}: {e.msg}") from None

    @classmethod
    def from_dict(cls, data: dict) -> "ApiConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def to_dict(self) -> dict:
        """The nine keys in pydantic's ``model_dump`` order."""
        return dataclasses.asdict(self)

    model_dump = to_dict


def load_api_config(path: Path = Path("config.json")) -> ApiConfig:
    """Load (or default) the flat API config; a malformed file falls back
    to the defaults, as the reference's forgiving loader."""
    path = Path(path)
    if not path.exists():
        return ApiConfig()
    try:
        return ApiConfig.from_dict(json.loads(path.read_text()))
    except (OSError, ValueError, TypeError) as e:
        logger.error("Failed to load config %s: %s", path, e)
        return ApiConfig()


def save_api_config(config: ApiConfig,
                    path: Path = Path("config.json")) -> bool:
    """Write the flat API config as ``config.json`` (indent 2, as the
    reference's); False, logged, when the write fails."""
    try:
        Path(path).write_text(json.dumps(config.to_dict(), indent=2))
    except OSError as e:
        logger.error("Failed to save config %s: %s", path, e)
        return False
    return True


@dataclasses.dataclass
class IngestConfig:
    batch_size: int = 256
    num_decode_workers: int = 4
    num_decode_procs: int = 0
    prefetch_videos: int = 8
    target_size: int = 224
    sampling_strategy: str = "interval"
    quality_filter: bool = False
    stream_mirror: bool = True


@dataclasses.dataclass
class IndexConfig:
    embed_dim: int = 512
    initial_capacity: int = 0
    corpus_shards: int = 0
    corpus_slices: int = 1
    # "bfloat16", "int8", "int4": candidate mirror + exact f32 re-rank;
    # "float32": the exact scan (VQT_INDEX_DTYPE overrides)
    device_dtype: str = "bfloat16"
    kind: str = "exact"
    ivf_nlist: int = 0
    ivf_nprobe: int = 8
    ivf_min_rows: int = 4096
    # "auto" = re-rank on the device while store + mirror fit
    # VQT_DEVICE_RERANK_BUDGET_GB (default 12); "on"/"off" force it
    device_rerank: str = "auto"
    rerank_store_dtype: str = "float32"


@dataclasses.dataclass
class CacheConfig:
    query_cache_size: int = 512
    query_cache_ttl_s: float = 300.0
    similarity_threshold: float = 0.95
    frame_memo_size: int = 0


@dataclasses.dataclass
class ModelConfig:
    family: str = "clip"
    name: str = "openai/clip-vit-base-patch32"
    checkpoint_dir: Optional[str] = None
    orbax_checkpoint: Optional[str] = None
    # tower compute/param dtype: "bfloat16" (default) or "float32"
    dtype: str = "bfloat16"
    parallel: str = "none"
    pipeline_microbatches: int = 4


@dataclasses.dataclass
class EngineConfig:
    videos_dir: str = "videos"
    # max queries the serving coalescer merges into one device pass
    coalesce_width: int = 64
    thumbnail_base_url: Optional[str] = None
    invalidate_on_config_change: bool = False
    api: ApiConfig = dataclasses.field(default_factory=ApiConfig)
    ingest: IngestConfig = dataclasses.field(default_factory=IngestConfig)
    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)

    def validate(self) -> None:
        if self.api.sampling_mode not in SAMPLING_MODES:
            raise ValueError(
                f"sampling_mode must be one of {SAMPLING_MODES}")
        if self.api.max_frames <= 0:
            raise ValueError("max_frames must be positive")
        if self.ingest.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.ingest.sampling_strategy not in SAMPLING_STRATEGIES:
            raise ValueError(
                f"sampling_strategy must be one of {SAMPLING_STRATEGIES}")
        if self.index.kind not in ("exact", "ivf"):
            raise ValueError("index.kind must be 'exact' or 'ivf'")
        if self.index.device_dtype not in ("float32", "bfloat16",
                                           "int8", "int4"):
            raise ValueError(
                "index.device_dtype must be one of float32/bfloat16/"
                "int8/int4")
        if self.index.device_dtype == "int4" \
                and self.index.corpus_shards > 1:
            raise ValueError(
                "index.device_dtype='int4' is the single-device tier — "
                "corpus sharding requires 'int8' or 'bfloat16'")
        if self.index.device_rerank not in ("auto", "on", "off"):
            raise ValueError(
                "index.device_rerank must be 'auto', 'on' or 'off'")
        if self.index.rerank_store_dtype not in ("float32", "bfloat16"):
            raise ValueError("index.rerank_store_dtype must be "
                             "'float32' or 'bfloat16'")
        if self.index.ivf_nprobe <= 0:
            raise ValueError("ivf_nprobe must be positive")
        if self.model.dtype not in ("float32", "bfloat16"):
            raise ValueError("model.dtype must be 'float32' or 'bfloat16'")
        if self.model.parallel not in ("none", "pp"):
            raise ValueError("model.parallel must be 'none' or 'pp'")
        if self.model.parallel == "pp" and self.model.family != "clip":
            raise ValueError(
                "model.parallel='pp' is implemented for the clip family")
        if self.model.pipeline_microbatches <= 0:
            raise ValueError("pipeline_microbatches must be positive")
        if self.coalesce_width <= 0:
            raise ValueError("coalesce_width must be positive")


def _flag(v: str) -> bool:
    return v not in ("0", "false", "")


_ENV_OVERRIDES = {
    "VQT_VIDEOS_DIR": ("videos_dir", str),
    "VQT_COALESCE_WIDTH": ("coalesce_width", int),
    "VQT_THUMBNAIL_BASE_URL": ("thumbnail_base_url", str),
    "VQT_BATCH_SIZE": ("ingest.batch_size", int),
    "VQT_DECODE_WORKERS": ("ingest.num_decode_workers", int),
    "VQT_DECODE_PROCS": ("ingest.num_decode_procs", int),
    "VQT_SAMPLING_STRATEGY": ("ingest.sampling_strategy", str),
    "VQT_QUALITY_FILTER": ("ingest.quality_filter", _flag),
    "VQT_STREAM_MIRROR": ("ingest.stream_mirror", _flag),
    "VQT_CLIP_CHECKPOINT": ("model.checkpoint_dir", str),
    "VQT_MODEL_NAME": ("model.name", str),
    "VQT_DTYPE": ("model.dtype", str),
    "VQT_CORPUS_SHARDS": ("index.corpus_shards", int),
    "VQT_CORPUS_SLICES": ("index.corpus_slices", int),
    "VQT_INDEX_DTYPE": ("index.device_dtype", str),
    "VQT_DEVICE_RERANK": ("index.device_rerank", str),
    "VQT_RERANK_STORE_DTYPE": ("index.rerank_store_dtype", str),
    "VQT_INDEX_KIND": ("index.kind", str),
    "VQT_IVF_NLIST": ("index.ivf_nlist", int),
    "VQT_IVF_NPROBE": ("index.ivf_nprobe", int),
    "VQT_IVF_MIN_ROWS": ("index.ivf_min_rows", int),
    "VQT_MODEL_FAMILY": ("model.family", str),
    "VQT_MODEL_PARALLEL": ("model.parallel", str),
    "VQT_PIPELINE_MICROBATCHES": ("model.pipeline_microbatches", int),
}


def apply_env_overrides(cfg: EngineConfig) -> EngineConfig:
    """``VQT_*`` environment variables override engine fields."""
    for env, (dotted, typ) in _ENV_OVERRIDES.items():
        raw = os.environ.get(env)
        if raw is None:
            continue
        obj = cfg
        *parents, leaf = dotted.split(".")
        for p in parents:
            obj = getattr(obj, p)
        try:
            setattr(obj, leaf, typ(raw))
        except ValueError:
            logger.error("Ignoring invalid %s=%r", env, raw)
    return cfg


def _apply_nested(cfg: EngineConfig, data: dict) -> None:
    for key, value in data.items():
        if not hasattr(cfg, key):
            logger.warning("unknown engine config key %r — ignored", key)
            continue
        current = getattr(cfg, key)
        if key == "api" and isinstance(value, dict):
            cfg.api = ApiConfig.from_dict({**cfg.api.to_dict(), **value})
        elif dataclasses.is_dataclass(current) and isinstance(value, dict):
            for sub, sval in value.items():
                if hasattr(current, sub):
                    setattr(current, sub, sval)
                else:
                    logger.warning("unknown engine config key %s.%s — "
                                   "ignored", key, sub)
        else:
            setattr(cfg, key, value)


def load_engine_config(config_json: Path = Path("config.json"),
                       config_yaml: Optional[Path] = None) -> EngineConfig:
    """Engine config = flat config.json (API tier) + optional nested
    ``engine.yaml`` + ``VQT_*`` env overrides, validated. The YAML file
    needs PyYAML; where it is missing the file is reported and skipped."""
    cfg = EngineConfig(api=load_api_config(config_json))
    if config_yaml is None:
        config_yaml = Path(config_json).with_name("engine.yaml")
    if Path(config_yaml).exists():
        try:
            import yaml
        except ImportError:
            logger.error("%s found but PyYAML is not installed — ignored",
                         config_yaml)
        else:
            with open(config_yaml) as f:
                _apply_nested(cfg, yaml.safe_load(f) or {})
            logger.info("engine config loaded from %s", config_yaml)
    apply_env_overrides(cfg)
    cfg.validate()
    return cfg
