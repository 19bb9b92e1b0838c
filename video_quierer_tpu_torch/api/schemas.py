"""Request validation and response shapes of the HTTP API (counterpart of
``video_quierer_tpu/api/schemas.py`` and of the cache helpers of
``video_quierer_tpu/api/app.py``), without pydantic.

Request fields take pydantic v2's lax coercion (``"5"`` and ``5.0`` are
the int 5, ``"true"`` and ``1`` are True; ``engine/config.py:lax_int``),
and a refused body answers 422 with pydantic's error list as ``detail``
(``type``, ``loc``, ``msg``, ``input``, ``ctx``), as the reference's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from video_quierer_tpu_torch.engine.config import LAX, ApiConfig, FieldError


class RequestError(Exception):
    """An error answer: ``{"detail": detail}`` with ``status``. ``cors``
    False for the answers the reference raises (``web.HTTPException``)
    rather than returns: those pass its CORS middleware without its
    headers."""

    def __init__(self, status: int, detail: Any, cors: bool = True):
        super().__init__(detail)
        self.status = status
        self.detail = detail
        self.cors = cors


# request schemas: (field, lax type, default (_REQUIRED: none), ge, le) in
# the order of the reference's pydantic models
_REQUIRED = object()
_SEARCH = (("query", "str", _REQUIRED, None, None),
           ("k", "int", 5, 1, 50),
           ("use_cache", "bool", True, None, None),
           ("dedup_videos", "bool", False, None, None),
           ("offset", "int", 0, 0, 63))
_BATCH_K = ("k", "int", 5, 1, 50)
_API_CONFIG = tuple((f.name, f.type, f.default, None, None)
                    for f in dataclasses.fields(ApiConfig))


def _error(type_: str, loc: list, msg: str, value, ctx=None) -> Dict:
    """One entry of pydantic's error list."""
    err = {"type": type_, "loc": loc, "msg": msg, "input": value}
    if ctx is not None:
        err["ctx"] = ctx
    return err


def _field(body: Dict, spec, errors: List[Dict]):
    """One field of a request body, coerced as pydantic's lax mode; a
    refusal is appended to ``errors`` (and gives None)."""
    name, typ, default, lo, hi = spec
    if name not in body:
        if default is _REQUIRED:
            errors.append(_error("missing", [name], "Field required", body))
        return default
    value = body[name]
    try:
        value = LAX[typ](value)
    except FieldError as e:
        errors.append(_error(e.type, [name], e.msg, value))
        return None
    if lo is not None and value < lo:
        errors.append(_error(
            "greater_than_equal", [name],
            f"Input should be greater than or equal to {lo}", value,
            {"ge": lo}))
    elif hi is not None and value > hi:
        errors.append(_error(
            "less_than_equal", [name],
            f"Input should be less than or equal to {hi}", value,
            {"le": hi}))
    return value


def _queries(body: Dict, errors: List[Dict]) -> Optional[List[str]]:
    """``queries``: a non-empty list of str (``List[str]``,
    ``min_length=1``)."""
    if "queries" not in body:
        errors.append(_error("missing", ["queries"], "Field required", body))
        return None
    value = body["queries"]
    if not isinstance(value, list):
        errors.append(_error("list_type", ["queries"],
                             "Input should be a valid list", value))
        return None
    before = len(errors)
    for i, q in enumerate(value):
        if not isinstance(q, str):
            errors.append(_error("string_type", ["queries", i],
                                 "Input should be a valid string", q))
    if len(errors) == before and not value:
        errors.append(_error(
            "too_short", ["queries"], "List should have at least 1 item "
            "after validation, not 0", value,
            {"field_type": "List", "min_length": 1, "actual_length": 0}))
    return value


def _model(body, specs) -> Tuple:
    """The fields ``specs`` of a model's body; 422 (raised, as pydantic's)
    with the whole error list. A body that is not an object fails as
    ``Model(**body)`` does: a ``TypeError``, answered 500."""
    if not isinstance(body, dict):
        raise TypeError("argument after ** must be a mapping")
    errors: List[Dict] = []
    values = tuple(_field(body, spec, errors) for spec in specs)
    if errors:
        raise RequestError(422, errors, cors=False)
    return values


def search_request(body) -> Tuple[str, int, bool, bool, int]:
    """``SearchRequest``'s fields."""
    return _model(body, _SEARCH)


def batch_request(body) -> Tuple[List[str], int]:
    """``BatchSearchRequest``'s fields."""
    if not isinstance(body, dict):
        raise TypeError("argument after ** must be a mapping")
    errors: List[Dict] = []
    queries = _queries(body, errors)
    k = _field(body, _BATCH_K, errors)
    if errors:
        raise RequestError(422, errors, cors=False)
    return queries, k


def api_config_request(body) -> ApiConfig:
    """An ``ApiConfig`` body (unknown keys ignored, as pydantic does)."""
    return ApiConfig(*_model(body, _API_CONFIG))


def parse_k(body: Dict, default: int = 5) -> int:
    """``k`` as Python's ``int()`` reads it (``"5"``, ``5.7`` and ``true``
    are 5, 5 and 1), in [1, 50]; 422 otherwise (raised, as the
    reference's ``_parse_k``)."""
    try:
        k = int(body.get("k", default))
    except (TypeError, ValueError):
        raise RequestError(422, "k must be an integer", cors=False) \
            from None
    if not 1 <= k <= 50:
        raise RequestError(422, "k must be in [1, 50]", cors=False)
    return k


def cache_stats(engine) -> Dict:
    """``CacheStats`` of the engine's cache file and index (a copy of
    ``video_quierer_tpu/api/app.py:_cache_stats``)."""
    path = engine.cache_path
    exists = path.exists()
    size_mb = path.stat().st_size / (1024 * 1024) if exists else 0.0
    last = time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(path.stat().st_mtime)) \
        if exists else "Never"
    return {
        "embeddings_count": len(engine.index),
        "videos_count": len(engine.index.video_names()),
        "cache_size_mb": round(size_mb, 2),
        "last_updated": last,
        "cache_file_exists": exists,
        "video_hashes_count": len(engine.index.video_hashes),
    }


def cache_health(engine) -> Dict:
    """``CacheHealthResult``: the reference's five checks (a copy of
    ``video_quierer_tpu/api/app.py:_cache_health``)."""
    issues, recs = [], []
    passed = 0
    if engine.cache_path.exists():
        passed += 1
    else:
        issues.append("Cache file does not exist")
        recs.append("Run rebuild cache to create cache file")
    passed += 1                 # an engine is present
    if len(engine.index) > 0:
        passed += 1
    else:
        issues.append("No embeddings found")
        recs.append("Process some videos to generate embeddings")
    # a columnar store cannot desynchronise embeddings and metadata
    passed += 1
    names = engine.index.video_names()
    missing = [n for n in names if not (engine.videos_dir / n).exists()]
    if not missing:
        passed += 1
    else:
        issues.append("Some indexed videos are missing from disk")
        recs.append("Remove missing videos from index or restore files")
    return {"success": not issues, "issues": issues,
            "recommendations": recs, "total_checks": 5,
            "passed_checks": passed}


def cache_response(success: bool, stats: Optional[Dict] = None,
                   message: Optional[str] = None) -> Dict:
    """``CacheResponse.model_dump()``."""
    return {"success": success, "stats": stats, "message": message}
