"""OpenAPI description of the HTTP surface (a copy of
``video_quierer_tpu/api/openapi.py``), served at ``/api/openapi.json``,
with a self-contained HTML browser at ``/api/docs`` (no CDN).

The JAX module builds its request schemas from pydantic models; the port
has no pydantic, so it carries their JSON schemas as data (``SCHEMAS``,
held equal to the JAX package's spec by the tests). The API's title and
description name the port, and the profiler's summary ``torch.profiler``.
"""

from __future__ import annotations

import copy
from typing import Dict

_INT_1_50 = {"default": 5, "maximum": 50, "minimum": 1, "title": "K",
             "type": "integer"}

# the request bodies' JSON schemas, as pydantic v2 writes them for the
# JAX package's SearchRequest, BatchSearchRequest and ApiConfig
SCHEMAS: Dict[str, Dict] = {
    "SearchRequest": {
        "properties": {
            "query": {
                "description": "Search query (text, or a "
                               "data:image/...;base64 URI for image search)",
                "title": "Query", "type": "string"},
            "k": _INT_1_50,
            "use_cache": {"default": True, "title": "Use Cache",
                          "type": "boolean"},
            "dedup_videos": {"default": False, "title": "Dedup Videos",
                             "type": "boolean"},
            "offset": {"default": 0, "maximum": 63, "minimum": 0,
                       "title": "Offset", "type": "integer"},
        },
        "required": ["query"],
        "title": "SearchRequest",
        "type": "object",
    },
    "BatchSearchRequest": {
        "properties": {
            "queries": {"items": {"type": "string"}, "minItems": 1,
                        "title": "Queries", "type": "array"},
            "k": _INT_1_50,
        },
        "required": ["queries"],
        "title": "BatchSearchRequest",
        "type": "object",
    },
    "ApiConfig": {
        "description": "config.json schema \u2014 reference parity "
                       "(routes.py:100-109).",
        "properties": {
            "sampling_mode": {"default": "high", "title": "Sampling Mode",
                              "type": "string"},
            "max_frames": {"default": 300, "title": "Max Frames",
                           "type": "integer"},
            "use_clip": {"default": True, "title": "Use Clip",
                         "type": "boolean"},
            "enhanced_mode": {"default": True, "title": "Enhanced Mode",
                              "type": "boolean"},
            "default_results": {"default": 10, "title": "Default Results",
                                "type": "integer"},
            "cache_search": {"default": True, "title": "Cache Search",
                             "type": "boolean"},
            "search_timeout": {"default": 30, "title": "Search Timeout",
                               "type": "integer"},
            "auto_save": {"default": True, "title": "Auto Save",
                          "type": "boolean"},
            "log_level": {"default": "INFO", "title": "Log Level",
                          "type": "string"},
        },
        "title": "ApiConfig",
        "type": "object",
    },
}

# (method, path, tag, summary, request schema name | None)
_ENDPOINTS = [
    ("get", "/api", "system", "API information", None),
    ("get", "/api/health", "system", "Component health", None),
    ("get", "/health", "system", "Liveness", None),
    ("get", "/api/stats", "system", "System statistics", None),
    ("get", "/metrics", "system", "Prometheus metrics", None),
    ("get", "/api/metrics", "system", "Metrics snapshot (JSON)", None),
    ("post", "/api/profiler/start", "system", "Start a torch.profiler trace",
     None),
    ("post", "/api/profiler/stop", "system", "Stop the profiler trace",
     None),
    ("post", "/api/search", "search",
     "Semantic search (text or data-URI image)", "SearchRequest"),
    ("post", "/api/search/batch", "search",
     "Batched search — one device pass", "BatchSearchRequest"),
    ("post", "/api/search/vector", "search",
     "Raw 512-d vector query", None),
    ("post", "/api/search/videos", "search",
     "Video-level search (mean-frame ranking)", None),
    ("post", "/api/search/image", "search",
     "Image search by multipart upload", None),
    ("post", "/api/search/similar", "search",
     "Similar moments to an indexed frame (seed excluded)", None),
    ("post", "/search", "search", "Legacy search", None),
    ("post", "/api/videos/upload", "videos",
     "Upload and index a video (multipart; ?upload_id= enables progress "
     "tracking)", None),
    ("get", "/api/videos/upload/progress/{upload_id}", "videos",
     "Upload progress snapshot", None),
    ("get", "/api/videos/upload/progress/{upload_id}/stream", "videos",
     "Upload progress stream (SSE)", None),
    ("post", "/api/videos/download-youtube", "videos",
     "Download and index from YouTube", None),
    ("get", "/api/videos", "videos", "List indexed videos", None),
    ("get", "/videos", "videos", "Legacy video list", None),
    ("get", "/api/videos/{video_id}", "videos", "Video info", None),
    ("delete", "/api/videos/{video_id}", "videos", "Delete a video", None),
    ("get", "/videos/{filename}", "videos",
     "Serve a video file (range requests)", None),
    ("get", "/api/video/{video_id}/frame", "videos",
     "Frame preview at ?timestamp= (base64 JPEG)", None),
    ("post", "/api/index/save", "index", "Save index to ?filepath=", None),
    ("post", "/api/index/load", "index", "Load index from ?filepath=",
     None),
    ("get", "/api/config", "configuration", "Get configuration", None),
    ("post", "/api/config", "configuration", "Update configuration",
     "ApiConfig"),
    ("post", "/api/config/reset", "configuration",
     "Reset configuration to defaults", None),
    ("get", "/api/cache/stats", "cache", "Cache statistics", None),
    ("post", "/api/cache/rebuild", "cache",
     "Reprocess all videos with the current config", None),
    ("post", "/api/cache/clear", "cache", "Clear the index", None),
    ("get", "/api/cache/health", "cache", "Five-check cache health", None),
    ("get", "/api/cache/export", "cache",
     "Download the cache pickle", None),
    ("post", "/api/cache/import", "cache",
     "Import a cache pickle (multipart)", None),
    ("post", "/api/cache/warm", "cache",
     "Pre-warm the query cache", None),
    ("get", "/", "system", "Web UI", None),
]


def openapi_spec(version: str) -> Dict:
    paths: Dict[str, Dict] = {}
    schemas: Dict[str, Dict] = {}
    for method, path, tag, summary, model in _ENDPOINTS:
        op = {"tags": [tag], "summary": summary,
              "responses": {"200": {"description": "OK"}}}
        if model is not None:
            name = model
            schemas[name] = copy.deepcopy(SCHEMAS[name])
            op["requestBody"] = {
                "content": {"application/json": {"schema": {
                    "$ref": f"#/components/schemas/{name}"}}}}
        paths.setdefault(path, {})[method] = op
    return {
        "openapi": "3.1.0",
        "info": {
            "title": "Video Search API (PyTorch/CUDA port)",
            "version": version,
            "description": "Semantic video search on PyTorch/CUDA — "
                           "reference-parity endpoint surface.",
        },
        "paths": paths,
        "components": {"schemas": schemas},
    }


def docs_html(version: str) -> str:
    rows = []
    last_tag = None
    for method, path, tag, summary, model in sorted(
            _ENDPOINTS, key=lambda e: (e[2], e[1])):
        if tag != last_tag:
            rows.append(f"<tr><th colspan=3>{tag}</th></tr>")
            last_tag = tag
        body = f" <code>{model}</code>" if model else ""
        rows.append(
            f"<tr><td class=m>{method.upper()}</td>"
            f"<td><code>{path}</code>{body}</td><td>{summary}</td></tr>")
    table = "\n".join(rows)
    return f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>API docs · Video Search</title><style>
body{{font:15px/1.5 system-ui;background:#0f1117;color:#e7e9ee;
     max-width:900px;margin:40px auto;padding:0 16px}}
table{{width:100%;border-collapse:collapse}}
td,th{{padding:7px 10px;border-bottom:1px solid #2a2f3e;text-align:left}}
th{{color:#8a91a3;text-transform:uppercase;font-size:12px;
    padding-top:22px}}
code{{color:#5b8cff}} .m{{font-weight:600;width:70px}}
a{{color:#39d98a}}</style></head><body>
<h1>Video Search API <small>v{version}</small></h1>
<p>Machine-readable spec: <a href="/api/openapi.json">openapi.json</a></p>
<table>{table}</table></body></html>"""
