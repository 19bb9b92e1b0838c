"""Query-result caching: LRU + TTL tier and a semantic query cache.

Copy of ``video_quierer_tpu/engine/cache.py`` for the PyTorch
port, which cannot import the JAX package (its ``__init__`` imports
jax); keep the two in step.

Rebuilds the dead-path cache stack (src/storage/cache.py /
simple_cache.py, SURVEY.md §2.2 D2/D3) and — unlike the reference, whose
live path plumbed ``use_cache`` flags with no cache behind them
(routes.py:611, SURVEY.md §3.3) — wires it into the live search path:

- :class:`LRUCache` — thread-safe LRU with TTL checked on read.
- :class:`QueryResultCache` — keys text queries by md5 and vector queries
  by md5 of their bytes, both suffixed with ``k``; a *semantic reuse* pass
  returns the cached result of a previously-seen vector query whose cosine
  similarity exceeds ``similarity_threshold`` (0.95, matching the dead
  path's behavior); any ingest/delete invalidates everything.

No Redis tier: TPU serving here is a single process (SURVEY.md §2.3 — the
reference's Redis L2 was dead anyway); persistence is the index cache file.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class LRUCache:
    def __init__(self, max_size: int = 1000,
                 ttl_seconds: Optional[float] = None):
        self.max_size = max_size
        self.ttl = ttl_seconds
        self._lock = threading.RLock()
        self._data: "OrderedDict[str, Tuple[float, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            item = self._data.get(key)
            if item is None:
                self.misses += 1
                return None
            ts, value = item
            if self.ttl is not None and time.time() - ts > self.ttl:
                del self._data[key]
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = (time.time(), value)
            self._data.move_to_end(key)
            while len(self._data) > self.max_size:
                self._data.popitem(last=False)

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._data.pop(key, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "size": len(self._data),
                "max_size": self.max_size,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
            }


class QueryResultCache:
    """Search-result cache with exact and semantic (cosine ≥ τ) reuse."""

    def __init__(self, max_size: int = 512,
                 ttl_seconds: Optional[float] = 300.0,
                 similarity_threshold: float = 0.95):
        self._cache = LRUCache(max_size, ttl_seconds)
        self.similarity_threshold = similarity_threshold
        self._lock = threading.RLock()
        # recent (normalized vector, key) pairs for semantic reuse
        self._recent_vectors: List[Tuple[np.ndarray, str]] = []
        self._max_recent = 64

    @staticmethod
    def text_key(query: str, k: int) -> str:
        digest = hashlib.md5(query.encode("utf-8")).hexdigest()
        return f"text_query:{digest}:{k}"

    @staticmethod
    def vector_key(vec: np.ndarray, k: int) -> str:
        digest = hashlib.md5(np.ascontiguousarray(
            vec, np.float32).tobytes()).hexdigest()
        return f"vector_query:{digest}:{k}"

    def get_text(self, query: str, k: int):
        return self._cache.get(self.text_key(query, k))

    def put_text(self, query: str, k: int, results) -> None:
        self._cache.put(self.text_key(query, k), results)

    def get_vector(self, vec: np.ndarray, k: int):
        exact = self._cache.get(self.vector_key(vec, k))
        if exact is not None:
            return exact
        # semantic reuse: a close-enough earlier vector query
        v = np.asarray(vec, np.float32)
        v = v / (np.linalg.norm(v) + 1e-10)
        with self._lock:
            candidates = list(self._recent_vectors)
        for cand, key in candidates:
            if key.endswith(f":{k}") and float(cand @ v) >= \
                    self.similarity_threshold:
                hit = self._cache.get(key)
                if hit is not None:
                    return hit
        return None

    def put_vector(self, vec: np.ndarray, k: int, results) -> None:
        key = self.vector_key(vec, k)
        self._cache.put(key, results)
        v = np.asarray(vec, np.float32)
        v = v / (np.linalg.norm(v) + 1e-10)
        with self._lock:
            self._recent_vectors.append((v, key))
            if len(self._recent_vectors) > self._max_recent:
                self._recent_vectors.pop(0)

    def invalidate_all(self) -> None:
        """Ingest/delete changed the corpus — drop everything (the dead
        path did the same, cache.py:480-488)."""
        self._cache.clear()
        with self._lock:
            self._recent_vectors.clear()

    def stats(self) -> Dict[str, float]:
        return self._cache.stats()
