"""Request coalescing: concurrent searches merge into one device pass
(counterpart of ``video_quierer_tpu/engine/batching.py``).

A worker thread blocks on a queue; on wake it drains up to ``max_batch``
requests for up to ``max_wait_ms``, groups them by ``k`` and answers each
group with one dispatch on the engine's serving route
(``engine._dispatch_batch``: the IVF tier's batch search while that tier is
live, else the fused text encode + scan of the mirror; the route is chosen
before the dispatch, never after a failure). The flush is PIPELINED (depth
``VQT_COALESCE_PIPELINE``, default 2): the worker tokenizes and dispatches
batch N+1 while a resolver thread copies batch N's results to the host
and builds its rows. The two phases hand the engine's shared read lock
across threads (the dispatcher acquires it, the resolver releases it), so
no index mutation moves rows under in-flight candidate indices. Only FULL
batches dispatch ahead: a partial batch whose window expired waits until
nothing is in flight (eager partial flushes fragment the load).

Failures are not retried on another path: a dispatch or resolve error is
set on every waiting request's future and the worker carries on.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Tuple

from video_quierer_tpu_torch.utils import stageprof

logger = logging.getLogger(__name__)


class SearchCoalescer:
    def __init__(self, engine, max_batch: int = 64,
                 max_wait_ms: float = 2.0,
                 pipeline_depth: int | None = None):
        self._engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        if pipeline_depth is None:
            pipeline_depth = int(os.environ.get("VQT_COALESCE_PIPELINE",
                                                "2"))
        # 0 = resolve each flush on the worker before the next dispatch
        self.pipeline_depth = max(0, pipeline_depth)
        self._queue: "queue.Queue[Tuple[str, int, Future]]" = queue.Queue()
        self._closed = False
        self._resolve_q: "queue.Queue" = queue.Queue(
            maxsize=max(1, self.pipeline_depth))
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._flushes = 0       # numbers the flushes (their spans' unit)
        n_resolvers = int(os.environ.get("VQT_COALESCE_RESOLVERS", "0")) \
            or self.pipeline_depth
        self._resolvers = []
        if self.pipeline_depth:
            for i in range(max(1, n_resolvers)):
                t = threading.Thread(target=self._resolve_loop, daemon=True,
                                     name=f"search-coalescer-resolve-{i}")
                t.start()
                self._resolvers.append(t)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="search-coalescer")
        self._worker.start()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and the resolvers (pending work drains)."""
        self._closed = True
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout)
        for t in self._resolvers:
            t.join(timeout)

    # ------------------------------------------------------------------

    def search_ex(self, query: str, k: int = 5, use_cache: bool = True
                  ) -> Tuple[List[Dict], bool]:
        """Blocking search through the coalescing path; returns
        ``(results, from_cache)``."""
        engine = self._engine
        cache_on = use_cache and engine.config.api.cache_search
        if cache_on:
            hit = engine.query_cache.get_text(query, k)
            if hit is not None:
                engine.metrics.inc("search_cache_hits")
                engine.metrics.inc("searches")
                return [dict(r) for r in hit], True
        fut: Future = Future()
        self._queue.put((query, k, fut))
        results = fut.result()
        if cache_on:
            engine.query_cache.put_text(query, k,
                                        [dict(r) for r in results])
        return results, False

    # ------------------------------------------------------------------

    def _run(self) -> None:
        while not self._closed:
            try:
                first = self._queue.get(timeout=1.0)
            except queue.Empty:
                continue
            if first is None:
                break
            batch = [first]
            while len(batch) < self.max_batch and not self._closed:
                try:
                    item = self._queue.get(timeout=self.max_wait)
                except queue.Empty:
                    with self._inflight_lock:
                        inflight = self._inflight
                    if inflight == 0:
                        break
                    continue
                if item is None:
                    self._closed = True
                    break
                batch.append(item)
            self._process(batch)
        for _ in self._resolvers:   # let each resolver drain, then exit
            self._resolve_q.put(None)

    def _process(self, batch) -> None:
        engine = self._engine
        engine.metrics.observe("coalesced_batch_size", len(batch))
        by_k: Dict[int, List] = {}
        for query, k, fut in batch:
            by_k.setdefault(k, []).append((query, fut))
        for k, items in by_k.items():
            queries = [q for q, _ in items]
            engine.metrics.inc("searches", len(queries))
            flush, self._flushes = self._flushes, self._flushes + 1
            t0 = time.perf_counter()
            with stageprof.unit(flush):
                with stageprof.span("lock_wait"):
                    engine.lock.acquire_read()
                try:
                    resolve = engine._dispatch_batch(queries, k)
                except Exception as e:  # boundary: fail the waiters, serve on
                    engine.lock.release_read()
                    logger.exception("coalesced dispatch failed")
                    for _, fut in items:
                        fut.set_exception(e)
                    continue
                with self._inflight_lock:
                    self._inflight += 1
                if not self.pipeline_depth:
                    self._finish(items, resolve, t0, flush)
                    continue
                # hand (items, read lock) to a resolver; blocks when
                # pipeline_depth flushes are already in flight
                engine.metrics.inc("pipelined_flushes")
                self._resolve_q.put((items, resolve, t0, flush))

    def _resolve_loop(self) -> None:
        while True:
            item = self._resolve_q.get()
            if item is None:
                break
            self._finish(*item)

    def _finish(self, items, resolve, t0: float, flush: int) -> None:
        """Resolve one flush, answer its futures, release its read lock."""
        engine = self._engine
        try:
            with stageprof.unit(flush):
                with stageprof.span("resolve"):
                    batches = resolve()
                with stageprof.span("format"):
                    results = [engine._format(r) for r in batches]
                with stageprof.span("deliver"):
                    for (_, fut), res in zip(items, results):
                        fut.set_result(res)
        except Exception as e:  # boundary: fail the waiters, keep serving
            logger.exception("coalesced resolve failed")
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            engine.lock.release_read()
            with self._inflight_lock:
                self._inflight -= 1
            engine.metrics.observe("flush_latency_ms",
                                   (time.perf_counter() - t0) * 1000.0)
