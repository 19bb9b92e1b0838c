"""Closed-loop text search through the request coalescer.

``clients`` threads each send one query, wait for its answer and send
the next, through ``VideoSearchEngine.search_coalesced_ex`` (what
``/api/search`` calls), at ``k`` with the query cache off. The queries
come from a pool drawn by ``gen.query_pool``: a fixed multiset of lengths
(``1 + Geometric(p)`` words, capped), so every seed sends the same
sizes in another order; client ``c`` sends pool entries ``c, c +
clients, ...``.

``search_qps`` counts the searches answered inside the window; a search
sent before the close and answered after it is waited for and counts
towards the latencies, not the rate.

Correctness: a sample of the window's answered searches (drawn from the
seed, with the longest query in it) is compared with the reference: the
f32 text tower on the same words and the exact f32 top-k over the same
library. ``score_gap``: the widest gap between a returned score and the
reference's score of that row; ``rank_gap``: the widest shortfall of a
returned row's reference score below the reference's own score at that
rank. A missing row reads infinite.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench import gen, program
from portbench.reference import clip as ref_clip
from portbench.reference import search as ref_search
from portbench.reference import tokenizer as ref_tok
from portbench.trace import label

# the fused search's batch and sequence buckets warmed in set-up (the
# engine's TEXT_BUCKETS up to the coalescer's width, TEXT_SEQ_BUCKETS);
# word counts that land in each sequence bucket under the hash tokenizer
WARM_BATCHES = (1, 8, 32, 64)
WARM_WORDS = (4, 12, 28, 60)


def _queries(traffic: dict, seed: int):
    return gen.query_pool(seed, traffic["pool"], traffic["vocabulary"],
                          traffic["geometric_p"], traffic["max_words"])


def setup(ctx) -> None:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    emb = program.embedder(cfg, dev, ctx.seed)
    eng = program.engine(cfg, emb, dev)
    rows = ctx.size("rows", cfg["library"]["rows"])
    ctx.notes["fill_s"] = program.fill_library(eng, cfg, dev, ctx.seed,
                                               rows, rows)
    t0 = time.perf_counter()
    eng._warm_up()
    r = gen.rng(ctx.seed, "warm-up")
    width = min(eng.config.coalesce_width, WARM_BATCHES[-1])
    for b in WARM_BATCHES:
        if b > width:
            break
        for n_words in WARM_WORDS:
            qs = [" ".join(gen.words(r, n_words)) for _ in range(b)]
            with eng.lock.read():
                eng._dispatch_batch_fused(qs, tr["k"])()
    eng.search_coalesced_ex("warm up", k=tr["k"], use_cache=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.notes["warm_s"] = time.perf_counter() - t0
    ctx.state.update(engine=eng, embedder=emb, rows=rows,
                     queries=_queries(tr, ctx.seed))


def _wrap_text_path(emb, log: list, tracer):
    """While the tracer runs, log each flush's token counts (at the
    embedder's id preparation, on the host) and each text-tower pass's
    batch and sequence length; returns a function that unwraps."""
    prep_inner, enc_inner = emb.prepare_text_ids, emb.text_encode_fn

    def prepare(ids):
        out = prep_inner(ids)
        if tracer.active:
            log.append(("tokens", (np.argmax(ids, axis=1) + 1).tolist()))
        return out

    def encode(params, ids):
        if tracer.active:
            tracer.unit()
            log.append(("pass", tuple(ids.shape)))
        return enc_inner(params, ids)

    emb.prepare_text_ids, emb.text_encode_fn = prepare, encode

    def unwrap():
        del emb.prepare_text_ids
        emb.text_encode_fn = enc_inner
    return unwrap


def _label_flushes(eng):
    """Name the coalescer's dispatch and resolve phases on the host's
    timeline (traced runs); returns a function that unwraps."""
    inner = eng._dispatch_batch

    def dispatch(queries, k):
        with label("dispatch"):
            resolve = inner(queries, k)

        def labelled():
            with label("resolve"):
                return resolve()
        return labelled
    eng._dispatch_batch = dispatch

    def unwrap():
        del eng._dispatch_batch
    return unwrap


def text_passes(log: list) -> list:
    """``(batch, seq, token counts)`` of each logged text pass."""
    out, tokens = [], None
    for kind, val in log:
        if kind == "tokens":
            tokens = val
        elif tokens is not None:
            out.append((val[0], val[1], tokens))
            tokens = None
    return out


class _Log:
    """One client's searches, in numpy buffers: the pool entry, the send
    and answer times, and the answer's rows and scores (row -1 where
    none came). No Python object outlives the search it records, so the
    harness adds nothing to what the collector walks."""

    def __init__(self, k: int, cap: int = 1024):
        self.k, self.n = k, 0
        self.q = np.zeros(cap, np.int64)
        self.t = np.zeros((cap, 2))
        self.ok = np.zeros(cap, bool)
        self.ids = np.full((cap, k), -1, np.int64)
        self.scores = np.full((cap, k), np.nan)

    FILL = {"q": 0, "t": 0.0, "ok": False, "ids": -1, "scores": np.nan}

    def add(self, q: int, t0: float, t1: float, got) -> None:
        if self.n == self.q.shape[0]:
            for name, fill in self.FILL.items():
                old = getattr(self, name)
                new = np.full((2 * old.shape[0],) + old.shape[1:], fill,
                              old.dtype)
                new[:self.n] = old
                setattr(self, name, new)
        i = self.n
        self.q[i], self.t[i] = q, (t0, t1)
        if got is not None:
            m = min(self.k, len(got))
            self.ids[i, :m] = [r["frame_id"] for r in got[:m]]
            self.scores[i, :m] = [r["score"] for r in got[:m]]
            self.ok[i] = True
        self.n += 1

    def take(self, name: str) -> np.ndarray:
        return getattr(self, name)[:self.n]


def window(ctx, tracer) -> dict:
    tr = ctx.traffic
    eng, emb = ctx.state["engine"], ctx.state["embedder"]
    queries = ctx.state["queries"]
    clients, k, seconds = ctx.size("clients", tr["clients"]), tr["k"], \
        ctx.seconds
    logs = [_Log(k) for _ in range(clients)]
    errors = [0] * clients
    go = threading.Event()
    t_start = [0.0]

    def client(c: int) -> None:
        go.wait()
        deadline = t_start[0] + seconds
        j = c
        log = logs[c]
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline:
                return
            q = j % len(queries)
            try:
                got, _ = eng.search_coalesced_ex(queries[q], k=k,
                                                 use_cache=False)
            except Exception:
                errors[c] += 1
                got = None
            log.add(q, t0, time.perf_counter(), got)
            del got
            j += clients

    encode_log = []
    before_c, before_s = program.counters(eng), program.spans()
    workers = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in workers:
        t.start()
    unwrap = _wrap_text_path(emb, encode_log, tracer)
    unlabel = _label_flushes(eng) if tracer.enabled else (lambda: None)
    t_start[0] = time.perf_counter()
    ctx.mark_window_start(t_start[0])
    go.set()
    end = t_start[0] + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        tracer.tick(now - t_start[0])
        time.sleep(max(0.0, min(end - now,
                                t_start[0] + tracer.next_at() - now, 0.05)))
    tracer.stop()
    for t in workers:
        t.join()
    unwrap()
    unlabel()
    t_close = t_start[0] + seconds
    after_c, after_s = program.counters(eng), program.spans()
    q = np.concatenate([g.take("q") for g in logs])
    t = np.concatenate([g.take("t") for g in logs])
    ok = np.concatenate([g.take("ok") for g in logs])
    done = np.sort(t[ok & (t[:, 1] <= t_close), 1])
    ctx.state["answers"] = (q[ok],
                            np.concatenate([g.take("ids") for g in logs])[ok],
                            np.concatenate([g.take("scores")
                                            for g in logs])[ok])
    # the longest time in the window in which no search was answered
    ctx.notes["longest_stall_s"] = float(np.diff(
        np.concatenate([[t_start[0]], done, [t_close]])).max())
    return {
        "e2e": {"search_qps": done.shape[0] / seconds},
        "attempted": int(q.shape[0]),
        "failed": sum(errors),
        "counters": program.delta(after_c, before_c),
        "spans": program.delta(after_s, before_s),
        "host": {"latencies_ms": (1e3 * (t[ok, 1] - t[ok, 0])).tolist(),
                 "searches": int(q.shape[0])},
        "encode_log": encode_log,
    }


def release(ctx) -> None:
    eng = ctx.state.pop("engine")
    eng.close()
    ctx.state.pop("embedder")
    del eng


def _sample(ctx, pool_idx: np.ndarray) -> list:
    """Indices into the answered searches (their pool entries
    ``pool_idx``): ``check_searches`` drawn from the seed, with the
    longest query among the answered ones."""
    queries = ctx.state["queries"]
    n = min(ctx.size("check_searches", ctx.traffic["check_searches"]),
            pool_idx.shape[0])
    r = gen.rng(ctx.seed, "check-sample")
    pick = set(r.choice(pool_idx.shape[0], size=n, replace=False).tolist())
    sent = np.unique(pool_idx).tolist()
    longest = max(sent, key=lambda q: ref_tok.token_count(queries[q]))
    pick.add(int(np.flatnonzero(pool_idx == longest)[0]))
    return sorted(pick)


def _reference_queries(ctx, texts, prec: str) -> torch.Tensor:
    sd = gen.weights(ctx.cfg, ctx.device, program._DTYPES[ctx.cfg["dtype"]],
                     ctx.seed)
    ids = torch.from_numpy(ref_tok.tokenize(texts)).to(ctx.device)
    out = []
    with torch.no_grad():
        for lo in range(0, ids.shape[0], 64):
            out.append(ref_clip.encode_text(sd, ctx.cfg, ids[lo:lo + 64],
                                            prec))
    return torch.cat(out)


def _gaps(ctx, q_ref, rows: torch.Tensor, scores: torch.Tensor) -> dict:
    """The two numbers for answers ``rows``/``scores`` ``[B, k]`` (row -1
    and score nan where an answer is missing) against the reference
    queries ``q_ref``."""
    k = ctx.traffic["k"]
    chunks = gen.corpus_chunks(ctx.device, ctx.state["rows"],
                               ctx.cfg["projection_dim"], ctx.seed)
    with torch.no_grad():
        top_v, _, picked = ref_search.topk_and_scores(chunks, q_ref, k,
                                                      rows.clamp(min=0))
    picked = torch.where(rows >= 0, picked, torch.nan)
    if torch.isnan(picked).any() or torch.isnan(scores).any():
        return {"score_gap": float("inf"), "rank_gap": float("inf")}
    return {"score_gap": float((scores - picked).abs().max()),
            "rank_gap": float((top_v - picked).max())}


def check(ctx) -> dict:
    pool_idx, ids, scores = ctx.state["answers"]
    if not pool_idx.shape[0]:
        return {"score_gap": float("inf"), "rank_gap": float("inf")}
    idx = _sample(ctx, pool_idx)
    texts = [ctx.state["queries"][pool_idx[i]] for i in idx]
    rows = torch.from_numpy(ids[idx]).to(ctx.device)
    got = torch.from_numpy(scores[idx]).float().to(ctx.device)
    q_ref = _reference_queries(ctx, texts, "f32")
    return _gaps(ctx, q_ref, rows, got)


def control(ctx, prec: str) -> dict:
    """The reference in ``prec`` put in the program's place, on a sample
    of the pool's queries: its exact top-k and scores judged as the
    program's answers are."""
    queries = ctx.state["queries"]
    n = min(ctx.size("check_searches", ctx.traffic["check_searches"]),
            len(queries))
    r = gen.rng(ctx.seed, "check-sample")
    idx = sorted(r.choice(len(queries), size=n, replace=False).tolist())
    idx.append(max(range(len(queries)),
                   key=lambda i: ref_tok.token_count(queries[i])))
    texts = [queries[i] for i in idx]
    q_low = _reference_queries(ctx, texts, prec)
    k = ctx.traffic["k"]
    chunks = gen.corpus_chunks(ctx.device, ctx.state["rows"],
                               ctx.cfg["projection_dim"], ctx.seed)
    dummy = torch.zeros((len(idx), k), dtype=torch.int64, device=ctx.device)
    with torch.no_grad():
        low_v, low_i, _ = ref_search.topk_and_scores(chunks, q_low, k, dummy)
    q_ref = _reference_queries(ctx, texts, "f32")
    return _gaps(ctx, q_ref, low_i, low_v)


def control_setup(ctx) -> None:
    """What :func:`control` needs, without the program."""
    ctx.state.update(rows=ctx.size("rows", ctx.cfg["library"]["rows"]),
                     queries=_queries(ctx.traffic, ctx.seed))
