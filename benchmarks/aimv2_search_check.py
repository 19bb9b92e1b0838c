"""AIMv2 searches on the card through the engine, held to the f32
reference's exact top-k.

Builds the engine of the ``aimv2-l14.ingest`` cell (AIMv2-L/14 LiT on
the seeded weights of ``portbench/gen_aimv2.py``, the 2,000,000-row
library of 512-wide rows), then searches:

- a batch of 64 queries of 2-12 words through ``search_batch`` (the text
  tower on the gated layer halves at a 16- or 32-token bucket, the bf16
  candidate scan B1 over the 512-wide mirror, the f32 re-rank);
- the first 32 of them from 32 threads through ``search_coalesced_ex``
  (the request coalescer, which merges them into fused batches);
- 8 of them one at a time through ``search_ex`` (the module tower);

and compares each answer's top 10 with the exact f32 top 10 of the
reference's query rows (``portbench/reference/aimv2.py``) over the
library: ``score_gap``, the widest gap between a returned score and the
reference's score of that row, and ``rank_gap``, the widest shortfall of
a returned row's reference score below the reference's own score at
that rank. One JSON line on standard output. Run from the root of a
checkout, on a card:

    python3 benchmarks/aimv2_search_check.py --seed 7
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import gen, gen_aimv2, program, run  # noqa: E402
from portbench.drivers import ingest_aimv2  # noqa: E402
from portbench.reference import aimv2 as ref_aimv2  # noqa: E402
from portbench.reference import search as ref_search  # noqa: E402

K = 10


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=None,
                    help="library rows (default: the configuration's)")
    args = ap.parse_args(argv)
    run.prepare_environment(ROOT, False)
    from video_quierer_tpu_torch.ops import fused_layer as fl
    from video_quierer_tpu_torch.ops import topk
    _, _, cfg, _ = run.load_cell(ROOT, "aimv2-l14.ingest")
    dev = torch.device(args.device)
    emb = ingest_aimv2.embedder(cfg, dev, args.seed)
    eng = program.engine(cfg, emb, dev)
    rows = args.rows or cfg["library"]["rows"]
    program.fill_library(eng, cfg, dev, args.seed, rows, rows)
    eng._warm_up()
    r = gen.rng(args.seed, "queries")
    vocab = gen.words(gen.rng(0, "vocabulary"), 4096)
    queries = [" ".join(vocab[i] for i in r.integers(0, 4096, size=m))
               for m in r.integers(2, 13, size=64)]
    before = (fl.rms_attn_half.launches, fl.gated_mlp_half.launches,
              topk.cand_scan.launches + topk.cand_scan_prefix.launches)
    batch = eng.search_batch(queries, k=K)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    after = (fl.rms_attn_half.launches, fl.gated_mlp_half.launches,
             topk.cand_scan.launches + topk.cand_scan_prefix.launches)
    with ThreadPoolExecutor(32) as pool:
        coalesced = list(pool.map(
            lambda q: eng.search_coalesced_ex(q, K, False)[0], queries[:32]))
    single = [eng.search_ex(q, k=K, use_cache=False)[0] for q in queries[:8]]
    ids = emb.prepare_text_ids(emb.tokenizer(queries))
    sd = gen_aimv2.weights(cfg, dev, program._DTYPES[cfg["dtype"]],
                           args.seed)
    eng.close()
    del eng, emb
    from portbench.reference.clip import no_tf32
    no_tf32()
    with torch.no_grad():
        q_ref = ref_aimv2.encode_text(sd, cfg, torch.from_numpy(
            np.ascontiguousarray(ids, np.int64)).to(dev))
    out = {"seed": args.seed, "queries": len(queries),
           "text_bucket": list(ids.shape),
           "launches": {"rms_attn_half": after[0] - before[0],
                        "gated_mlp_half": after[1] - before[1],
                        "cand_scan": after[2] - before[2]}}
    for name, answers, q in (("batch", batch, q_ref),
                             ("coalesced", coalesced, q_ref[:32]),
                             ("single", single, q_ref[:8])):
        got_rows = torch.tensor([[a["frame_id"] for a in ans]
                                 for ans in answers], device=dev)
        got = torch.tensor([[a["score"] for a in ans] for ans in answers],
                           device=dev)
        chunks = gen.corpus_chunks(dev, rows, cfg["projection_dim"],
                                   args.seed)
        with torch.no_grad():
            top_v, top_i, picked = ref_search.topk_and_scores(
                chunks, q, K, got_rows)
        out[name] = {"score_gap": float((got - picked).abs().max()),
                     "rank_gap": float((top_v - picked).max()),
                     "same_rows_share": float(
                         (got_rows == top_i).float().mean())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
