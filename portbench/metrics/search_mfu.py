"""The whole flush's share of the card's peak in the traced slice: each
flush's least time, the larger of its operations over 989 TFLOP/s and its
bytes over 3.35 TB/s (text pass, candidate scan and exact re-rank from
shapes, ``portbench/roofline.py``), summed over the flushes the device
ran, over the slice's seconds. A flush is byte-bound, so this is its
roofline share."""

from portbench import roofline, segments
from portbench.drivers.search import text_passes


def read(r):
    if r.slice is None or r.slice.window_s <= 0:
        return None
    passes = text_passes(r.encode_log)
    _, scans, _ = segments.search_flushes(r.slice.ops)
    if not passes or not scans:
        return None
    rows, dim = r.state["rows"], r.cfg["projection_dim"]
    fetch = r.traffic["rerank_fetch"]
    least = []
    for _, _, toks in passes:
        parts = (roofline.text_pass(r.cfg, toks),
                 roofline.scan_pass(rows, dim, len(toks)),
                 roofline.rerank_pass(len(toks), fetch, dim))
        least.append(roofline.bound_s(sum(p[0] for p in parts),
                                      sum(p[1] for p in parts), "bf16"))
    return 100.0 * len(scans) * (sum(least) / len(least)) / r.slice.window_s
