"""The candidate scan's (B1, ``cand_kernel``) share of its roofline in
the traced slice: the bf16 mirror of the live rows, the queries and the
winners moved once (``roofline.scan_pass`` at each flush's query count)
at 3.35 TB/s, over the scans' device time."""

from portbench import roofline, segments
from portbench.drivers.search import text_passes


def read(r):
    if r.slice is None:
        return None
    passes = text_passes(r.encode_log)
    _, scans, _ = segments.search_flushes(r.slice.ops)
    spent = segments.seconds(scans)
    if not passes or not scans or spent <= 0:
        return None
    rows, dim = r.state["rows"], r.cfg["projection_dim"]
    least = [roofline.bound_s(*roofline.scan_pass(rows, dim, len(toks)),
                              "bf16") for _, _, toks in passes]
    return 100.0 * len(scans) * (sum(least) / len(least)) / spent
