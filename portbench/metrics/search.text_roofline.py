"""The text tower's share of its roofline in the traced slice: the least
time of the slice's text passes (``roofline.text_pass``: each query at
its own token count, the weights read once a pass) over the device time
of the kernels each flush ran between its ids' upload and its scan
(``segments.search_flushes``). The passes' least time is their mean
from the host's log times the flushes the device ran."""

from portbench import roofline, segments
from portbench.drivers.search import text_passes


def read(r):
    if r.slice is None:
        return None
    passes = text_passes(r.encode_log)
    text, _, _ = segments.search_flushes(r.slice.ops)
    spent = sum(segments.seconds(t) for t in text)
    if not passes or not text or spent <= 0:
        return None
    least = [roofline.bound_s(*roofline.text_pass(r.cfg, toks), "bf16")
             for _, _, toks in passes]
    return 100.0 * len(text) * (sum(least) / len(least)) / spent
