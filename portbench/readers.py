"""Reading logic shared by metrics that read one quantity in several
cells (``portbench/metrics/<metric>.py`` names the metric; what it reads
is here)."""

from portbench import roofline, segments


def idle_pct(r):
    """Share of the traced slice in which no device operation ran."""
    s = r.slice
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (s.window_s - s.busy_s) / s.window_s


def per_batch_ms(r, key):
    """Host milliseconds per ingest batch of the window's ``host[key]``
    seconds."""
    n = r.host.get("batches", 0)
    if not n:
        return None
    return 1e3 * r.host[key] / n


def upload_ms(r):
    """Device milliseconds per batch of the host-to-device copies and the
    element-wise preprocess kernels right after them."""
    s = r.slice
    if s is None or not s.ops or not s.units:
        return None
    ops = segments.upload_ops(s.ops)
    if not ops:
        return None
    return 1e3 * segments.seconds(ops) / s.units


def _vision_tokens(r):
    v = r.cfg["vision_config"]
    seq = (v["image_size"] // v["patch_size"]) ** 2 + 1
    return r.traffic["batch_frames"] * seq, seq, v


def half_roofline(r, half):
    """B5's (``half`` "attn") or B6's ("mlp") share of its roofline: the
    least time of each half over the batch's tokens against its kernels'
    device time, found in launch order."""
    if r.slice is None:
        return None
    b5, b6 = segments.vision_halves(r.slice.ops)
    groups = b5 if half == "attn" else b6
    spent = sum(segments.seconds(g) for g in groups)
    if not groups or spent <= 0:
        return None
    t, seq, v = _vision_tokens(r)
    counts = (roofline.attn_half(t, v["hidden_size"], seq) if half == "attn"
              else roofline.mlp_half(t, v["hidden_size"],
                                     v["intermediate_size"]))
    return 100.0 * len(groups) * roofline.bound_s(*counts, "bf16") / spent


def ingest_mfu(r):
    """The vision tower's operations per frame times the frames of the
    batches begun in the traced slice, over its seconds at 989 TFLOP/s."""
    s = r.slice
    if s is None or not s.ops or not s.units or s.window_s <= 0:
        return None
    frames = s.units * r.traffic["batch_frames"]
    return 100.0 * roofline.vision_flops(r.cfg) * frames / (
        s.window_s * roofline.PEAK_FLOPS["bf16"])
