"""The whole step's share of the card's f32 peak in the traced slice:
three times the forward operations of both towers per pair
(``roofline.train_flops``, the captions at their mean token count) times
the pairs of the steps begun in the slice, over the slice's seconds times
67 TFLOP/s (f32 outside the tensor cores: the configuration trains in
f32 with TF32 off)."""

from portbench import roofline


def read(r):
    s = r.slice
    if s is None or not s.ops or not s.units or s.window_s <= 0:
        return None
    pairs = s.units * r.host["batch"]
    flops = roofline.train_flops(r.cfg, r.state["caption_tokens"])
    return 100.0 * flops * pairs / (s.window_s * roofline.PEAK_FLOPS["f32"])
