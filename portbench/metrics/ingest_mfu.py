"""The whole batch's share of the card's bf16 peak in the traced slice:
the vision tower's operations per frame (``roofline.vision_flops``)
times the frames of the batches begun in the slice, over the slice's
seconds times 989 TFLOP/s."""

from portbench.readers import ingest_mfu


def read(r):
    return ingest_mfu(r)
