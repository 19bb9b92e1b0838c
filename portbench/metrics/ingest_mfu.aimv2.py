"""The whole batch's share of the card's bf16 peak in the AIMv2 cell's
traced slice: AIMv2's operations per frame
(``roofline_aimv2.vision_flops``: patch projection, blocks, pooling head,
projection) times the frames of the batches begun in the slice, over the
slice's seconds times 989 TFLOP/s."""

from portbench.readers_aimv2 import ingest_mfu


def read(r):
    return ingest_mfu(r)
