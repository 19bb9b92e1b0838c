"""Host milliseconds the ingest loop waits on its batch iterator
(``ingest/pipeline.py:batched_frames``) per batch, over the window."""

from portbench.readers import per_batch_ms


def read(r):
    return per_batch_ms(r, "frame_wait_s")
