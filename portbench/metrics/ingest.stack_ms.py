"""Host milliseconds per batch in which the frame pipeline copies a
batch's frames into one array: the program's span ``frames.stack``
(``ingest/pipeline.py:batched_frames``, inside ``ingest.next``) over the
window."""

from portbench.spans import ms_per_batch


def read(r):
    return ms_per_batch(r, "frames.stack")
