"""Host milliseconds per batch in the index's appends, timed by the
program: its span ``ingest.append`` (``engine/system.py:
_ingest_batches``, around a batch's per-video ``add_batch`` runs and its
``stream_rows_device``) over the window."""

from portbench.spans import ms_per_batch


def read(r):
    return ms_per_batch(r, "ingest.append")
