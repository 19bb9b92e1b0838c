"""Host milliseconds per batch in the index's appends
(``DeviceVideoIndex.add_batch`` for each video's run, then
``stream_rows_device``), over the window."""

from portbench.readers import per_batch_ms


def read(r):
    return per_batch_ms(r, "append_s")
