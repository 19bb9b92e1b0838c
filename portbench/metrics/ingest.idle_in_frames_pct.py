"""Of the traced slice's device-idle time (the gaps between its device
operations), the share in which the ingest loop was waiting on the frame
pipeline: inside the program's ``ingest.next`` spans of the loop's
thread, on the profiler's clock."""

from portbench.spans import idle_inside_pct


def read(r):
    return idle_inside_pct(r, ("ingest.next",))
