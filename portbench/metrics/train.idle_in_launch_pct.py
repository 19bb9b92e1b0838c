"""Of the traced slice's device-idle time (the gaps between its device
operations), the share in which the trainer's thread was issuing a
step's work: inside the program's ``train.forward``, ``train.backward``
and ``train.optimizer`` spans, on the profiler's clock."""

from portbench.spans import LAUNCH, idle_inside_pct


def read(r):
    return idle_inside_pct(r, LAUNCH)
