"""Share of the traced slice in which no device operation ran."""

from portbench.readers import idle_pct


def read(r):
    return idle_pct(r)
