"""Kernels launched per training step in the traced slice (copies and
sets not counted)."""

from portbench import segments


def read(r):
    s = r.slice
    if s is None or not s.ops or not s.units:
        return None
    return len(segments.kernels(s.ops)) / s.units
