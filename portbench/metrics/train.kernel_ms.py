"""Device milliseconds of kernels per training step in the traced slice
(forward, autograd's backward and the optimizer)."""

from portbench import segments


def read(r):
    s = r.slice
    if s is None or not s.ops or not s.units:
        return None
    return 1e3 * segments.seconds(segments.kernels(s.ops)) / s.units
