"""Device milliseconds per batch of the host-to-device copies and the
element-wise preprocess kernels right after them
(``segments.upload_ops``), in the traced slice."""

from portbench.readers import upload_ms


def read(r):
    return upload_ms(r)
