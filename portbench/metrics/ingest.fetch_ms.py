"""Host milliseconds per batch the embedder waits for the vision tower
and copies the batch's rows back: the program's span ``embed.fetch``
(``models/clip/embedder.py:embed_frames_device``) over the window."""

from portbench.spans import ms_per_batch


def read(r):
    return ms_per_batch(r, "embed.fetch")
