"""The benchmark of ``video_quierer_tpu_torch`` (see ``portbench/run.py``)."""
