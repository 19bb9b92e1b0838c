"""Device meshes of the port (counterpart of ``video_quierer_tpu/parallel``)."""
