"""AIMv2 in its LiT form, the third dual-encoder family (``model.family =
"aimv2"``): configuration, module towers, checkpoint conversion, fused
encodes on the gated layer halves, embedder and the plain reference the
tests hold them to. It has no counterpart in the JAX package."""
