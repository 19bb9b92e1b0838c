"""SigLIP, the second dual-encoder family (counterpart of
``video_quierer_tpu/models/siglip``): serving towers, weights bridge,
fused text encode, embedder and SentencePiece tokenizer."""
