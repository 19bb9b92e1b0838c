"""The plain reference: CLIP's two towers, the tokenizer, the exact top-k
and the contrastive step with AdamW, in plain PyTorch. It imports
nothing of the program and nothing of JAX, and takes only what the
benchmark makes (``portbench/gen.py``)."""
