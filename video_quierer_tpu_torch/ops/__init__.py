"""Kernel wrappers and their plain PyTorch versions."""
