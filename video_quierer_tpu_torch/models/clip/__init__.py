"""CLIP text side of the port."""
