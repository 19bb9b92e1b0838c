"""Model towers of the port."""
