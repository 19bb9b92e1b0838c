"""Ingest of the port: frame extraction and the decode pipeline."""
