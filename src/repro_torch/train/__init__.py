"""Serving steps and the chunked CE of the port (the training steps come
with their slice)."""
