"""Serving steps of the port (the training steps come with their slice)."""
