"""Fault-tolerant checkpointing of train states (``Checkpointer``)."""
