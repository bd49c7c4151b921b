"""Optimizers of the port: AdamW with f32 master weights and moments."""
