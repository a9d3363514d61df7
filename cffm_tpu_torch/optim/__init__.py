"""Optimizers of the port: per-row sparse updates and the dense chain."""
