"""Timing, tracing and logging helpers."""
