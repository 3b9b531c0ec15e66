"""Atomic checkpoints of the port's state trees (``repro/checkpoint/``)."""
