"""Atomic, versioned checkpoints: the port's copy of
``repro/checkpoint/``."""
