"""Blocked (flash-style) attention: op, CUDA kernel (K4) and its plain
version."""
