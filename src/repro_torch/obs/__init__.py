"""Observability: span tracer and metrics registry."""
