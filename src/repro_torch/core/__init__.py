"""Accounting-side core: layer geometry, Eq. (15), planner rules."""
