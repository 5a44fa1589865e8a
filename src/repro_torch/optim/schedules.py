"""LR schedules (warmup + cosine / constant) — the port's copy of
``repro/optim/schedules.py``.

The reference computes them in f32 on the device; the port computes the
same f32 arithmetic on the host (numpy ``float32``), so choosing a
step's rate costs no device work, and returns the f32 value as a Python
``float``.  ``warmup_cosine`` is 0 at step 0: that step moves no
parameter.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> float:
    step = _F32(step)
    if step < warmup:
        return float(_F32(peak_lr) * step / _F32(max(warmup, 1)))
    frac = np.clip((step - _F32(warmup)) / _F32(max(total - warmup, 1)),
                   _F32(0), _F32(1))
    # the cosine of the f32 angle, rounded once to f32
    cos = _F32((1 - floor) * 0.5) * (_F32(1) + _F32(np.cos(np.float64(
        _F32(np.pi) * frac))))
    return float(_F32(peak_lr) * (_F32(floor) + cos))


def constant(step, *, peak_lr: float, **_) -> float:
    return float(_F32(peak_lr))
