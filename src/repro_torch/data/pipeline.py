"""Double-buffered prefetching data pipeline — the port's copy of
``repro/data/pipeline.py``.

Wraps any step -> batch function with a background thread that keeps
``depth`` batches ready, hiding host-side generation behind the
previous step's compute.  Given a CUDA ``device``, the worker pins each
batch's tensors and :meth:`Prefetcher.__next__` starts their copy to
the card (``non_blocking``, ordered on the caller's stream before the
step that reads them); the reference's worker does the same with a
``device_put`` to its sharding.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import torch

from repro_torch.tree import tree_map


class Prefetcher:
    def __init__(self, make_batch: Callable[[int], Any], *,
                 start_step: int = 0, depth: int = 2, device=None):
        self._make = make_batch
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _pinned(self, x):
        if isinstance(x, torch.Tensor) and self._device.type == "cuda":
            return x.pin_memory()
        return x

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._make(step)
            if self._device is not None:
                batch = tree_map(self._pinned, batch)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        if self._device is not None:
            batch = tree_map(lambda x: x.to(self._device, non_blocking=True)
                             if isinstance(x, torch.Tensor) else x, batch)
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
