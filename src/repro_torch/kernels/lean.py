"""One lean launch: what a kernel wrapper reads once per geometry and what
it does per call.

A short conv (ResNet-20/32's at batch 8: a bound under 1 us) costs its
host enqueue, so a wrapper reads its route and plan once per geometry
key (:class:`LaunchCache`) and, per call, only checks that the key is
one it has seen, allocates its output, fills in the pointers and the
stream and calls the kernel's C entry.  The key holds everything the
wrapper's checks and route read of the operands (shape, type, device,
contiguity and 16-byte alignment of each) and the call's geometry, so a
call with the same key passes the same checks and takes the same route
with the same plan.  The packed arguments of a geometry (and the C
side's cache of tensor maps) are shared, so launches come from one
thread at a time: every caller in this package launches from one
thread, except the serving loop's ``run_async``, whose attempts enqueue
under :data:`LAUNCH_LOCK` (``ImageServer._execute``).
"""

from __future__ import annotations

import threading

import torch

#: held over a dispatch's enqueue by a caller that launches from more
#: than one thread, so the shared packed arguments are filled in and
#: launched by one thread at a time
LAUNCH_LOCK = threading.Lock()

#: the most entries a :class:`LaunchCache` keeps before it starts afresh
#: (the plan functions' own caches keep as many)
CACHE_ENTRIES = 4096

#: the raw stream of a device, without building a ``Stream`` object
#: (PyTorch's own bindings use it; the public call where it is missing)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def operand_key(t: torch.Tensor | None):
    """What a wrapper's checks and route read of one operand."""
    if t is None:
        return None
    return (t.shape, t.dtype, t.device, t.is_contiguous(),
            t.data_ptr() % 16 == 0)


def current_stream(device: torch.device) -> int:
    """The current stream of ``device`` (which must be current)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def on_device(device: torch.device, launch):
    """``launch(stream)`` on ``device``'s current stream: with no device
    guard where ``device`` is already current."""
    if device.index == torch.cuda.current_device():
        return launch(current_stream(device))
    with torch.cuda.device(device):
        return launch(current_stream(device))


class LaunchCache:
    """Launch entries by geometry key.  ``plans`` counts the entries
    made; an entry whose first launch raises is dropped, so a refused
    launch leaves nothing behind."""

    def __init__(self):
        self.entries: dict = {}
        self.plans = 0

    def get(self, key, make):
        """``(entry, fresh)``: the entry of ``key``, made by ``make()``
        if there is none yet."""
        entry = self.entries.get(key)
        if entry is not None:
            return entry, False
        if len(self.entries) >= CACHE_ENTRIES:
            self.entries.clear()
        entry = self.entries[key] = make()
        self.plans += 1
        return entry, True

    def drop(self, key) -> None:
        self.entries.pop(key, None)

    def clear(self) -> None:
        self.entries.clear()
