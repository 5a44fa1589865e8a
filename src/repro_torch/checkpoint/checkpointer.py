"""Atomic, versioned, multi-host-aware checkpointing — the port's copy of
``repro/checkpoint/checkpointer.py``.

Layout, as the reference's: ``<dir>/step_<N>/`` (N in 8 digits) holding
one ``shard_<host>.npz`` per host (leaf ``i`` as ``leaf_<i>``, leaves
dealt round-robin over the hosts) and a ``manifest.json`` with the
reference's keys (``step``, ``time``, ``n_hosts``, ``names``,
``dtypes``, ``shapes``).  npz has no bfloat16, so a bf16 leaf is
widened to f32 in the file and restored to bf16.  A step is written
under a temporary name and renamed into place, so a crash mid-save never
corrupts the latest checkpoint; :func:`restore_latest` picks the newest
*complete* step (one with a manifest).  Trees are those of
:mod:`repro_torch.tree`: tensors (on any device), numpy arrays or
numbers at the leaves.

:class:`AsyncCheckpointer` runs saves on a background thread.  The
trainer updates its state in place, so :meth:`AsyncCheckpointer.submit`
first takes a snapshot of every tensor on its own device (a copy
enqueued on the caller's stream ahead of the next step's update); the
worker copies the snapshot to the host and writes it, so training does
not wait for the device-to-host copy or the filesystem.

A state sharded over a mesh (``layout``, a
:class:`~repro_torch.parallel.sharding.Layout`) is saved as the
reference saves its sharded state: whole leaves under the reference's
manifest, each gathered from every rank's block
(:func:`~repro_torch.parallel.sharding.gather_whole`; a collective, so
every rank calls ``save``/``submit`` and none returns before every
rank's blocks are in the gathered copy), written by rank 0 alone; the
ranks meet at a barrier after a synchronous save and in
:meth:`AsyncCheckpointer.wait`, so none reads a step before it is on
disk.  ``restore(..., whole=True)`` reads the whole leaves by the
manifest's shapes, whatever the mesh ``like`` was sharded for, for the
caller to cut onto any mesh (``runtime.elastic.reshard_state``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tree import leaves, paths, tree_map, unflatten

#: a torch type's name in the manifest (numpy's names, as the
#: reference writes them)
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float16: "float16", torch.float64: "float64",
          torch.int32: "int32", torch.int64: "int64", torch.int8: "int8",
          torch.uint8: "uint8", torch.bool: "bool"}
_TYPES = {v: k for k, v in _NAMES.items()}


def tree_paths(tree: Any) -> list[str]:
    return paths(tree)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _NAMES[leaf.dtype]
    return str(np.asarray(leaf).dtype)


def _to_np(leaf) -> np.ndarray:
    """A leaf on the host as numpy; bf16 widened (exactly) to f32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _shape(leaf) -> list[int]:
    return list(leaf.shape) if hasattr(leaf, "shape") \
        else list(np.shape(leaf))


def _writer(layout) -> bool:
    """Does this rank write a ``layout``'s checkpoints (rank 0 does)?"""
    return layout is None or dist.get_rank() == 0


def barrier(layout) -> None:
    """Every rank of a ``layout``'s world waits for the others (nothing
    without a layout or on one rank)."""
    if layout is not None and dist.get_world_size() > 1:
        dist.barrier()


def save(ckpt_dir: str, step: int, tree: Any, *, host_id: int = 0,
         n_hosts: int = 1, layout=None) -> str:
    """Write one checkpoint step atomically.  Returns the final path.
    With ``layout`` every rank calls it: the whole leaves are gathered,
    rank 0 writes them, and the ranks meet at a barrier."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if layout is not None:
        tree = layout.whole(tree)
        if _writer(layout):
            _write(ckpt_dir, step, tree, host_id=0, n_hosts=1)
        barrier(layout)
        return final
    return _write(ckpt_dir, step, tree, host_id=host_id, n_hosts=n_hosts)


def _write(ckpt_dir: str, step: int, tree: Any, *, host_id: int,
           n_hosts: int) -> str:
    flat = leaves(tree)
    names = paths(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp_{host_id}"
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"leaf_{i}": _to_np(leaf) for i, leaf in enumerate(flat)
              if i % n_hosts == host_id}
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **arrays)
    manifest = {
        "step": step, "time": time.time(), "n_hosts": n_hosts,
        "names": names,
        "dtypes": [_dtype_name(leaf) for leaf in flat],
        "shapes": [_shape(leaf) for leaf in flat],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if host_id == 0:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    return final


def _complete(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and "tmp" not in d
             and _complete(os.path.join(ckpt_dir, d))]
    return max(steps) if steps else None


def _restored(arr: np.ndarray, dtype: str, like):
    """One stored array as ``like``'s kind: a tensor of the manifest's
    type on ``like``'s device (its metadata only: its data may be long
    overwritten), or a numpy array."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device,
                                        dtype=_TYPES[dtype])
    if dtype == "bfloat16":
        import ml_dtypes
        return arr.astype(ml_dtypes.bfloat16)
    return arr.astype(dtype)


def restore(ckpt_dir: str, step: int, like: Any, *, host_id: int = 0,
            n_hosts: int = 1, whole: bool = False) -> Any:
    """Restore into the structure of ``like`` (shapes validated against
    ``like``'s leaves, or with ``whole`` against the manifest's: the
    whole leaves of a state ``like`` holds blocks of)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = leaves(like)
    out = list(flat)
    for h in range(manifest["n_hosts"]):
        f = os.path.join(path, f"shard_{h}.npz")
        if not os.path.exists(f):
            continue
        with np.load(f) as data:
            for key in data.files:
                i = int(key.split("_")[1])
                arr = data[key]
                want = manifest["shapes"][i] if whole else _shape(flat[i])
                if list(arr.shape) != list(want):
                    raise ValueError(
                        f"shape mismatch restoring leaf {i}: "
                        f"{arr.shape} vs {tuple(want)}")
                out[i] = _restored(arr, manifest["dtypes"][i], flat[i])
    return unflatten(like, out)


def restore_latest(ckpt_dir: str, like: Any, **kw) -> tuple[Any, int] | None:
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    return restore(ckpt_dir, step, like, **kw), step


def _snapshot(leaf):
    """A copy of a tensor on its own device, taken now; other leaves as
    they are."""
    return leaf.detach().clone() if isinstance(leaf, torch.Tensor) \
        else leaf


class AsyncCheckpointer:
    """Non-blocking saves; at most one in flight, newest wins.  With
    ``layout`` every rank submits (the gather is a collective) and waits;
    rank 0's worker writes."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, layout=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.layout = layout
        self._pending: tuple[int, Any] | None = None
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._stop = False
        self._busy = False
        self._last_saved: int | None = None
        #: seconds each save took on the worker (to the host, then disk)
        self.save_seconds: list[float] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, step: int, tree: Any):
        if self.layout is not None:
            tree = self.layout.whole(tree)
            if not _writer(self.layout):
                return
        snap = tree_map(_snapshot, tree)
        with self._lock:
            self._pending = (step, snap)
            self._busy = True
        self._event.set()

    def _worker(self):
        while True:
            self._event.wait()
            self._event.clear()
            if self._stop and self._pending is None:
                return
            with self._lock:
                job, self._pending = self._pending, None
            if job is None:
                if self._stop:
                    return
                continue
            step, tree = job
            t0 = time.perf_counter()
            # the host copy happens here
            _write(self.ckpt_dir, step, tree, host_id=0, n_hosts=1)
            del tree
            self.save_seconds.append(time.perf_counter() - t0)
            self._last_saved = step
            self._gc()
            with self._lock:
                self._busy = self._pending is not None
            if self._stop:
                return

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and "tmp" not in d)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir,
                                       f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self, timeout: float = 30.0):
        """Until every submitted save is on disk (or ``timeout``).  The
        reference's returns once its worker has taken the last job (and
        some step is on disk), possibly before that job's save ends;
        this one waits for the save."""
        t0 = time.time()
        while self._busy and time.time() - t0 < timeout:
            time.sleep(0.01)
        barrier(self.layout)

    def close(self):
        self._stop = True
        self._event.set()
        self._thread.join(timeout=30)
