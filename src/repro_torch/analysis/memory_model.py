"""Analytic per-rank memory model for the dry-run records — the port's
copy of ``repro/analysis/memory_model.py``.

Eager PyTorch has no compiler report of a step's memory, so this is the
number the "does it fit" judgment uses: the exact sharded state
footprint (params, optimizer moments, caches and inputs, from their
shapes and types and their specs) plus a transient-activation
allowance.  A spec is the port's tuple (one entry a dim: a mesh axis, a
tuple of axes, or ``None``; :mod:`repro_torch.parallel.sharding`); a
spec tree has the structure of the shape tree, a spec standing where
the shape tree has a tensor.  ``mesh`` is anything with the mesh's
``shape`` (axis name -> size).
"""

from __future__ import annotations

from typing import Any

from repro_torch.tree import leaves, tree_map


def _shards(spec, mesh) -> int:
    n = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            n *= mesh.shape[a]
    return n


def _nbytes(leaf) -> int:
    n = 1
    for s in leaf.shape:
        n *= int(s)
    itemsize = getattr(leaf, "itemsize", None) or leaf.dtype.itemsize
    return n * itemsize


def sharded_bytes_per_chip(shapes: Any, specs: Any, mesh) -> int:
    """Sum of leaf bytes divided by each leaf's shard count (a leaf
    whose spec is ``None`` counts whole)."""
    def per_leaf(leaf, spec):
        size = _nbytes(leaf)
        if spec is not None:
            size //= max(1, _shards(spec, mesh))
        return size
    return sum(leaves(tree_map(per_leaf, shapes, specs)))


def activation_allowance(cfg, seq_len: int, global_batch: int,
                         mesh, kind: str) -> int:
    """Residual-stack (remat-saved) + transient working-set estimate.

    train:   nb x (B_l, S_l, d) bf16 saved block boundaries
             + ~6 live full-seq activations of the widest layer dim
    prefill: same transient, no saved stack (no backward)
    decode:  negligible activations (counted in the transient term).
    """
    from repro_torch.models.transformer import n_blocks
    mp = mesh.shape.get("model", 1)
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.shape and global_batch % (dp * mesh.shape[a]) == 0:
            dp *= mesh.shape[a]
    b_l = max(1, global_batch // dp)
    # wide layer outputs (d_ff, conv_dim, heads) are model-sharded; only
    # the d_model residual is ever live at full width per chip
    widest = max(cfg.d_model,
                 ((cfg.d_inner + 2 * cfg.ssm_state) if cfg.ssm_state
                  else 0) // mp,
                 2 * cfg.d_ff // max(1, mp))
    if kind == "decode":
        return 6 * b_l * widest * 4
    transient = 6 * b_l * seq_len * widest * 2          # bf16 live set
    if kind == "prefill":
        return transient
    nb = n_blocks(cfg) if cfg.family != "encdec" else cfg.n_layers
    stack = nb * b_l * (seq_len // mp) * cfg.d_model * 2
    return stack + transient
