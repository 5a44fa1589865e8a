"""Parameter / activation / cache sharding rules (DP x FSDP x TP(+EP)) —
the port's copy of ``repro/parallel/sharding.py``.

The mesh axes are ("pod"?, "data", "model"):
  * pod    — pure data parallel across pods;
  * data   — batch DP + ZeRO-3 parameter sharding (``fsdp``: the
             weights are sharded over "data" and all-gathered at use);
  * model  — tensor parallel (Megatron column/row splits), expert
             parallel for MoE, vocab parallel for the embedding and the
             LM head, and KV-sequence parallel for decode caches.

A spec is a plain tuple with one entry per dim: a mesh axis name, a
tuple of names (sharded over their product, the first major), or
``None`` (replicated) — the reference's ``PartitionSpec`` without JAX,
canonical as it is (:func:`~repro_torch.parallel.axes.P`: a tuple of
one name is the name, an empty one ``None``).
The rules and specs are the reference's, entry for entry
(:func:`_param_spec`, :func:`batch_specs`, :func:`_cache_spec`).

What the reference gets from ``jax.device_put`` onto a
``NamedSharding``, the port gets from :func:`local_shard` (this rank's
block of a whole tensor) and :func:`shard_params` (every weight's block
under :func:`param_specs`; a train state's moments under their params'
specs, since a leaf's spec reads only the names on its path);
:func:`gather_whole` and :func:`whole_params` are the inverse, for
checkpoints and tests.  The port's params keep one dict per
block in a list where the reference stacks the blocks on a leading
axis, so :func:`param_specs` drops the stacked axis's (always ``None``)
entry.

Training on a mesh adds what the reference's ``jax.grad`` of a sharded
step gets from its partitioner: :func:`sync_grads` (the gradient sync,
whose rule its docstring states), :func:`norm_axes` (the axes a leaf's
sum of squares is summed over for the global gradient norm) and the
train batch's rows (:func:`train_batch_specs`, :func:`shard_batch`).

``compat.py`` has no counterpart here: it is the reference's shim over
JAX versions' ``shard_map`` spellings.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import P, Mesh


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_axes_for(mesh, global_batch: int) -> tuple[str, ...] | None:
    """Largest prefix of (pod, data) whose product divides the batch."""
    axes: list[str] = []
    prod = 1
    for a in data_axes(mesh):
        if global_batch % (prod * mesh.shape[a]) == 0:
            axes.append(a)
            prod *= mesh.shape[a]
    return tuple(axes) if axes else None


def axis_rules(mesh, global_batch: int, seq_len: int, tp_ok: bool = True,
               *, fsdp: bool = True, sp_rs: bool = False) -> dict[str, Any]:
    """Logical-name -> mesh-axis rules (the reference's, entry for
    entry).  ``fsdp``: ZeRO-3 parameter sharding over "data"; ``sp_rs``:
    the reference's explicit sequence-parallel boundaries, which a
    training stack reads (:func:`~repro_torch.models.layers.use_sp_rs`:
    the residual sequence-sharded over "model" between sublayers)."""
    mp = mesh.shape.get("model", 1)
    batch = batch_axes_for(mesh, global_batch)
    seq = "model" if (tp_ok and seq_len % mp == 0 and seq_len >= mp) \
        else None
    return {
        "batch": batch,
        "seq": seq,
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "kv_seq": "model",
        "_fsdp": fsdp,
        "_sp_rs": sp_rs,
    }


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

_REPLICATED_KEYS = {"ln1", "ln2", "lnx", "final_ln", "enc_ln", "norm_w",
                    "A_log", "D", "dt_bias", "router", "b"}
_COLUMN_KEYS = {"wq", "wk", "wv", "wg", "wi", "in_proj"}   # (d_in, d_out@tp)
_ROW_KEYS = {"wo", "out_proj"}                             # (d_in@tp, d_out)
_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _keys(path) -> list:
    """A path's dict keys; a list index (which the reference's stacked
    trees never hold) reads as ``None``, as a JAX sequence key does."""
    return [k if isinstance(k, str) else None for k in path]


def _param_spec(path, leaf, fsdp: bool = True,
                moe_ep_data: bool = False) -> tuple:
    """The reference's spec of the leaf at ``path`` (dict keys from the
    root) with ``leaf.ndim`` dims, in its stacked layout: a leaf under a
    ``*blocks`` key carries the leading stacked-blocks dim."""
    keys = _keys(path)
    stacked = 1 if any(k in _STACKS for k in keys) else 0
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else None
    lead = (None,) * stacked
    ndim = leaf.ndim

    if name in ("embed", "lm_head"):
        return P("model", None)
    if name == "head":                                   # cnn head
        return P(None, None)
    if parent == "moe" or (len(keys) >= 3 and keys[-2] == "moe"):
        if name == "router":
            return P(*lead, None, None)
        if moe_ep_data:
            return P(*lead, ("model", "data"),
                    *([None] * (ndim - stacked - 1)))
        moe_data = "data" if fsdp else None
        if name in ("wg", "wi"):
            return P(*lead, "model", None, moe_data)
        if name == "wo":
            return P(*lead, "model", moe_data, None)
    if name in _REPLICATED_KEYS or ndim - stacked <= 1:
        return P(*lead, *([None] * (ndim - stacked)))
    if name == "conv_w":
        return P(*lead, None, "model")
    data = "data" if fsdp else None
    if name in _COLUMN_KEYS:
        return P(*lead, data, "model")
    if name in _ROW_KEYS:
        return P(*lead, "model", data)
    if name == "w" and ndim - stacked == 4:              # cnn conv
        return P(*lead, None, None, None, None)
    return P(*lead, *([None] * (ndim - stacked)))


class _Dims:
    """A stand-in leaf of ``ndim`` dims."""

    def __init__(self, ndim: int):
        self.ndim = ndim


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over dicts, lists and dataclasses (a train
    state: a field's name is its key)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def leaf_spec(path, leaf, fsdp: bool = True,
              moe_ep_data: bool = False) -> tuple:
    """The spec of a leaf of the port's params (per-block lists): the
    reference's :func:`_param_spec` less the stacked-blocks entry."""
    if any(k in _STACKS for k in path if isinstance(k, str)):
        return _param_spec(path, _Dims(leaf.ndim + 1), fsdp,
                           moe_ep_data)[1:]
    return _param_spec(path, leaf, fsdp, moe_ep_data)


def param_specs(params, fsdp: bool = True, moe_ep_data: bool = False):
    """The spec tree of the port's params (the reference's
    ``param_shardings``, as specs)."""
    return _map(lambda p, leaf: leaf_spec(p, leaf, fsdp, moe_ep_data),
                params)


# --------------------------------------------------------------------------
# batch / cache specs
# --------------------------------------------------------------------------

def batch_specs(specs, mesh, rules: dict):
    """Specs of an input tree (the reference's ``batch_shardings``):
    ``specs`` holds tensors or anything with ``.shape`` and ``.ndim``,
    under the reference's names (``tokens``, ``labels``, ``frames``,
    ``prefix_embeds``, ``token``, ``cur_pos``, ``caches``)."""
    batch = rules["batch"]
    seq = rules["seq"]

    def spec_for_leaf(path, leaf):
        keys = [k for k in path if isinstance(k, str)]
        name = keys[-1] if keys else ""
        if "caches" in keys:
            return _cache_spec(name, leaf, batch)
        if name in ("tokens", "labels"):
            sq = seq if leaf.shape[-1] % mesh.shape.get("model", 1) == 0 \
                and seq else None
            return P(batch, sq)
        if name in ("frames", "prefix_embeds"):
            return P(batch, None, None)
        if name == "token":
            return P(batch, None)
        if name == "cur_pos" or leaf.ndim == 0:
            return P()
        return P(batch, *([None] * (leaf.ndim - 1)))

    return _map(spec_for_leaf, specs)


def _cache_spec(name: str, leaf, batch) -> tuple:
    """The reference's spec of a stacked cache leaf (leading
    stacked-blocks dim): K/V slots over "model", cross K/V replicated,
    the SSM heads and the conv channels over "model"."""
    if name in ("k", "v", "cross_k", "cross_v"):
        axis = "model" if name in ("k", "v") else None
        return P(None, batch, axis, None, None)
    if name == "pos":
        return P(None, "model")
    if name == "ssm":
        return P(None, batch, "model", None, None)
    if name == "conv":
        return P(None, batch, None, "model")
    return P(*([None] * leaf.ndim))


def decode_output_specs(mesh, rules: dict, cache_specs):
    """(logits spec, cache spec tree) of a decode step (the reference's
    ``output_shardings_for_decode``)."""
    batch = rules["batch"]
    logits = P(batch, "model")

    def spec(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), "")
        return _cache_spec(name, leaf, batch)
    return logits, _map(spec, cache_specs)


# --------------------------------------------------------------------------
# this rank's blocks
# --------------------------------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def local_shard(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a
    view; ``t`` itself where no dim is split).  A dim sharded over axes
    of total size n must split into n equal blocks."""
    out = t
    for dim, entry in enumerate(spec):
        axes = [a for a in _entry_axes(entry) if mesh.shape[a] > 1]
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.index[a]
        size = out.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} ({size}) of a {tuple(t.shape)} "
                             f"tensor does not split over {n} ranks "
                             f"({axes})")
        out = out.narrow(dim, idx * (size // n), size // n)
    return out


def gather_whole(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block under
    ``spec`` (the inverse of :func:`local_shard`): every split dim
    all-gathered over its axes, the last axis first, so the first is
    major.  Outside autograd; ``t`` itself where no dim is split."""
    out = t.detach()
    for dim, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            out = col.all_gather(out, a, dim, mesh)
    return out


def shard_params(params, mesh: Mesh, fsdp: bool = True,
                 moe_ep_data: bool = False):
    """Whole params (the port's layout), or a whole train state ->
    this rank's blocks under :func:`param_specs`, each on the mesh's
    device; a leaf that no axis splits is kept as it is, a split one is
    copied; a 0-d step counter stays where it is (on the host)."""
    def shard(path, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return leaf
        block = local_shard(leaf, leaf_spec(path, leaf, fsdp, moe_ep_data),
                            mesh)
        if block is not leaf:
            block = block.clone(memory_format=torch.contiguous_format)
        return block.to(mesh.device)
    return _map(shard, params)


def shard_cache(caches, mesh: Mesh, rules: dict):
    """Whole decode caches (the port's per-block list) -> this rank's
    blocks under :func:`_cache_spec` less its stacked-blocks entry: K
    and V rows over the batch axes and slots over "model", the cross
    K/V and the SSM caches by rows (and "model" where the spec says).
    ``pos``, a host vector, stays whole: the port keeps every slot's
    position on every rank."""
    def shard(path, leaf):
        name = next((k for k in reversed(path) if isinstance(k, str)), "")
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = _cache_spec(name, _Dims(leaf.ndim + 1), rules["batch"])[1:]
        block = local_shard(leaf, spec, mesh)
        if block is not leaf:
            block = block.clone(memory_format=torch.contiguous_format)
        return block.to(mesh.device)
    return _map(shard, caches)


def batch_rows(t: torch.Tensor, mesh: Mesh, rules: dict,
               dim: int = 0) -> torch.Tensor:
    """This rank's rows (dim ``dim``) of a whole batch under the rules'
    batch axes."""
    spec = [None] * t.dim()
    spec[dim] = rules["batch"]
    return local_shard(t, tuple(spec), mesh)


def whole_params(tree, mesh: Mesh, fsdp: bool = True,
                 moe_ep_data: bool = False):
    """This rank's blocks of params or a train state -> the whole
    tensors (:func:`gather_whole` of every leaf under its spec; a
    collective on every rank)."""
    def whole(path, leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return leaf
        return gather_whole(leaf, leaf_spec(path, leaf, fsdp, moe_ep_data),
                            mesh)
    return _map(whole, tree)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a train state's blocks lie: the mesh and the spec rules'
    switches.  :meth:`whole` gathers every leaf (a collective on every
    rank), :meth:`local` cuts a whole state into this rank's blocks."""
    mesh: Mesh
    fsdp: bool = True
    moe_ep_data: bool = False

    def whole(self, tree):
        return whole_params(tree, self.mesh, self.fsdp, self.moe_ep_data)

    def local(self, tree):
        return shard_params(tree, self.mesh, self.fsdp, self.moe_ep_data)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _split_axes(spec, mesh: Mesh) -> set[str]:
    return {a for e in spec for a in _entry_axes(e) if mesh.shape[a] > 1}


def sync_grads(grads, mesh: Mesh, rules: dict, fsdp: bool = True,
               moe_ep_data: bool = False):
    """The gradient sync of a step on a mesh: each leaf's
    gradient summed over every mesh axis that the leaf is replicated on
    and on which its cotangent arrives partial.

    Where the cotangents arrive partial follows from where the
    collectives' adjoints sit (:mod:`repro_torch.parallel.collectives`,
    :mod:`repro_torch.models.layers`):

      * over the batch axes (the rules' ``batch``), the rows differ by
        rank, so every leaf's cotangent is this rank's rows' share.  A
        leaf sharded over such an axis (the ``fsdp`` weights over
        "data") got the sum in its gather's backward, a reduce-scatter;
        a leaf replicated over it is summed here (the data-parallel
        all-reduce);
      * over "model", every cotangent arrives whole or is made whole
        where it is used: a whole residual entering a column-parallel
        projection or the vocab-parallel loss sums its cotangent over
        "model" there ("f"), a norm weight applied to sequence-sharded
        rows (``sp_rs``) and the MoE router of ``a2a`` (each rank
        routes its own tokens) likewise, and the expert and
        tensor-parallel weights are sharded over "model".  Nothing is
        summed over "model" here;
      * over a data axis the batch is not split on, every rank computes
        the same rows: whole, and not summed.

    ``grads`` has the params' structure; returns the synced tree."""
    batch = [a for a in (rules.get("batch") or ()) if mesh.shape[a] > 1]

    def sync(path, g):
        if not isinstance(g, torch.Tensor) or not batch:
            return g
        split = _split_axes(leaf_spec(path, g, fsdp, moe_ep_data), mesh)
        axes = [a for a in batch if a not in split]
        return col.psum(g, axes, mesh) if axes else g
    return _map(sync, grads)


def norm_axes(params, mesh: Mesh, fsdp: bool = True,
              moe_ep_data: bool = False) -> list[tuple[str, ...]]:
    """For each leaf of ``params`` in :mod:`repro_torch.tree`'s
    flattening order, the mesh axes (of size above 1) its spec shards it
    on: the global gradient norm sums the leaf's sum of squares over
    them, and over no axis it is replicated on (counted once)."""
    from repro_torch.tree import leaves_with_paths
    out = []
    for p, leaf in leaves_with_paths(params):
        keys = tuple(int(k) if k.isdigit() else k for k in p.split("/"))
        spec = leaf_spec(keys, leaf, fsdp, moe_ep_data)
        out.append(tuple(a for a in mesh.axis_names
                         if a in _split_axes(spec, mesh)))
    return out


def train_batch_specs(batch, rules: dict):
    """Specs of a train batch: ``tokens``, ``labels`` (and ``frames``,
    ``prefix_embeds``) rows over the rules' batch axes, every other dim
    whole (each model rank reads its rows' whole sequence)."""
    return {k: P(rules["batch"], *([None] * (v.ndim - 1)))
            for k, v in batch.items()}


def shard_batch(batch, mesh: Mesh, rules: dict) -> dict:
    """This rank's rows of a global train batch (:func:`train_batch_specs`),
    in order: data rank ``i`` takes the ``i``-th block of rows."""
    specs = train_batch_specs(batch, rules)
    return {k: local_shard(torch.as_tensor(v), specs[k], mesh)
            for k, v in batch.items()}
