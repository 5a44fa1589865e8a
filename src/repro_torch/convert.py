"""Parameters of the reference package as the port's tensors, and back.

The reference's CNN params are a ``{"convs": [{"w", "b"}], "head"}``
pytree; handed over as numpy arrays (``numpy.asarray`` of each leaf),
:func:`params_from_numpy` turns them into the port's dict of tensors,
and :func:`params_to_numpy` turns the port's params (or gradients of
the same shape) into numpy arrays leaf by leaf.
Layouts are kept — HWIO weights stay HWIO, the ``(Co,)`` bias and the
``(C, n_classes)`` head as they are — so both packages compute on
identical weights.

The reference's LM params (``{"embed", "blocks", "final_ln",
["lm_head"]}``, ``blocks`` a pytree whose every leaf is stacked on a
leading block axis) and its decode caches (``{"sub0": {"k", "v",
"pos"}}`` for an attention sublayer, ``{"ssm", "conv"}`` for a Mamba
one, stacked likewise) go to the port's per-block lists and back
through :func:`lm_params_from_numpy` / :func:`lm_params_to_numpy` and
:func:`lm_cache_from_numpy` / :func:`lm_cache_to_numpy`, bit for bit
in both types (a bfloat16 leaf comes back as numpy's bfloat16 of
``ml_dtypes``); a cache's ``pos`` stays a host numpy vector.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exec_target import resolve_device


def _tensor(a) -> torch.Tensor:
    """One numpy leaf as a tensor of its own type; a bfloat16 leaf
    (numpy's extension type, which ``torch.from_numpy`` does not take)
    through its 16-bit pattern."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """``{"convs": [{"w": ndarray, "b": ndarray?}], "head": ndarray}``
    -> the same dict of tensors on ``device``, each of its leaf's type
    (float32 or bfloat16, as the reference's params are)."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return _tensor(a).to(device=dev)

    return {"convs": [{k: t(v) for k, v in conv.items()}
                      for conv in tree["convs"]],
            "head": t(tree["head"])}


def params_to_numpy(tree: dict) -> dict:
    """The port's ``{"convs": [{"w", "b"?}], "head"}`` tensors -> the
    same dict of numpy arrays (detached, on the host); a bfloat16 leaf
    comes back widened, exactly, to float32."""

    def a(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return {"convs": [{k: a(v) for k, v in conv.items()}
                      for conv in tree["convs"]],
            "head": a(tree["head"])}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its own type, bit for bit (bfloat16
    through its 16-bit pattern as ``ml_dtypes.bfloat16``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    """``fn`` on every leaf of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _unstack(tree, fn) -> list:
    """A tree stacked on a leading block axis -> one tree per block, each
    leaf's slice through ``fn``."""
    n = len(_leaves(tree)[0])
    return [_map(tree, lambda a, i=i: fn(a[i])) for i in range(n)]


def _stack(trees: list, fn):
    """Per-block trees -> one tree of ``fn``-converted leaves stacked on
    a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], fn) for k in trees[0]}
    return np.stack([fn(t) for t in trees])


def lm_params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's LM params as numpy leaves -> the port's: each
    leaf a tensor of its type on ``device``, ``blocks`` split into a
    list of per-block dicts."""
    dev = resolve_device(device)
    out = {k: _tensor(v).to(dev) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = _unstack(tree["blocks"], lambda a: _tensor(a).to(dev))
    return out


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM params -> the reference's layout of numpy arrays
    (blocks stacked), bit for bit."""
    out = {k: _numpy(v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = _stack(params["blocks"], _numpy)
    return out


def lm_cache_from_numpy(tree: dict, device="cuda") -> list:
    """The reference's stacked decode caches (``{sub: {name: array}}``)
    as numpy leaves -> the port's list of per-block caches: a leaf named
    ``pos`` a host int32 vector, every other (``k``, ``v``, ``ssm``,
    ``conv``) a tensor on ``device``."""
    dev = resolve_device(device)

    def leaf(name: str, a):
        return np.array(a, np.int32) if name == "pos" \
            else _tensor(a).to(dev)
    n = len(_leaves(tree)[0])
    return [{sub: {name: leaf(name, a[i]) for name, a in c.items()}
             for sub, c in tree.items()} for i in range(n)]


def lm_cache_to_numpy(caches: list) -> dict:
    """The port's per-block caches -> the reference's stacked numpy
    layout."""
    return {sub: {name: np.stack([
        np.array(b[sub][name], np.int32) if name == "pos"
        else _numpy(b[sub][name]) for b in caches])
        for name in c} for sub, c in caches[0].items()}
