"""Parameters of the reference package as the port's tensors, and back.

The reference's CNN params are a ``{"convs": [{"w", "b"}], "head"}``
pytree; handed over as numpy arrays (``numpy.asarray`` of each leaf),
:func:`params_from_numpy` turns them into the port's dict of tensors,
and :func:`params_to_numpy` turns the port's params (or gradients of
the same shape) into numpy arrays leaf by leaf.
Layouts are kept — HWIO weights stay HWIO, the ``(Co,)`` bias and the
``(C, n_classes)`` head as they are — so both packages compute on
identical weights.

The reference's LM params and decode caches go to the port's per-layer
lists and back through :func:`lm_params_from_numpy` /
:func:`lm_params_to_numpy` and :func:`lm_cache_from_numpy` /
:func:`lm_cache_to_numpy`, bit for bit in both types (a bfloat16 leaf
comes back as numpy's bfloat16 of ``ml_dtypes``), for both LM families:

  * decoder-only: params ``{"embed", "blocks", "final_ln",
    ["lm_head"]}``, ``blocks`` a pytree whose every leaf is stacked on a
    leading block axis; caches ``{"sub0": {"k", "v", "pos"}}`` for an
    attention sublayer, ``{"ssm", "conv"}`` for a Mamba one, stacked
    likewise;
  * encoder-decoder: params ``{"embed", "enc_blocks", "dec_blocks",
    "enc_ln", "final_ln"}``, both block stacks stacked; caches
    ``{"self": {"k", "v", "pos"}, "cross_k", "cross_v"}``, the cross
    leaves at the top of the tree.

Every params key that ends in ``blocks`` is a stack of layers; a
cache's ``pos`` stays a host numpy vector.  Params at any ``tp`` (the
reference's padded heads, vocabulary and expert slices) go across as
they are; with a ``mesh``, :func:`lm_params_from_numpy` and
:func:`lm_cache_from_numpy` keep this rank's blocks
(:func:`~repro_torch.parallel.sharding.shard_params`,
:func:`~repro_torch.parallel.sharding.shard_cache`).

A training state goes across through :func:`train_state_from_numpy`
and back through :func:`train_state_to_numpy`: the params and the AdamW
moments ``m`` and ``v`` (trees of the params' structure) as above, the
optimizer's and the state's ``step`` as 0-d int32 tensors on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exec_target import resolve_device
from repro_torch.tree import leaves, tree_map


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


def _unstack(tree, fn) -> list:
    """A tree stacked on a leading block axis -> one tree per block, each
    leaf's slice through ``fn``."""
    n = len(leaves(tree)[0])
    return [tree_map(lambda a, i=i: fn(a[i]), tree) for i in range(n)]


def _stack(trees: list, fn):
    """Per-block trees -> one tree of ``fn``-converted leaves stacked on
    a leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], fn) for k in trees[0]}
    return np.stack([fn(t) for t in trees])


def _is_stack(key: str) -> bool:
    """A params key that holds a stack of layers."""
    return key.endswith("blocks")


def lm_params_from_numpy(tree: dict, device="cuda", *, mesh=None,
                         fsdp: bool = True,
                         moe_ep_data: bool = False) -> dict:
    """The reference's LM params as numpy leaves -> the port's: each
    leaf a tensor of its type on ``device``, each stack of layers
    (``blocks``; ``enc_blocks``, ``dec_blocks``) split into a list of
    per-layer dicts; with ``mesh``, this rank's blocks of them."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return _tensor(a).to(dev)
    params = {k: _unstack(v, t) if _is_stack(k) else t(v)
              for k, v in tree.items()}
    if mesh is None:
        return params
    from repro_torch.parallel.sharding import shard_params
    return shard_params(params, mesh, fsdp=fsdp, moe_ep_data=moe_ep_data)


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM params -> the reference's layout of numpy arrays
    (layers stacked), bit for bit."""
    return {k: _stack(v, _numpy) if _is_stack(k) else _numpy(v)
            for k, v in params.items()}


def lm_cache_from_numpy(tree: dict, device="cuda", *, mesh=None,
                        rules: dict | None = None) -> list:
    """The reference's stacked decode caches as numpy leaves (``{sub:
    {name: array}}``, or the encoder-decoder's, which also holds
    ``cross_k``/``cross_v`` arrays at its top) -> the port's list of
    per-layer caches: a leaf named ``pos`` a host int32 vector, every
    other (``k``, ``v``, ``ssm``, ``conv``, ``cross_k``, ``cross_v``) a
    tensor on ``device``; with ``mesh`` (and its ``rules``), this
    rank's blocks of them."""
    dev = resolve_device(device)

    def leaf(name: str, a):
        return np.array(a, np.int32) if name == "pos" \
            else _tensor(a).to(dev)
    n = len(leaves(tree)[0])
    caches = [{sub: {name: leaf(name, a[i]) for name, a in c.items()}
               if isinstance(c, dict) else leaf(sub, c[i])
               for sub, c in tree.items()} for i in range(n)]
    if mesh is None:
        return caches
    from repro_torch.parallel.sharding import shard_cache
    return shard_cache(caches, mesh, rules)


def lm_cache_to_numpy(caches: list) -> dict:
    """The port's per-layer caches -> the reference's stacked numpy
    layout."""
    def stack(name: str, xs: list) -> np.ndarray:
        return np.stack([np.array(x, np.int32) if name == "pos"
                         else _numpy(x) for x in xs])
    return {sub: {name: stack(name, [b[sub][name] for b in caches])
                  for name in c} if isinstance(c, dict)
            else stack(sub, [b[sub] for b in caches])
            for sub, c in caches[0].items()}


def train_state_from_numpy(state, device="cuda"):
    """The reference's ``TrainState`` with numpy leaves (``params``,
    ``opt.m``, ``opt.v``, ``opt.step``, ``step``, read as attributes)
    -> the port's :class:`~repro_torch.launch.steps.TrainState`."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import AdamWState

    def step(a) -> torch.Tensor:
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32)
    return TrainState(
        params=lm_params_from_numpy(state.params, device),
        opt=AdamWState(m=lm_params_from_numpy(state.opt.m, device),
                       v=lm_params_from_numpy(state.opt.v, device),
                       step=step(state.opt.step)),
        step=step(state.step))


def train_state_to_numpy(state) -> dict:
    """The port's ``TrainState`` -> ``{"params", "m", "v", "opt_step",
    "step"}`` in the reference's layout (layers stacked), bit for bit."""
    return {"params": lm_params_to_numpy(state.params),
            "m": lm_params_to_numpy(state.opt.m),
            "v": lm_params_to_numpy(state.opt.v),
            "opt_step": np.int32(int(state.opt.step)),
            "step": np.int32(int(state.step))}
