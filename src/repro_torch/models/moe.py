"""Mixture-of-Experts FFN with expert parallelism — the port's copy of
``repro/models/moe.py``.  Three modes, one set of weights:

  * ``dense`` — no mesh: every expert computed over its bins on one
    rank (below);
  * ``a2a``   — prefill and training on a mesh (:func:`moe_ffn_a2a`):
    this rank's tokens dispatched into fixed-capacity bins, exchanged
    with one all-to-all over "model", run through this rank's expert
    slice, and returned by a second all-to-all;
  * ``psum``  — decode on a mesh (:func:`moe_ffn_psum`): the tokens
    whole on every model rank, each rank's expert slice computed densely
    for all of them and the partials summed over "model";
    :func:`moe_ffn_psum_ep2` is its two-axis form for the serving layout
    whose experts lie over ("model", "data") jointly.

Each is the body of the reference's ``shard_map`` on this rank's blocks,
with its collectives from :mod:`repro_torch.parallel.collectives`.  When
there are fewer experts than model shards, each expert is split over
``tpe = mp // E`` shards (its f dim) and the dispatch repeats its bin to
all of them; under ``fsdp`` the f dim is sharded over "data" too and
gathered at use.  The expert products stay ``torch.bmm``: the reference
computes them outside any kernel.

Tokens are routed to their ``top_k`` experts (ties toward the lower
expert, as ``jax.lax.top_k`` breaks them), sort-dispatched into
fixed-capacity bins (a stable sort by expert; a (token, choice) pair
ranked ``>= capacity`` within its expert is dropped into one extra,
discarded row), every expert's SwiGLU runs over its whole bin (empty
rows are zeros and are multiplied too, as the reference computes), and
the outputs are gathered back per (token, choice), weighted by the
gates and summed over the choices.  Every shape is known on the host:
nothing here waits on the device.  In dense mode the routing and
dispatch run in a ``moe_dispatch`` profiler range and the combine in
``moe_combine`` (a profile splits a step by them; the ranges cover
the forward and a remat recompute, not the autograd backward).

"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import dense_init, gather_weight, split_keys
from repro_torch.parallel import collectives as col


def init_moe(key, d_model: int, d_ff: int, n_experts: int, dtype,
             tpe: int = 1):
    """Weights: router (d, E), always f32; experts stored pre-split for
    EP x TP: wi/wg (E*tpe, d, f/tpe), wo (E*tpe, f/tpe, d).

    Each is drawn at 1/sqrt(its input width): d for wg/wi, d_ff for wo.
    The reference passes the fan-in for wo only, so its wg/wi take
    ``dense_init``'s default ``shape[0]``, the expert count, and come
    out sqrt(d / E) times as large (22.6x at mixtral's widths)."""
    ks = split_keys(key, 4)
    f_l = d_ff // tpe
    e_rows = n_experts * tpe
    return {
        "router": dense_init(ks[0], (d_model, n_experts), torch.float32),
        "wg": dense_init(ks[1], (e_rows, d_model, f_l), dtype,
                         fan_in=d_model),
        "wi": dense_init(ks[2], (e_rows, d_model, f_l), dtype,
                         fan_in=d_model),
        "wo": dense_init(ks[3], (e_rows, f_l, d_model), dtype,
                         fan_in=d_ff),
    }


def router_top_k(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Returns (gates (T, k) f32 normalized, idx (T, k) int64): the k
    largest probabilities in descending order, a tie to the lower
    expert (a stable sort, where ``torch.topk`` promises no order)."""
    logits = x.to(torch.float32) @ router
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def bin_capacity(t: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Rows of each expert's bin for ``t`` tokens (host arithmetic)."""
    return max(1, int(math.ceil(t * top_k / n_experts * capacity_factor)))


def _expert_ffn(toks, wg, wi, wo):
    """toks (E_l, C, d) x per-expert SwiGLU -> (E_l, C, d)."""
    h = F.silu(torch.bmm(toks, wg)) * torch.bmm(toks, wi)
    return torch.bmm(h, wo)


def moe_dispatch_local(x, gates, idx, n_experts: int, capacity: int):
    """Sort-based fixed-capacity dispatch of local tokens.

    Returns (bins (E, C, d), slot (T*k,)) where ``slot`` maps each
    (token, choice) to its bin row (E*C = dropped)."""
    t, d = x.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    # rank within the expert: position in the sorted list less the
    # position of the expert's first pair
    rank = torch.arange(t * k, device=x.device) - torch.searchsorted(se, se)
    slot_sorted = torch.where(rank < capacity, se * capacity + rank,
                              n_experts * capacity)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    tok_of_flat = torch.arange(t * k, device=x.device) // k
    # every dropped pair lands in the extra last row, which is discarded
    bins = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype,
                       device=x.device)
    bins[slot] = x[tok_of_flat]
    return bins[:-1].reshape(n_experts, capacity, d), slot


def moe_combine_local(ret_bins, slot, gates, t: int, k: int):
    """Gather expert outputs back per (token, choice), weight, sum."""
    e_c, d = ret_bins.shape[0] * ret_bins.shape[1], ret_bins.shape[2]
    flat = torch.cat([ret_bins.reshape(e_c, d),
                      ret_bins.new_zeros((1, d))], dim=0)
    per_choice = flat[slot]                         # dropped -> zeros
    w = gates.reshape(t * k).to(per_choice.dtype)
    return (per_choice * w[:, None]).reshape(t, k, d).sum(dim=1)


def moe_ffn_dense(x, params, top_k: int, capacity_factor: float):
    """Reference mode (no mesh): dense compute of all experts."""
    t, d = x.shape
    e_rows = params["wg"].shape[0]
    n_experts = params["router"].shape[1]
    tpe = e_rows // n_experts
    with record_function("moe_dispatch"):
        gates, idx = router_top_k(x, params["router"], top_k)
        cap = bin_capacity(t, top_k, n_experts, capacity_factor)
        bins, slot = moe_dispatch_local(x, gates, idx, n_experts, cap)
    if tpe == 1:
        ret = _expert_ffn(bins, params["wg"], params["wi"], params["wo"])
    else:
        rep = torch.repeat_interleave(bins, tpe, dim=0)   # (E*tpe, C, d)
        part = _expert_ffn(rep, params["wg"], params["wi"], params["wo"])
        ret = part.reshape(n_experts, tpe, cap, d).sum(dim=1)
    with record_function("moe_combine"):
        return moe_combine_local(ret, slot, gates, t, top_k)


def _one_row(n_experts: int, tpe: int, mp: int) -> None:
    if n_experts * tpe != mp:
        raise ValueError(f"{n_experts} experts x {tpe} slices must equal "
                         f"the {mp} model shards (one expert row a rank)")


def gather_data(params, data_axis: str | None):
    """The expert weights with their f dim whole over ``data_axis``
    (ZeRO-3 gathered at use; under autograd their cotangents come back
    reduce-scattered, :func:`~repro_torch.models.layers.gather_weight`)."""
    wg, wi, wo = params["wg"], params["wi"], params["wo"]
    if data_axis is not None:
        wg = gather_weight(wg, data_axis, dim=2)
        wi = gather_weight(wi, data_axis, dim=2)
        wo = gather_weight(wo, data_axis, dim=1)
    return wg, wi, wo


def moe_ffn_a2a(x, params, top_k: int, capacity_factor: float,
                model_axis: str, data_axis: str | None):
    """x (T_local, d), this rank's tokens; the expert weights this rank's
    row (E * tpe rows over the model shards).  Dispatch -> all-to-all ->
    the local expert slice -> all-to-all -> combine.

    Under autograd the all-to-alls carry the cotangents back the same
    way; the routing indices carry none, the gates do.  The router,
    replicated, routes only this rank's tokens, so its cotangent is
    summed over ``model_axis`` (the transpose of the reference's
    ``shard_map`` over a replicated input)."""
    t, d = x.shape
    mp = col.axis_size(model_axis)
    n_experts = params["router"].shape[1]
    tpe = max(1, mp // n_experts)
    _one_row(n_experts, tpe, mp)
    wg, wi, wo = gather_data(params, data_axis)
    router = col.psum_grad(params["router"], model_axis)
    gates, idx = router_top_k(x, router, top_k)
    cap = bin_capacity(t, top_k, n_experts, capacity_factor)
    bins, slot = moe_dispatch_local(x, gates, idx, n_experts, cap)
    send = torch.repeat_interleave(bins, tpe, dim=0)      # (mp, C, d)
    # recv: (mp, C, d), the tokens for this rank's expert slice from
    # every source
    recv = col.all_to_all(send, model_axis)
    out = _expert_ffn(recv.reshape(1, mp * cap, d), wg, wi, wo)
    # ret: (mp, C, d), per (expert, slice) partials for this rank's tokens
    ret = col.all_to_all(out.reshape(mp, cap, d), model_axis)
    ret = ret.reshape(n_experts, tpe, cap, d).sum(dim=1)
    return moe_combine_local(ret, slot, gates, t, top_k)


def moe_ffn_psum(x, params, top_k: int, model_axis: str,
                 data_axis: str | None):
    """Decode: x (T, d) whole on every model rank; each rank computes its
    expert slice densely for all T tokens, weighted by the tokens' gates
    for its expert, and the partials are summed over ``model_axis``."""
    mp = col.axis_size(model_axis)
    n_experts = params["router"].shape[1]
    tpe = max(1, mp // n_experts)
    _one_row(n_experts, tpe, mp)
    wg, wi, wo = gather_data(params, data_axis)
    my_expert = col.axis_index(model_axis) // tpe
    gates, idx = router_top_k(x, params["router"], top_k)
    # the weight of this rank's expert for each token (0 if not routed)
    w_tok = ((idx == my_expert).to(torch.float32) * gates).sum(dim=1)
    out = _expert_ffn(x[None], wg, wi, wo)[0]
    out = out * w_tok[:, None].to(out.dtype)
    return col.psum(out, model_axis)


def moe_ffn_psum_ep2(x, params, top_k: int, axes: tuple,
                     batch_axis: str | None):
    """Two-axis expert parallelism for serving (no weight gathers): the
    expert weights (E * tpe2, d, f/tpe2) lie over ``axes`` =
    ("model", "data") jointly, one (expert, f slice) pair a rank.  The
    batch-sharded tokens are all-gathered over ``batch_axis``, this
    rank's slice computed for every token routed to its expert, the
    partials summed over both axes, and this rank's rows kept."""
    t_local, d = x.shape
    if batch_axis is not None:
        xg = col.all_gather(x, batch_axis, dim=0)
        my_rows = col.axis_index(batch_axis)
    else:
        xg, my_rows = x, 0
    n_experts = params["router"].shape[1]
    tpe2 = max(1, col.axis_size(axes) // n_experts)
    my_expert = col.axis_index(axes) // tpe2
    gates, idx = router_top_k(xg, params["router"], top_k)
    w_tok = ((idx == my_expert).to(torch.float32) * gates).sum(dim=1)
    out = _expert_ffn(xg[None], params["wg"], params["wi"],
                      params["wo"])[0]
    out = col.psum(out * w_tok[:, None].to(out.dtype), axes)
    if batch_axis is not None:
        out = out[my_rows * t_local:(my_rows + 1) * t_local]
    return out
