"""Mixture-of-Experts FFN — the port's copy of ``repro/models/moe.py`` in
its ``dense`` mode (no mesh, tp = 1).

Tokens are routed to their ``top_k`` experts (ties toward the lower
expert, as ``jax.lax.top_k`` breaks them), sort-dispatched into
fixed-capacity bins (a stable sort by expert; a (token, choice) pair
ranked ``>= capacity`` within its expert is dropped into one extra,
discarded row), every expert's SwiGLU runs over its whole bin (empty
rows are zeros and are multiplied too, as the reference computes), and
the outputs are gathered back per (token, choice), weighted by the
gates and summed over the choices.  Every shape is known on the host:
nothing here waits on the device.

The mesh modes (``a2a``, ``psum``, ``psum_ep2``) wait for the port's
``parallel/`` and raise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, split_keys

_MESH = ("the mesh modes of the MoE FFN wait for the port's parallel/: "
         "ROADMAP.md §1 item 6")


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
    gates, idx = router_top_k(x, params["router"], top_k)
    cap = bin_capacity(t, top_k, n_experts, capacity_factor)
    bins, slot = moe_dispatch_local(x, gates, idx, n_experts, cap)
    if tpe == 1:
        ret = _expert_ffn(bins, params["wg"], params["wi"], params["wo"])
    else:
        rep = torch.repeat_interleave(bins, tpe, dim=0)   # (E*tpe, C, d)
        part = _expert_ffn(rep, params["wg"], params["wi"], params["wo"])
        ret = part.reshape(n_experts, tpe, cap, d).sum(dim=1)
    return moe_combine_local(ret, slot, gates, t, top_k)


def moe_ffn_a2a(*_args, **_kw):
    raise NotImplementedError(f"moe_ffn_a2a: {_MESH}")


def moe_ffn_psum(*_args, **_kw):
    raise NotImplementedError(f"moe_ffn_psum: {_MESH}")


def moe_ffn_psum_ep2(*_args, **_kw):
    raise NotImplementedError(f"moe_ffn_psum_ep2: {_MESH}")
