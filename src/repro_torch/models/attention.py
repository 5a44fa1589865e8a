"""GQA attention sublayer: projections + RoPE + cache management — the
port's copy of ``repro/models/attention.py``.

Prefill runs the blocked attention kernel, K4
(:func:`~repro_torch.kernels.attention_block.ops.flash_attention`),
causal over absolute positions from 0, with the config's window.
Decode writes the token's K and V into its cache slot (a ring of
``window`` slots for sliding-window archs) and runs K4 without a causal
mask over exactly the slots the reference's decode mask keeps
(:func:`kept_slots`): softmax does not depend on the keys' order, so
that is the reference's ``decode_attention``.  The cache's ``pos``
vector, shared by every batch row as in the reference, lives on the
host, so choosing the slots costs no device sync.  On a CPU tensor K4
runs its plain version; on a CUDA tensor it launches or raises.

``attn="plain"`` runs the reference's plain attentions instead
(:func:`~repro_torch.models.layers.attention_chunked`,
:func:`~repro_torch.models.layers.decode_attention`): the yardstick the
tests and the chip smoke hold the kernel path to.  ``tap``, where
given, is called with every K4 call's inputs and output.

The encoder-decoder family (:mod:`repro_torch.models.encdec`) adds two
kinds, both on K4 without a causal mask, as the reference runs them:

  * non-causal self-attention (the encoder): RoPE on q and k at
    ``pos``, every key kept;
  * cross-attention (``cross_kv``: the encoder's K and V with their
    positions): no RoPE on either side, every cross slot kept; at
    decode nothing is written to any cache.

Non-causal attention departs from the reference on purpose where its
chunked plain version pads the keys: the reference gives its pad keys
the position ``INT32_MAX`` and every query of a non-causal call the
same, so the zero pad keys pass its ``kpos <= qpos`` mask and dilute the
softmax whenever ``Skv`` is not a multiple of the chunk (whisper's 1500
frames at ``attn_chunk`` 1024: 548 zero keys a row).  K4 attends over
the real keys only, and so does ``attn="plain"`` here.  A non-causal
call under a window raises: there the reference's result depends on its
chunk padding.

On a mesh (:mod:`repro_torch.parallel`; ``n_heads`` and ``n_kv_heads``
are the model's padded counts, which split evenly over "model"):

  * prefill and training: ``wq``/``wk``/``wv`` are column shards, so
    each rank projects and attends over its own heads (query heads
    ``[r * H_l, (r + 1) * H_l)`` read kv heads ``[r * KV_l, ...)``, the
    same groups as the whole); ``wo`` is a row shard, its partial
    products summed over "model" (the boundaries of
    :func:`~repro_torch.models.layers.column_input` and ``row_output``,
    under autograd; K4's backward, ``attention_vjp``, stays on the
    rank's heads);
  * decode: the cache's slots are sharded over "model" (slot ``s``
    belongs to shard ``s // slots_local``), with every kv head; the new
    token's q, k and v are all-gathered over "model", the owner of slot
    ``cur_pos`` (``cur_pos % total`` in a window's ring) writes it, and
    each shard attends over the slots it keeps (K4 with its
    log-sum-exp, or the reference's ``decode_attention`` with ``axis``
    under ``attn="plain"``).  The shards' partials are merged with one
    all-reduce MAX and one all-reduce SUM over "model"
    (:func:`merge_shards`, the reference's ``pmax``/``psum``); a shard
    that keeps no slot launches nothing and adds nothing.  Where no
    shard keeps a slot, each runs K4 from a zero query over all its
    slots, and the merge gives the mean of V over every slot, the
    reference's result.  The cache's ``pos`` vector is kept whole on
    every rank (every rank writes the same positions), so which slots a
    shard keeps, and whether any shard keeps one, costs no collective;
  * cross-attention (whisper): the cross K/V are replicated, with every
    head; each rank attends with its own query heads over its kv heads.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.attention_block.ops import flash_attention
from repro_torch.models.layers import (apply_rope, attention_chunked,
                                       column_input, decode_attention,
                                       dense_init, row_output, row_parallel,
                                       split_keys)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import current_mesh, model_size

ATTN = ("kernel", "plain")
#: the query position of a non-causal plain call: past every real key,
#: short of the ``INT32_MAX`` the chunked attention gives its pad keys
NONCAUSAL_Q_POS = torch.iinfo(torch.int32).max - 1


def init_attention(key, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype):
    ks = split_keys(key, 4)
    return {
        "wq": dense_init(ks[0], (d_model, n_heads * head_dim), dtype),
        "wk": dense_init(ks[1], (d_model, n_kv_heads * head_dim), dtype),
        "wv": dense_init(ks[2], (d_model, n_kv_heads * head_dim), dtype),
        "wo": dense_init(ks[3], (n_heads * head_dim, d_model), dtype,
                         fan_in=n_heads * head_dim),
    }


def _project_qkv(params, h, n_heads, n_kv_heads, head_dim):
    b, s, _ = h.shape
    q = (h @ params["wq"]).reshape(b, s, n_heads, head_dim)
    k = (h @ params["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (h @ params["wv"]).reshape(b, s, n_kv_heads, head_dim)
    return q, k, v


def _check_attn(attn: str) -> None:
    if attn not in ATTN:
        raise ValueError(f"attn must be one of {ATTN}, got {attn!r}")


def attention_block(params, h, pos, cfg, n_heads, n_kv_heads, *,
                    cross_kv=None, causal=True, attn="kernel", tap=None,
                    sp: bool = False):
    """Prefill and training attention.  h: (B, S, d); pos: (S,) absolute
    positions, ``arange(S)`` (K4's causal mask counts from 0 on both
    sides).

    ``cross_kv``: ``(k, v, kv_pos)`` for encoder-decoder
    cross-attention, used as given (no RoPE; only q is projected).
    ``causal=False`` keeps every key.  ``sp``: ``h`` is this rank's
    (B, S / mp, d) sequence block (the rules' ``sp_rs``), gathered for
    the projections (the reference's ``sp_qkv``) and the output
    reduce-scattered back (its ``row_parallel_proj``).  Returns (out,
    (k, v)) so prefill can hand k/v to ``cache_from_prefill``.
    """
    _check_attn(attn)
    if not causal and cfg.window:
        raise ValueError(f"non-causal attention under a window "
                         f"({cfg.window}) is not defined: the reference's "
                         f"result depends on its chunk padding")
    hd = cfg.head_dim
    n_heads, n_kv_heads = _local_heads(n_heads, n_kv_heads)
    x = column_input(h, sp)
    b, s = x.shape[0], x.shape[1]
    if cross_kv is None:
        q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, hd)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        kv_pos = pos
    else:
        q = (x @ params["wq"]).reshape(b, s, n_heads, hd)
        k, v, kv_pos = cross_kv
    if attn == "plain":
        # INT32_MAX - 1, not the reference's INT32_MAX: the chunked
        # attention's pad keys sit at INT32_MAX and must stay masked
        q_pos = pos if causal else torch.full(
            (s,), NONCAUSAL_Q_POS, dtype=torch.int64, device=h.device)
        out = attention_chunked(q, k, v, q_pos, kv_pos, cfg.window,
                                cfg.attn_chunk)
    else:
        out = flash_attention(q, k, v, window=cfg.window, causal=causal)
        if tap is not None:
            tap(q, k, v, out, window=cfg.window, causal=causal)
    return row_output(out.reshape(b, s, n_heads * hd) @ params["wo"], sp), \
        (k, v)


def _local_heads(n_heads: int, n_kv_heads: int) -> tuple[int, int]:
    """This rank's query and kv head counts: the whole over "model"."""
    mp = model_size()
    if n_heads % mp or n_kv_heads % mp:
        raise ValueError(f"{n_heads} query and {n_kv_heads} kv heads do not "
                         f"split over {mp} model shards: build at tp={mp}")
    return n_heads // mp, n_kv_heads // mp


def gather_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H_l, hd) of this rank's heads -> (B, S, H, hd) of all."""
    return col.all_gather(t, "model", dim=2) if model_size() > 1 else t


def own_heads(t: torch.Tensor, n_local: int) -> torch.Tensor:
    """This rank's ``n_local`` heads of (B, S, H, hd)."""
    if model_size() == 1:
        return t
    r = col.axis_index("model")
    return t[:, :, r * n_local:(r + 1) * n_local]


def init_cache(batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
               window: int, dtype, *, device="cpu"):
    """Empty decode cache.  Ring-buffered to ``window`` slots for SWA;
    ``pos`` (-1 = empty) is a host ``numpy`` int32 vector.  On a mesh
    ``batch`` is this rank's rows, K and V hold its shard of the slots,
    and ``pos`` every slot's position."""
    slots = min(max_seq, window) if window else max_seq
    local = _local_slots(slots)
    return {
        "k": torch.zeros((batch, local, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, local, n_kv_heads, head_dim), dtype=dtype,
                         device=device),
        "pos": np.full((slots,), -1, np.int32),
    }


def _local_slots(slots: int) -> int:
    mp = model_size()
    if slots % mp:
        raise ValueError(f"{slots} cache slots do not split over {mp} "
                         f"model shards")
    return slots // mp


def prefill_cache(k, v, pos, max_seq: int, window: int):
    """The decode cache of a prefill's K and V (B, S, KV_l, hd) of this
    rank's kv heads: :func:`cache_from_prefill` of every head
    (all-gathered over "model"), of which this rank keeps its shard of
    the slots (and every slot's position)."""
    mp = model_size()
    cache = cache_from_prefill(gather_heads(k), gather_heads(v), pos,
                               max_seq, window)
    if mp > 1:
        local = cache["k"].shape[1] // mp
        r = col.axis_index("model")
        for name in ("k", "v"):
            cache[name] = cache[name][:, r * local:(r + 1) * local].clone()
    return cache


def cache_from_prefill(k, v, pos, max_seq: int, window: int):
    """Scatter prefilled K/V into a fresh cache of every slot
    (ring-aware).  ``pos`` are the prefill's absolute positions, on the
    host; as the reference's scatter does, a position past the last
    slot (no window) is dropped."""
    b, s, kvh, hd = k.shape
    slots = min(max_seq, window) if window else max_seq
    take = min(s, slots)
    p_t = np.asarray(pos, np.int32)[-take:]
    idx = p_t % slots if window else p_t
    keep = np.flatnonzero(idx < slots)
    cache = {name: k.new_zeros((b, slots, kvh, hd)) for name in ("k", "v")}
    cache["pos"] = np.full((slots,), -1, np.int32)
    dst = torch.as_tensor(idx[keep], device=k.device)
    src = torch.as_tensor(keep + (s - take), device=k.device)
    cache["k"][:, dst] = k[:, src].to(cache["k"].dtype)
    cache["v"][:, dst] = v[:, src].to(cache["v"].dtype)
    cache["pos"][idx[keep]] = p_t[keep]
    return cache


def kept_slots(pos, cur_pos: int, window: int) -> np.ndarray:
    """The cache slots the reference's decode mask keeps for a token at
    ``cur_pos``: ``0 <= pos <= cur_pos`` and, under a window,
    ``pos > cur_pos - window``; ascending."""
    pos = np.asarray(pos)
    keep = (pos >= 0) & (pos <= cur_pos)
    if window:
        keep &= pos > cur_pos - window
    return np.flatnonzero(keep)


def _gather(c: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """The slots ``idx`` of cache tensor ``c`` (B, slots, KV, hd): a
    slice when they are a prefix, else an ``index_select``."""
    n = len(idx)
    if n and idx[-1] == n - 1:
        return c[:, :n]
    return c.index_select(1, torch.as_tensor(idx, device=c.device))


def _decode_local(q, new_k, new_v, cache, cur_pos: int, window: int,
                  chunk: int, attn: str, tap):
    """Write the token into its slot, attend: the reference's
    ``_decode_local``.  The slot is ``cur_pos``, or ``cur_pos % total``
    in a ring under a window (``total`` slots over every shard); its
    owner, shard ``slot // slots_local``, writes it in place.  Past the
    last slot (no window) no shard owns it and nothing is written, as in
    the reference.  Where the mask keeps no slot, the reference's scores
    are all -1e30 and its softmax uniform: K4 gets the same from a zero
    query over every slot.  On a mesh (q, k and v of every head) the
    shards attend over their own slots and :func:`merge_shards` joins
    them."""
    mesh = current_mesh()
    local = cache["k"].shape[1]
    mp = model_size()
    r = col.axis_index("model") if mp > 1 else 0
    total = local * mp
    slot = cur_pos % total if window else cur_pos
    if 0 <= slot < total:
        if slot // local == r:
            cache["k"][:, slot - r * local] = new_k[:, 0].to(
                cache["k"].dtype)
            cache["v"][:, slot - r * local] = new_v[:, 0].to(
                cache["v"].dtype)
        cache["pos"][slot] = cur_pos
    pos_local = cache["pos"][r * local:(r + 1) * local]
    if attn == "plain":
        return decode_attention(q, cache["k"], cache["v"], pos_local,
                                cur_pos, window=window, chunk=chunk,
                                axis="model" if mp > 1 else None)
    if not len(kept_slots(cache["pos"], cur_pos, window)):
        q, idx = torch.zeros_like(q), np.arange(local)
    else:
        idx = kept_slots(pos_local, cur_pos, window)
    if not len(idx):
        # a shard that keeps no slot launches nothing and adds nothing
        b, _, h, hd = q.shape
        return merge_shards(q.new_zeros((b, 1, h, hd)),
                            torch.full((b, 1, h), -torch.inf,
                                       device=q.device)).to(q.dtype)
    k_sel = _gather(cache["k"], idx).to(q.dtype)
    v_sel = _gather(cache["v"], idx).to(q.dtype)
    out = flash_attention(q, k_sel, v_sel, window=0, causal=False,
                          return_lse=mesh is not None)
    if mesh is not None:
        out, lse = out
    if tap is not None:
        tap(q, k_sel, v_sel, out, window=0, causal=False)
    if mesh is None:
        return out
    return merge_shards(out, lse.transpose(1, 2)).to(q.dtype)


def merge_shards(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The attention over every shard's keys from this shard's ``out``
    (B, Sq, H, hd) and row log-sum-exp ``lse`` (B, Sq, H), in f32: the
    weights ``exp(lse - max)`` through one all-reduce MAX over "model"
    and the weighted outputs and weights through one all-reduce SUM
    (:func:`~repro_torch.kernels.attention_block.ops.combine_partials`
    with the shard dim across ranks).  Some shard keeps a key of every
    row."""
    m = col.pmax(lse, "model")
    w = torch.exp(lse - m)[..., None]
    both = col.psum(torch.cat([w * out.to(torch.float32), w], dim=-1),
                    "model")
    return both[..., :-1] / both[..., -1:]


def decode_block(params, h, cache, cur_pos, cfg, n_heads, n_kv_heads, *,
                 cross_kv=None, attn="kernel", tap=None):
    """One-token decode.  h: (B, 1, d).  Writes the token's K/V and
    position into ``cache`` in place (the reference's server donates
    its cache) and returns (out, cache).

    ``cross_kv``: ``(k, v, kv_pos)``, the static cross-attention cache:
    only q is projected, without RoPE, and attends over every cross
    slot; ``cache`` is returned untouched."""
    _check_attn(attn)
    hd = cfg.head_dim
    b = h.shape[0]
    cur = int(cur_pos)
    nh_l, nkv_l = _local_heads(n_heads, n_kv_heads)
    if cross_kv is not None:
        q = (h @ params["wq"]).reshape(b, 1, nh_l, hd)
        ck, cv, cpos = cross_kv
        ck, cv = own_heads(ck, nkv_l), own_heads(cv, nkv_l)
        if attn == "plain":
            out = decode_attention(q, ck, cv, cpos,
                                   torch.iinfo(torch.int32).max, window=0,
                                   chunk=cfg.attn_chunk)
        else:
            out = flash_attention(q, ck, cv, window=0, causal=False)
            if tap is not None:
                tap(q, ck, cv, out, window=0, causal=False)
        return row_parallel(out.reshape(b, 1, nh_l * hd), params["wo"]), \
            cache
    q, k, v = _project_qkv(params, h, nh_l, nkv_l, hd)
    q = apply_rope(q, cur, cfg.rope_theta)
    k = apply_rope(k, cur, cfg.rope_theta)
    out = _decode_local(gather_heads(q), gather_heads(k), gather_heads(v),
                        cache, cur, cfg.window, cfg.attn_chunk, attn, tap)
    return row_parallel(own_heads(out, nh_l).reshape(b, 1, nh_l * hd),
                        params["wo"]), cache
