"""Shared transformer building blocks — the port's copy of
``repro/models/layers.py``.

Norms, RoPE, the SwiGLU MLP (the reference's ``sp_ffn`` with ``sp``),
the parameter-init helpers, the mesh's column- and row-parallel
boundaries (with the reference's ``use_sp_rs``) and three attentions:

  * ``attention_naive``   — the O(S^2) oracle (:func:`~repro_torch.
    kernels.attention_block.ref.attention_ref` reads it);
  * ``attention_chunked`` — the double-chunked online softmax over
    absolute positions;
  * ``decode_attention``  — one token against a cache whose slots carry
    absolute positions (-1 = empty); with ``axis`` the slots are this
    rank's shard of the cache and the shards' partial ``(acc, m, l)``
    are merged by a ``pmax`` and two ``psum`` over the axis
    (flash-decoding, the reference's combine).

On a mesh (:mod:`repro_torch.parallel`) the residual stream's rows are
sharded over the batch axes.  A column-parallel weight
(``wq``/``wk``/``wv``/``wg``/``wi``) holds this rank's output columns,
a row-parallel one (``wo``) its input rows.  Between sublayers the
residual is whole on every model rank, as the port serves; under the
rules' ``sp_rs`` (:func:`use_sp_rs`: the reference's explicit
sequence-parallel boundaries) a training stack keeps it
sequence-sharded over "model" instead, as the reference lays it out.
The boundaries, under autograd (:mod:`repro_torch.parallel.
collectives`):

  * entering a column-parallel projection (:func:`column_input`): a
    whole residual passes as it is and its cotangent is summed over
    "model" on the way back (Megatron's "f"); a sequence-sharded one
    is all-gathered over the sequence, its cotangent reduce-scattered
    (the gather of the reference's ``sp_qkv`` and ``sp_ffn``);
  * leaving a row-parallel one (:func:`row_output`): the partial
    products summed over "model" with an identity backward ("g"), or
    reduce-scattered onto the sequence (the reference's
    ``row_parallel_proj``);
  * a replicated norm weight applied to sequence-sharded rows
    (:func:`norm`) has its cotangent summed over "model", as the
    reference's ``shard_map`` sums that of a replicated input.

Under the rules' ``fsdp`` each block's weights are sharded over "data"
as well and :func:`fsdp_gather` all-gathers them as the block runs
(the reference's GSPMD gathers them at use); their cotangents come
back reduce-scattered over "data".

The last two attentions are plain versions that the tests hold against
the reference's.  The model path never calls them on the card: it runs
the attention kernel (``flash_attention``, K4) in
:mod:`repro_torch.models.attention`, and only a caller that asks for
``attn="plain"`` gets them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import (current_flag, current_fsdp,
                                       current_mesh, current_rules,
                                       model_size)


# --------------------------------------------------------------------------
# norms / positional / MLP
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, pos, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); pos: (S,) or a scalar position index (a
    Python ``int`` costs no host-to-device copy)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    if isinstance(pos, int):
        angles = freqs * float(pos)
    else:
        angles = torch.as_tensor(pos, dtype=torch.float32,
                                 device=x.device)[..., None] * freqs
    cos = torch.cos(angles)[..., None, :]                 # (S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def use_sp_rs(seq_len: int) -> bool:
    """Are the rules' explicit sequence-parallel boundaries on and
    applicable to a ``seq_len``-token stack (the reference's test)?"""
    mesh = current_mesh()
    if mesh is None or not current_flag("sp_rs"):
        return False
    mp = mesh.shape.get("model", 1)
    return mp > 1 and seq_len % mp == 0 and seq_len >= mp


def column_input(x: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """``x`` (B, S, d), whole on every model rank, or with ``sp`` its
    (B, S / mp, d) sequence block, as a column-parallel projection
    takes it: whole.  Backward, the cotangent summed over "model", or
    with ``sp`` reduce-scattered onto the sequence."""
    if model_size() == 1:
        return x
    if sp:
        return col.all_gather(x, "model", dim=1)
    return col.psum_grad(x, "model")


def row_output(part: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """The partial products of a row-parallel projection summed over
    "model" (identity backward), or with ``sp`` reduce-scattered onto
    the sequence (all-gathered backward)."""
    if current_mesh() is None:
        return part
    if sp:
        return col.psum_scatter(part, "model", dim=1)
    return col.psum(part, "model")


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of a row-parallel ``w`` (this rank's input rows): the
    partial products summed over "model" (nothing without a mesh)."""
    return row_output(x @ w)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, sp: bool = False) -> torch.Tensor:
    """SwiGLU MLP; on a mesh ``w_gate``/``w_up`` are column shards and
    ``w_down`` a row shard (the hidden activations sharded over
    "model"); with ``sp`` the reference's ``sp_ffn``: one all-gather of
    the sequence, the three local products, one reduce-scatter back."""
    x = column_input(x, sp)
    return row_output((F.silu(x @ w_gate) * (x @ w_up)) @ w_down, sp)


def norm(x: torch.Tensor, w: torch.Tensor, eps: float,
         sp: bool = False) -> torch.Tensor:
    """:func:`rms_norm`; with ``sp`` (``x`` this rank's sequence block)
    the replicated weight's cotangent summed over "model"."""
    if sp:
        w = col.psum_grad(w, "model")
    return rms_norm(x, w, eps)


def batch_axes() -> tuple[str, ...]:
    """The current rules' batch axes (none without a mesh)."""
    if current_mesh() is None:
        return ()
    return tuple((current_rules() or {}).get("batch") or ())


def gather_weight(w: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """A weight block all-gathered whole over ``axis`` (ZeRO-3 at use).
    Its cotangent is reduce-scattered back where the batch rows are
    split over ``axis`` (each rank's use of it is a partial), and
    sliced where they are not (each rank's is whole)."""
    return col.all_gather(w, axis, dim, whole_grad=axis not in batch_axes())


def fsdp_gather(tree, path: tuple):
    """A block's weights whole over "data": every leaf that
    :func:`~repro_torch.parallel.sharding.leaf_spec` shards over "data"
    (the rules' ``fsdp``) all-gathered on that dim
    (:func:`gather_weight`); ``path`` is the block's path from the
    params' root.  MoE expert weights are left sharded: the MoE modes
    gather them themselves, as the reference's bodies do.  Without a
    mesh, a "data" axis of size 1 or ``fsdp`` off, ``tree`` itself."""
    from repro_torch.parallel.sharding import leaf_spec
    mesh = current_mesh()
    if mesh is None or mesh.shape.get("data", 1) == 1 or not current_fsdp():
        return tree

    def walk(node, p):
        if isinstance(node, dict):
            return {k: walk(v, p + (k,)) for k, v in node.items()}
        if not isinstance(node, torch.Tensor) or "moe" in p:
            return node
        for dim, entry in enumerate(leaf_spec(p, node)):
            if entry == "data":
                return gather_weight(node, "data", dim)
        return node
    return walk(tree, tuple(path))


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _gqa_scores_scale(head_dim: int) -> float:
    return 1.0 / math.sqrt(head_dim)


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*groups, hd)."""
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, kv * groups, hd)


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor,
                    window: int = 0) -> torch.Tensor:
    """Reference O(S^2) causal (optionally sliding-window) attention.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); positions are absolute.
    A row with no unmasked key is NaN (it is masked with ``-inf``)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * _gqa_scores_scale(hd)
    mask = kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > (q_pos[:, None] - window)
    scores = scores.masked_fill(~mask[None, None, None], -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _online_update(carry, scores, v_chunk):
    """One online-softmax step: fold a (…, Ck) score panel and its
    (…, Ck, hd) value panel into the running (acc, m, l) accumulator."""
    acc, m, l = carry
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("...qs,...sh->...qh", p,
                                                v_chunk)
    return acc, m_new, l


def _pad_pos(pos, pad: int, value: int, device) -> torch.Tensor:
    """Positions (any device, numpy too) as int64 on ``device``, with
    ``pad`` more of ``value``."""
    pos = torch.as_tensor(pos, device=device).to(torch.int64)
    return torch.cat([pos, torch.full((pad,), value, dtype=torch.int64,
                                      device=device)])


def _chunk_pairs(q_pos, kv_pos, cq: int, ck: int, nq: int, nk: int,
                 window: int) -> np.ndarray:
    """Which (query chunk, key chunk) pairs :func:`attention_chunked`
    must run, (nq, nk) bool.  A pair whose every score is masked (its
    keys all past its last query, or all at or before its first query's
    window) adds exactly 0 to a row that keeps some key elsewhere: a
    later real maximum scales what it added by exp(-1e30 - m) = 0, and
    after one its weights are exp(-1e30 - m) = 0.  So where every query
    row keeps some key (the positions read on the host, the keys'
    ascending), those pairs are skipped and the result is the same to
    the bit; otherwise every pair runs."""
    run = np.ones((nq, nk), bool)
    qh = torch.as_tensor(q_pos).to("cpu", torch.int64).numpy()
    kh = torch.as_tensor(kv_pos).to("cpu", torch.int64).numpy()
    if not len(kh) or np.any(np.diff(kh) < 0):
        return run
    hi = np.searchsorted(kh, qh, side="right")
    lo = np.searchsorted(kh, qh - window, side="right") if window else 0
    if not np.all(hi > lo):
        return run
    for i in range(nq):
        qi = qh[i * cq:(i + 1) * cq]
        for j in range(nk):
            kj = kh[j * ck:(j + 1) * ck]
            run[i, j] = len(kj) > 0 and kj.min() <= qi.max() and not (
                window and kj.max() <= qi.min() - window)
    return run


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, kv_pos: torch.Tensor,
                      window: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Double-chunked online-softmax attention: query chunks outer, KV
    chunks inner with the (acc, m, l) accumulator resident; a masked
    score is -1e30.  q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd).  Chunk
    pairs that no mask leaves a score in are skipped where that changes
    no bit (:func:`_chunk_pairs`): a causal prefill of S tokens runs
    about half its pairs, one under a window W about W / S of them."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    cq, ck = min(chunk, sq), min(chunk, skv)
    nq, nk = -(-sq // cq), -(-skv // ck)
    pad_q, pad_k = nq * cq - sq, nk * ck - skv
    scale = _gqa_scores_scale(hd)
    dev = q.device

    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    qpos = _pad_pos(q_pos, pad_q, -1, dev)
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    kpos = _pad_pos(kv_pos, pad_k, torch.iinfo(torch.int32).max, dev)
    run = _chunk_pairs(q_pos, kv_pos, cq, ck, nq, nk, window)

    outs = []
    for i in range(nq):
        qi = qp[:, i * cq:(i + 1) * cq].reshape(b, cq, kvh, g, hd)
        qpi = qpos[i * cq:(i + 1) * cq]
        carry = (torch.zeros((b, kvh, g, cq, hd), device=dev),
                 torch.full((b, kvh, g, cq), -1e30, device=dev),
                 torch.zeros((b, kvh, g, cq), device=dev))
        for j in range(nk):
            if not run[i, j]:
                continue
            ki = kp[:, j * ck:(j + 1) * ck]
            vi = vp[:, j * ck:(j + 1) * ck]
            kpi = kpos[j * ck:(j + 1) * ck]
            s = torch.einsum("bqkgh,bskh->bkgqs", qi.to(torch.float32),
                             ki.to(torch.float32)) * scale
            mask = kpi[None, :] <= qpi[:, None]
            if window:
                mask &= kpi[None, :] > (qpi[:, None] - window)
            s = s.masked_fill(~mask[None, None, None], -1e30)
            vi32 = vi.to(torch.float32).transpose(1, 2)   # (B, KV, ck, hd)
            carry = _online_update(carry, s, vi32[:, :, None])
        acc, _, l = carry
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))           # (B, cq, KV, G, hd)
    out = torch.cat(outs, dim=1).reshape(b, nq * cq, h, hd)
    return out[:, :sq].to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_pos, cur_pos,
                     window: int = 0, chunk: int = 2048,
                     axis: str | None = None) -> torch.Tensor:
    """Single-token attention against a (possibly slot-sharded) cache.

    q: (B, 1, H, hd); caches: (B, Skv_local, KV, hd); ``kv_pos`` gives
    the absolute position of every local cache slot (-1 = empty), on any
    device.  A slot is kept iff ``0 <= pos <= cur_pos`` (and ``pos >
    cur_pos - window`` under a window); a masked score is -1e30.  With
    ``axis`` the partial accumulators are merged across the axis's
    shards: renormalized by the global max (``pmax``), then summed
    (``psum``), as the reference does."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    scale = _gqa_scores_scale(hd)
    skv = k_cache.shape[1]
    ck = min(chunk, skv)
    nk = -(-skv // ck)
    pad = nk * ck - skv
    dev = q.device
    kp = F.pad(k_cache, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v_cache, (0, 0, 0, 0, 0, pad))
    pp = _pad_pos(kv_pos, pad, -1, dev)
    cur = int(cur_pos)
    qg = q.reshape(b, kvh, g, 1, hd)     # Sq = 1
    carry = (torch.zeros((b, kvh, g, 1, hd), device=dev),
             torch.full((b, kvh, g, 1), -1e30, device=dev),
             torch.zeros((b, kvh, g, 1), device=dev))
    for j in range(nk):
        ki = kp[:, j * ck:(j + 1) * ck]
        vi = vp[:, j * ck:(j + 1) * ck]
        pi = pp[j * ck:(j + 1) * ck]
        s = torch.einsum("bkgqh,bskh->bkgqs", qg.to(torch.float32),
                         ki.to(torch.float32)) * scale
        mask = (pi >= 0) & (pi <= cur)
        if window:
            mask &= pi > (cur - window)
        s = s.masked_fill(~mask[None, None, None, None], -1e30)
        vi32 = vi.to(torch.float32).transpose(1, 2)
        carry = _online_update(carry, s, vi32[:, :, None])
    acc, m, l = carry
    if axis is not None:
        m_glob = col.pmax(m, axis)
        corr = torch.exp(m - m_glob)
        acc = col.psum(acc * corr[..., None], axis)
        l = col.psum(l * corr, axis)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


# --------------------------------------------------------------------------
# parameter init helpers
# --------------------------------------------------------------------------

_KEEP_F32 = {"A_log", "D", "dt_bias", "router", "ln1", "ln2", "lnx",
             "norm_w", "final_ln", "enc_ln"}


def cast_params_for_compute(tree, dtype):
    """Mixed precision: cast f32 master matmul weights to the compute
    dtype at use (norm/router/SSM decay params stay f32).  A leaf's name
    is its dict key (a list element has none); what is not a tensor
    passes through."""
    def f(node, name):
        if isinstance(node, dict):
            return {k: f(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [f(v, None) for v in node]
        if isinstance(node, torch.Tensor) and node.dtype == torch.float32 \
                and name not in _KEEP_F32 and node.dim() >= 2:
            return node.to(dtype)
        return node
    return f(tree, None)


def dense_init(key: torch.Generator | None, shape: tuple[int, ...], dtype,
               fan_in: int | None = None, *, device=None) -> torch.Tensor:
    """N(0, 1/fan_in) in f32, then ``dtype``, drawn from ``key`` on
    ``device`` (the generator's own device).  On the ``meta`` device
    (``key`` None) only the shape and type are made."""
    if key is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(fan_in)
    dev = key.device if device is None else device
    return (torch.randn(shape, generator=key, dtype=torch.float32,
                        device=dev) * std).to(dtype)


def filled(shape: tuple[int, ...], value: float,
           key: torch.Generator | None) -> torch.Tensor:
    """An f32 tensor of ``value`` on ``key``'s device (the ``meta``
    device without a key, as :func:`dense_init`)."""
    return torch.full(shape, value, dtype=torch.float32,
                      device="meta" if key is None else key.device)


def split_keys(key: torch.Generator | None,
               n: int) -> list[torch.Generator | None]:
    """``n`` generators on ``key``'s device, seeded from ``key``'s stream
    (``None`` stays ``None``: shapes only)."""
    if key is None:
        return [None] * n
    seeds = torch.randint(0, 2 ** 62, (n,), generator=key,
                          device=key.device).tolist()
    return [torch.Generator(device=key.device).manual_seed(s)
            for s in seeds]
