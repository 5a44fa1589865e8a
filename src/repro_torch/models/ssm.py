"""Mamba2 (state-space duality, SSD) block — the port's copy of
``repro/models/ssm.py`` (arXiv:2405.21060).

The SSD algorithm is itself a blocked contraction: the sequence is
split into chunks; within a chunk the computation is a (masked) matmul
block, and across chunks a small recurrent state is carried.  Prefill
runs the chunked scan (a Python loop over chunks where the reference
scans), decode the O(1) recurrence; the arithmetic is f32 throughout,
as the reference's.  No Pallas kernel computes any of it in the
reference, and plain PyTorch ops compute it here, on either device.

On a "model" axis above 1 (:func:`mamba_forward_mesh`,
:func:`mamba_decode_mesh`) the weights and caches keep the reference's
layouts, whose contiguous split of ``in_proj``'s packed ``[z | x | B |
C | dt]`` output does not fall on the SSD heads: each rank regroups
inside the mixer, taking its heads (:func:`heads_cut`) from the
all-gathered projection.  The body after the gathers (:func:`mix`,
:func:`mix_decode`) takes their results from its caller, so
:func:`run_shards` can run the shards of a mesh one after another in a
process.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import (column_input, dense_init, filled,
                                       rms_norm, row_output, split_keys)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import model_size


def init_mamba(key, d_model: int, state: int, head_dim: int,
               expand: int, conv_k: int, dtype, n_groups: int = 1):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * state
    ks = split_keys(key, 4)
    proj_out = 2 * d_inner + 2 * n_groups * state + n_heads
    return {
        "in_proj": dense_init(ks[0], (d_model, proj_out), dtype),
        "conv_w": dense_init(ks[1], (conv_k, conv_dim), dtype,
                             fan_in=conv_k),
        "A_log": filled((n_heads,), 0.0, key),
        "D": filled((n_heads,), 1.0, key),
        "dt_bias": filled((n_heads,), 0.0, key),
        "norm_w": filled((d_inner,), 1.0, key),
        "out_proj": dense_init(ks[2], (d_inner, d_model), dtype),
    }


def _split_proj(proj, d_inner, n_groups, state, n_heads):
    z, xbc_dt = proj.split([d_inner, proj.shape[-1] - d_inner], dim=-1)
    conv_dim = d_inner + 2 * n_groups * state
    xbc, dt = xbc_dt.split([conv_dim, xbc_dt.shape[-1] - conv_dim], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc, conv_w):
    """Depthwise causal conv along seq: xbc (b, L, C), conv_w (k, C)."""
    k = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1]] * conv_w[i] for i in range(k))
    return F.silu(out)


def _chunk_step(state, xi, dti, dtai, bi, ci, tri, g: int, hg: int):
    """One chunk: the intra-chunk block product (the paper's psum
    block) + the O(1) state carry.  Only this chunk's (q x q) decay
    panel materializes."""
    bsz, q, _h, p = xi.shape
    cs = torch.cumsum(dtai, dim=1)                          # (B, q, H)
    seg = cs[:, :, None, :] - cs[:, None, :, :]
    # above the diagonal exp(seg) may overflow to inf: the mask goes in
    # before the exp, which gives exactly 0 there.  The reference's
    # ``where(tri, exp(seg), 0)`` has the same values, but its gradient
    # is exp(seg) * 0 = inf * 0 = NaN past ~90 rows of a chunk.
    decay = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                      float("-inf")))
    xg = xi.reshape(bsz, q, g, hg, p)
    dtg = dti.reshape(bsz, q, g, hg)
    decg = decay.reshape(bsz, q, q, g, hg)
    cb = torch.einsum("bqgn,bsgn->bqsg", ci, bi)
    # explicit contraction order: the (b,q,s,g,h) weight panel first,
    # then one product over s (never the (b,q,s,g,h,p) tensor)
    wpanel = cb[..., None] * decg * dtg[:, None]            # (b,q,s,g,h)
    y_diag = torch.einsum("bqsgh,bsghp->bqghp", wpanel, xg)
    # contribution of the carried state (contract n first)
    inc = torch.exp(cs).reshape(bsz, q, g, hg)
    y_off = torch.einsum("bqgn,bghpn->bqghp", ci, state) * inc[..., None]
    # chunk-final state update
    decay_last = torch.exp(cs[:, -1:, :] - cs).reshape(bsz, q, g, hg)
    xw = xg * (decay_last * dtg)[..., None]                 # (b,s,g,h,p)
    states = torch.einsum("bsgn,bsghp->bghpn", bi, xw)
    chunk_decay = torch.exp(cs[:, -1, :]).reshape(bsz, g, hg)
    new_state = state * chunk_decay[..., None, None] + states
    return new_state, (y_diag + y_off).reshape(bsz, q, g * hg, p)


@record_function("ssd_chunked")
def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, chunk: int,
                init_state=None):
    """Chunked SSD scan, in an ``ssd_chunked`` profiler range.

    x: (B, L, H, P); dt: (B, L, H); b_mat/c_mat: (B, L, G, N);
    returns y (B, L, H, P) and the final state (B, H, P, N)."""
    bsz, length, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    hg = h // g
    q = min(chunk, length)
    nc = -(-length // q)
    pad = nc * q - length
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))

    a = -torch.exp(a_log)                                   # (H,) negative
    dta = dt * a                                            # (B, L', H)
    if init_state is None:
        state = torch.zeros((bsz, g, hg, p, n), dtype=torch.float32,
                            device=x.device)
    else:
        state = init_state.reshape(bsz, g, hg, p, n)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        rows = slice(c * q, (c + 1) * q)
        state, y = _chunk_step(state, x[:, rows], dt[:, rows], dta[:, rows],
                               b_mat[:, rows], c_mat[:, rows], tri, g, hg)
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + x * d_skip[None, None, :, None]
    return y[:, :length], state.reshape(bsz, h, p, n)


def ssd_decode_step(x_t, dt_t, a_log, b_t, c_t, d_skip, state):
    """O(1) recurrence: x_t (B,H,P); dt_t (B,H); b_t/c_t (B,G,N);
    state (B,H,P,N) -> (y (B,H,P), new state)."""
    bsz, h, p = x_t.shape
    g = b_t.shape[1]
    hg = h // g
    a = -torch.exp(a_log)
    da = torch.exp(dt_t * a)                                # (B,H)
    sg = state.reshape(bsz, g, hg, p, -1)
    b_in = torch.einsum("bh,bgn,bghp->bghpn", dt_t, b_t,
                        x_t.reshape(bsz, g, hg, p))
    new = sg * da.reshape(bsz, g, hg)[..., None, None] + b_in
    y = torch.einsum("bgn,bghpn->bghp", c_t, new).reshape(bsz, h, p)
    y = y + x_t * d_skip[None, :, None]
    return y, new.reshape(bsz, h, p, -1)


def _split_conv(conv, d_inner: int, n_groups: int, state: int):
    return conv.split([d_inner, n_groups * state, n_groups * state],
                      dim=-1)


# --------------------------------------------------------------------------
# the mixer's body: whole, or one shard's heads
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cut:
    """Where one shard's heads lie in the packed projection: its ``z``
    channels (of ``d_inner``), its ``x`` channels (of the conv's
    ``conv_dim``; B and C are read whole) and its ``dt`` heads, each a
    ``(start, stop)`` pair."""
    z: tuple[int, int]
    x: tuple[int, int]
    dt: tuple[int, int]


def shard_heads(cfg, mp: int) -> int:
    """The SSD heads of one of ``mp`` model shards; raises unless they
    split evenly."""
    if cfg.ssm_heads % mp:
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} SSD heads do not "
                         f"split over a model axis of {mp}")
    return cfg.ssm_heads // mp


def heads_cut(cfg, r: int, mp: int) -> Cut:
    """Rank ``r`` of ``mp``'s heads ``r * H/mp ... (r+1) * H/mp``."""
    hl = shard_heads(cfg, mp)
    dl = hl * cfg.ssm_head_dim
    return Cut(z=(r * dl, (r + 1) * dl), x=(r * dl, (r + 1) * dl),
               dt=(r * hl, (r + 1) * hl))


def _cols(t, span):
    return t[..., span[0]:span[1]]


def _own(t, cut: Cut | None, d_inner: int):
    """The channels a shard convolves of a tensor in the conv's space
    (..., conv_dim): its ``x`` channels, then B and C whole (``t``
    itself without a cut)."""
    if cut is None:
        return t
    return torch.cat([_cols(t, cut.x), t[..., d_inner:]], dim=-1)


def mix(proj, conv_w, heads, cfg, cut: Cut | None = None, init_state=None,
        conv_state=None):
    """:func:`mamba_forward` from the packed projection ``proj = x @
    in_proj`` (B, L, proj_out) and the whole ``conv_w`` (k, conv_dim) up
    to the gate, for the heads of ``cut`` (all of them without one).
    ``heads`` holds those heads' ``A_log``, ``D`` and ``dt_bias``;
    ``init_state`` their SSM state, ``conv_state`` the whole conv tail.

    Returns (y * silu(z) (B, L, d_cut) in ``proj``'s type, (the final
    SSM state of the heads, the whole conv tail: the last k - 1 rows of
    the conv's input, zeros first where L < k - 1))."""
    d_inner, n = cfg.d_inner, cfg.ssm_state
    z, xbc, dt = _split_proj(proj, d_inner, 1, n, cfg.ssm_heads)
    w = _own(conv_w, cut, d_inner)
    if conv_state is not None:
        xbc_ext = torch.cat([conv_state, xbc], dim=1)
        conv = _causal_conv(_own(xbc_ext, cut, d_inner), w)
        conv = conv[:, conv_state.shape[1]:]
    else:
        conv = _causal_conv(_own(xbc, cut, d_inner), w)
    k1 = cfg.ssm_conv - 1
    conv_tail = torch.cat([xbc.new_zeros((xbc.shape[0],
                                          max(0, k1 - xbc.shape[1]),
                                          xbc.shape[2])),
                           xbc[:, -k1:]], dim=1)
    if cut is not None:
        z, dt = _cols(z, cut.z), _cols(dt, cut.dt)
    d_cut, h_cut = z.shape[-1], dt.shape[-1]
    xin, bmat, cmat = _split_conv(conv, d_cut, 1, n)
    bsz, length = proj.shape[0], proj.shape[1]
    xh = xin.reshape(bsz, length, h_cut, cfg.ssm_head_dim)
    dt_act = F.softplus(dt.to(torch.float32) + heads["dt_bias"])
    y, final_state = ssd_chunked(
        xh.to(torch.float32), dt_act, heads["A_log"],
        bmat.reshape(bsz, length, 1, n).to(torch.float32),
        cmat.reshape(bsz, length, 1, n).to(torch.float32),
        heads["D"], chunk=min(256, length), init_state=init_state)
    y = y.reshape(bsz, length, d_cut).to(proj.dtype)
    return y * F.silu(z), (final_state, conv_tail)


def mix_decode(proj, conv_w, heads, cfg, ssm_state, conv_state,
               cut: Cut | None = None):
    """:func:`mamba_decode` from ``proj`` (B, 1, proj_out) and the whole
    ``conv_w`` and ``conv_state`` (B, k-1, conv_dim) up to the gate, for
    the heads of ``cut`` (``heads`` and ``ssm_state`` are theirs).
    Returns (y * silu(z) (B, 1, d_cut), (their new SSM state, the whole
    new conv state))."""
    d_inner, n = cfg.d_inner, cfg.ssm_state
    z, xbc, dt = _split_proj(proj, d_inner, 1, n, cfg.ssm_heads)
    window = torch.cat([conv_state, xbc], dim=1)            # (B, k, conv)
    conv = F.silu(torch.einsum("bkc,kc->bc", _own(window, cut, d_inner),
                               _own(conv_w, cut, d_inner)))[:, None]
    if cut is not None:
        z, dt = _cols(z, cut.z), _cols(dt, cut.dt)
    d_cut, h_cut = z.shape[-1], dt.shape[-1]
    xin, bmat, cmat = _split_conv(conv, d_cut, 1, n)
    bsz = proj.shape[0]
    dt_act = F.softplus(dt.to(torch.float32) + heads["dt_bias"])[:, 0]
    y, new_state = ssd_decode_step(
        xin.reshape(bsz, h_cut, cfg.ssm_head_dim).to(torch.float32),
        dt_act, heads["A_log"],
        bmat.reshape(bsz, 1, n).to(torch.float32),
        cmat.reshape(bsz, 1, n).to(torch.float32),
        heads["D"], ssm_state)
    y = y.reshape(bsz, 1, d_cut).to(proj.dtype)
    return y * F.silu(z), (new_state, window[:, 1:])


def sum_squares(y):
    """A shard's part of the gated norm's statistic: the f32 sum of
    squares over its channels (..., 1)."""
    return y.to(torch.float32).square().sum(dim=-1, keepdim=True)


def shard_norm(y, w, total, d_inner: int, eps: float = 1e-5):
    """:func:`~repro_torch.models.layers.rms_norm` of a shard's channels
    ``y`` with their weights ``w``, given ``total``, the sum of squares
    over all ``d_inner`` channels."""
    return ((y.to(torch.float32) * torch.rsqrt(total / d_inner + eps))
            * w).to(y.dtype)


# --------------------------------------------------------------------------
# the mixer, whole
# --------------------------------------------------------------------------

def mamba_forward(params, x, cfg, init_state=None, conv_state=None):
    """Full block forward: x (B, L, d_model) -> (B, L, d_model).

    Returns (y, (ssm_state, conv_tail)) for prefill cache handoff; the
    conv tail is the last k - 1 rows of the conv's input, zeros first
    where L < k - 1."""
    y, cache = mix(x @ params["in_proj"], params["conv_w"], params, cfg,
                   init_state=init_state, conv_state=conv_state)
    return rms_norm(y, params["norm_w"]) @ params["out_proj"], cache


def mamba_decode(params, x, cfg, ssm_state, conv_state):
    """x (B, 1, d_model); conv_state (B, k-1, conv_dim)."""
    y, cache = mix_decode(x @ params["in_proj"], params["conv_w"], params,
                          cfg, ssm_state, conv_state)
    return rms_norm(y, params["norm_w"]) @ params["out_proj"], cache


# --------------------------------------------------------------------------
# the mixer on a "model" axis above 1
# --------------------------------------------------------------------------

_HEAD_PARAMS = ("A_log", "D", "dt_bias")


def _conv_block(t, r: int, mp: int):
    """Rank ``r``'s contiguous block of the conv channels (the cache's
    layout, ``P(batch, None, "model")``)."""
    n = t.shape[-1] // mp
    return t[..., r * n:(r + 1) * n]


def _gated_norm_mesh(y, params, cfg):
    """The gated norm over ``d_inner`` of this rank's channels: the sum
    of squares all-reduced over "model" (its cotangent, partial on every
    rank, all-reduced back), this rank's block of ``norm_w``."""
    total = col.psum_grad(col.psum(sum_squares(y), "model"), "model")
    w = col.split(params["norm_w"], "model", dim=0)
    return shard_norm(y, w, total, cfg.d_inner)


def _out_proj(yn, w, sp: bool = False):
    """The row-parallel ``out_proj``: this rank's partial product taken
    in f32 (its operands' products exact, as the whole mixer's one GEMM
    accumulates them), summed over "model" (or with ``sp``
    reduce-scattered onto the sequence) in f32, then rounded once to the
    compute type.  A bf16 partial summed in bf16 rounds once a shard:
    at 16 shards the mixer then misses the whole one's bf16 gate by
    2x."""
    part = yn.to(torch.float32) @ w.to(torch.float32)
    return row_output(part, sp).to(yn.dtype)


def _mesh_heads(params) -> dict:
    """This rank's block of the replicated per-head parameters (their
    cotangents all-gathered whole)."""
    return {k: col.split(params[k], "model", dim=0) for k in _HEAD_PARAMS}


def mamba_forward_mesh(params, x, cfg, sp: bool = False):
    """:func:`mamba_forward` on a "model" axis of ``mp`` > 1, in the
    reference's layouts: ``in_proj`` this rank's contiguous block of the
    packed output columns, ``conv_w`` of the conv channels, ``out_proj``
    of the ``d_inner`` rows.  This rank multiplies its block; one
    all-gather gives every rank the whole projection, of which it takes
    its heads' ``z``, ``x`` and ``dt`` and B and C whole
    (:func:`heads_cut`); ``conv_w`` is all-gathered whole; the scan runs
    over its heads, the gated norm sums its squares over "model", and
    ``out_proj`` is row-parallel, its partial products taken and summed
    in f32 (:func:`_out_proj`).  ``x`` enters through
    :func:`~repro_torch.models.layers.column_input` and leaves through
    ``row_output`` (with ``sp``, this rank's sequence block).  Returns
    (out, (this rank's heads' SSM state, its block of the conv tail))."""
    r, mp = col.axis_index("model"), model_size()
    cut = heads_cut(cfg, r, mp)
    proj = col.all_gather(column_input(x, sp) @ params["in_proj"], "model",
                          dim=-1)
    conv_w = col.all_gather(params["conv_w"], "model", dim=1)
    y, (st, tail) = mix(proj, conv_w, _mesh_heads(params), cfg, cut)
    out = _out_proj(_gated_norm_mesh(y, params, cfg), params["out_proj"], sp)
    return out, (st, _conv_block(tail, r, mp))


def mamba_decode_mesh(params, x, cfg, ssm_state, conv_state):
    """:func:`mamba_decode` on a "model" axis above 1 (the layouts of
    :func:`mamba_forward_mesh`; ``ssm_state`` this rank's heads,
    ``conv_state`` its block of the conv channels, all-gathered whole
    for the window)."""
    r, mp = col.axis_index("model"), model_size()
    cut = heads_cut(cfg, r, mp)
    proj = col.all_gather(x @ params["in_proj"], "model", dim=-1)
    conv_w = col.all_gather(params["conv_w"], "model", dim=1)
    window = col.all_gather(conv_state, "model", dim=2)
    y, (st, conv) = mix_decode(proj, conv_w, _mesh_heads(params), cfg,
                               ssm_state, window, cut)
    out = _out_proj(_gated_norm_mesh(y, params, cfg), params["out_proj"])
    return out, (st, _conv_block(conv, r, mp))


def run_shards(params, x, cfg, mp: int, caches=None, cut=heads_cut):
    """The mixer as ``mp`` shards run in turn in one process, the
    collectives done in the process: shard ``r`` multiplies its
    contiguous ``in_proj`` columns, the shards' products are
    concatenated (the all-gather), each runs :func:`mix` (or
    :func:`mix_decode`) over the heads ``cut(cfg, r, mp)`` gives it, the
    sums of squares are added (the all-reduce), and the shards' partial
    ``out_proj`` products, taken and summed in f32 (the row-parallel
    reduce, as :func:`mamba_forward_mesh` takes it).  ``params``
    and ``caches`` (``(ssm, conv)`` whole, or ``None`` for a prefill)
    are whole; each shard is given its blocks of them.  Returns (out,
    (the SSM state, the conv tail), whole: the shards' blocks
    concatenated)."""
    d_inner, dl = cfg.d_inner, cfg.d_inner // mp
    width = params["in_proj"].shape[-1] // mp
    proj = torch.cat([x @ params["in_proj"][:, r * width:(r + 1) * width]
                      for r in range(mp)], dim=-1)
    cuts = [cut(cfg, r, mp) for r in range(mp)]
    parts = []
    for r, c in enumerate(cuts):
        heads = {k: _cols(params[k], c.dt) for k in _HEAD_PARAMS}
        if caches is None:
            parts.append(mix(proj, params["conv_w"], heads, cfg, c))
        else:
            hl = cfg.ssm_heads // mp
            parts.append(mix_decode(
                proj, params["conv_w"], heads, cfg,
                caches[0][:, r * hl:(r + 1) * hl], caches[1], c))
    total = sum(sum_squares(y) for y, _ in parts)
    out = sum(shard_norm(y, params["norm_w"][r * dl:(r + 1) * dl], total,
                         d_inner).to(torch.float32)
              @ params["out_proj"][r * dl:(r + 1) * dl].to(torch.float32)
              for r, (y, _) in enumerate(parts)).to(x.dtype)
    state = torch.cat([st for _, (st, _t) in parts], dim=1)
    return out, (state, parts[0][1][1])
