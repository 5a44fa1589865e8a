"""Mamba2 (state-space duality, SSD) block — the port's copy of
``repro/models/ssm.py`` (arXiv:2405.21060).

The SSD algorithm is itself a blocked contraction: the sequence is
split into chunks; within a chunk the computation is a (masked) matmul
block, and across chunks a small recurrent state is carried.  Prefill
runs the chunked scan (a Python loop over chunks where the reference
scans), decode the O(1) recurrence; the arithmetic is f32 throughout,
as the reference's.  No Pallas kernel computes any of it in the
reference, and plain PyTorch ops compute it here, on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (dense_init, filled, rms_norm,
                                       split_keys)


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
    # above the diagonal exp(seg) may overflow to inf: ``where`` drops
    # it (a product with the mask would give inf * 0 = NaN)
    decay = torch.where(tri[None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=seg.dtype, device=seg.device))
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


def ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, chunk: int,
                init_state=None):
    """Chunked SSD scan.

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


def mamba_forward(params, x, cfg, init_state=None, conv_state=None):
    """Full block forward: x (B, L, d_model) -> (B, L, d_model).

    Returns (y, (ssm_state, conv_tail)) for prefill cache handoff; the
    conv tail is the last k - 1 rows of the conv's input, zeros first
    where L < k - 1."""
    d_inner = cfg.d_inner
    n_heads = cfg.ssm_heads
    n_groups = 1
    state = cfg.ssm_state
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(proj, d_inner, n_groups, state, n_heads)
    if conv_state is not None:
        xbc_ext = torch.cat([conv_state, xbc], dim=1)
        conv = _causal_conv(xbc_ext, params["conv_w"])
        conv = conv[:, conv_state.shape[1]:]
    else:
        conv = _causal_conv(xbc, params["conv_w"])
    k1 = cfg.ssm_conv - 1
    conv_tail = torch.cat([xbc.new_zeros((xbc.shape[0],
                                          max(0, k1 - xbc.shape[1]),
                                          xbc.shape[2])),
                           xbc[:, -k1:]], dim=1)
    xin, bmat, cmat = _split_conv(conv, d_inner, n_groups, state)
    bsz, length = x.shape[0], x.shape[1]
    xh = xin.reshape(bsz, length, n_heads, cfg.ssm_head_dim)
    dt_act = F.softplus(dt.to(torch.float32) + params["dt_bias"])
    y, final_state = ssd_chunked(
        xh.to(torch.float32), dt_act, params["A_log"],
        bmat.reshape(bsz, length, n_groups, state).to(torch.float32),
        cmat.reshape(bsz, length, n_groups, state).to(torch.float32),
        params["D"], chunk=min(256, length), init_state=init_state)
    y = y.reshape(bsz, length, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["norm_w"])
    return y @ params["out_proj"], (final_state, conv_tail)


def mamba_decode(params, x, cfg, ssm_state, conv_state):
    """x (B, 1, d_model); conv_state (B, k-1, conv_dim)."""
    d_inner = cfg.d_inner
    n_heads = cfg.ssm_heads
    n_groups = 1
    state = cfg.ssm_state
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(proj, d_inner, n_groups, state, n_heads)
    window = torch.cat([conv_state, xbc], dim=1)            # (B, k, conv)
    conv = F.silu(torch.einsum("bkc,kc->bc", window,
                               params["conv_w"]))[:, None]
    new_conv_state = window[:, 1:]
    xin, bmat, cmat = _split_conv(conv, d_inner, n_groups, state)
    bsz = x.shape[0]
    dt_act = F.softplus(dt.to(torch.float32) + params["dt_bias"])[:, 0]
    y, new_state = ssd_decode_step(
        xin.reshape(bsz, n_heads, cfg.ssm_head_dim).to(torch.float32),
        dt_act, params["A_log"],
        bmat.reshape(bsz, n_groups, state).to(torch.float32),
        cmat.reshape(bsz, n_groups, state).to(torch.float32),
        params["D"], ssm_state)
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, params["norm_w"])
    return y @ params["out_proj"], (new_state, new_conv_state)
