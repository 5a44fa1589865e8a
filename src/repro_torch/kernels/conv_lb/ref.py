"""The plain PyTorch versions of the conv kernel and the wgrad kernel
(the port's counterpart of ``repro/kernels/conv_lb/ref.py``, the
unfused epilogue ``_lax_epilogue`` and the dgrad kernel ``_flip_w`` of
``ops.py``).

It repeats the kernel's arithmetic in the plainest form: the
lhs-dilated plane is materialized by zero insertion, padded, and the
conv is the sum over the Hk x Wk windows of one (B*Ho*Wo, Ci) x
(Ci, Co) product each, accumulated in f32 — the implicit-GEMM form of
paper Fig. 3 — followed by the unfused epilogue (bias -> residual ->
ReLU -> max-pool).  The kernel wrapper runs it for CPU tensors, and
the chip smoke holds the kernel against it on the card; it never runs
for a CUDA tensor on the serving or training path.  :func:`wgrad_ref`
is the weight gradient in the same form: one ``xs^T @ dy`` product per
window, summed in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v) -> tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def max_pool(y: torch.Tensor, pool: int) -> torch.Tensor:
    """Aligned ``pool`` x ``pool`` max-pool, stride = pool, VALID
    (a trailing partial window is dropped), on NHWC."""
    if pool <= 1:
        return y
    b, h, w, c = y.shape
    hp, wp = h // pool, w // pool
    y = y[:, :hp * pool, :wp * pool]
    return y.reshape(b, hp, pool, wp, pool, c).amax(dim=(2, 4))


def epilogue(y: torch.Tensor, bias=None, relu: bool = False,
             pool: int = 1, residual=None) -> torch.Tensor:
    """The unfused epilogue: bias -> residual join -> relu -> max-pool,
    the exact math the kernel fuses on its f32 register tile."""
    if bias is not None:
        y = y + bias.to(y.dtype)
    if residual is not None:
        y = y + residual.to(y.dtype)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return max_pool(y, pool)


def lhs_dilate(x: torch.Tensor, lhs_dilation) -> torch.Tensor:
    """(B, H, W, C) with ``ldy - 1`` zero rows between input rows and
    ``ldx - 1`` zero columns between input columns."""
    ldy, ldx = lhs_dilation
    if (ldy, ldx) == (1, 1):
        return x
    b, h, wd, ci = x.shape
    xd = x.new_zeros(b, (h - 1) * ldy + 1, (wd - 1) * ldx + 1, ci)
    xd[:, ::ldy, ::ldx] = x
    return xd


def _conv_sum(x, w, stride, padding, dilation, lhs_dilation):
    """Pre-epilogue conv of one group as a sum of window products."""
    sy, sx = stride
    py, px = padding
    dy, dx = dilation
    b, h, wd, ci = x.shape
    hk, wk, _, co = w.shape
    x = lhs_dilate(x.to(torch.float32), lhs_dilation)
    w = w.to(torch.float32)
    x = F.pad(x, (0, 0, px, px, py, py))
    hp, wp = x.shape[1], x.shape[2]
    ho = (hp - ((hk - 1) * dy + 1)) // sy + 1
    wo = (wp - ((wk - 1) * dx + 1)) // sx + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{hk}x{wk} conv has no output on a {h}x{wd} "
                         f"plane")
    acc = x.new_zeros(b * ho * wo, co)
    for ky in range(hk):
        for kx in range(wk):
            xs = x[:, ky * dy:ky * dy + (ho - 1) * sy + 1:sy,
                   kx * dx:kx * dx + (wo - 1) * sx + 1:sx, :]
            acc.addmm_(xs.reshape(b * ho * wo, ci), w[ky, kx])
    return acc.reshape(b, ho, wo, co)


def conv2d_ref(x, w, bias=None, residual=None, *, stride=1, padding=0,
               dilation=1, lhs_dilation=1, groups: int = 1,
               relu: bool = False, pool: int = 1) -> torch.Tensor:
    """x: (B, H, W, Ci); w: (Hk, Wk, Ci/groups, Co)
    -> (B, Ho/pool, Wo/pool, Co), in x's dtype."""
    kw = dict(stride=_pair(stride), padding=_pair(padding),
              dilation=_pair(dilation), lhs_dilation=_pair(lhs_dilation))
    ci_g, co = w.shape[2], w.shape[3]
    co_g = co // groups
    y = torch.cat([_conv_sum(x[..., g * ci_g:(g + 1) * ci_g],
                             w[..., g * co_g:(g + 1) * co_g], **kw)
                   for g in range(groups)], dim=-1)
    return epilogue(y, bias, relu, pool, residual).to(x.dtype)


def flip_w(w: torch.Tensor) -> torch.Tensor:
    """(Hk, Wk, Ci, Co) -> spatially flipped (Hk, Wk, Co, Ci): the
    dgrad conv's kernel (contiguous)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def wgrad_ref(x: torch.Tensor, dy: torch.Tensor, hk: int, wk: int, *,
              stride=1, padding=0, dilation=1) -> torch.Tensor:
    """dW (Hk, Wk, Ci, Co) f32 of the conv x (B, H, W, Ci) -> dy
    (B, Ho, Wo, Co): for every window, the product of the window's
    strided input slice (B*Ho*Wo, Ci) transposed with dy
    (B*Ho*Wo, Co), accumulated in f32."""
    sy, sx = _pair(stride)
    py, px = _pair(padding)
    dly, dlx = _pair(dilation)
    b, _, _, ci = x.shape
    _, ho, wo, co = dy.shape
    xp = F.pad(x.to(torch.float32), (0, 0, px, px, py, py))
    g = dy.to(torch.float32).reshape(b * ho * wo, co)
    out = g.new_zeros(hk, wk, ci, co)
    for ky in range(hk):
        for kx in range(wk):
            xs = xp[:, ky * dly:ky * dly + (ho - 1) * sy + 1:sy,
                    kx * dlx:kx * dlx + (wo - 1) * sx + 1:sx, :]
            out[ky, kx] = xs.reshape(b * ho * wo, ci).t() @ g
    return out


def im2col_ref(x: torch.Tensor, hk: int, wk: int, *, padding=0, dilation=1,
               channels: int | None = None) -> torch.Tensor:
    """The stride-1 im2col plane (B, Ho, Wo, channels) of x (B, H, W,
    Ci), in x's dtype: channel (ky * wk + kx) * Ci + ci of pixel
    (oy, ox) is x[oy + ky*dly - py, ox + kx*dlx - px, ci] (zero outside
    the plane), channels Hk*Wk*Ci onward zero.  Its 1x1 weight gradient
    against dy, rows 0 .. Hk*Wk*Ci - 1, is the conv's dW in HWIO
    order."""
    py, px = _pair(padding)
    dly, dlx = _pair(dilation)
    _, h, w, ci = x.shape
    ho, wo = h + 2 * py - (hk - 1) * dly, w + 2 * px - (wk - 1) * dlx
    xp = F.pad(x, (0, 0, px, px, py, py))
    plane = torch.cat([xp[:, ky * dly:ky * dly + ho, kx * dlx:kx * dlx + wo]
                       for ky in range(hk) for kx in range(wk)], dim=-1)
    k = hk * wk * ci
    return F.pad(plane, (0, (channels or k) - k))
