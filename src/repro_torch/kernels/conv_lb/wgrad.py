"""The wgrad kernel's wrapper: build, bind and launch the hand-written
CUDA kernel (``csrc/wgrad_lb.cu``), which replaces the TPU kernel
``_wgrad_kernel`` / ``wgrad_lb_call`` of
``repro/kernels/conv_lb/wgrad.py``.

dW is the conv of the input with the incoming gradient as the kernel
plane (batch folds into the reduction):

  dW[ky, kx, ci, co] = sum_{b, oy, ox}
      x_pad[b, ky*dil + oy*stride, kx*dil + ox*stride, ci]
      * dy[b, oy, ox, co]

The library is built like the conv kernel's
(:func:`repro_torch.kernels.conv_lb.kernel.build`).
:func:`wgrad_lb` dispatches on where its tensors lie and nothing else:
a CUDA tensor launches the kernel or raises; a CPU tensor runs the
plain version (:func:`~repro_torch.kernels.conv_lb.ref.wgrad_ref`).
Each layer call that launches the kernel adds one to
``wgrad_lb.launches``; a split reduction's second pass adds one to
``wgrad_lb.reduce_launches``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.core.hopper_adapter import (HBM_BYTES_PER_S,
                                             PEAK_F32_FLOPS, SM_COUNT)
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.conv_lb.kernel import (CTAS_PER_SM, DTYPES,
                                                _aligned,
                                                _check_cuda_operand, build)
from repro_torch.kernels.conv_lb.ref import _pair, wgrad_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "wgrad_lb.cu"

#: the kernel's fixed CTA shape (must match csrc/wgrad_lb.cu)
TILE_M = 128        # dW rows (ky, kx, ci) per CTA
CHUNK = 16          # reduction pixels staged per step
MAX_SPLITS = 1024


@dataclasses.dataclass(frozen=True)
class WgradGeometry:
    """The forward conv a weight gradient belongs to."""

    hk: int
    wk: int
    stride: tuple[int, int] = (1, 1)
    padding: tuple[int, int] = (0, 0)
    dilation: tuple[int, int] = (1, 1)

    @classmethod
    def of(cls, geom) -> "WgradGeometry":
        """A :class:`WgradGeometry` passes through; a
        :class:`~repro_torch.kernels.conv_lb.ops.WgradPlan` gives its
        executing geometry."""
        if isinstance(geom, cls):
            return geom
        return cls(hk=geom.hk, wk=geom.wk, stride=(geom.sy, geom.sx),
                   padding=(geom.py, geom.px),
                   dilation=(geom.dly, geom.dlx))


@lru_cache(maxsize=4096)
def wgrad_split(m: int, co: int, k: int) -> tuple[int, int, int]:
    """The kernel's own tiling ``(tn, splits, chunks_per_split)`` for a
    dW of ``m`` = Hk*Wk*Ci rows x ``co`` columns reduced over ``k`` =
    B*Ho*Wo pixels.  ``tn`` is 128 where Co exceeds 64.  The split of
    the reduction minimizes a model of the time: waves of CTAs over
    the card's SMs x the pixel steps of one CTA, at the f32 FMA rate,
    plus the second pass's workspace bytes at the HBM rate; ties go to
    fewer splits."""
    tn = 64 if co <= 64 else 128
    tiles = ceil_div(m, TILE_M) * ceil_div(co, tn)
    chunks = ceil_div(k, CHUNK)
    slots = SM_COUNT * CTAS_PER_SM
    step_s = 2.0 * CHUNK * TILE_M * tn * slots / PEAK_F32_FLOPS
    best = None
    for splits in range(1, min(chunks, MAX_SPLITS) + 1):
        cps = ceil_div(chunks, splits)
        real = ceil_div(chunks, cps)       # no empty range
        if real != splits:
            continue
        t = ceil_div(tiles * splits, slots) * cps * step_s
        if splits > 1:
            t += 4.0 * (2 * splits + 1) * m * co / HBM_BYTES_PER_S
        if best is None or t < best[0]:
            best = (t, (tn, splits, cps))
    return best[1]


def wgrad_lb(x: torch.Tensor, dy: torch.Tensor, geom) -> torch.Tensor:
    """dW (Hk, Wk, Ci, Co) f32 of one group of the conv x (B, H, W, Ci)
    -> dy (B, Ho, Wo, Co), x and dy f32 or bf16 (one type, widened to
    f32 as they are staged); ``geom`` a :class:`WgradGeometry` or a
    :class:`~repro_torch.kernels.conv_lb.ops.WgradPlan`.

    A CUDA ``x`` launches the CUDA kernel; a CPU ``x`` runs the plain
    version.  Any other device raises."""
    g = WgradGeometry.of(geom)
    sy, sx = _pair(g.stride)
    py, px = _pair(g.padding)
    dly, dlx = _pair(g.dilation)
    if x.device.type == "cpu":
        return wgrad_ref(x, dy, g.hk, g.wk, stride=(sy, sx),
                         padding=(py, px), dilation=(dly, dlx))
    if x.device.type != "cuda":
        raise ValueError(f"the wgrad kernel runs on CUDA tensors (or its "
                         f"plain version on CPU ones), not {x.device}")
    if min(sy, sx, dly, dlx) < 1 or min(py, px) < 0:
        raise ValueError("stride and dilation must be >= 1 and padding "
                         ">= 0")
    b, h, wd, ci = x.shape
    ho = (h + 2 * py - ((g.hk - 1) * dly + 1)) // sy + 1
    wo = (wd + 2 * px - ((g.wk - 1) * dlx + 1)) // sx + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"{g.hk}x{g.wk} conv has no output on a "
                         f"{h}x{wd} plane")
    co = dy.shape[-1]
    _check_cuda_operand("x", x, x.device, (b, h, wd, ci), x.dtype)
    _check_cuda_operand("dy", dy, x.device, (b, ho, wo, co), x.dtype)
    m, k = g.hk * g.wk * ci, b * ho * wo
    if max(m, k) >= 2 ** 31:
        raise ValueError(f"wgrad of {m} x {co} over {k} pixels exceeds "
                         f"the kernel's index range")
    tn, splits, cps = wgrad_split(m, co, k)
    lib = build(SOURCE)
    forward = lib.bind("wgrad_lb_forward", 4, 22)
    dw = torch.empty((g.hk, g.wk, ci, co), dtype=torch.float32,
                     device=x.device)
    ws = (torch.empty((splits, m, co), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
            None if ws is None else ws.data_ptr(),
            b, h, wd, ci, co, g.hk, g.wk, ho, wo, sy, sx, dly, dlx, py, px,
            tn, splits, cps, _aligned(x), _aligned(dy),
            _aligned(dw) and (ws is None or _aligned(ws)),
            DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wgrad_lb kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")
    wgrad_lb.launches += 1
    if splits > 1:
        wgrad_lb.reduce_launches += 1
    return dw


wgrad_lb.launches = 0
wgrad_lb.reduce_launches = 0
