"""The im2col plane of a small-channel conv, shared by K1 and K2: the
wrapper of the staging kernel ``csrc/wgrad_im2col.cu``.

A channel count too small for a TMA map (VGG16's conv1_1 and ResNet-20's
stem, Ci = 3: a 6-byte bf16 pixel) is staged as a plane of ``cp`` <= 64
channels,

  plane[b, oy, ox, (ky*Wk + kx)*Ci + ci] =
      x[b, oy + ky*dly - py, ox + kx*dlx - px, ci]

(zero outside x, and in channels Hk*Wk*Ci .. cp - 1), so that the
stride-1 conv becomes a 1x1 conv over the plane and its weight gradient
a 1x1 weight gradient: K1's route ``sm90_im2col``
(:mod:`~repro_torch.kernels.conv_lb.kernel`) and K2's
(:mod:`~repro_torch.kernels.conv_lb.wgrad`) both run the tensor-core
kernel of their type on it.  The taps come in HWIO order, so rows 0 ..
Hk*Wk*Ci - 1 of the 1x1 weight are the conv's (Hk, Wk, Ci, Co) weight.

:func:`stage` launches the kernel, and each caller counts its own
launches (``conv_lb.stage_launches``, ``wgrad_lb.stage_launches``);
:func:`im2col_plane` is the plane alone (a CUDA ``x`` launches the
kernel, counted in ``im2col_plane.stage_launches``; a CPU ``x`` runs the
plain version :func:`~repro_torch.kernels.conv_lb.ref.im2col_ref`).  The
kernel is built at first use (:mod:`repro_torch.kernels.nvcc`), never at
import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.analysis.plan_check import LaunchFacts, grid_rule
from repro_torch.core.hopper_adapter import GRID_X_MAX, round_up
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.conv_lb.ref import _pair, im2col_ref
from repro_torch.kernels.nvcc import _entry

SOURCE = Path(__file__).resolve().parent / "csrc" / "wgrad_im2col.cu"

#: the plane's channels: at most 64 (one tensor-core row block), a
#: multiple of 8 (16-byte bf16 pixels); its staging kernel's taps
IM2COL_MAX = 64
#: the staging kernel's grid: one x index per 256 16-byte chunks of an
#: output row, rows of every image folded into x, at most ``GRID_X_MAX``
THREADS = 256
#: operand types the staging kernel takes, by the code its C interface
#: uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class Im2colPlan:
    """Route ``sm90_im2col`` of K1 or K2: the plane's ``cp`` channels,
    the taps its staging kernel reads (per window ``(ky*dly - py,
    kx*dlx - px)``), and the plan of the tensor-core kernel that takes
    the plane as a 1x1 conv or 1x1 weight gradient (its ``tile``, and
    K2's ``splits``)."""

    cp: int
    taps: tuple[tuple[int, int], ...]
    inner: object

    @property
    def splits(self) -> int:
        return self.inner.splits

    @property
    def tile(self) -> tuple[int, ...]:
        """``(cp, *inner.tile)``."""
        return (self.cp, *self.inner.tile)


def im2col_channels(ci: int, hk: int, wk: int) -> int:
    """The plane's channels: Hk*Wk*Ci rounded up to a multiple of 8."""
    return round_up(hk * wk * ci, 8)


def im2col_taps(hk: int, wk: int, padding=(0, 0), dilation=(1, 1)
                ) -> tuple[tuple[int, int], ...]:
    """Per window ``ky * wk + kx``, the (row, column) offset of the input
    pixel it reads from the output pixel: ``(ky*dly - py, kx*dlx - px)``."""
    (py, px), (dly, dlx) = _pair(padding), _pair(dilation)
    return tuple((ky * dly - py, kx * dlx - px)
                 for ky in range(hk) for kx in range(wk))


def stage_grid(ho: int, wo: int, cp: int, elt: int, b: int
               ) -> tuple[int, int, int]:
    """The staging kernel's grid: ``ceil(wo * cp * elt / 16 / THREADS)
    * ho * b`` blocks along x."""
    return ceil_div(wo * cp * elt // 16, THREADS) * ho * b, 1, 1


def stage_fits(b: int, h: int, w: int, ci: int, ho: int, wo: int, cp: int,
               elt: int) -> bool:
    """The staging kernel takes this plane (the ``sm90.stage`` rule):
    ``cp`` <= ``IM2COL_MAX``, one image of x and one plane row each
    under 2^31 words, and a grid (:func:`stage_grid`) that
    :func:`~repro_torch.analysis.plan_check.grid_rule` passes."""
    return (cp <= IM2COL_MAX and h * w * ci < 2 ** 31
            and wo * cp < 2 ** 31
            and grid_rule(stage_grid(ho, wo, cp, elt, b)) is None)


def stage_facts(xshape: tuple, ho: int, wo: int, cp: int, elt: int
                ) -> LaunchFacts:
    """What one staging launch asks of the card
    (:func:`~repro_torch.analysis.plan_check.check_launch`)."""
    b, h, w, ci = xshape
    return LaunchFacts(source=SOURCE.stem, function="wgrad_im2col_kernel",
                       grid=stage_grid(ho, wo, cp, elt, b),
                       threads=THREADS, smem_bytes=0,
                       stage=(b, h, w, ci, ho, wo, cp, elt))


@lru_cache(maxsize=4096)
def _c_ints(values: tuple[int, ...]):
    """A C int array of ``values``, made once and kept (a launch passes
    its address)."""
    return (ctypes.c_int * len(values))(*values)


def stage(x: torch.Tensor, taps: tuple[tuple[int, int], ...], ho: int,
          wo: int, cp: int) -> torch.Tensor:
    """One launch of the staging kernel: the plane (B, ho, wo, cp) of the
    CUDA tensor x (B, H, W, Ci) on ``taps``, in x's type.  Raises if the
    launch is refused."""
    b, h, wd, ci = x.shape
    lib, forward = _entry(SOURCE, "wgrad_im2col_forward", 3, 9)
    plane = torch.empty((b, ho, wo, cp), dtype=x.dtype, device=x.device)
    offs = _c_ints(tuple(itertools.chain(*taps)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = forward(x.data_ptr(), plane.data_ptr(), ctypes.addressof(offs),
                      b, h, wd, ci, ho, wo, len(taps), cp, DTYPES[x.dtype],
                      stream)
    if err != 0:
        raise RuntimeError(f"wgrad_im2col kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")
    return plane


def im2col_plane(x: torch.Tensor, hk: int, wk: int, padding=(0, 0),
                 dilation=(1, 1)) -> torch.Tensor:
    """The stride-1 im2col plane (B, Ho, Wo, :func:`im2col_channels`) of
    x (B, H, W, Ci), in x's type: a CUDA ``x`` launches the staging
    kernel on :func:`im2col_taps`; a CPU ``x`` runs the plain version."""
    (py, px), (dly, dlx) = _pair(padding), _pair(dilation)
    cp = im2col_channels(x.shape[-1], hk, wk)
    if x.device.type == "cpu":
        return im2col_ref(x, hk, wk, padding=(py, px),
                          dilation=(dly, dlx), channels=cp)
    if x.device.type != "cuda":
        raise ValueError(f"the im2col kernel runs on CUDA tensors (or its "
                         f"plain version on CPU ones), not {x.device}")
    b, h, wd, ci = x.shape
    ho, wo = h + 2 * py - (hk - 1) * dly, wd + 2 * px - (wk - 1) * dlx
    if not stage_fits(b, h, wd, ci, ho, wo, cp, x.element_size()):
        raise ValueError(f"the staging kernel does not take a {b} x {ho} x "
                         f"{wo} x {cp} plane of a {h} x {wd} x {ci} input")
    plane = stage(x, im2col_taps(hk, wk, (py, px), (dly, dlx)), ho, wo, cp)
    im2col_plane.stage_launches += 1
    return plane


im2col_plane.stage_launches = 0
