"""The attention kernel's wrapper: build, bind and launch the
hand-written CUDA kernel (``csrc/attention_block.cu``, K4), which
replaces the TPU kernel ``_attn_kernel`` / ``attention_call`` of
``repro/kernels/attention_block/kernel.py``.

The library is built like the conv kernel's
(:func:`repro_torch.kernels.conv_lb.kernel.build`): ``nvcc`` at first
use, never at import.  :func:`attention` dispatches on where its
tensors lie and nothing else: a CUDA tensor launches the kernel or
raises; a CPU tensor runs the plain version
(:func:`~repro_torch.kernels.attention_block.ref.attention_plain`).
Each launch adds one to ``attention.launches``.  The kernel runs a head
dim at the next width it is instantiated for (:func:`padded_head_dim`),
with zeros in the padded columns and the softmax scale of the real
head dim.
"""

from __future__ import annotations

from pathlib import Path

import torch

from repro_torch.core.hopper_adapter import SMEM_PER_BLOCK
from repro_torch.kernels.attention_block.ref import attention_plain
from repro_torch.kernels.conv_lb.kernel import _aligned, build

SOURCE = Path(__file__).resolve().parent / "csrc" / "attention_block.cu"

#: the widths the kernel is instantiated for (must match
#: csrc/attention_block.cu); a head dim runs at the next one
HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128, 256)
#: the kernel's fixed tiles (must match csrc/attention_block.cu)
BQ = BKV = 64
#: input types the kernel takes, by the code its C interface uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def padded_head_dim(hd: int) -> int:
    """The width the kernel runs head dim ``hd`` at: the least
    instantiated width >= ``hd``; above 256 it raises."""
    for width in HEAD_DIMS:
        if width >= hd:
            return width
    raise ValueError(f"head dim {hd} exceeds the attention kernel's "
                     f"largest width {HEAD_DIMS[-1]}")


def attention_stages(width: int, dtype: torch.dtype) -> int:
    """K/V stages the kernel keeps at ``width``: two where they fit in
    the card's shared memory, else one (f32 at 256)."""
    return 2 if attention_smem_bytes(width, dtype, 2) <= SMEM_PER_BLOCK \
        else 1


def attention_smem_bytes(width: int, dtype: torch.dtype,
                         stages: int | None = None) -> int:
    """Dynamic shared memory of one CTA: Q, ``stages`` stages of K and V
    (rows padded by 16 bytes) and the f32 P tile."""
    if stages is None:
        stages = attention_stages(width, dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    return ((BQ + 2 * stages * BKV) * (width + 16 // elt) * elt
            + BQ * (BKV + 4) * 4)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              groups: int, window: int = 0,
              causal: bool = True) -> torch.Tensor:
    """q (B*H, Sq, hd); k, v (B*KV, Skv, hd) with H = KV * ``groups``
    -> (B*H, Sq, hd) in ``q.dtype``.

    A CUDA ``q`` launches the CUDA kernel; a CPU ``q`` runs the plain
    version.  Any other device raises."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, groups=groups, window=window,
                               causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel runs on CUDA tensors (or "
                         f"its plain version on CPU ones), not {q.device}")
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if groups < 1 or bh != k.shape[0] * groups:
        raise ValueError(f"{bh} query heads do not split into groups of "
                         f"{groups} over {k.shape[0]} kv heads")
    width = padded_head_dim(hd)
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t, shape in (("k", k, (bh // groups, skv, hd)),
                           ("v", v, (bh // groups, skv, hd))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"attention needs {shape}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise TypeError(f"the attention kernel takes float32 or "
                            f"bfloat16 operands of one type; {name} is "
                            f"{t.dtype}, q {q.dtype}")
        if not t.is_contiguous() or not _aligned(t):
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if bh > 65535:
        raise ValueError(f"{bh} heads exceed the kernel's grid")
    lib = build(SOURCE)
    forward = lib.bind("attention_block_forward", 4, 9)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bh, sq, skv, hd, width, groups, window,
                      int(causal), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")
    attention.launches += 1
    return out


attention.launches = 0
