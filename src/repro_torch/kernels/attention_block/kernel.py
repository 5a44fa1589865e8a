"""The attention kernels' wrapper: build, bind and launch the three
hand-written CUDA kernels of K4, which together replace the TPU kernel
``_attn_kernel`` / ``attention_call`` of
``repro/kernels/attention_block/kernel.py``:

  * ``csrc/attention_block_sm90.cu`` (route ``"sm90"``): bf16 on the
    tensor cores, TMA into an mbarrier ring feeding ``wgmma``;
  * ``csrc/attention_block_sm90_tf32.cu`` (route ``"sm90_tf32"``): f32
    on the tensor cores in 3xTF32, the same ring in 32-key stages,
    producer warps splitting each K tile into hi and lo and rewriting
    each V tile into K-major hi and lo tiles of V^T
    (:func:`sm90_tf32_plan` lays out its shared memory);
  * ``csrc/attention_block.cu`` (route ``"fma"``): the f32 and bf16
    head dims TMA cannot describe and every head dim above the tensor
    -core routes' widths, on FMA.

The libraries are built like the conv kernel's
(:mod:`repro_torch.kernels.nvcc`): ``nvcc`` at first use, never at
import.  :func:`attention` dispatches on where its
tensors lie: a CUDA tensor launches a kernel or raises; a CPU tensor
runs the plain version
(:func:`~repro_torch.kernels.attention_block.ref.attention_plain`).  On
the card :func:`route` picks the kernel from type and head dim before
launch, never by trying one.  Each launch adds one to
``attention.launches`` and to its route's entry of
``attention.launches_by_route``; a launch that also writes each row's
log-sum-exp (``lse=True``) adds one to its route's entry of
``attention.lse_launches_by_route`` besides.

Log-sum-exp: each of the three kernels can write, beside O, each row's
``lse`` in f32, (B*H, Sq): the natural log of the row's sum of
``exp(scale * s)`` over its unmasked keys, ``scale * max + log sum
exp(scale * s - scale * max)`` (the bf16 and 3xTF32 kernels keep their
row max in the exp2 domain and write ``ln 2 * (m2 + log2 l)``), and
``-inf`` for a row with no unmasked key (whose O keeps the mean-of-V
rule).  O is the same, bit for bit, with and without it.  Partial
attentions over shards of the keys merge through it
(:func:`~repro_torch.kernels.attention_block.ops.combine_partials`).

Every kernel visits only the key tiles that hold an unmasked pair for a
query tile (:func:`key_tile_range`, which the CUDA code mirrors).  Each
runs a head dim at the next width it is instantiated for
(:func:`padded_head_dim`, :func:`sm90_head_dim`,
:func:`sm90_tf32_head_dim`), with zeros in the
padded columns and the softmax scale of the real head dim; the FMA
kernel runs a head dim above 256 as ``ceil(hd / 256)`` column chunks
(:func:`head_dim_chunks`).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from repro_torch.analysis.plan_check import LaunchFacts, TmaMap, tile_fits
from repro_torch.core.layer import ceil_div
from repro_torch.kernels.attention_block.ref import attention_plain
from repro_torch.kernels.conv_lb.kernel import _aligned
from repro_torch.kernels.nvcc import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "attention_block.cu"
SM90_SOURCE = (Path(__file__).resolve().parent / "csrc"
               / "attention_block_sm90.cu")
TF32_SOURCE = (Path(__file__).resolve().parent / "csrc"
               / "attention_block_sm90_tf32.cu")

#: the widths the FMA kernel is instantiated for (must match
#: csrc/attention_block.cu); a head dim runs at the next one, and one
#: above the last as column chunks of it
HEAD_DIMS = (8, 16, 32, 64, 80, 96, 128, 256)
#: the tiles every kernel skips key tiles on (must match every source):
#: 64 query rows (an FMA CTA, a tensor-core kernel's consumer warpgroup)
#: x 64 keys (two ring stages of the 3xTF32 kernel)
BQ = BKV = 64
#: the widths the sm90 kernel is instantiated for (must match
#: csrc/attention_block_sm90.cu)
SM90_HEAD_DIMS = (64, 80, 96, 128, 256)
#: input types the kernels take, by the code the FMA kernel's C
#: interface uses
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the 3xTF32 kernel's shape (must match csrc/attention_block_sm90_tf32.cu):
#: the widths it is instantiated for, 128 query rows a CTA (two consumer
#: warpgroups of 64), 32 keys a ring stage (a 64-key skip tile in two),
#: two stages in each of its two rings, three producer warps splitting
#: K and rewriting V as V^T
TF32_HEAD_DIMS = (64, 96, 128)
TF32_BQ = 128
TF32_BK = 32
TF32_STAGES = 2
TF32_TRANSPOSERS = 3
#: 3xTF32: three tensor-core products per multiply-add
TF32_PRODUCTS = 3
ROUTES = ("sm90", "sm90_tf32", "fma")
#: the grid's limits: blocks along x, and along y (the column chunks)
GRID_X, GRID_Y = 2 ** 31 - 1, 65535


def padded_head_dim(hd: int) -> int:
    """The width the FMA kernel runs head dim ``hd`` at: the least
    instantiated width >= ``hd``; above the last (256), 256, in
    :func:`head_dim_chunks` column chunks."""
    for width in HEAD_DIMS:
        if width >= hd:
            return width
    return HEAD_DIMS[-1]


def head_dim_chunks(hd: int) -> int:
    """The FMA kernel's 256-column chunks of head dim ``hd``: one up to
    256, ``ceil(hd / 256)`` above."""
    return ceil_div(hd, HEAD_DIMS[-1])


def sm90_head_dim(hd: int) -> int | None:
    """The width the sm90 kernel runs head dim ``hd`` at, or ``None``
    where TMA cannot describe its rows (``hd * 2`` not a multiple of 16
    bytes) or ``hd`` exceeds 256."""
    if hd % 8:
        return None
    for width in SM90_HEAD_DIMS:
        if width >= hd:
            return width
    return None


def sm90_cta_rows(width: int) -> int:
    """Query rows of one sm90 CTA at ``width``: two consumer
    warpgroups of 64, one above 128 (where O alone takes 128 registers
    a thread)."""
    return BQ if width > 128 else 2 * BQ


@dataclasses.dataclass(frozen=True)
class Tf32Plan:
    """The 3xTF32 kernel's shared memory at one width, in bytes from the
    1024-byte line the kernel aligns its base to (the swizzle's period):
    the Q tile (128 rows of 32-column boxes), the raw ring (a K tile,
    which the producer warps overwrite with its hi words, and a V tile,
    per stage, as TMA lays them out), the split ring (K lo, V^T hi and
    V^T lo per stage), then a full and an empty mbarrier per stage of
    each ring and Q's.  ``smem_bytes`` adds the alignment slack.
    ``v_key_off`` is the key the transposers read V at, relative to the
    one they write (0; anything else is the smoke's control, never a
    route)."""
    width: int
    q_bytes: int
    tile_bytes: int      # one 32-key K, V, K lo, V^T hi or V^T lo tile
    raw: int
    split: int
    bars: int
    smem_bytes: int
    v_key_off: int = 0


def sm90_tf32_plan(width: int) -> Tf32Plan | None:
    """The 3xTF32 kernel's layout at ``width``, or ``None`` where it is
    not instantiated or does not fit the card's shared memory."""
    if width not in TF32_HEAD_DIMS:
        return None
    q_bytes = TF32_BQ * width * 4
    tile = TF32_BK * width * 4
    raw = q_bytes
    split = raw + TF32_STAGES * 2 * tile
    bars = split + TF32_STAGES * 3 * tile
    smem = 1024 + bars + 8 * (1 + 4 * TF32_STAGES)
    if not tile_fits(smem):
        return None
    return Tf32Plan(width=width, q_bytes=q_bytes, tile_bytes=tile, raw=raw,
                    split=split, bars=bars, smem_bytes=smem)


def sm90_tf32_head_dim(hd: int) -> int | None:
    """The width the 3xTF32 kernel runs f32 head dim ``hd`` at (the next
    of :data:`TF32_HEAD_DIMS` whose plan fits), or ``None`` where TMA
    cannot describe its rows (``hd * 4`` not a multiple of 16 bytes) or
    no width takes it."""
    if hd < 1 or hd % 4:
        return None
    for width in TF32_HEAD_DIMS:
        if width >= hd and sm90_tf32_plan(width) is not None:
            return width
    return None


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"sm90"`` iff q, k and v are bf16 and the head dim has an sm90
    width (:func:`sm90_head_dim`); ``"sm90_tf32"`` iff they are f32 and
    the head dim has a 3xTF32 width whose plan fits
    (:func:`sm90_tf32_head_dim`); else ``"fma"``.  Read from types and
    shapes only."""
    hd = q.shape[-1]
    if q.dtype == k.dtype == v.dtype == torch.bfloat16 \
            and sm90_head_dim(hd) is not None:
        return "sm90"
    if q.dtype == k.dtype == v.dtype == torch.float32 \
            and sm90_tf32_head_dim(hd) is not None:
        return "sm90_tf32"
    return "fma"


def cta_rows(rt: str, hd: int) -> int:
    """Query rows of one CTA of route ``rt`` at head dim ``hd``."""
    if rt == "sm90":
        return sm90_cta_rows(sm90_head_dim(hd) or 0)
    if rt == "sm90_tf32":
        return TF32_BQ
    return BQ


def key_tile_range(q0: int, q1: int, skv: int, window: int, causal: bool,
                   bkv: int) -> tuple[int, int]:
    """The key tiles ``[lo, hi)`` of ``bkv`` keys that query rows
    ``[q0, q1)`` visit: every tile that holds an unmasked pair (up to
    the diagonal under ``causal``, from the tile that holds
    ``q0 - window + 1`` under a window); every tile if a row has no
    unmasked key (``q1 - 1 >= skv + window - 1`` with a window), which
    then takes the mean of V over all ``skv`` keys.  The CUDA kernels
    mirror it."""
    nkv = ceil_div(skv, bkv)
    if window > 0 and q1 - 1 >= skv + window - 1:
        return 0, nkv
    hi = min(nkv, (q1 - 1) // bkv + 1) if causal else nkv
    lo = max(0, q0 - window + 1) // bkv if window > 0 else 0
    return lo, hi


def visited_pairs(sq: int, skv: int, window: int, causal: bool) -> int:
    """(query, key) pairs every kernel visits per head: each 64-row query
    tile's real rows against the real keys of the key tiles
    :func:`key_tile_range` gives it."""
    pairs = 0
    for q0 in range(0, sq, BQ):
        q1 = min(q0 + BQ, sq)
        lo, hi = key_tile_range(q0, q1, skv, window, causal, BKV)
        pairs += (q1 - q0) * max(0, min(hi * BKV, skv) - lo * BKV)
    return pairs


def attention_stages(width: int, dtype: torch.dtype) -> int:
    """K/V stages the FMA kernel keeps at ``width``: two where they fit
    in the card's shared memory, else one (f32 at 256)."""
    return 2 if tile_fits(attention_smem_bytes(width, dtype, 2)) else 1


def attention_smem_bytes(width: int, dtype: torch.dtype,
                         stages: int | None = None) -> int:
    """Dynamic shared memory of one FMA CTA: Q, ``stages`` stages of K
    and V (rows padded by 16 bytes) and the f32 P tile.  A head dim
    above 256 runs the one-stage tile of width 256 (a Q chunk, a K
    chunk and its own V columns)."""
    if stages is None:
        stages = attention_stages(width, dtype)
    elt = torch.empty((), dtype=dtype).element_size()
    return ((BQ + 2 * stages * BKV) * (width + 16 // elt) * elt
            + BQ * (BKV + 4) * 4)


def sm90_smem_bytes(width: int) -> int:
    """The sm90 kernel's dynamic shared memory at ``width``
    (``Cfg<HD>::kBytes``): 1024 bytes of alignment, the Q tile and two
    stages of a K and a V tile, each in 64-column boxes of 128-byte
    rows, a full and an empty mbarrier a stage and Q's."""
    boxes = ceil_div(width, 64)
    return (1024 + sm90_cta_rows(width) * 128 * boxes
            + 2 * 2 * BKV * 128 * boxes + 8 * (1 + 2 * 2))


def plan_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            via: str | None = None):
    """The route :func:`attention` takes (``via``, where given) and its
    kernel's plan: the sm90 kernel's width (``"sm90"``), the 3xTF32
    kernel's :class:`Tf32Plan` (``"sm90_tf32"``), or the FMA kernel's
    width (``"fma"``); the plan ``None`` where ``via`` names a route
    that does not take the input."""
    rt = route(q, k, v) if via is None else via
    hd = q.shape[-1]
    if rt == "sm90":
        return rt, (sm90_head_dim(hd) if q.dtype == torch.bfloat16
                    else None)
    if rt == "sm90_tf32":
        width = sm90_tf32_head_dim(hd) if q.dtype == torch.float32 else None
        return rt, None if width is None else sm90_tf32_plan(width)
    return rt, padded_head_dim(hd)


def launch_facts(kernel: str, route: str, plan, shape, dtype
                 ) -> tuple[LaunchFacts, ...]:
    """What one launch of route ``route`` with ``plan`` (its
    :func:`plan_of`) asks of the card, for
    :func:`~repro_torch.analysis.plan_check.check_launch_plan`:
    ``shape`` is ``(bh, sq, skv, hd, groups)``."""
    if kernel != "attention":
        raise ValueError(f"{kernel!r} is not this module's kernel")
    bh, sq, skv, hd, _ = shape
    if route == "fma":
        wide = head_dim_chunks(hd) > 1
        return (LaunchFacts(
            source=SOURCE.stem,
            function="attention_wide_kernel" if wide else "attention_kernel",
            grid=(ceil_div(sq, BQ) * bh, head_dim_chunks(hd), 1),
            threads=256, smem_bytes=attention_smem_bytes(
                plan, dtype, 1 if wide else None)),)
    tf32 = route == "sm90_tf32"
    if tf32:
        elt, cols, rows, width = 4, TF32_BK, TF32_BQ, plan.width
        threads, smem, kv_rows = 384, plan.smem_bytes, TF32_BK
        function = f"attention_sm90_tf32_kernelILi{width}E"
    else:
        elt, cols, rows, width = 2, 64, sm90_cta_rows(plan), plan
        threads = 128 * (1 + rows // BQ)
        smem, kv_rows = sm90_smem_bytes(plan), BKV
        function = f"attention_sm90_kernelILi{width}E"
    return (LaunchFacts(
        source=(TF32_SOURCE if tf32 else SM90_SOURCE).stem,
        function=function,
        grid=(ceil_div(sq, rows) * bh, 1, 1), threads=threads,
        smem_bytes=smem,
        maps=(TmaMap("q", (cols, rows, 1), (hd * elt, hd * elt * sq)),
              TmaMap("k", (cols, kv_rows, 1), (hd * elt, hd * elt * skv)),
              TmaMap("v", (cols, kv_rows, 1), (hd * elt, hd * elt * skv)))),)


def _launched(lib, err: int, name: str, rt: str, lse=None) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.error_string(err)} (error {err})")
    attention.launches += 1
    attention.launches_by_route[rt] += 1
    if lse is not None:
        attention.lse_launches_by_route[rt] += 1


def _lse_buffer(lse: bool, q: torch.Tensor) -> torch.Tensor | None:
    """The f32 (B*H, Sq) tensor the log-sum-exp goes to, where ``lse``
    asks for it."""
    if not lse:
        return None
    return torch.empty(tuple(q.shape[:2]), dtype=torch.float32,
                       device=q.device)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              groups: int, window: int = 0, causal: bool = True,
              via: str | None = None, lse: bool = False):
    """q (B*H, Sq, hd); k, v (B*KV, Skv, hd) with H = KV * ``groups``
    -> (B*H, Sq, hd) in ``q.dtype``; with ``lse`` the pair (out, lse),
    ``lse`` the f32 (B*H, Sq) log-sum-exp of each row (module
    docstring).

    A CUDA ``q`` launches the kernel :func:`route` names, or the one
    ``via`` names (``"fma"`` takes every input; ``"sm90"`` and
    ``"sm90_tf32"`` raise on an input they do not take); a CPU ``q``
    runs the plain version; a ``meta`` ``q`` gives the output's shape
    and type and computes nothing (:func:`_meta`).  Any other device
    raises."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, groups=groups, window=window,
                               causal=causal, return_lse=bool(lse))
    if q.device.type == "meta":
        return _meta(q, k, v, window=window, causal=causal, lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernel runs on CUDA tensors (or "
                         f"its plain version on CPU ones), not {q.device}")
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if groups < 1 or bh != k.shape[0] * groups:
        raise ValueError(f"{bh} query heads do not split into groups of "
                         f"{groups} over {k.shape[0]} kv heads")
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
    if max(sq, skv, hd, window) >= 2 ** 31 or \
            max(q.numel(), k.numel()) >= 2 ** 62:
        raise ValueError(f"attention of {bh} heads x {sq} x {skv} keys at "
                         f"head dim {hd} exceeds the kernel's index range")
    rt, _ = plan_of(q, k, v, via)
    if rt not in ROUTES:
        raise ValueError(f"unknown attention route {rt!r}; expected one "
                         f"of {ROUTES}")
    bq = cta_rows(rt, hd)
    if ceil_div(sq, bq) * bh > GRID_X:
        raise ValueError(f"{bh} heads x {ceil_div(sq, bq)} query tiles "
                         f"exceed the grid's {GRID_X} blocks")
    if head_dim_chunks(hd) > GRID_Y:
        raise ValueError(f"head dim {hd} needs {head_dim_chunks(hd)} "
                         f"column chunks, more than the grid's {GRID_Y}")
    buf = _lse_buffer(lse, q)
    if rt == "sm90_tf32":
        width = sm90_tf32_head_dim(hd)
        if q.dtype != torch.float32 or width is None:
            raise ValueError(f"route sm90_tf32 takes f32 at a head dim "
                             f"that is a multiple of 4 up to "
                             f"{TF32_HEAD_DIMS[-1]}, not {q.dtype} at {hd}")
        out = _sm90_tf32(q, k, v, sm90_tf32_plan(width), groups=groups,
                         window=window, causal=causal, lse=buf)
        return out if buf is None else (out, buf)
    out = torch.empty_like(q)
    if rt == "sm90":
        width = sm90_head_dim(hd)
        if q.dtype != torch.bfloat16 or width is None:
            raise ValueError(f"route sm90 takes bf16 at a head dim that "
                             f"is a multiple of 8 up to 256, not {q.dtype} "
                             f"at {hd}")
        lib = build(SM90_SOURCE)
        entry = "attention_block_sm90_forward"
        args = (bh, sq, skv, hd, width, groups, window, int(causal))
        name = "attention_block_sm90"
    else:
        lib = build(SOURCE)
        entry = "attention_block_forward"
        args = (bh, sq, skv, hd, padded_head_dim(hd), groups, window,
                int(causal), DTYPES[q.dtype])
        name = "attention_block"
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if buf is not None:
        entry += "_lse"
        ptrs += (buf.data_ptr(),)
    forward = lib.bind(entry, len(ptrs), len(args))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = forward(*ptrs, *args, stream)
    _launched(lib, err, name, rt, buf)
    return out if buf is None else (out, buf)


def _sm90_tf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               plan: Tf32Plan, *, groups: int, window: int, causal: bool,
               lo_terms: bool = True,
               lse: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of ``csrc/attention_block_sm90_tf32.cu`` on ``plan``,
    the inputs checked by :func:`attention`; ``lse``, where given, the
    f32 (B*H, Sq) tensor the kernel writes each row's log-sum-exp to.
    ``lo_terms=False`` drops every lo word (1xTF32), and a plan with
    ``v_key_off`` 1 has the transposers read V one key off: controls
    that the card's gate sees each, never a route."""
    bh, sq, hd = q.shape
    lib = build(TF32_SOURCE)
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    entry = "attention_block_sm90_tf32_forward"
    if lse is not None:
        entry += "_lse"
        ptrs += (lse.data_ptr(),)
    forward = lib.bind(entry, len(ptrs), 14)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = forward(*ptrs, bh, sq, k.shape[1], hd, plan.width,
                      groups, window, int(causal), plan.raw, plan.split,
                      plan.bars, plan.smem_bytes, plan.v_key_off,
                      int(lo_terms), stream)
    _launched(lib, err, "attention_block_sm90_tf32", "sm90_tf32", lse)
    return out


def _meta_op():
    """``repro_torch::attention_meta``, registered at first use: K4's
    stand-in on the ``meta`` device (the dry-run), an op whose fake
    implementation gives the output's shape and type, and which
    ``torch.utils.flop_counter.FlopCounterMode`` counts at 4 * hd FLOPs
    for each (query, key) pair the kernels visit
    (:func:`visited_pairs`).  It computes nothing, on any device."""
    try:
        return torch.ops.repro_torch.attention_meta
    except AttributeError:
        pass
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::attention_meta", mutates_args=())
    def op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           causal: bool) -> torch.Tensor:
        raise ValueError("attention_meta computes nothing: it takes meta "
                         "tensors only")

    @op.register_fake
    def _shape(q, k, v, window, causal):
        return torch.empty_like(q)

    @register_flop_formula(torch.ops.repro_torch.attention_meta)
    def _flops(q_shape, k_shape, v_shape, window, causal, *args, **kwargs):
        bh, sq, hd = q_shape
        return 4 * hd * bh * visited_pairs(sq, k_shape[1], window, causal)
    return torch.ops.repro_torch.attention_meta


def _meta(q, k, v, *, window: int, causal: bool, lse: bool):
    """:func:`attention` of ``meta`` tensors: the output (and the f32
    log-sum-exp) as empty tensors of the right shape and type, counted
    by :func:`_meta_op`'s FLOP formula.  Nothing is launched."""
    out = _meta_op()(q, k, v, int(window), bool(causal))
    if not lse:
        return out
    return out, torch.empty(q.shape[:2], dtype=torch.float32, device="meta")


attention.launches = 0
attention.launches_by_route = dict.fromkeys(ROUTES, 0)
attention.lse_launches_by_route = dict.fromkeys(ROUTES, 0)
