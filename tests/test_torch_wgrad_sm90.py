"""K2's sm90 route on the CPU: what the wrapper decides and computes
before it launches ``csrc/wgrad_lb_sm90.cu``.

  * :func:`route` for every case it reads (types, stride, channel
    counts, pointers, the window count and the halo box), and on the
    VGG16/224 and ResNet-20/32 stacks: ``sm90`` for the 12 bf16 VGG
    layers after conv1_1, ``sm90_im2col`` for conv1_1 (Ci = 3, through
    the im2col plane), ``fma`` for ResNet-20's stride-2 layers (f32
    takes ``sm90_tf32``; ``test_torch_wgrad_tc.py`` holds both newer
    routes);
  * :func:`sm90_wgrad_plan`: a ring that fits the card's shared memory,
    at most 128 f32 sums a consumer thread, and a split that covers the
    reduction exactly, for every VGG16/224 and ResNet-20/32 layer the
    route takes, at batch 1 and 8; conv5_x fills the card;
  * a numpy model of the A and B addressing: the transposed,
    128-byte-swizzled halo descriptor (the 64-channel boxes, the
    halo-row stride offset and the per-window shifts the wrapper passes)
    and the 128-byte-swizzled dy tile read N-major, applied to the
    operands as TMA lays them out (out-of-bounds zeros), read as wgmma
    reads MN-major operands, stored by the kernel's masks and summed
    over the splits in order, must reproduce ``wgrad_ref`` and the
    reference's ``wgrad_lb_call`` at its interpret target.  Tolerance:
    max |model - plain| <= 1e-5 * max |plain| (f32 sums in another
    order).

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.conv_lb.ops import plan_conv as jax_plan_conv
from repro.kernels.conv_lb.ops import plan_conv_wgrad as jax_plan_wgrad
from repro.kernels.conv_lb.wgrad import wgrad_lb_call
from repro_torch.core.hopper_adapter import SM_COUNT, SMEM_PER_BLOCK
from repro_torch.kernels.conv_lb import wgrad as W
from repro_torch.kernels.conv_lb.ops import plan_conv, plan_conv_wgrad
from repro_torch.kernels.conv_lb.ref import wgrad_ref
from repro_torch.models.cnn import resnet_graph, vgg_graph, vgg_layer_dims
from repro_torch.models.graph import graph_stages

BF = torch.bfloat16
TOL = 1e-5


def _vgg_stages():
    params = {"convs": [{"w": torch.empty((3, 3, ci, co))}
                        for _, ci, co, _, _ in vgg_layer_dims()]}
    return graph_stages(vgg_graph(params), 224, 224)


def _resnet_stages():
    return graph_stages(resnet_graph(), 32, 32)


def _misaligned(*shape, dtype=BF):
    """A contiguous tensor whose base is 2 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)
    assert t.data_ptr() % 16 == 2
    return t


def _geom(k=3, s=1, p=1, d=1):
    return W.WgradGeometry(hk=k, wk=k, stride=(s, s), padding=(p, p),
                           dilation=(d, d))


# ---------------------------------------------------------------- route


@pytest.mark.parametrize("case,want", [
    ("bf16", "sm90"),
    ("f32", "sm90_tf32"),
    ("bf16 x, f32 dy", "fma"),
    ("f32 x, bf16 dy", "fma"),
    ("stride 2", "fma"),
    ("stride (1, 2)", "fma"),
    ("dilation 2", "sm90"),
    ("padding 0", "sm90"),
    ("ci 3", "sm90_im2col"),
    ("ci 12", "fma"),
    ("ci 8", "sm90"),
    ("co 12", "fma"),
    ("co 200", "sm90"),
    ("x off by 2 bytes", "fma"),
    ("dy off by 2 bytes", "fma"),
    ("11x11 window (121 windows)", "sm90"),
    ("13x13 window (169 windows)", "fma"),
    ("halo of 258 columns", "fma"),
])
def test_route_reads_types_geometry_and_pointers(case, want):
    ci = {"ci 3": 3, "ci 12": 12, "ci 8": 8}.get(case, 64)
    co = {"co 12": 12, "co 200": 200}.get(case, 64)
    x = torch.zeros((2, 8, 8, ci), dtype=torch.float32 if case in (
        "f32", "f32 x, bf16 dy") else BF)
    dy = torch.zeros((2, 8, 8, co), dtype=torch.float32 if case in (
        "f32", "bf16 x, f32 dy") else BF)
    geom = _geom()
    if case.startswith("stride"):
        geom = dataclasses.replace(
            geom, stride=(2, 2) if case == "stride 2" else (1, 2))
    elif case == "dilation 2":
        geom = _geom(p=2, d=2)
    elif case == "padding 0":
        geom = _geom(p=0)
    elif case == "x off by 2 bytes":
        x = _misaligned(*x.shape)
    elif case == "dy off by 2 bytes":
        dy = _misaligned(*dy.shape)
    elif case.startswith("11x11"):
        geom = _geom(k=11, p=5)
    elif case.startswith("13x13"):
        geom = _geom(k=13, p=6)
    elif case.startswith("halo"):
        # 8 + 2 * 125 = 258 halo columns: past a TMA box's 256
        geom = _geom(p=125, d=125)
    assert W.route(x, dy, geom) == want


def test_route_names_sm90_for_vgg16_after_conv1_1():
    """conv1_1 (Ci = 3: 6-byte pixels TMA cannot stride) goes through
    the im2col plane; conv1_2 ... conv5_3 take the sm90 kernel in bf16
    and the 3xTF32 kernel in f32."""
    got = {BF: [], torch.float32: []}
    for st in _vgg_stages():
        n = st.node
        for dtype in got:
            x = torch.zeros((1, st.h, st.w, n.ci), dtype=dtype)
            dy = torch.zeros((1, st.ho, st.wo, n.co), dtype=dtype)
            got[dtype].append(W.route(x, dy, _geom(s=n.stride, p=n.pad)))
    assert got[BF] == ["sm90_im2col"] + ["sm90"] * 12
    assert got[torch.float32] == ["sm90_im2col"] + ["sm90_tf32"] * 12


def test_route_on_resnet20():
    """The stride-1 3x3 convs take sm90; the stem (Ci = 3) goes through
    the im2col plane; the stride-2 3x3 convs and the 1x1/2 projections
    stay on FMA."""
    got = {}
    for st in _resnet_stages():
        n = st.node
        x = torch.zeros((1, st.h, st.w, n.ci), dtype=BF)
        dy = torch.zeros((1, st.ho, st.wo, n.co), dtype=BF)
        got[n.name] = W.route(x, dy, _geom(k=n.hk, s=n.stride, p=n.pad))
    for name, rt in got.items():
        want = ("sm90_im2col" if name == "stem" else
                "fma" if name.endswith("_proj")
                or name in ("s2b0_a", "s3b0_a") else "sm90")
        assert rt == want, name
    assert sum(rt == "sm90" for rt in got.values()) == 16


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_plan_of_names_the_route_and_its_kernels_plan(dtype):
    """``plan_of`` gives what ``wgrad_lb`` launches on VGG16/224 at
    batch 8: the route :func:`W.route` names, with ``sm90_wgrad_plan``'s
    plan there (``sm90_tf32_wgrad_plan``'s and the im2col route's are
    held in ``test_torch_wgrad_tc.py``); a reference-style ``WgradPlan``
    names the same as its geometry."""
    for st in _vgg_stages():
        n = st.node
        x = torch.zeros((8, st.h, st.w, n.ci), dtype=dtype)
        dy = torch.zeros((8, st.ho, st.wo, n.co), dtype=dtype)
        geom = _geom(s=n.stride, p=n.pad)
        rt, plan = W.plan_of(x, dy, geom)
        assert rt == W.route(x, dy, geom)
        if rt == "sm90":
            assert plan == W.sm90_wgrad_plan(8, st.ho, st.wo, n.ci, n.co,
                                             3, 3, (1, 1))
            assert plan.tile == (plan.bn, plan.nwc, plan.cib, plan.splits)
        elif rt == "sm90_tf32":
            assert plan == W.sm90_tf32_wgrad_plan(8, st.ho, st.wo, n.ci,
                                                  n.co, 3, 3, (1, 1))
        else:
            assert rt == "sm90_im2col" and n.ci == 3
            assert plan.inner.nblk == 8 * 28 * 28
        wplan = plan_conv_wgrad(plan_conv(st.h, st.w, n.ci, n.co, 3, 3,
                                          batch=8, stride=(n.stride,) * 2,
                                          padding=(n.pad,) * 2))
        assert W.plan_of(x, dy, wplan) == (rt, plan)


def test_launch_counters_by_route():
    assert set(W.wgrad_lb.launches_by_route) == set(W.ROUTES) == {
        "sm90", "sm90_tf32", "sm90_im2col", "fma"}
    assert isinstance(W.wgrad_lb.launches, int)
    assert isinstance(W.wgrad_lb.reduce_launches, int)


# ---------------------------------------------------------------- plan


def _plan_cases():
    cases = []
    for st in _vgg_stages()[1:]:
        cases.append(("vgg " + st.node.name, st.ho, st.wo, st.node.ci,
                      st.node.co, 3))
    for st in _resnet_stages():
        n = st.node
        if n.stride == 1 and n.ci % 8 == 0 and n.co % 8 == 0:
            cases.append(("resnet " + n.name, st.ho, st.wo, n.ci, n.co,
                          n.hk))
    return cases


def _ring_bytes(p: W.Sm90WgradPlan) -> int:
    """The ring and barriers as csrc/wgrad_lb_sm90.cu lays them out: from
    a 1024-byte line, per stage a bn x 64-pixel dy tile and cib / 64
    halo boxes, then a full and an empty mbarrier per stage."""
    dy_tile = p.bn * 64 * 2
    halo = (p.cib // 64) * p.sub_bytes
    return 1024 + p.stages * (dy_tile + halo) + 16 * p.stages


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name,ho,wo,ci,co,k", _plan_cases())
def test_sm90_plan_fits_and_covers_the_reduction(name, ho, wo, ci, co, k,
                                                 batch):
    p = W.sm90_wgrad_plan(batch, ho, wo, ci, co, k, k, (1, 1))
    assert p is not None
    assert (p.bn, p.nwc) in W.SM90_TILES and p.cib in W.SM90_CIBS
    # registers: at most 128 f32 sums a consumer thread
    assert p.nwc * p.bn // 2 <= 128
    # shared memory, and the halo box TMA can describe
    assert p.smem_bytes == _ring_bytes(p) <= SMEM_PER_BLOCK
    assert 2 <= p.stages <= W.SM90_MAX_STAGES
    assert p.hy == 8 + k - 1 and p.hx == 8 + k - 1
    assert p.sub_bytes % 1024 == 0 and p.sub_bytes >= p.hy * p.hx * 128
    assert p.sbo == p.hx * 128
    # the split covers every pixel block once, no range empty
    nblk = batch * -(-ho // 8) * -(-wo // 8)
    assert p.nblk == nblk
    assert (p.splits - 1) * p.bps < nblk <= p.splits * p.bps
    assert p.bps <= W.SM90_MAX_RANGE
    # every (64-channel slice, window) row block of every Ci block, and
    # every column block, has a CTA
    groups = -(-(k * k * p.cib // 64) // (2 * p.nwc))
    assert p.tiles == -(-ci // p.cib) * groups * -(-co // p.bn)
    assert p.ws_bytes == (4 * p.splits * k * k * ci * co
                          if p.splits > 1 else 0)


@pytest.mark.parametrize("name", ["conv5_1", "conv5_2", "conv5_3"])
def test_sm90_plan_fills_the_card_on_vgg_conv5(name):
    """conv5_x at batch 8 (14 x 14, 32 pixel blocks, 4608 x 512 dW):
    the plan's CTAs fill at least 90% of the card's SMs in their last
    wave."""
    st = {s.node.name: s for s in _vgg_stages()}[name]
    p = W.sm90_wgrad_plan(8, st.ho, st.wo, 512, 512, 3, 3, (1, 1))
    waves = -(-p.ctas // SM_COUNT)
    assert p.ctas >= 0.9 * waves * SM_COUNT, p


def test_sm90_plan_refuses_what_fits_no_tile():
    assert W.sm90_wgrad_plan(1, 8, 8, 64, 64, 13, 13, (1, 1)) is None
    assert W.sm90_wgrad_plan(1, 8, 8, 64, 64, 3, 3, (125, 125)) is None
    assert W.sm90_wgrad_plan(1, 8, 8, 64, 64, 11, 11, (1, 1)) is not None


def test_kernel_constants_match_the_wrapper():
    src = W.SM90_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kConsumers") == W.SM90_CONSUMERS
    assert const("kBlock") == W.SM90_BLOCK
    assert const("kMaxWin") == W.SM90_MAX_WIN
    assert const("kMaxStages") == W.SM90_MAX_STAGES
    # every (bn, nwc) the plan may pick has an instance, and no other
    inst = set(re.findall(r"if \(bn == (\d+) && nwc == (\d+)\)", src))
    assert {(int(a), int(b)) for a, b in inst} == set(W.SM90_TILES)


def test_wrapper_binds_the_kernels_c_interface():
    """The number of ints ``_sm90`` passes is the C function's."""
    src = W.SM90_SOURCE.read_text()
    sig = re.search(r'extern "C" int wgrad_lb_sm90_forward\((.*?)\)',
                    src, re.S)[1]
    params = [p.strip() for p in sig.split(",")]
    assert sum(p.startswith("int ") for p in params) == 22
    assert sum("*" in p for p in params) == 6      # 5 operands + stream
    assert "_entry(SM90_SOURCE, \"wgrad_lb_sm90_forward\", 5, 22)" in \
        Path(W.__file__).read_text()


# ------------------------------------------ numpy model of A's and B's reads


def _swizzle128(off: np.ndarray) -> np.ndarray:
    """The 128-byte swizzle on offsets from a 1024-byte line: the 16-byte
    chunk (bits 4-6) XOR the 128-byte row within the line (bits 7-9)."""
    return off ^ (((off >> 7) & 7) << 4)


def _stage(xp, dyp, p: W.Sm90WgradPlan, pad, margin, b, oy0, ox0, ci0,
           n0) -> tuple[np.ndarray, np.ndarray]:
    """One ring stage in 2-byte words, as the kernel's 4-D TMA loads lay
    it out, 128-byte swizzled from 1024-byte lines: the dy tile (bn / 64
    boxes of 64 channels x 8 x 8 pixels, 8 KB apart, row 8 oy + ox) and
    the halo (box q, channels ci0 + 64q .., at q * sub_bytes, [hy][hx]
    pixels of 128 bytes from (oy0 - py, ox0 - px)).  ``xp`` and ``dyp``
    carry zeros past every edge (TMA's out-of-bounds fill)."""
    dy_words = np.zeros(p.bn * 64)
    for j in range(p.bn // 64):
        box = dyp[b, oy0:oy0 + 8, ox0:ox0 + 8, n0 + 64 * j:n0 + 64 * j + 64]
        off = j * 8192 + np.arange(64 * 128, step=2)
        dy_words[_swizzle128(off) // 2] = box.reshape(-1)
    h_words = np.zeros((p.cib // 64) * p.sub_bytes // 2)
    y0, x0 = oy0 - pad[0] + margin, ox0 - pad[1] + margin
    for q in range(p.cib // 64):
        box = xp[b, y0:y0 + p.hy, x0:x0 + p.hx,
                 ci0 + 64 * q:ci0 + 64 * q + 64]
        off = q * p.sub_bytes + np.arange(box.size * 2, step=2)
        h_words[_swizzle128(off) // 2] = box.reshape(-1)
    return dy_words, h_words


def _read_a(words: np.ndarray, start: int, sbo: int) -> np.ndarray:
    """The 64 x 16 A tile wgmma reads from an MN-major descriptor with the
    128-byte swizzle (imm-trans-a): row m (a channel), column k (a pixel)
    at the swizzle of start + (k // 8) * sbo + (k % 8) * 128 + m * 2
    bytes (64 rows: one swizzle atom wide, no leading offset)."""
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    addr = start + (k // 8) * sbo + (k % 8) * 128 + m * 2
    assert addr.min() >= 0 and addr.max() < 2 * words.size
    return words[_swizzle128(addr) // 2]


def _read_b(words: np.ndarray, start: int, lbo: int, sbo: int, n: int
            ) -> np.ndarray:
    """The 16 x n B tile wgmma reads from an MN-major descriptor with the
    128-byte swizzle (imm-trans-b): row k, column c at the swizzle of
    start + (c // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 +
    (c % 64) * 2 bytes."""
    k = np.arange(16)[:, None]
    c = np.arange(n)[None, :]
    addr = start + (c // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 \
        + (c % 64) * 2
    assert addr.min() >= 0 and addr.max() < 2 * words.size
    return words[_swizzle128(addr) // 2]


def _model_wgrad(x: np.ndarray, dy: np.ndarray, p: W.Sm90WgradPlan, k: int,
                 pad) -> np.ndarray:
    """The sm90 kernel's dW for every CTA of the plan: per pixel block
    of its range one ring stage, per row block and k16 step one A read
    through the passed offsets and one B read, the tile stored through
    the kernel's masks into its split's slice, the slices summed in
    split order."""
    b, h, wd, ci = x.shape
    _, ho, wo, co = dy.shape
    nwin = k * k
    margin = max(p.hy, p.hx) + max(pad)
    ncb = -(-ci // p.cib)
    nco = -(-co // p.bn)
    xp = np.zeros((b, h + 2 * margin, wd + 2 * margin, ncb * p.cib))
    xp[:, margin:margin + h, margin:margin + wd, :ci] = x
    dyp = np.zeros((b, ho + 8, wo + 8, nco * p.bn))
    dyp[:, :ho, :wo, :co] = dy
    nby, nbx = -(-ho // 8), -(-wo // 8)
    nrb = nwin * p.cib // 64
    ngrp = -(-nrb // (2 * p.nwc))
    assert p.tiles == ncb * ngrp * nco
    ws = np.full((p.splits, nwin, ci, co), np.nan)
    for z in range(p.splits):
        blocks = range(z * p.bps, min(p.nblk, (z + 1) * p.bps))
        for cb, grp, nb in np.ndindex(ncb, ngrp, nco):
            rbs = [(grp * 2 + cw) * p.nwc + j for cw in range(2)
                   for j in range(p.nwc)]
            offs = [(min(r, nrb - 1) // nwin) * p.sub_bytes
                    + p.win_off[min(r, nrb - 1) % nwin] for r in rbs]
            acc = np.zeros((len(rbs), 64, p.bn))
            for blk in blocks:
                bi, rem = divmod(blk, nby * nbx)
                oy0, ox0 = (rem // nbx) * 8, (rem % nbx) * 8
                dy_w, h_w = _stage(xp, dyp, p, pad, margin, bi, oy0, ox0,
                                   cb * p.cib, nb * p.bn)
                for kk in range(4):
                    bt = _read_b(dy_w, kk * 2048, 8192, 1024, p.bn)
                    for i, off in enumerate(offs):
                        at = _read_a(h_w, off + kk * 2 * p.sbo, p.sbo)
                        acc[i] += at @ bt
            for i, r in enumerate(rbs):
                if r >= nrb:
                    continue
                c0 = cb * p.cib + (r // nwin) * 64
                real = min(64, ci - c0)
                cols = min(p.bn, co - nb * p.bn)
                if real > 0:
                    ws[z, r % nwin, c0:c0 + real,
                       nb * p.bn:nb * p.bn + cols] = acc[i, :real, :cols]
    assert not np.isnan(ws).any()     # every slice fully written
    out = ws[0].copy()
    for z in range(1, p.splits):
        out += ws[z]
    return out.reshape(k, k, ci, co)


def _plan(b, ho, wo, ci, co, k, d, tile=None, splits=None):
    p = W.sm90_wgrad_plan(b, ho, wo, ci, co, k, k, (d, d), only=tile)
    if splits is not None:
        bps = -(-p.nblk // splits)
        p = dataclasses.replace(p, splits=splits, bps=bps)
        assert (splits - 1) * bps < p.nblk
    return p


def _inputs(b, h, w, ci, co, k, pad, d, seed):
    rng = np.random.default_rng(seed)
    ho = h + 2 * pad - (k - 1) * d
    wo = w + 2 * pad - (k - 1) * d
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    dy = rng.standard_normal((b, ho, wo, co)).astype(np.float32)
    return x, dy, ho, wo


def _close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), err


# b, h, w, ci, co, k, pad, dilation: a ragged 9 x 11 plane (pixel blocks
# past Ho and Wo), dilation 2 at pad 2, Ci 24 (a Ci block past Ci),
# Ci 136 (two 128-channel Ci blocks, the second mostly past Ci) with
# Co 72 (a column block past Co), a 1x1
MODEL_CASES = [
    (2, 9, 11, 16, 16, 3, 1, 1),
    (1, 10, 10, 24, 8, 3, 2, 2),
    (1, 8, 9, 136, 72, 3, 1, 1),
    (2, 8, 8, 16, 16, 1, 0, 1),
]


@pytest.mark.parametrize("tile", [(bn, nwc, cib) for bn, nwc in W.SM90_TILES
                                  for cib in W.SM90_CIBS])
@pytest.mark.parametrize("b,h,w,ci,co,k,pad,d", MODEL_CASES)
def test_addressing_model_reproduces_the_plain_wgrad(b, h, w, ci, co, k,
                                                     pad, d, tile):
    """Every tile the plan may pick, with the offsets
    :func:`sm90_wgrad_layout` computes (what the wrapper passes), over
    two split ranges (the second pass in split order)."""
    x, dy, ho, wo = _inputs(b, h, w, ci, co, k, pad, d, seed=ci + h)
    p = _plan(b, ho, wo, ci, co, k, d, tile=tile, splits=2)
    got = _model_wgrad(x, dy, p, k, (pad, pad))
    want = wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy), k, k,
                     padding=pad, dilation=d).numpy()
    _close(got, want)


def test_addressing_model_at_the_plans_own_tile_matches_the_reference():
    """The tile, split and offsets :func:`sm90_wgrad_plan` picks for a
    small conv, against ``wgrad_ref`` and the reference's Pallas
    ``wgrad_lb_call`` at its interpret target (cropped to the layer's
    channels)."""
    b, h, w, ci, co, k, pad, d = 2, 12, 12, 16, 16, 3, 1, 1
    x, dy, ho, wo = _inputs(b, h, w, ci, co, k, pad, d, seed=7)
    p = W.sm90_wgrad_plan(b, ho, wo, ci, co, k, k, (d, d))
    assert p is not None
    got = _model_wgrad(x, dy, p, k, (pad, pad))
    rplan = jax_plan_wgrad(jax_plan_conv(h, w, ci, co, k, k, batch=b,
                                         stride=(1, 1), padding=(pad, pad),
                                         dilation=(d, d)))
    # the reference kernel at its default, the interpret target
    ref_kernel = np.asarray(wgrad_lb_call(x, dy, rplan))[..., :ci, :co]
    _close(got, ref_kernel)
    _close(got, wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy), k, k,
                          padding=pad).numpy())


def test_addressing_model_sees_a_halo_one_row_off():
    """The card's control: the centre window's shift one halo row too
    far (``sbo`` added) gives a dW far outside the tolerance."""
    b, h, w, ci, co, k, pad, d = 1, 8, 8, 16, 8, 3, 1, 1
    x, dy, ho, wo = _inputs(b, h, w, ci, co, k, pad, d, seed=9)
    p = W.sm90_wgrad_plan(b, ho, wo, ci, co, k, k, (d, d))
    off = list(p.win_off)
    off[4] += p.sbo
    got = _model_wgrad(x, dy, dataclasses.replace(p, win_off=tuple(off)),
                       k, (pad, pad))
    want = wgrad_ref(torch.from_numpy(x), torch.from_numpy(dy), k, k,
                     padding=pad).numpy()
    assert np.abs(got - want).max() > 100 * TOL * np.abs(want).max()
