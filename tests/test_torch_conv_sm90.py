"""K1's sm90 route on the CPU: what the wrapper decides and computes
before it launches ``csrc/conv_lb_sm90.cu``.

  * :func:`route` for every case it reads (types, stride, lhs dilation,
    channel counts, pointers, the fused pool), and on the VGG16/224
    stack: ``sm90`` (bf16) or ``sm90_tf32`` (f32,
    ``test_torch_conv_tc.py``) for the 12 layers after conv1_1 and
    their dgrads, ``sm90_im2col`` for conv1_1 (Ci = 3, through the
    im2col plane);
  * :func:`sm90_plan`: two pool-aligned 8 x 8 blocks per CTA whose
    rings fit the card's shared memory, for every VGG16/224 and
    ResNet-20/32 layer the route takes, at batch 1 and 8;
  * a numpy model of the A addressing: the plane leading offset, the
    row stride offset, the consumers' block offsets and the per-window
    shifts that the wrapper passes to the kernel, applied to the halo
    as TMA lays it out (out-of-bounds zeros), read as wgmma reads a
    K-major operand with no swizzle, must reproduce ``conv2d_ref``.
    Tolerance: max |model - plain| <= 1e-5 * max |plain| (f32 sums in
    another order).

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.hopper_adapter import SMEM_PER_BLOCK
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb.ref import conv2d_ref, flip_w
from repro_torch.models.cnn import resnet_graph, vgg_graph, vgg_layer_dims
from repro_torch.models.graph import graph_stages

BF = torch.bfloat16


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


# ---------------------------------------------------------------- route


def _operands(ci=64, co=64, dtype=BF, bias=True):
    x = torch.zeros((2, 8, 8, ci), dtype=dtype)
    w = torch.zeros((3, 3, ci, co), dtype=dtype)
    b = torch.zeros((co,), dtype=dtype) if bias else None
    return x, w, b


@pytest.mark.parametrize("case,want", [
    ("bf16", "sm90"),
    ("f32", "sm90_tf32"),
    ("bf16 x, f32 w", "fma"),
    ("f32 bias", "fma"),
    ("stride 2", "fma"),
    ("stride (1, 2)", "fma"),
    ("lhs dilation 2", "fma"),
    ("lhs dilation (1, 2)", "fma"),
    ("rhs dilation 2", "sm90"),
    ("ci 3", "sm90_im2col"),
    ("ci 12", "fma"),
    ("ci 8", "sm90"),
    ("co 12", "fma"),
    ("co 200", "sm90"),
    ("x off by 2 bytes", "fma"),
    ("w off by 2 bytes", "fma"),
    ("bias off by 2 bytes", "fma"),
    ("residual off by 2 bytes", "fma"),
    ("residual", "sm90"),
    ("pool 2", "sm90"),
    ("pool 4", "fma"),
    ("no bias", "sm90"),
])
def test_route_reads_types_geometry_and_pointers(case, want):
    x, w, b = _operands(
        ci={"ci 3": 3, "ci 12": 12, "ci 8": 8}.get(case, 64),
        co={"co 12": 12, "co 200": 200}.get(case, 64),
        dtype=torch.float32 if case == "f32" else BF,
        bias=case != "no bias")
    kw = dict(bias=b)
    stride, lhs = (1, 1), (1, 1)
    if case == "bf16 x, f32 w":
        w = w.float()
    elif case == "f32 bias":
        kw["bias"] = b.float()
    elif case.startswith("stride"):
        stride = (2, 2) if case == "stride 2" else (1, 2)
    elif case.startswith("lhs"):
        lhs = (2, 2) if case == "lhs dilation 2" else (1, 2)
    elif case == "rhs dilation 2":
        kw["dilation"] = (2, 2)
    elif case == "x off by 2 bytes":
        x = _misaligned(*x.shape)
    elif case == "w off by 2 bytes":
        w = _misaligned(*w.shape)
    elif case == "bias off by 2 bytes":
        kw["bias"] = _misaligned(*b.shape)
    elif case.startswith("residual"):
        r = torch.zeros((2, 8, 8, 64), dtype=BF)
        kw["residual"] = _misaligned(*r.shape) if "off" in case else r
    elif case.startswith("pool"):
        kw["pool"] = int(case[-1])
    assert K.route(x, w, stride, lhs, **kw) == want


def test_route_refuses_a_halo_that_fits_no_tile():
    """A 7x7 window at dilation 16 needs a 104-row halo per 8 output
    rows: no tile's rings fit shared memory even at 16-channel blocks."""
    x, w, _ = _operands()
    w = torch.zeros((7, 7, 64, 64), dtype=BF)
    assert K.sm90_plan(1, 8, 8, 64, 64, 7, 7, (16, 16)) is None
    assert K.route(x, w, dilation=(16, 16)) == "fma"
    assert K.route(x, w, dilation=(2, 2)) == "sm90"


def test_route_names_sm90_for_vgg16_after_conv1_1_and_every_dgrad():
    """conv1_1 (Ci = 3: 6-byte pixels TMA cannot stride) takes the
    im2col plane and the tensor-core kernel of its type as a 1x1 conv;
    conv1_2 ... conv5_3 and the dgrads a training step runs (conv1_2's
    to conv5_3's: gy against the flipped weights, stride 1, full
    padding) take the sm90 kernel in bf16 and the 3xTF32 kernel in
    f32."""
    for dtype, tc in ((BF, "sm90"), (torch.float32, "sm90_tf32")):
        fwd, bwd = [], []
        for st in _vgg_stages():
            n = st.node
            x = torch.zeros((1, st.h, st.w, n.ci), dtype=dtype)
            w = torch.zeros((3, 3, n.ci, n.co), dtype=dtype)
            b = torch.zeros((n.co,), dtype=dtype)
            pool = st.pool if st.fused_pool else 1
            fwd.append(K.route(x, w, (n.stride,) * 2, bias=b, pool=pool))
            gy = torch.zeros((1, st.ho, st.wo, n.co), dtype=dtype)
            bwd.append(K.route(gy, flip_w(w)))
        assert fwd == ["sm90_im2col"] + [tc] * 12, dtype
        # conv1_1's dgrad is never run (the images need no gradient); its
        # flipped weights have Co = 3 and would stay on FMA
        assert bwd == ["fma"] + [tc] * 12, dtype


def test_route_on_resnet20():
    """The stride-1 3x3 convs take sm90 in bf16 and sm90_tf32 in f32,
    the stem (Ci = 3) the im2col plane; the stride-2 3x3 convs and the
    1x1/2 projections take sm90_tf32 in f32 and stay on FMA in bf16."""
    for dtype, tc in ((BF, "sm90"), (torch.float32, "sm90_tf32")):
        got = {}
        for st in _resnet_stages():
            n = st.node
            x = torch.zeros((1, st.h, st.w, n.ci), dtype=dtype)
            w = torch.zeros((n.hk, n.wk, n.ci, n.co), dtype=dtype)
            got[n.name] = K.route(x, w, (n.stride,) * 2)
        strided = "fma" if dtype == BF else tc
        for name, rt in got.items():
            want = ("sm90_im2col" if name == "stem" else strided
                    if name.endswith("_proj") or name in ("s2b0_a", "s3b0_a")
                    else tc)
            assert rt == want, (name, dtype)
        assert sum(rt == tc for rt in got.values()) == (
            16 if dtype == BF else 20)


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_plan_of_names_the_route_and_its_kernels_tile(dtype):
    """``plan_of`` gives what ``conv_lb`` launches on VGG16/224 at batch
    8: the route :func:`K.route` names, with ``sm90_plan``'s tile there
    (bf16), ``sm90_tf32_plan``'s (f32) and ``cta_plan``'s on FMA
    (forward with the fused pool, and the dgrad geometry)."""
    elt = torch.tensor([], dtype=dtype).element_size()
    for st in _vgg_stages():
        n = st.node
        x = torch.zeros((8, st.h, st.w, n.ci), dtype=dtype)
        w = torch.zeros((3, 3, n.ci, n.co), dtype=dtype)
        b = torch.zeros((n.co,), dtype=dtype)
        pool = st.pool if st.fused_pool else 1
        rt, plan = K.plan_of(x, w, b, stride=(n.stride,) * 2,
                             padding=(n.pad,) * 2, pool=pool)
        assert rt == K.route(x, w, (n.stride,) * 2, bias=b, pool=pool)
        if rt == "sm90":
            assert plan == K.sm90_plan(8, st.ho, st.wo, n.co, n.ci, 3, 3)
            assert plan.tile == (plan.bb, plan.ty, plan.tx, plan.bn,
                                 plan.cib)
        elif rt == "sm90_tf32":
            assert dtype == torch.float32
            assert plan == K.sm90_tf32_plan(8, st.ho, st.wo, n.co, n.ci, 3,
                                            3)
            assert plan.tile == (plan.bb, plan.ty, plan.tx, plan.bn)
        elif rt == "sm90_im2col":
            assert n.ci == 3
            inner = K.sm90_plan if dtype == BF else K.sm90_tf32_plan
            assert plan.inner == inner(8, st.ho, st.wo, n.co, 32)
            assert plan.tile == (32, *plan.inner.tile)
        else:
            assert plan == K.cta_plan(8, st.ho, st.wo, n.co, pool, 3, 3,
                                      (n.stride,) * 2, (1, 1), elt)
        gy = torch.zeros((8, st.ho, st.wo, n.co), dtype=dtype)
        rt, plan = K.plan_of(gy, flip_w(w), padding=(1, 1))
        tc = "sm90" if dtype == BF else "sm90_tf32"
        assert rt == (tc if n.ci % 8 == 0 else "fma")
        assert plan == (K.sm90_plan(8, st.h, st.w, n.ci, n.co, 3, 3)
                        if rt == "sm90" else
                        K.sm90_tf32_plan(8, st.h, st.w, n.ci, n.co, 3, 3)
                        if rt == "sm90_tf32" else
                        K.cta_plan(8, st.h, st.w, n.ci, 1, 3, 3, (1, 1),
                                   (1, 1), elt))


def test_launch_counters_by_route():
    assert set(K.conv_lb.launches_by_route) == set(K.ROUTES) == {
        "sm90", "sm90_tf32", "sm90_im2col", "fma"}
    assert isinstance(K.conv_lb.stage_launches, int)


# ---------------------------------------------------------------- plan


def _plan_cases():
    cases = []
    for st in _vgg_stages()[1:]:
        cases.append(("vgg " + st.node.name, st.ho, st.wo, st.node.ci,
                      st.node.co, 3))
        cases.append(("vgg dgrad " + st.node.name, st.h, st.w, st.node.co,
                      st.node.ci, 3))
    for st in _resnet_stages():
        n = st.node
        if n.stride == 1 and n.ci % 8 == 0:
            cases.append(("resnet " + n.name, st.ho, st.wo, n.ci, n.co,
                          n.hk))
    return cases


def _ring_bytes(p: K.Sm90Plan) -> int:
    """The rings and barriers as csrc/conv_lb_sm90.cu lays them out: the
    weight ring from a 1024-byte line, then the halo ring, then a full
    and an empty mbarrier per stage."""
    w_ring = K.SM90_W_STAGES * p.bn * p.cib * 2
    h_ring = K.SM90_H_STAGES * (p.cib // 8) * p.plane_bytes
    return 1024 + w_ring + h_ring + 16 * (K.SM90_W_STAGES + K.SM90_H_STAGES)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("name,ho,wo,ci,co,k", _plan_cases())
def test_sm90_plan_fits_and_is_pool_aligned(name, ho, wo, ci, co, k,
                                            batch):
    """Two 8 x 8 blocks per CTA, each starting on an 8-aligned row and
    column of one image (so every 2 x 2 pool window lies inside one
    block, and inside one consumer's registers), rings within the
    card's shared memory.  The 2 x 2 pool runs on the accumulators: no
    f32 pre-pool tile is staged."""
    p = K.sm90_plan(batch, ho, wo, co, ci, k, k, (1, 1))
    assert p is not None
    assert (p.bb, p.ty, p.tx) in K.SM90_TILES
    assert p.ty == 8 and p.bb * p.tx == 16
    assert p.bn in K.SM90_BN and p.cib in (16, 32, 64)
    assert p.smem_bytes == _ring_bytes(p) <= SMEM_PER_BLOCK
    assert p.ctas == (-(-batch // p.bb) * -(-ho // p.ty) * -(-wo // p.tx)
                      * -(-co // p.bn))


def test_sm90_plan_fills_the_card_on_vgg_conv5():
    """conv5_x at batch 8 (14 x 14): 16 pixel tiles; 64-channel CTAs
    give 128 CTAs in one wave rather than 64 at 128 channels."""
    p = K.sm90_plan(8, 14, 14, 512, 512, 3, 3, (1, 1))
    assert p.bn == 64 and p.ctas == 128


def test_kernel_constants_match_the_wrapper():
    src = (Path(K.__file__).parent / "csrc" / "conv_lb_sm90.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kWStages") == K.SM90_W_STAGES
    assert const("kHStages") == K.SM90_H_STAGES
    assert const("kMaxWin") == K.SM90_MAX_WIN
    assert const("kConsumers") == 2


# ------------------------------------------------- numpy model of A's reads


def _halo_stage(x: np.ndarray, p: K.Sm90Plan, ci0: int, ox0: int,
                oy0: int, b0: int) -> np.ndarray:
    """One halo stage in 2-byte words, as the kernel's 4-D TMA loads lay
    it out: plane q (channels ci0 + 8q ..) at q * plane_bytes, a box
    [bb][hy][hx][8] from (b0, oy0, ox0), zeros out of bounds."""
    b, h, w, ci = x.shape
    words = np.zeros((p.cib // 8) * p.plane_bytes // 2)
    for q in range(p.cib // 8):
        box = np.zeros((p.bb, p.hy, p.hx, 8))
        for lb in range(p.bb):
            for yy in range(p.hy):
                for xx in range(p.hx):
                    bi, yi, xi = b0 + lb, oy0 + yy, ox0 + xx
                    if 0 <= bi < b and 0 <= yi < h and 0 <= xi < w:
                        c = np.arange(ci0 + 8 * q, ci0 + 8 * q + 8)
                        ok = c < ci
                        box[lb, yy, xx, ok] = x[bi, yi, xi, c[ok]]
        base = q * p.plane_bytes // 2
        words[base:base + box.size] = box.reshape(-1)
    return words


def _read_a(words: np.ndarray, start: int, lbo: int, sbo: int
            ) -> np.ndarray:
    """The 64 x 16 A tile wgmma reads from a K-major descriptor with no
    swizzle: row m, column k at start + (m // 8) * sbo + (k // 8) * lbo
    + (m % 8) * 16 + (k % 8) * 2 bytes."""
    m = np.arange(64)[:, None]
    k = np.arange(16)[None, :]
    addr = start + (m // 8) * sbo + (k // 8) * lbo + (m % 8) * 16 \
        + (k % 8) * 2
    assert addr.min() >= 0 and addr.max() < 2 * words.size
    assert np.all(addr % 2 == 0)
    return words[addr // 2]


def _model_conv(x: np.ndarray, w: np.ndarray, p: K.Sm90Plan, pad, ho,
                wo) -> np.ndarray:
    """The sm90 kernel's sums (before the epilogue) for every CTA of
    the plan's tile: per Ci block one halo stage, per window and k16
    step one A read through the passed offsets, B the (window, Ci
    block) slice of w with zeros past Ci."""
    b, h, wd, ci = x.shape
    hk, wk, _, co = w.shape
    out = np.zeros((b, ho, wo, co))
    hits = np.zeros((b, ho, wo), dtype=int)
    ncb = -(-ci // p.cib)
    for b0 in range(0, b, p.bb):
        for oy0 in range(0, ho, p.ty):
            for ox0 in range(0, wo, p.tx):
                acc = np.zeros((2, 64, co))
                for cb in range(ncb):
                    ci0 = cb * p.cib
                    words = _halo_stage(x, p, ci0, ox0 - pad[1],
                                        oy0 - pad[0], b0)
                    for win in range(hk * wk):
                        wslice = np.zeros((p.cib, co))
                        real = min(p.cib, ci - ci0)
                        wslice[:real] = w[win // wk, win % wk,
                                          ci0:ci0 + real]
                        for cw in range(2):
                            for kk in range(p.cib // 16):
                                start = (p.blk_off[cw] + p.win_off[win]
                                         + kk * 2 * p.plane_bytes)
                                a = _read_a(words, start, p.plane_bytes,
                                            p.sbo)
                                acc[cw] += a @ wslice[16 * kk:16 * kk + 16]
                # block cw: the next image's, or 8 columns on; its row m
                # is output pixel (m // 8, m % 8) of the block
                for cw in range(2):
                    bi = b0 + cw * (p.bb - 1)
                    bx = ox0 + cw * (p.tx - 8)
                    for m in range(64):
                        oy, ox = oy0 + m // 8, bx + m % 8
                        if bi < b and oy < ho and ox < wo:
                            out[bi, oy, ox] = acc[cw, m]
                            hits[bi, oy, ox] += 1
    assert np.all(hits == 1)
    return out


# b, h, w, ci, co, k, pad, dilation: 3x3 at pad 1 and at dilation 2 pad
# 2, Ci 16 and 64, a ragged 14 x 14 plane (two tiles' worth of discarded
# rows and columns), Ci 24 (a Ci block past Ci), a 1x1
MODEL_CASES = [
    (2, 14, 14, 16, 8, 3, 1, 1),
    (1, 14, 14, 64, 8, 3, 2, 2),
    (2, 10, 12, 16, 16, 3, 2, 2),
    (3, 9, 17, 24, 8, 3, 1, 1),
    (1, 8, 8, 16, 8, 1, 0, 1),
]


@pytest.mark.parametrize("tile", K.SM90_TILES)
@pytest.mark.parametrize("b,h,w,ci,co,k,pad,d", MODEL_CASES)
def test_a_addressing_model_reproduces_the_plain_conv(b, h, w, ci, co, k,
                                                      pad, d, tile):
    """Every tile shape the plan may pick, with the offsets
    :func:`sm90_layout` computes (what the wrapper passes)."""
    rng = np.random.default_rng(ci * 100 + h)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    wt = (rng.standard_normal((k, k, ci, co)) / (k * k * ci) ** 0.5
          ).astype(np.float32)
    ho = h + 2 * pad - (k - 1) * d
    wo = w + 2 * pad - (k - 1) * d
    lay = K.sm90_layout(*tile, 64, K.sm90_cibs(ci)[0], k, k, (d, d))
    p = K.Sm90Plan(**lay, ctas=0)
    got = _model_conv(x, wt, p, (pad, pad), ho, wo)
    want = conv2d_ref(torch.from_numpy(x), torch.from_numpy(wt),
                      padding=pad, dilation=d).numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_a_addressing_model_at_the_plans_own_tile():
    """The tile, Ci block and offsets :func:`sm90_plan` picks for a
    conv5-like 14 x 14 plane at 32 channels (a narrow Ci block) and
    dilation 2."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 14, 14, 32)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 32, 16)) / 17).astype(np.float32)
    p = K.sm90_plan(2, 14, 14, 16, 32, 3, 3, (2, 2))
    assert p.cib == 32
    got = _model_conv(x, wt, p, (2, 2), 14, 14)
    want = conv2d_ref(torch.from_numpy(x), torch.from_numpy(wt),
                      padding=2, dilation=2).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
