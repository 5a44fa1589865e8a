"""K1's route ``sm90_im2col`` and the shared im2col plane on the CPU:
what the wrappers decide and compute before they launch
``csrc/wgrad_im2col.cu`` (the plane) and ``csrc/conv_lb_sm90.cu`` (its
1x1 conv).

  * :func:`K.route` and :func:`K.plan_of`: ``sm90_im2col`` for bf16
    VGG16/224 conv1_1 and ResNet-20/32's stem (also at batch 65536), and
    for f32 (onto the 3xTF32 kernel, ``test_torch_conv_tc.py``); ``fma``
    for strides, Hk*Wk*Ci > 64, Co off the 16-byte pitch,
    a misaligned base, a pool the sm90 epilogue does not take, and a
    plane whose staging grid would pass 2^31 - 1 blocks; K2's
    ``plan_of`` at the ResNet stem and batch 65536 still names
    ``sm90_im2col`` (the staging kernel's grid no longer stops at 65535
    images or rows);
  * the decomposition the route runs, on the plain versions: the plane
    (``im2col_ref``), then a 1x1 conv against w read as Hk*Wk*Ci rows
    and zero rows to the plane's channels (what the weight map's
    out-of-bounds fill gives), with bias, residual, ReLU and a 2x2 pool,
    against the reference's ``conv2d_ref`` and ``conv2d_lb(...,
    fallback=True)`` on the same numpy inputs.  Tolerance: max |plane
    route - reference| <= 1e-5 * max |reference| (f32 sums in another
    order); a plane with one tap one column off errs far past it, and
    fails the card's bf16 gate;
  * the kernels' sources against the wrapper: the staging kernel's
    one-dimensional grid and its limits, the sm90 conv's C interface
    (its weight rows ``wCi`` passed apart from the plane's channels).

The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import ast
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_lb.ops import conv2d_lb as jax_conv2d_lb
from repro.kernels.conv_lb.ref import conv2d_ref as jax_conv2d_ref
from repro_torch.kernels.conv_lb import im2col as I
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb import wgrad as W
from repro_torch.kernels.conv_lb.ref import conv2d_ref, im2col_ref
from repro_torch.models.cnn import resnet_graph
from repro_torch.models.graph import graph_stages

BF = torch.bfloat16
TOL = 1e-5
#: the card's bf16 gate (chip_smoke.CARD_TOL): rtol 2^-6, atol the
#: smaller of 0.8 and 1e-2 rms(plain)
BF16_GATE = (2 ** -6, 0.8, 1e-2)


def _zeros(*shape, dtype=BF):
    return torch.zeros(shape, dtype=dtype)


def _misaligned(*shape, dtype=BF):
    """A contiguous tensor whose base is 2 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    t = torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)
    assert t.data_ptr() % 16 == 2
    return t


# ---------------------------------------------------------------- route


def test_route_and_plan_of_vgg16_conv1_1():
    """bf16 conv1_1 at batch 8 (pad 1, bias, ReLU): the plane of 32
    channels on the taps in HWIO order, then the sm90 kernel's plan of
    the 1x1 conv of the plane."""
    x, w, b = _zeros(8, 224, 224, 3), _zeros(3, 3, 3, 64), _zeros(64)
    assert K.route(x, w, bias=b, padding=(1, 1)) == "sm90_im2col"
    rt, plan = K.plan_of(x, w, b, padding=(1, 1))
    assert rt == "sm90_im2col"
    assert plan.cp == 32 == I.im2col_channels(3, 3, 3)
    assert plan.taps == tuple((ky - 1, kx - 1) for ky in range(3)
                              for kx in range(3))
    assert plan.inner == K.sm90_plan(8, 224, 224, 64, 32)
    assert plan.inner.win_off == (0,)      # one window: the plane's 1x1
    assert plan.tile == (32, *plan.inner.tile)


@pytest.mark.parametrize("batch", [1, 8, 65536])
def test_route_and_plan_of_the_resnet_stem(batch):
    """ResNet-20/32's stem (Ci 3, Co 16, 3x3, pad 1) takes the plane in
    bf16 at every batch, 65536 images included."""
    stem = graph_stages(resnet_graph(), 32, 32)[0]
    assert stem.node.ci == 3 and stem.node.stride == 1
    x = _zeros(1, 32, 32, 3).expand(batch, 32, 32, 3)
    w = _zeros(3, 3, 3, stem.node.co)
    rt, plan = K.plan_of(x, w, padding=(1, 1))
    assert rt == "sm90_im2col" == K.route(x, w, padding=(1, 1))
    assert plan.inner == K.sm90_plan(batch, 32, 32, stem.node.co, 32)
    assert I.stage_fits(batch, 32, 32, 3, 32, 32, 32, 2)


@pytest.mark.parametrize("case", [
    "f32", "stride 2", "lhs dilation 2", "5x5 ci 3", "3x3 ci 8 is sm90",
    "co 12", "w off by 2 bytes", "bias off by 2 bytes", "pool 4",
    "f32 bias", "grid past 2^31 blocks"])
def test_route_refuses_what_the_plane_route_does_not_take(case):
    x, w, b = _zeros(2, 16, 16, 3), _zeros(3, 3, 3, 32), _zeros(32)
    kw = dict(bias=b, padding=(1, 1))
    stride, lhs = (1, 1), (1, 1)
    want = "fma"
    if case == "f32":                     # the plane onto the 3xTF32 kernel
        x, w, b = x.float(), w.float(), b.float()
        kw["bias"], want = b, "sm90_im2col"
    elif case == "stride 2":
        stride = (2, 2)
    elif case == "lhs dilation 2":
        lhs = (2, 2)
    elif case == "5x5 ci 3":              # 75 taps: past IM2COL_MAX
        w = _zeros(5, 5, 3, 32)
    elif case == "3x3 ci 8 is sm90":
        x, w, want = _zeros(2, 16, 16, 8), _zeros(3, 3, 8, 32), "sm90"
    elif case == "co 12":
        w, kw["bias"] = _zeros(3, 3, 3, 12), _zeros(12)
    elif case == "w off by 2 bytes":
        w = _misaligned(3, 3, 3, 32)
    elif case == "bias off by 2 bytes":
        kw["bias"] = _misaligned(32)
    elif case == "pool 4":
        kw["pool"] = 4
    elif case == "f32 bias":
        kw["bias"] = b.float()
    else:
        # 4 blocks a 224-wide row of 32 bf16 channels, 224 rows, 2^22
        # images: 3.8e9 blocks
        x = _zeros(1, 224, 224, 3).expand(2 ** 22, 224, 224, 3)
        assert not I.stage_fits(2 ** 22, 224, 224, 3, 224, 224, 32, 2)
    assert K.route(x, w, stride, lhs, **kw) == want


def test_wgrad_plan_at_the_resnet_stem_and_batch_65536():
    """K2's route at the ResNet stem and batch 65536: the plane (its
    staging grid 2^21 blocks, more images and rows than the grid's y and
    z dimensions held), then the 1x1 wgrad's plan within ``GRID_Z_MAX``
    splits."""
    x = _zeros(1, 32, 32, 3).expand(65536, 32, 32, 3)
    dy = _zeros(1, 32, 32, 16).expand(65536, 32, 32, 16)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    rt, plan = W.plan_of(x, dy, geom)
    assert rt == "sm90_im2col" and plan.cp == 32
    assert 1 < plan.splits <= W.GRID_Z_MAX
    rows = -(-32 * 32 * 2 // 16 // I.THREADS)
    assert rows * 32 * 65536 > 65535
    assert W.plan_of(x.float(), dy.float(), geom)[0] == "sm90_im2col"


def test_cpu_tensors_stage_nothing():
    """On the CPU the wrappers run the plain versions: no launch and no
    staging launch is counted."""
    x = torch.randn(1, 8, 8, 3).to(BF)
    w = torch.randn(3, 3, 3, 16).to(BF)
    before = (K.conv_lb.launches, dict(K.conv_lb.launches_by_route),
              K.conv_lb.stage_launches, I.im2col_plane.stage_launches)
    out = K.conv_lb(x, w, padding=(1, 1))
    plane = I.im2col_plane(x, 3, 3, (1, 1))
    assert torch.equal(out, conv2d_ref(x, w, padding=(1, 1)))
    assert torch.equal(plane, im2col_ref(x, 3, 3, padding=1, channels=32))
    assert (K.conv_lb.launches, K.conv_lb.launches_by_route,
            K.conv_lb.stage_launches,
            I.im2col_plane.stage_launches) == before


# -------------------------------------------- the decomposition it runs


def _as_plane_conv(x, w, bias, res, pad, pool, taps=None):
    """The route's arithmetic on the plain versions: the plane, then the
    1x1 conv against w's Hk*Wk*Ci rows and zero rows up to the plane's
    channels (the weight map's out-of-bounds zeros), with the same fused
    epilogue."""
    hk, wk, ci, co = w.shape
    cp = I.im2col_channels(ci, hk, wk)
    if taps is None:
        plane = im2col_ref(x, hk, wk, padding=pad, channels=cp)
    else:
        xp = torch.nn.functional.pad(x, (0, 0, pad + 1, pad + 1,
                                         pad + 1, pad + 1))
        ho, wo = x.shape[1] + 2 * pad - hk + 1, x.shape[2] + 2 * pad - wk + 1
        plane = torch.cat([xp[:, 1 + pad + ty:1 + pad + ty + ho,
                              1 + pad + tx:1 + pad + tx + wo]
                           for ty, tx in taps], dim=-1)
        plane = torch.nn.functional.pad(plane, (0, cp - plane.shape[-1]))
    w_rows = torch.zeros((1, 1, cp, co), dtype=w.dtype)
    w_rows[0, 0, :hk * wk * ci] = w.reshape(hk * wk * ci, co)
    return conv2d_ref(plane, w_rows, bias, res, relu=True, pool=pool)


# b, h, ci, co, k, pad, pool, residual: conv1_1's geometry small, the
# ResNet stem's, a 2x2 pool, a residual join, 63 taps
CASES = [
    (2, 20, 3, 64, 3, 1, 1, False),
    (3, 12, 3, 16, 3, 1, 1, True),
    (2, 16, 3, 32, 3, 1, 2, False),
    (1, 14, 7, 24, 3, 1, 2, True),
    (2, 11, 3, 8, 1, 0, 1, False),
]


def _inputs(b, h, ci, co, k, pad, res, seed):
    rng = np.random.default_rng(seed)
    ho = h + 2 * pad - k + 1
    x = rng.standard_normal((b, h, h, ci)).astype(np.float32)
    w = (rng.standard_normal((k, k, ci, co))
         / np.sqrt(k * k * ci)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    r = (rng.standard_normal((b, ho, ho, co)).astype(np.float32)
         if res else None)
    return x, w, bias, r


@pytest.mark.parametrize("b,h,ci,co,k,pad,pool,res", CASES)
def test_plane_then_1x1_is_the_conv(b, h, ci, co, k, pad, pool, res):
    x, w, bias, r = _inputs(b, h, ci, co, k, pad, res, seed=h + ci)
    got = _as_plane_conv(*(None if a is None else torch.from_numpy(a)
                           for a in (x, w, bias, r)), pad, pool).numpy()
    ref = np.asarray(jax_conv2d_lb(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if r is None else jnp.asarray(r), padding=pad, relu=True,
        pool=pool, fallback=True))
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL * scale
    if r is None:
        plain = np.asarray(jax_conv2d_ref(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), padding=pad,
            relu=True, pool=pool))
        assert np.abs(got - plain).max() <= TOL * scale


def test_plane_one_tap_one_column_off_fails_the_bf16_gate():
    """The card's control: the centre tap read one column off gives a
    conv that the bf16 gate refuses (and is far outside ``TOL``)."""
    x, w, bias, _ = _inputs(2, 20, 3, 64, 3, 1, False, seed=3)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, bias))
    taps = list(I.im2col_taps(3, 3, (1, 1)))
    right = _as_plane_conv(xt, wt, bt, None, 1, 1, taps)
    plain = conv2d_ref(xt, wt, bt, relu=True, padding=1)
    assert (right - plain).abs().max() <= TOL * plain.abs().max()
    taps[4] = (taps[4][0], taps[4][1] + 1)
    wrong = _as_plane_conv(xt, wt, bt, None, 1, 1, taps)
    rtol, atol, atol_rms = BF16_GATE
    atol = min(atol, atol_rms * plain.square().mean().sqrt().item())
    worst = ((wrong - plain).abs() / (atol + rtol * plain.abs())).max()
    assert worst > 10


# ------------------------------------------- kernels against the wrapper


def test_staging_kernel_grid_is_one_dimension_of_every_row():
    """The staging kernel folds images and rows into the grid's x
    dimension: no 65535 limit on B or Ho, and the C entry refuses only
    what ``stage_fits`` refuses."""
    src = I.SOURCE.read_text()
    entry = re.search(r'extern "C" int wgrad_im2col_forward.*?\n}\n', src,
                      re.S)[0]
    assert "65535" not in src
    assert "blockIdx.y" not in src and "blockIdx.z" not in src
    assert "const dim3 grid(static_cast<unsigned>(blocks));" in entry
    assert "blocks > 0x7fffffffll" in entry
    assert I.GRID_X_MAX == 0x7fffffff
    assert int(re.search(r"<<<grid, (\d+), 0, s>>>", entry)[1]) == I.THREADS
    assert int(re.search(r"constexpr int kMaxTaps = (\d+);", src)[1]) \
        == I.IM2COL_MAX


def test_stage_fits_counts_the_grids_blocks():
    # VGG16/224 conv1_1: 896 chunks a row in bf16 (4 blocks), 448 in f32
    # (2 blocks, 32 channels of 4 bytes: 8 chunks a pixel)
    assert I.stage_fits(8, 224, 224, 3, 224, 224, 32, 2)
    limit = I.GRID_X_MAX // (4 * 224)
    assert I.stage_fits(limit, 224, 224, 3, 224, 224, 32, 2)
    assert not I.stage_fits(limit + 1, 224, 224, 3, 224, 224, 32, 2)
    assert not I.stage_fits(1, 8, 8, 9, 8, 8, 88, 2)    # cp past 64


@pytest.mark.parametrize("source,name,pointers,ints", [
    (K.SM90_SOURCE, "conv_lb_sm90_forward", 6, 26),
    (I.SOURCE, "wgrad_im2col_forward", 3, 9),
])
def test_wrappers_bind_the_kernels_c_interface(source, name, pointers,
                                               ints):
    """The number of pointers and ints the wrappers pass is the C
    function's; the sm90 conv takes the weight's rows (``wCi``) beside
    the input's channels."""
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', source.read_text(),
                    re.S)[1]
    params = [p.strip() for p in sig.split(",")]
    assert sum(p.startswith("int ") for p in params) == ints
    assert sum("*" in p for p in params) == pointers + 1   # + stream
    module, var = ((K, "SM90_SOURCE") if "sm90" in name else (I, "SOURCE"))
    assert (f'_entry({var}, "{name}", {pointers}, {ints})'
            in Path(module.__file__).read_text())
    if "sm90" in name:
        assert params.index("int Ci") + 1 == params.index("int wCi")


def test_plane_module_imports_no_wrapper_above_it():
    """The plane's launcher sits below K1's and K2's wrappers: it builds
    through ``kernels/nvcc.py``, imports neither wrapper, and leaves the
    counting of its launches to each caller."""
    tree = ast.parse(Path(I.__file__).read_text())
    imported = {n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)}
    assert "repro_torch.kernels.nvcc" in imported
    assert not imported & {"repro_torch.kernels.conv_lb.kernel",
                           "repro_torch.kernels.conv_lb.wgrad"}
    assert list(inspect.signature(I.stage).parameters) == [
        "x", "taps", "ho", "wo", "cp"]
