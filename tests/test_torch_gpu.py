"""The port's CUDA kernels on the card, held against their plain
PyTorch versions on the same inputs (TF32 off on both sides): the conv
kernel (also in its dgrad geometry; in f32 on the 3xTF32 kernel, whose
second launch gives the same bits and whose recompute gives the
forward's pre-epilogue sums bit for bit), the wgrad kernel, a ResNet-20
training step against the plain version's autograd, the two backwards
the kernels do not take (routed to the library rung, loudly), and the
matmul and attention kernels in f32 and bf16 (kernel and plain version
sum the same words in f32 and round once: f32 rtol 2e-5, atol the
smaller of 2e-4 and 1e-3 rms(plain); bf16 rtol 2^-6, two rounding
steps, atol the smaller of 0.8 and 1e-2 rms(plain); never looser than
the reference's f32 rtol 2e-5, atol 2e-4 and bf16 rtol 8e-2, atol 0.8).

Marked ``gpu``: on a host without a CUDA device these skip with a
reason.  Run them on the card with ``pytest -m gpu tests/test_torch_gpu.py``.
Tolerances: max |kernel - plain| <= 1e-4 * max |plain| (f32 sums in
another order); the wgrad kernel 2e-4 (reductions over up to 10^5
pixels in another order); a training step's gradients 1e-3 of each
tensor's max |plain grad| (21 layers of such sums).
"""

import pytest
import torch

import torch.nn.functional as F

from repro_torch.kernels.attention_block import kernel as K4
from repro_torch.kernels.attention_block.ops import (flash_attention,
                                                     heads_first)
from repro_torch.kernels.attention_block.ref import attention_plain
from repro_torch.kernels.conv_lb import im2col as I
from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb import wgrad as W
from repro_torch.kernels.conv_lb.ops import ConvArgs, conv2d_lb, dgrad_lb
from repro_torch.kernels.conv_lb.ref import (conv2d_ref, flip_w, im2col_ref,
                                             wgrad_ref)
from repro_torch.kernels.matmul_lb import kernel as K3
from repro_torch.kernels.matmul_lb.ops import matmul_lb
from repro_torch.kernels.matmul_lb.ref import matmul_ref
from repro_torch.launch import train_vgg as T
from repro_torch.models.cnn import init_resnet, resnet_graph
from repro_torch.models.graph import graph_logits

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the conv kernel has no CPU "
                    "build (its plain version is covered by "
                    "test_torch_conv.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, tol=1e-4):
    assert out.shape == ref.shape
    err = (out - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), err


@pytest.mark.parametrize("b,h,ci,co,k,s,p,d,ld,pool,res", [
    (2, 16, 8, 16, 3, 1, 1, 1, 1, 2, False),
    (1, 33, 3, 64, 3, 1, 1, 1, 1, 1, False),
    (4, 16, 16, 32, 3, 2, 1, 1, 1, 1, False),
    (4, 16, 16, 32, 1, 2, 0, 1, 1, 1, False),
    (2, 20, 16, 16, 3, 1, 2, 2, 1, 1, False),
    (2, 9, 8, 8, 3, 1, 2, 1, 2, 1, False),
    (3, 12, 24, 40, 3, 1, 1, 1, 1, 2, True),
    (8, 14, 256, 200, 3, 1, 1, 1, 1, 1, True),
])
def test_kernel_matches_plain(cuda, b, h, ci, co, k, s, p, d, ld, pool,
                              res):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((b, h, h, ci), generator=g).to(cuda)
    w = (torch.randn((k, k, ci, co), generator=g) / (k * k * ci) ** 0.5
         ).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    hd = (h - 1) * ld + 1
    ho = (hd + 2 * p - ((k - 1) * d + 1)) // s + 1
    r = torch.randn((b, ho, ho, co), generator=g).to(cuda) if res else None
    kw = dict(stride=s, padding=p, dilation=d, lhs_dilation=ld, pool=pool,
              relu=True)
    before = K.conv_lb.launches
    out = conv2d_lb(x, w, bias, r, **kw)
    torch.cuda.synchronize()
    assert K.conv_lb.launches == before + 1
    _close(out, conv2d_ref(x, w, bias, r, **kw))


def test_resnet_logits_through_the_kernel(cuda):
    graph = resnet_graph()
    params = init_resnet(torch.Generator().manual_seed(0), graph,
                         device=cuda)
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(1)).to(cuda)
    before = K.conv_lb.launches
    got = graph_logits(graph, params, x)
    assert K.conv_lb.launches == before + len(graph.nodes)
    _close(got, graph_logits(graph, params, x, conv=conv2d_ref))


def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn((1, 8, 8, 4), device=cuda)
    w = torch.randn((3, 3, 4, 4), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        conv2d_lb(x.double(), w.double(), padding=1)
    with pytest.raises(ValueError, match="contiguous"):
        K.conv_lb(x.transpose(1, 2), w, padding=(1, 1))
    with pytest.raises(ValueError, match="lies on"):
        K.conv_lb(x, w.cpu(), padding=(1, 1))
    with pytest.raises(ValueError, match="pool"):
        conv2d_lb(torch.randn((1, 7, 7, 4), device=cuda), w, padding=1,
                  pool=2)


# b, h, w, ci, co, k, stride, pad: the forward conv of the backward
BWD = [
    (8, 28, 28, 128, 256, 3, 1, 1),
    (8, 32, 32, 16, 32, 3, 2, 1),
    (8, 32, 32, 16, 32, 1, 2, 0),
    (3, 15, 13, 7, 9, 3, 1, 1),
    (2, 15, 13, 3, 16, 3, 2, 1),
]


@pytest.mark.parametrize("b,h,w,ci,co,k,s,p", BWD + [
    (8, 224, 224, 3, 64, 3, 1, 1), (8, 14, 14, 512, 512, 3, 1, 1)])
def test_wgrad_kernel_matches_plain(cuda, b, h, w, ci, co, k, s, p):
    g = torch.Generator().manual_seed(1)
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    x = torch.randn((b, h, w, ci), generator=g).to(cuda)
    dy = torch.randn((b, ho, wo, co), generator=g).to(cuda)
    before = W.wgrad_lb.launches
    dw = W.wgrad_lb(x, dy, W.WgradGeometry(hk=k, wk=k, stride=(s, s),
                                           padding=(p, p)))
    torch.cuda.synchronize()
    assert W.wgrad_lb.launches == before + 1
    _close(dw, wgrad_ref(x, dy, k, k, stride=s, padding=p), tol=2e-4)


@pytest.mark.parametrize("b,h,w,ci,co,k,s,p", BWD)
def test_conv_kernel_in_the_dgrad_geometry_matches_plain(cuda, b, h, w,
                                                         ci, co, k, s, p):
    g = torch.Generator().manual_seed(2)
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    gy = torch.randn((b, ho, wo, co), generator=g).to(cuda)
    wf = flip_w((torch.randn((k, k, ci, co), generator=g)
                 / (k * k * ci) ** 0.5).to(cuda))
    gyp = F.pad(gy, (0, 0, 0, int(s > 1), 0, int(s > 1)))
    kw = dict(stride=1, padding=k - 1 - p, lhs_dilation=s)
    _close(conv2d_lb(gyp, wf, **kw), conv2d_ref(gyp, wf, **kw))


def test_resnet_training_step_matches_plain_autograd(cuda):
    gen = torch.Generator().manual_seed(0)
    graph, params = T.build_model("resnet", width_mult=1.0, n_classes=10,
                                  generator=gen, device=cuda)
    images, labels = T.make_batch(8, 32, 10, gen, cuda)
    want_loss, want = T.loss_and_grads(graph, params, images, labels,
                                       conv=conv2d_ref)
    k1, k2 = K.conv_lb.launches, W.wgrad_lb.launches
    loss, grads = T.sgd_step(graph, params, images, labels, 1e-3)
    torch.cuda.synchronize()
    assert K.conv_lb.launches - k1 == 3 * len(graph.nodes) - 1
    assert W.wgrad_lb.launches - k2 == len(graph.nodes)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(
        float(want_loss))
    for got, ref in zip(grads, want):
        _close(got, ref, tol=1e-3)


@pytest.mark.parametrize("name,lhs_dilation,padding,launches,tally", [
    # the reference takes lax's VJP wholesale: no kernel in the backward
    ("lhs_dilated", 2, 2, (0, 0), {"bwd": 1}),
    # the reference runs dgrad on lax and wgrad on its kernel; the
    # recompute runs on K1 as in every backward of the port
    ("padding_past_full", 1, 3, (1, 1), {"dgrad": 1}),
])
def test_backward_the_kernels_do_not_take_routes_to_the_library(
        cuda, name, lhs_dilation, padding, launches, tally):
    from repro_torch.kernels.conv_lb import ops
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 9, 9, 4), generator=g).to(cuda)
    w = (torch.randn((3, 3, 4, 6), generator=g) * 0.2).to(cuda)
    bias = torch.randn((6,), generator=g).to(cuda)
    kw = dict(padding=padding, lhs_dilation=lhs_dilation, relu=True)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    out = conv2d_lb(*leaves, **kw)
    gy = torch.randn(out.shape, generator=g).to(cuda)
    ops.reset_fallback_counts()
    k1, k2 = K.conv_lb.launches, W.wgrad_lb.launches
    got = torch.autograd.grad(out, leaves, gy)
    torch.cuda.synchronize()
    assert (K.conv_lb.launches - k1, W.wgrad_lb.launches - k2) == launches
    assert ops.exec_fallback_counts() == tally
    plain = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    want = torch.autograd.grad(conv2d_ref(*plain, **kw), plain, gy)
    for a, b in zip(got, want):
        _close(a, b)


MATMULS = [(64, 64, 64), (300, 200, 150), (1000, 333, 77), (8, 8, 8),
           (257, 129, 511)]
# (rtol, atol, atol per rms of the plain output): the atol in force is
# the smaller, so the gate is never looser than the reference's
# (tests/test_kernels.py: f32 2e-5, 2e-4; bf16 8e-2, 0.8)
TOL = {torch.float32: (2e-5, 2e-4, 1e-3),
       torch.bfloat16: (2 ** -6, 0.8, 1e-2)}


def _within(out, ref, dtype):
    rtol, atol, atol_rms = TOL[dtype]
    ref = ref.float()
    atol = min(atol, atol_rms * ref.square().mean().sqrt().item())
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", MATMULS)
def test_matmul_kernel_matches_plain(cuda, m, k, n, dtype):
    g = torch.Generator().manual_seed(4)
    x = torch.randn((m, k), generator=g).to(cuda, dtype)
    w = torch.randn((k, n), generator=g).to(cuda, dtype)
    before = K3.matmul_lb.launches
    out = matmul_lb(x, w)
    torch.cuda.synchronize()
    assert K3.matmul_lb.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    _within(out, matmul_ref(x, w), dtype)


def test_matmul_kernel_takes_a_misaligned_operand(cuda):
    buf = torch.randn(1 + 129 * 65, device=cuda)
    x = buf[1:].view(129, 65)        # 4 bytes past an aligned base
    w = torch.randn((65, 33), device=cuda)
    _within(K3.matmul_lb(x, w), matmul_ref(x, w), torch.float32)


# b, sq, skv, h, kv, hd, window, causal: the reference's sweep, a fully
# masked row case, and the configs' head dims 64 and 128
ATTENTION = [
    (2, 64, 64, 4, 2, 16, 0, True),
    (1, 100, 100, 8, 8, 32, 0, True),
    (1, 48, 80, 4, 4, 16, 0, False),
    (1, 33, 65, 2, 1, 8, 16, True),
    (1, 64, 20, 2, 1, 16, 8, True),
    (1, 200, 200, 4, 2, 64, 0, True),
    (2, 130, 130, 4, 1, 128, 64, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", ATTENTION)
def test_attention_kernel_matches_plain(cuda, b, sq, skv, h, kv, hd, win,
                                        causal, dtype):
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(s, generator=g).to(cuda, dtype)
               for s in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd)))
    before = K4.attention.launches
    out = flash_attention(q, k, v, window=win, causal=causal)
    torch.cuda.synchronize()
    assert K4.attention.launches == before + 1
    want = attention_plain(*map(heads_first, (q, k, v)), groups=h // kv,
                           window=win, causal=causal)
    _within(out, want.reshape(b, h, sq, hd).transpose(1, 2), dtype)


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn((2, 16, 32), device=cuda)
    with pytest.raises(ValueError, match="route sm90 takes bf16"):
        K4.attention(q, q[:1], q[:1], groups=2, via="sm90")
    with pytest.raises(ValueError, match="route sm90 takes bf16"):
        K4.attention(q[..., :20].contiguous().bfloat16(),
                     q[:1, :, :20].contiguous().bfloat16(),
                     q[:1, :, :20].contiguous().bfloat16(), groups=2,
                     via="sm90")
    with pytest.raises(ValueError, match="unknown attention route"):
        K4.attention(q, q[:1], q[:1], groups=2, via="tma")
    q = torch.randn((2, 16, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or"):
        K4.attention(q, q[:1], q[:1], groups=2)


def test_profile_step_sees_the_ports_kernels(cuda):
    from repro_torch.launch.profile_step import profile_steps
    rep = profile_steps("resnet", image=32, batch=4, width_mult=0.25,
                        steps=1, warmup=1, lr=1e-3)
    own = {r["kernel"]: r for r in rep["own_kernels"]}
    # f32 at width 0.25 (4, 8 and 16 channels): K1's and K2's stems
    # through the im2col plane onto the 3xTF32 kernels, the 16 stride-1
    # 3x3 convs and the 4 strided ones (the stride-2 convs and the
    # projections) on them (K1: forward, recompute, dgrad: a strided
    # one's by output phases, one launch), none on FMA
    assert "K1 conv_lb" not in own and "K2 wgrad_lb" not in own
    assert own["K1 conv_lb_sm90_tf32"]["launches_per_step"] == 62
    assert own["K2 wgrad_lb_sm90_tf32"]["launches_per_step"] == 21
    assert own["K1/K2 im2col staging"]["launches_per_step"] == 3
    assert 0.0 <= rep["device_idle_share"] < 1.0


# b, h, ci, co, k, stride, pad, dilation: windows whose whole weight
# slice (7x7 at 64 channels: 200,704 B double-buffered) crowds the
# shared memory, and one (11x11) whose slice alone exceeds it, staged
# a kernel row at a time
LARGE_WINDOWS = [
    (8, 224, 3, 64, 7, 2, 3, 1),
    (2, 40, 16, 64, 7, 1, 6, 2),
    (2, 227, 3, 64, 11, 4, 2, 1),
]


@pytest.mark.parametrize("b,h,ci,co,k,s,p,d", LARGE_WINDOWS)
def test_large_window_kernel_matches_plain(cuda, b, h, ci, co, k, s, p,
                                           d):
    g = torch.Generator().manual_seed(6)
    x = torch.randn((b, h, h, ci), generator=g).to(cuda)
    w = (torch.randn((k, k, ci, co), generator=g) / (k * k * ci) ** 0.5
         ).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    kw = dict(stride=s, padding=p, dilation=d, relu=True)
    before = K.conv_lb.launches
    out = conv2d_lb(x, w, bias, **kw)
    torch.cuda.synchronize()
    assert K.conv_lb.launches == before + 1
    _close(out, conv2d_ref(x, w, bias, **kw))


# b, s, h, kv, hd, window: head dims between and above the configs'
# (80, 96: the next width is their own; 20, 24: padded, and 20 is not
# 16-byte pitched in either type; 256: one K/V stage in f32)
PADDED_HEADS = [
    (1, 150, 4, 2, 80, 0),
    (1, 130, 4, 1, 96, 32),
    (1, 100, 2, 1, 256, 0),
    (2, 70, 4, 2, 24, 0),
    (1, 90, 2, 2, 20, 16),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,win", PADDED_HEADS)
def test_attention_kernel_at_any_head_dim(cuda, b, s, h, kv, hd, win,
                                          dtype):
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype)
               for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    before = K4.attention.launches
    out = flash_attention(q, k, v, window=win, causal=True)
    torch.cuda.synchronize()
    assert K4.attention.launches == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    want = attention_plain(*map(heads_first, (q, k, v)), groups=h // kv,
                           window=win, causal=True)
    _within(out, want.reshape(b, h, s, hd).transpose(1, 2), dtype)


def _bf16_operands(m, k, n, layout, seed=8):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((m, k), generator=g).to("cuda", torch.bfloat16)
    if layout == "k-major":     # w.t() of a contiguous (N, K)
        w = torch.randn((n, k), generator=g).to("cuda", torch.bfloat16).t()
    else:
        w = torch.randn((k, n), generator=g).to("cuda", torch.bfloat16)
    return x, w


# the reference's sweep shapes whose rows TMA can describe, a ragged
# edge in every dimension, and a long K
SM90_MATMULS = [(64, 64, 64), (128, 256, 128), (8, 8, 8), (1000, 328, 88),
                (520, 4104, 392)]


@pytest.mark.parametrize("layout", ["n-major", "k-major"])
@pytest.mark.parametrize("m,k,n", SM90_MATMULS)
def test_sm90_matmul_matches_plain(cuda, m, k, n, layout):
    x, w = _bf16_operands(m, k, n, layout)
    assert K3.route(x, w) == "sm90" and K3.w_layout(w) == layout
    launches = dict(K3.matmul_lb.launches_by_route)
    copies = K3.matmul_lb.copies
    out = matmul_lb(x, w)
    torch.cuda.synchronize()
    assert K3.matmul_lb.launches_by_route == dict(
        launches, sm90=launches["sm90"] + 1)
    assert K3.matmul_lb.copies == copies
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    _within(out, matmul_ref(x, w), torch.bfloat16)


@pytest.mark.parametrize("case", ["f32 w.t()", "bf16 x off by 2 bytes",
                                  "bf16 x strided, odd pitch"])
def test_matmul_routes_and_copies_what_tma_cannot_take(cuda, case):
    g = torch.Generator().manual_seed(9)
    if case == "f32 w.t()":     # K = 70: 280-byte rows, no TMA map
        x = torch.randn((100, 70), generator=g).to(cuda)
        w = torch.randn((40, 70), generator=g).to(cuda).t()
        dtype, want_copies = torch.float32, 1
    elif case == "bf16 x off by 2 bytes":
        buf = torch.randn(1 + 96 * 64, generator=g).to(cuda, torch.bfloat16)
        x = buf[1:].view(96, 64)
        w = torch.randn((64, 48), generator=g).to(cuda, torch.bfloat16)
        dtype, want_copies = torch.bfloat16, 0
    else:
        x = torch.randn((96, 65), generator=g).to(cuda, torch.bfloat16)
        x = x[:, :64]
        w = torch.randn((64, 48), generator=g).to(cuda, torch.bfloat16)
        dtype, want_copies = torch.bfloat16, 1
    assert K3.route(x, w) == "fma"
    launches = dict(K3.matmul_lb.launches_by_route)
    copies = K3.matmul_lb.copies
    out = matmul_lb(x, w)
    torch.cuda.synchronize()
    assert K3.matmul_lb.launches_by_route == dict(
        launches, fma=launches["fma"] + 1)
    assert K3.matmul_lb.copies == copies + want_copies
    _within(out, matmul_ref(x, w), dtype)


def test_sm90_launch_error_raises(cuda):
    """A tensor map the driver refuses (a 130-byte row pitch, which the
    route would never send) raises with its reason and counts no
    launch."""
    x = torch.zeros((64, 65), device=cuda, dtype=torch.bfloat16)[:, :64]
    w = torch.zeros((64, 64), device=cuda, dtype=torch.bfloat16)
    before = K3.matmul_lb.launches
    with pytest.raises(RuntimeError, match="matmul_lb_sm90"):
        K3._sm90(x, w)
    assert K3.matmul_lb.launches == before


# b, sq, skv, h, kv, hd, window, causal: every sm90 width (16 and 48 run
# at 64), causal tails, windows, non-causal, fully masked rows (q >= 20 +
# 8 - 1), GQA, and head dims above 256 (fma, in column chunks)
ROUTED = [
    (2, 200, 200, 4, 2, 16, 0, True),
    (1, 130, 130, 4, 2, 48, 0, False),
    (1, 300, 300, 4, 1, 64, 100, True),
    (1, 150, 150, 4, 2, 80, 0, True),
    (1, 130, 130, 4, 1, 96, 32, True),
    (2, 257, 257, 8, 2, 128, 0, True),
    (1, 64, 20, 2, 1, 128, 8, True),
    (1, 200, 150, 2, 1, 256, 64, True),
    (1, 100, 100, 2, 1, 320, 0, True),
    (1, 130, 100, 4, 2, 512, 16, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", ROUTED)
def test_attention_every_route_matches_plain(cuda, b, sq, skv, h, kv, hd,
                                             win, causal, dtype):
    """Each case on every route that takes it (head dims above 256 only
    fma; bf16 at a multiple of 8 up to 256 also sm90, f32 at a multiple
    of 4 up to 128 also sm90_tf32, which ``route`` picks), one launch of
    that route each."""
    g = torch.Generator().manual_seed(10)
    q, k, v = (torch.randn(s, generator=g).to(cuda, dtype)
               for s in ((b * h, sq, hd), (b * kv, skv, hd),
                         (b * kv, skv, hd)))
    want = attention_plain(q, k, v, groups=h // kv, window=win,
                           causal=causal)
    routes = ["fma"]
    if dtype == torch.bfloat16 and K4.sm90_head_dim(hd) is not None:
        routes.append("sm90")
    if dtype == torch.float32 and K4.sm90_tf32_head_dim(hd) is not None:
        routes.append("sm90_tf32")
    assert K4.route(q, k, v) == routes[-1]
    for rt in routes:
        before = dict(K4.attention.launches_by_route)
        out = K4.attention(q, k, v, groups=h // kv, window=win,
                           causal=causal, via=rt)
        torch.cuda.synchronize()
        assert K4.attention.launches_by_route == dict(
            before, **{rt: before[rt] + 1})
        assert out.dtype == dtype and out.shape == q.shape
        _within(out, want, dtype)


# b, h, ci, co, k, stride, pad, lhs dilation, pool, residual: conv1_1
# (Ci = 3: 6-byte bf16 pixels, staged by plain loads), odd channels,
# the dgrad geometry, a fused pool and residual, a 7x7/2 stem
BF16_CONVS = [
    (2, 33, 3, 64, 3, 1, 1, 1, 1, False),
    (3, 15, 7, 9, 3, 1, 1, 1, 1, False),
    (2, 9, 8, 8, 3, 1, 2, 2, 1, False),
    (3, 12, 24, 40, 3, 1, 1, 1, 2, True),
    (8, 14, 256, 200, 3, 1, 1, 1, 1, True),
    (8, 56, 3, 64, 7, 2, 3, 1, 1, False),
]


@pytest.mark.parametrize("b,h,ci,co,k,s,p,ld,pool,res", BF16_CONVS)
def test_bf16_conv_kernel_matches_plain(cuda, b, h, ci, co, k, s, p, ld,
                                        pool, res):
    """K1 in bf16: bf16 operands, f32 sums and epilogue, one rounding;
    the plain version does the same, so the bf16 gate holds."""
    g = torch.Generator().manual_seed(11)
    bf = torch.bfloat16
    x = torch.randn((b, h, h, ci), generator=g).to(cuda, bf)
    w = (torch.randn((k, k, ci, co), generator=g) / (k * k * ci) ** 0.5
         ).to(cuda, bf)
    bias = torch.randn((co,), generator=g).to(cuda, bf)
    hd = (h - 1) * ld + 1
    ho = (hd + 2 * p - k) // s + 1
    r = (torch.randn((b, ho, ho, co), generator=g).to(cuda, bf)
         if res else None)
    kw = dict(stride=s, padding=p, lhs_dilation=ld, pool=pool, relu=True)
    before = K.conv_lb.launches
    out = conv2d_lb(x, w, bias, r, **kw)
    torch.cuda.synchronize()
    assert K.conv_lb.launches == before + 1 and out.dtype == bf
    _within(out, conv2d_ref(x, w, bias, r, **kw), bf)


@pytest.mark.parametrize("b,h,w,ci,co,k,s,p", BWD)
def test_bf16_wgrad_kernel_matches_plain(cuda, b, h, w, ci, co, k, s, p):
    """K2 takes bf16 x and dy, widens them as it stages them and sums
    in f32: dW (f32) within the f32 wgrad tolerance of the plain
    version on the same words."""
    g = torch.Generator().manual_seed(12)
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    x = torch.randn((b, h, w, ci), generator=g).to(cuda, torch.bfloat16)
    dy = torch.randn((b, ho, wo, co), generator=g).to(cuda, torch.bfloat16)
    dw = W.wgrad_lb(x, dy, W.WgradGeometry(hk=k, wk=k, stride=(s, s),
                                           padding=(p, p)))
    torch.cuda.synchronize()
    assert dw.dtype == torch.float32
    _close(dw, wgrad_ref(x, dy, k, k, stride=s, padding=p), tol=2e-4)


def test_bf16_backward_through_the_kernels(cuda):
    """A bf16 conv's backward on the card: K1 recomputes and runs the
    dgrad, K2 the wgrad; the gradients come back in bf16 and agree with
    the plain version's autograd at the bf16 gate."""
    g = torch.Generator().manual_seed(13)
    bf = torch.bfloat16
    x = torch.randn((4, 16, 16, 32), generator=g).to(cuda, bf)
    w = (torch.randn((3, 3, 32, 64), generator=g) / 17).to(cuda, bf)
    bias = torch.randn((64,), generator=g).to(cuda, bf)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    out = conv2d_lb(*leaves, stride=2, padding=1)
    gy = torch.randn(out.shape, generator=g).to(cuda, bf)
    k1, k2 = K.conv_lb.launches, W.wgrad_lb.launches
    got = torch.autograd.grad(out, leaves, gy)
    torch.cuda.synchronize()
    assert (K.conv_lb.launches - k1, W.wgrad_lb.launches - k2) == (2, 1)
    plain = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    want = torch.autograd.grad(conv2d_ref(*plain, stride=2, padding=1),
                               plain, gy)
    for a, b in zip(got, want):
        assert a.dtype == bf
        _within(a, b, bf)


def test_bf16_server_on_the_card(cuda):
    """A computing bf16 ImageServer runs every conv on K1 in bf16 and
    answers bf16 logits within the bf16 gate of the plain version."""
    from repro_torch.models.cnn import init_vgg, vgg_graph
    from repro_torch.serve import ImageServer
    params = init_vgg(torch.Generator().manual_seed(14), width_mult=0.25,
                      device=cuda)
    params = {"convs": [{k: t.bfloat16() for k, t in p.items()}
                        for p in params["convs"]],
              "head": params["head"].bfloat16()}
    srv = ImageServer(params, 32, 32, device=cuda, dtype=torch.bfloat16,
                      buckets=(2,))
    x = torch.randn((2, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(15))
    before = K.conv_lb.launches
    srv.submit(x)
    (res,) = srv.drain()
    assert K.conv_lb.launches == before + 13
    assert res.logits.dtype == torch.bfloat16
    want = graph_logits(vgg_graph(params), params,
                        x.to(cuda, torch.bfloat16), conv=conv2d_ref)
    _within(res.logits, want, torch.bfloat16)


# b, h, ci, co, pool, residual, dilation, pad: K1's sm90 kernel at VGG
# shapes (conv1_2 with its pool, conv3_2, conv5_3 with its pool on the
# 14 x 14 plane), a residual join, dilation 2, and Co 200 (not a
# multiple of any CTA width) at Ci 24 (a Ci block past Ci)
SM90_CONVS = [
    (2, 224, 64, 64, 2, False, 1, 1),
    (8, 56, 256, 256, 1, False, 1, 1),
    (8, 14, 512, 512, 2, False, 1, 1),
    (4, 28, 64, 64, 1, True, 1, 1),
    (2, 20, 32, 48, 1, False, 2, 2),
    (3, 12, 24, 200, 2, True, 1, 1),
]


def _sm90_launched(before):
    return {r: K.conv_lb.launches_by_route[r] - before[r] for r in before}


def _on_conv(rt):
    return dict.fromkeys(K.ROUTES, 0) | {rt: 1}


@pytest.mark.parametrize("b,h,ci,co,pool,res,d,p", SM90_CONVS)
def test_sm90_conv_matches_plain(cuda, b, h, ci, co, pool, res, d, p):
    """K1's sm90 kernel (TMA, wgmma, f32 sums, one rounding) within the
    bf16 gate of the plain version, one launch on route ``sm90``."""
    g = torch.Generator().manual_seed(16)
    bf = torch.bfloat16
    x = torch.randn((b, h, h, ci), generator=g).to(cuda, bf)
    w = (torch.randn((3, 3, ci, co), generator=g) / (9 * ci) ** 0.5
         ).to(cuda, bf)
    bias = torch.randn((co,), generator=g).to(cuda, bf)
    ho = h + 2 * p - 2 * d
    r = (torch.randn((b, ho, ho, co), generator=g).to(cuda, bf)
         if res else None)
    kw = dict(padding=(p, p), dilation=(d, d), relu=True, pool=pool)
    assert K.route(x, w, bias=bias, residual=r, dilation=(d, d),
                   pool=pool) == "sm90"
    before = dict(K.conv_lb.launches_by_route)
    out = K.conv_lb(x, w, bias, r, **kw)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == _on_conv("sm90")
    assert out.dtype == bf and out.shape == (b, ho // pool, ho // pool, co)
    _within(out, conv2d_ref(x, w, bias, r, **kw), bf)


@pytest.mark.parametrize("b,h,ci,co", [(8, 28, 256, 512), (2, 14, 512, 512),
                                       (2, 56, 128, 256)])
def test_sm90_dgrad_geometry_matches_plain(cuda, b, h, ci, co):
    """The dgrad of a VGG layer (gy against the flipped weights, stride
    1, full padding) takes the sm90 kernel."""
    g = torch.Generator().manual_seed(17)
    bf = torch.bfloat16
    gy = torch.randn((b, h, h, co), generator=g).to(cuda, bf)
    wf = flip_w((torch.randn((3, 3, ci, co), generator=g) / (9 * ci) ** 0.5
                 ).to(cuda, bf))
    before = dict(K.conv_lb.launches_by_route)
    out = K.conv_lb(gy, wf, padding=(1, 1))
    torch.cuda.synchronize()
    assert _sm90_launched(before) == _on_conv("sm90")
    _within(out, conv2d_ref(gy, wf, padding=(1, 1)), bf)


@pytest.mark.parametrize("case", ["stride 2", "lhs dilation 2", "ci 12",
                                  "x off by 2 bytes"])
def test_what_sm90_does_not_take_runs_on_fma(cuda, case):
    """Geometries the route refuses run on the FMA kernel, at the same
    gate (Ci = 12: 108 taps, more than the im2col plane's 64)."""
    g = torch.Generator().manual_seed(18)
    bf = torch.bfloat16
    ci = 12 if case == "ci 12" else 16
    x = torch.randn((2, 16, 16, ci), generator=g).to(cuda, bf)
    if case == "x off by 2 bytes":
        flat = torch.zeros(x.numel() + 8, dtype=bf, device=cuda)
        x = flat[1:x.numel() + 1].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 == 2
    w = (torch.randn((3, 3, ci, 32), generator=g) / (9 * ci) ** 0.5
         ).to(cuda, bf)
    kw = dict(padding=(1, 1), relu=True,
              stride=(2, 2) if case == "stride 2" else (1, 1),
              lhs_dilation=(2, 2) if case == "lhs dilation 2" else (1, 1))
    assert K.route(x, w, kw["stride"], kw["lhs_dilation"]) == "fma"
    before = dict(K.conv_lb.launches_by_route)
    out = K.conv_lb(x, w, **kw)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == _on_conv("fma")
    _within(out, conv2d_ref(x, w, **kw), bf)


def test_conv_sm90_launch_error_raises(cuda, monkeypatch):
    """A tensor map the driver refuses (24-byte pixels: Ci = 12, which
    the route would never send, forced onto sm90 here) raises through
    ``conv_lb`` with its reason and counts no launch on any route."""
    bf = torch.bfloat16
    x = torch.zeros((1, 8, 8, 12), device=cuda, dtype=bf)
    w = torch.zeros((3, 3, 12, 16), device=cuda, dtype=bf)
    assert K.route(x, w) == "fma"
    monkeypatch.setattr(K, "route", lambda *a, **kw: "sm90")
    before = (K.conv_lb.launches, dict(K.conv_lb.launches_by_route))
    with pytest.raises(RuntimeError, match="conv_lb_sm90"):
        K.conv_lb(x, w, padding=(1, 1))
    assert (K.conv_lb.launches, K.conv_lb.launches_by_route) == before


# b, h, w, ci, co, pad, dilation: K2's sm90 kernel at VGG16/224 shapes
# (conv1_2 and conv3_1 at batch 2, conv5_3 at batch 8: the longest and
# the shortest reductions), a ragged 13 x 15 plane, Ci 16 and 24 (a Ci
# block past Ci), dilation 2
SM90_WGRADS = [
    (2, 224, 224, 64, 64, 1, 1),
    (2, 56, 56, 128, 256, 1, 1),
    (8, 14, 14, 512, 512, 1, 1),
    (3, 13, 15, 32, 48, 1, 1),
    (2, 20, 20, 16, 64, 1, 1),
    (2, 20, 20, 24, 40, 1, 1),
    (2, 20, 20, 32, 32, 2, 2),
]


def _wgrad_launched(before):
    return {r: W.wgrad_lb.launches_by_route[r] - before[r] for r in before}


@pytest.mark.parametrize("b,h,w,ci,co,p,d", SM90_WGRADS)
def test_sm90_wgrad_matches_plain(cuda, b, h, w, ci, co, p, d):
    """K2's sm90 kernel (TMA, wgmma, f32 sums) within the wgrad
    tolerance of the plain version on the same bf16 words, one launch on
    route ``sm90``."""
    g = torch.Generator().manual_seed(19)
    bf = torch.bfloat16
    ho, wo = h + 2 * p - 2 * d, w + 2 * p - 2 * d
    x = torch.randn((b, h, w, ci), generator=g).to(cuda, bf)
    dy = torch.randn((b, ho, wo, co), generator=g).to(cuda, bf)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(p, p), dilation=(d, d))
    assert W.route(x, dy, geom) == "sm90"
    before = dict(W.wgrad_lb.launches_by_route)
    dw = W.wgrad_lb(x, dy, geom)
    torch.cuda.synchronize()
    assert _wgrad_launched(before) == _one_on("sm90")
    assert dw.dtype == torch.float32
    _close(dw, wgrad_ref(x, dy, 3, 3, padding=p, dilation=d), tol=2e-4)


def _one_on(rt):
    return dict.fromkeys(W.ROUTES, 0) | {rt: 1}


@pytest.mark.parametrize("case", ["stride 2", "ci 9", "x off by 2 bytes"])
def test_what_sm90_wgrad_does_not_take_runs_on_fma(cuda, case):
    """Strides, a misaligned base, and Ci = 9 (81 taps: neither a TMA map
    nor the im2col plane takes it) run on FMA."""
    g = torch.Generator().manual_seed(20)
    bf = torch.bfloat16
    ci, s = (9 if case == "ci 9" else 16), (2 if case == "stride 2" else 1)
    x = torch.randn((2, 16, 16, ci), generator=g).to(cuda, bf)
    if case == "x off by 2 bytes":
        flat = torch.zeros(x.numel() + 8, dtype=bf, device=cuda)
        x = flat[1:x.numel() + 1].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 == 2
    ho = (16 + 2 - 3) // s + 1
    dy = torch.randn((2, ho, ho, 32), generator=g).to(cuda, bf)
    geom = W.WgradGeometry(hk=3, wk=3, stride=(s, s), padding=(1, 1))
    assert W.route(x, dy, geom) == "fma"
    before = dict(W.wgrad_lb.launches_by_route)
    dw = W.wgrad_lb(x, dy, geom)
    torch.cuda.synchronize()
    assert _wgrad_launched(before) == _one_on("fma")
    _close(dw, wgrad_ref(x, dy, 3, 3, stride=s, padding=1), tol=2e-4)


def test_wgrad_sm90_launch_error_raises(cuda, monkeypatch):
    """A launch the kernel refuses (Ci = 12, which the route would never
    send, forced onto sm90 here) raises through ``wgrad_lb`` with its
    reason and counts no launch on any route."""
    bf = torch.bfloat16
    x = torch.zeros((1, 8, 8, 12), device=cuda, dtype=bf)
    dy = torch.zeros((1, 8, 8, 16), device=cuda, dtype=bf)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    assert W.route(x, dy, geom) == "fma"
    plan = W.sm90_wgrad_plan(1, 8, 8, 16, 16, 3, 3, (1, 1))
    monkeypatch.setattr(W, "plan_of", lambda *a, **kw: ("sm90", plan))
    before = (W.wgrad_lb.launches, dict(W.wgrad_lb.launches_by_route))
    with pytest.raises(RuntimeError, match="wgrad_lb_sm90"):
        W.wgrad_lb(x, dy, geom)
    assert (W.wgrad_lb.launches, W.wgrad_lb.launches_by_route) == before


# b, h, w, ci, co, pad, dilation: K2's 3xTF32 kernel at VGG16/224 shapes
# (conv1_2 and conv3_1 at batch 2, conv5_3 at batch 8), a ragged 13 x 15
# plane, Ci 4 and 12 (16 channels of a window in a row block, a 32-channel
# box past Ci), dilation 2
TF32_WGRADS = [
    (2, 224, 224, 64, 64, 1, 1),
    (2, 56, 56, 128, 256, 1, 1),
    (8, 14, 14, 512, 512, 1, 1),
    (3, 13, 15, 32, 48, 1, 1),
    (2, 20, 20, 4, 16, 1, 1),
    (2, 20, 20, 12, 20, 1, 1),
    (2, 20, 20, 32, 32, 2, 2),
]


@pytest.mark.parametrize("b,h,w,ci,co,p,d", TF32_WGRADS)
def test_tf32_wgrad_matches_plain(cuda, b, h, w, ci, co, p, d):
    """K2's 3xTF32 kernel (TMA, A from registers, hi and lo dy tiles,
    wgmma .tf32) within the wgrad tolerance of the plain version on the
    same f32 words, one launch on route ``sm90_tf32``; the same plan
    without its lo terms (1xTF32) errs at least 4x more."""
    g = torch.Generator().manual_seed(20)
    ho, wo = h + 2 * p - 2 * d, w + 2 * p - 2 * d
    x = torch.randn((b, h, w, ci), generator=g).to(cuda)
    dy = torch.randn((b, ho, wo, co), generator=g).to(cuda)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(p, p), dilation=(d, d))
    rt, plan = W.plan_of(x, dy, geom)
    assert rt == "sm90_tf32"
    before = dict(W.wgrad_lb.launches_by_route)
    dw = W.wgrad_lb(x, dy, geom)
    torch.cuda.synchronize()
    assert _wgrad_launched(before) == _one_on("sm90_tf32")
    want = wgrad_ref(x, dy, 3, 3, padding=p, dilation=d)
    _close(dw, want, tol=2e-4)
    one = W._sm90_tf32(x, dy, geom, plan, lo_terms=False)
    scale = want.abs().max()
    assert ((one - want).abs().max() / scale
            >= 4 * (dw - want).abs().max() / scale)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_im2col_wgrad_matches_plain(cuda, dtype, b):
    """VGG16's conv1_1 (Ci = 3) on route ``sm90_im2col``: one layer
    launch, one staging launch, the plane equal to the plain one, dW
    within the wgrad tolerance."""
    g = torch.Generator().manual_seed(21)
    x = torch.randn((b, 224, 224, 3), generator=g).to(cuda, dtype)
    dy = torch.randn((b, 224, 224, 64), generator=g).to(cuda, dtype)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    assert W.route(x, dy, geom) == "sm90_im2col"
    before = dict(W.wgrad_lb.launches_by_route)
    stages = W.wgrad_lb.stage_launches
    dw = W.wgrad_lb(x, dy, geom)
    torch.cuda.synchronize()
    assert _wgrad_launched(before) == _one_on("sm90_im2col")
    assert W.wgrad_lb.stage_launches == stages + 1
    assert dw.shape == (3, 3, 3, 64) and dw.dtype == torch.float32
    _close(dw, wgrad_ref(x, dy, 3, 3, padding=1), tol=2e-4)
    assert torch.equal(I.im2col_plane(x, 3, 3, (1, 1)),
                       im2col_ref(x, 3, 3, padding=1, channels=32))


@pytest.mark.parametrize("dtype,batch", [(torch.float32, 84),
                                         (torch.bfloat16, 336)])
def test_wgrad_past_max_splits_matches_plain(cuda, dtype, batch):
    """A 224 x 224 reduction long enough that the range cap needs more than
    ``MAX_SPLITS`` ranges (65,856 pixel blocks in f32, 263,424 in bf16):
    one launch on the tensor-core route of its type, over that many
    splits, within the wgrad tolerance of the plain version."""
    g = torch.Generator().manual_seed(22)
    ci = 4 if dtype == torch.float32 else 8
    x = torch.randn((batch, 224, 224, ci), generator=g).to(cuda, dtype)
    dy = torch.randn((batch, 224, 224, 8), generator=g).to(cuda, dtype)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    rt, plan = W.plan_of(x, dy, geom)
    assert rt == ("sm90_tf32" if dtype == torch.float32 else "sm90")
    assert plan.splits > W.MAX_SPLITS
    before = dict(W.wgrad_lb.launches_by_route)
    dw = W.wgrad_lb(x, dy, geom)
    torch.cuda.synchronize()
    assert _wgrad_launched(before) == _one_on(rt)
    _close(dw, wgrad_ref(x, dy, 3, 3, padding=1), tol=2e-4)


def test_wgrad_tf32_launch_error_raises(cuda, monkeypatch):
    """A launch the kernel refuses (Ci = 6, which the route would never
    send, forced onto sm90_tf32 here) raises through ``wgrad_lb`` with
    its reason and counts no launch on any route."""
    x = torch.zeros((1, 8, 8, 6), device=cuda)
    dy = torch.zeros((1, 8, 8, 16), device=cuda)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    assert W.route(x, dy, geom) == "sm90_im2col"
    plan = W.sm90_tf32_wgrad_plan(1, 8, 8, 8, 16, 3, 3, (1, 1))
    monkeypatch.setattr(W, "plan_of", lambda *a, **kw: ("sm90_tf32", plan))
    before = (W.wgrad_lb.launches, dict(W.wgrad_lb.launches_by_route))
    with pytest.raises(RuntimeError, match="wgrad_lb_sm90_tf32"):
        W.wgrad_lb(x, dy, geom)
    assert (W.wgrad_lb.launches, W.wgrad_lb.launches_by_route) == before


# b, h, ci, co, k, pad, pool, residual: K1's route sm90_im2col at
# VGG16's conv1_1 (batch 8), ResNet-20's stem, a fused 2x2 pool with a
# residual join, and 63 taps (Ci 7)
IM2COL_CONVS = [
    (8, 224, 3, 64, 3, 1, 1, False),
    (8, 32, 3, 16, 3, 1, 1, False),
    (2, 20, 3, 32, 3, 1, 2, True),
    (2, 18, 7, 24, 3, 1, 1, False),
]


@pytest.mark.parametrize("b,h,ci,co,k,p,pool,res", IM2COL_CONVS)
def test_im2col_conv_matches_plain(cuda, b, h, ci, co, k, p, pool, res):
    """K1 at Ci not a multiple of 8 on route ``sm90_im2col``: one layer
    launch, one staging launch, the output within the bf16 gate of the
    plain version."""
    g = torch.Generator().manual_seed(23)
    bf = torch.bfloat16
    x = torch.randn((b, h, h, ci), generator=g).to(cuda, bf)
    w = (torch.randn((k, k, ci, co), generator=g) / (k * k * ci) ** 0.5
         ).to(cuda, bf)
    bias = torch.randn((co,), generator=g).to(cuda, bf)
    ho = h + 2 * p - k + 1
    r = (torch.randn((b, ho, ho, co), generator=g).to(cuda, bf)
         if res else None)
    kw = dict(padding=(p, p), relu=True, pool=pool)
    assert K.route(x, w, bias=bias, residual=r, pool=pool,
                   padding=(p, p)) == "sm90_im2col"
    before = dict(K.conv_lb.launches_by_route)
    stages = K.conv_lb.stage_launches
    out = K.conv_lb(x, w, bias, r, **kw)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == _on_conv("sm90_im2col")
    assert K.conv_lb.stage_launches == stages + 1
    assert out.dtype == bf and out.shape == (b, ho // pool, ho // pool, co)
    _within(out, conv2d_ref(x, w, bias, r, **kw), bf)


# m, k, n: K3's 3xTF32 route at the reference's sweep shapes whose f32
# rows TMA describes, a ragged edge in every dimension, and
# phi3-medium-14b's FFN down (K = 17,920: four promotions a 128 of K)
TF32_MATMULS = [(64, 64, 64), (128, 256, 128), (8, 8, 8), (1000, 328, 88),
                (520, 4104, 392), (4096, 17920, 5120)]


@pytest.mark.parametrize("layout", ["n-major", "k-major"])
@pytest.mark.parametrize("m,k,n", TF32_MATMULS)
def test_tf32_matmul_matches_plain(cuda, m, k, n, layout):
    """K3's f32 route ``sm90_tf32`` within the f32 card gate of the plain
    version (f32 sums on FMA), one launch, the same bits on every launch
    (no atomics); the same tile without its lo terms (1xTF32) errs at
    least 4x more."""
    g = torch.Generator().manual_seed(24)
    x = torch.randn((m, k), generator=g).to(cuda)
    if layout == "k-major":
        w = (torch.randn((n, k), generator=g) / k ** 0.5).to(cuda).t()
    else:
        w = (torch.randn((k, n), generator=g) / k ** 0.5).to(cuda)
    assert K3.route(x, w) == "sm90_tf32" and K3.w_layout(w) == layout
    launches = dict(K3.matmul_lb.launches_by_route)
    out = matmul_lb(x, w)
    torch.cuda.synchronize()
    assert K3.matmul_lb.launches_by_route == dict(
        launches, sm90_tf32=launches["sm90_tf32"] + 1)
    assert out.dtype == torch.float32 and out.shape == (m, n)
    want = matmul_ref(x, w)
    _within(out, want, torch.float32)
    for _ in range(3):
        assert torch.equal(K3._sm90_tf32(x, w), out)
    one = K3._sm90_tf32(x, w, lo_terms=False)
    assert ((one - want).abs().max()
            >= 4 * (out - want).abs().max())


def test_tf32_matmul_launch_error_raises(cuda):
    """A tensor map the driver refuses (a 260-byte row pitch, which the
    route would never send) raises with its reason and counts no
    launch."""
    x = torch.zeros((64, 65), device=cuda)[:, :64]
    w = torch.zeros((64, 64), device=cuda)
    assert K3.route(x, w) == "fma"
    before = K3.matmul_lb.launches
    with pytest.raises(RuntimeError, match="matmul_lb_sm90_tf32"):
        K3._sm90_tf32(x, w)
    assert K3.matmul_lb.launches == before


def test_wgrad_stem_at_batch_65536_matches_plain(cuda):
    """ResNet-20/32's stem wgrad (Ci 3, Co 16, 3x3, pad 1) at batch
    65536 in bf16 (x 0.4 GB, dy 2.1 GB, the plane 4.3 GB): route
    ``sm90_im2col``, whose staging grid now takes 65536 images, within
    ``WGRAD_TOL`` of the plain version summed over batch chunks of
    4096."""
    bf = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(25)
    batch, chunk = 65536, 4096
    x = torch.randn((batch, 32, 32, 3), generator=gen, device=cuda).to(bf)
    dy = torch.randn((batch, 32, 32, 16), generator=gen, device=cuda).to(bf)
    geom = W.WgradGeometry(hk=3, wk=3, padding=(1, 1))
    assert W.route(x, dy, geom) == "sm90_im2col"
    before = dict(W.wgrad_lb.launches_by_route)
    stages = W.wgrad_lb.stage_launches
    dw = W.wgrad_lb(x, dy, geom)
    torch.cuda.synchronize()
    assert _wgrad_launched(before) == _one_on("sm90_im2col")
    assert W.wgrad_lb.stage_launches == stages + 1
    want = sum(wgrad_ref(x[i:i + chunk], dy[i:i + chunk], 3, 3, padding=1)
               for i in range(0, batch, chunk))
    _close(dw, want, tol=2e-4)


# b, h, ci, co, pool, residual: K1's 3xTF32 route at VGG16/224 batch 8
# (conv1_2 and conv5_3 with their pools, conv3_2) and a ResNet-20/32
# residual layer (16 channels: 32-wide CTAs)
TF32_CONVS = [
    (8, 224, 64, 64, 2, False),
    (8, 56, 256, 256, 1, False),
    (8, 14, 512, 512, 2, False),
    (8, 32, 16, 16, 1, True),
]


@pytest.mark.parametrize("b,h,ci,co,pool,res", TF32_CONVS)
def test_tf32_conv_matches_plain(cuda, b, h, ci, co, pool, res):
    """K1's f32 route ``sm90_tf32`` (3x3, pad 1, bias, ReLU) within 1e-4
    of max |plain|, one launch; a second launch gives the same bits (no
    atomics, no race on the rings), and the backward's recompute (no
    epilogue) gives the forward's pre-epilogue sums bit for bit: the
    epilogue applied to it in PyTorch is the forward's output."""
    g = torch.Generator().manual_seed(26)
    x = torch.randn((b, h, h, ci), generator=g).to(cuda)
    w = (torch.randn((3, 3, ci, co), generator=g) / (9 * ci) ** 0.5
         ).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    r = torch.randn((b, h, h, co), generator=g).to(cuda) if res else None
    kw = dict(padding=(1, 1), relu=True, pool=pool)
    assert K.route(x, w, bias=bias, residual=r, pool=pool) == "sm90_tf32"
    before = dict(K.conv_lb.launches_by_route)
    out = K.conv_lb(x, w, bias, r, **kw)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == _on_conv("sm90_tf32")
    assert out.shape == (b, h // pool, h // pool, co)
    _close(out, conv2d_ref(x, w, bias, r, **kw))
    assert torch.equal(K.conv_lb(x, w, bias, r, **kw), out)
    z = K.conv_lb(x, w, padding=(1, 1)) + bias
    if r is not None:
        z = z + r
    z = torch.clamp_min(z, 0.0)
    if pool == 2:
        z = z.reshape(b, h // 2, 2, h // 2, 2, co).amax(dim=(2, 4))
    assert torch.equal(z, out)


def test_tf32_dgrad_and_backward_ride_the_kernel(cuda):
    """A VGG conv4 layer's backward in f32: the recompute and the dgrad
    (gy against the flipped weights, full padding) on ``sm90_tf32``,
    the gradients within 1e-4 of the plain autograd (no ReLU or pool: no
    discrete choice to flip)."""
    g = torch.Generator().manual_seed(27)
    x = torch.randn((8, 28, 28, 256), generator=g).to(cuda)
    w = (torch.randn((3, 3, 256, 512), generator=g) / (9 * 256) ** 0.5
         ).to(cuda)
    bias = torch.randn((512,), generator=g).to(cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    out = conv2d_lb(*leaves, padding=1)
    gy = torch.randn(out.shape, generator=g).to(cuda)
    before = dict(K.conv_lb.launches_by_route)
    got = torch.autograd.grad(out, leaves, gy)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == dict.fromkeys(K.ROUTES, 0) | {
        "sm90_tf32": 2}
    plain = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    want = torch.autograd.grad(conv2d_ref(*plain, padding=1), plain, gy)
    for a, b_ in zip(got, want):
        _close(a, b_, tol=2e-4)


@pytest.mark.parametrize("b,h,co", [(8, 224, 64), (8, 32, 16)])
def test_tf32_im2col_conv_matches_plain(cuda, b, h, co):
    """f32 conv1_1 and the ResNet stem (Ci = 3) on ``sm90_im2col``: the
    plane, then the 3xTF32 kernel as a 1x1 conv; one layer and one
    staging launch, within 1e-4 of max |plain|."""
    g = torch.Generator().manual_seed(28)
    x = torch.randn((b, h, h, 3), generator=g).to(cuda)
    w = (torch.randn((3, 3, 3, co), generator=g) / 27 ** 0.5).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    kw = dict(padding=(1, 1), relu=True)
    rt, plan = K.plan_of(x, w, bias, padding=(1, 1))
    assert rt == "sm90_im2col"
    assert plan.inner == K.sm90_tf32_plan(b, h, h, co, 32)
    before = dict(K.conv_lb.launches_by_route)
    stages = K.conv_lb.stage_launches
    out = K.conv_lb(x, w, bias, **kw)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == _on_conv("sm90_im2col")
    assert K.conv_lb.stage_launches == stages + 1
    _close(out, conv2d_ref(x, w, bias, **kw))


def test_conv_tf32_launch_error_raises(cuda, monkeypatch):
    """A launch the kernel refuses (Ci = 6, which the route would never
    send, forced onto sm90_tf32 here) raises through ``conv_lb`` with
    its reason and counts no launch on any route."""
    x = torch.zeros((1, 8, 8, 6), device=cuda)
    w = torch.zeros((3, 3, 6, 16), device=cuda)
    assert K.route(x, w, padding=(1, 1)) == "sm90_im2col"
    plan = K.sm90_tf32_plan(1, 8, 8, 16, 6, 3, 3)
    monkeypatch.setattr(K, "plan_of", lambda *a, **kw: ("sm90_tf32", plan))
    before = (K.conv_lb.launches, dict(K.conv_lb.launches_by_route))
    with pytest.raises(RuntimeError, match="conv_lb_sm90_tf32"):
        K.conv_lb(x, w, padding=(1, 1))
    assert (K.conv_lb.launches, K.conv_lb.launches_by_route) == before


# b, sq, skv, h, kv, hd, window, causal: K4's 3xTF32 route at the
# reference's sweep, rows with no unmasked key, GQA with a window, the
# widths 64, 96 (hd 80 padded) and 128, a ragged last tile, hd 20 (padded
# to 64), and a long non-causal case (64 sub-tiles a row)
TF32_ATTENTION = [
    (2, 64, 64, 4, 2, 16, 0, True),
    (1, 64, 20, 2, 1, 16, 8, True),
    (1, 300, 300, 4, 1, 64, 100, True),
    (1, 150, 150, 4, 2, 80, 0, True),
    (1, 130, 130, 4, 1, 96, 32, True),
    (2, 257, 257, 8, 2, 128, 0, True),
    (1, 90, 90, 2, 1, 20, 16, True),
    (1, 2048, 2048, 4, 2, 128, 0, False),
]


@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", TF32_ATTENTION)
def test_tf32_attention_matches_plain(cuda, b, sq, skv, h, kv, hd, win,
                                      causal):
    """K4's f32 route ``sm90_tf32`` within the f32 card gate of the plain
    version, one launch, the same bits on every launch (no atomics); the
    same plan without its lo terms (1xTF32) errs at least 4x more, and
    with the transposers reading V one key off fails the gate."""
    import dataclasses
    g = torch.Generator().manual_seed(26)
    q, k, v = (torch.randn(s, generator=g).to(cuda)
               for s in ((b * h, sq, hd), (b * kv, skv, hd),
                         (b * kv, skv, hd)))
    kw = dict(groups=h // kv, window=win, causal=causal)
    assert K4.route(q, k, v) == "sm90_tf32"
    before = dict(K4.attention.launches_by_route)
    out = K4.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K4.attention.launches_by_route == dict(
        before, sm90_tf32=before["sm90_tf32"] + 1)
    assert out.dtype == torch.float32 and out.shape == q.shape
    want = attention_plain(q, k, v, **kw)
    _within(out, want, torch.float32)
    plan = K4.sm90_tf32_plan(K4.sm90_tf32_head_dim(hd))
    for _ in range(3):
        assert torch.equal(K4._sm90_tf32(q, k, v, plan, **kw), out)
    one = K4._sm90_tf32(q, k, v, plan, lo_terms=False, **kw)
    assert (one - want).abs().max() >= 4 * (out - want).abs().max()
    bad = K4._sm90_tf32(q, k, v, dataclasses.replace(plan, v_key_off=1),
                        **kw)
    with pytest.raises(AssertionError):
        _within(bad, want, torch.float32)


def test_tf32_attention_rejects_what_it_does_not_take(cuda):
    q = torch.randn((2, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="route sm90_tf32 takes f32"):
        K4.attention(q.bfloat16(), q[:1].bfloat16(), q[:1].bfloat16(),
                     groups=2, via="sm90_tf32")
    q = torch.randn((2, 16, 130), device=cuda)
    assert K4.route(q, q[:1], q[:1]) == "fma"
    with pytest.raises(ValueError, match="route sm90_tf32 takes f32"):
        K4.attention(q, q[:1], q[:1], groups=2, via="sm90_tf32")


def test_tf32_attention_launch_error_raises(cuda):
    """A plan whose offsets do not fit the kernel's own sizes (the split
    ring laid over the raw one), which the wrapper would never make, is
    refused before launch: it raises with its reason and counts no
    launch."""
    import dataclasses
    q = torch.randn((2, 64, 128), device=cuda)
    plan = K4.sm90_tf32_plan(128)
    bad = dataclasses.replace(plan, split=plan.raw)
    before = K4.attention.launches
    with pytest.raises(RuntimeError, match="attention_block_sm90_tf32"):
        K4._sm90_tf32(q, q[:1], q[:1], bad, groups=2, window=0,
                      causal=True)
    assert K4.attention.launches == before



# b, h, ci, co, k, stride, pad: ResNet-20/32's four strided convs at
# batch 8
RESNET_STRIDED = [
    (8, 32, 16, 32, 3, 2, 1),
    (8, 32, 16, 32, 1, 2, 0),
    (8, 16, 32, 64, 3, 2, 1),
    (8, 16, 32, 64, 1, 2, 0),
]


def _strided(cuda, b, h, ci, co, k, s, p, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, h, ci), generator=g).to(cuda)
    w = (torch.randn((k, k, ci, co), generator=g) / (k * k * ci) ** 0.5
         ).to(cuda)
    bias = torch.randn((co,), generator=g).to(cuda)
    ho = (h + 2 * p - k) // s + 1
    gy = torch.randn((b, ho, ho, co), generator=g).to(cuda)
    return x, w, bias, gy


@pytest.mark.parametrize("b,h,ci,co,k,s,p", RESNET_STRIDED)
def test_tf32_strided_forward_matches_plain(cuda, b, h, ci, co, k, s, p):
    """ResNet-20/32's strided convs in f32 on ``sm90_tf32`` (the halo as
    parts at the traversal stride): one launch, within 1e-4 of max
    |plain|, the same bits on a second launch."""
    x, w, bias, _ = _strided(cuda, b, h, ci, co, k, s, p, seed=31)
    kw = dict(stride=(s, s), padding=(p, p), relu=True)
    assert K.route(x, w, (s, s), bias=bias, padding=(p, p)) == "sm90_tf32"
    before = dict(K.conv_lb.launches_by_route)
    out = K.conv_lb(x, w, bias, **kw)
    again = K.conv_lb(x, w, bias, **kw)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == dict.fromkeys(K.ROUTES, 0) | {
        "sm90_tf32": 2}
    _close(out, conv2d_ref(x, w, bias, **kw))
    assert torch.equal(out, again)


@pytest.mark.parametrize("b,h,ci,co,k,s,p", RESNET_STRIDED)
def test_tf32_phased_dgrad_matches_plain(cuda, b, h, ci, co, k, s, p):
    """Their data gradients by output phases: one launch on
    ``sm90_tf32`` (no pad, flip or crop: K1's only launch, and dx comes
    back at the input's size, contiguous), within 1e-4 of max |plain
    autograd|."""
    x, w, _, gy = _strided(cuda, b, h, ci, co, k, s, p, seed=32)
    a = ConvArgs(stride=(s, s), padding=(p, p), dilation=(1, 1),
                 lhs_dilation=(1, 1), groups=1, relu=False, pool=1)
    before = dict(K.conv_lb.launches_by_route)
    dx = dgrad_lb(gy, w, a, h, h)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == dict.fromkeys(K.ROUTES, 0) | {
        "sm90_tf32": 1}
    assert dx.shape == x.shape and dx.is_contiguous()
    xg = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(conv2d_ref(xg, w, stride=s, padding=p),
                                  xg, gy)
    _close(dx, want)


def test_stride_one_dgrad_is_composed_outside_the_dgrad_cache(cuda):
    """A stride-1 f32 dgrad (ResNet-20/32's s2b1_a: route ``composed``)
    is one launch on the conv's own route, puts no entry in the
    phased dgrad's cache and is within 1e-4 of max |plain autograd|."""
    b, h, c = 8, 16, 32
    g = torch.Generator().manual_seed(35)
    x = torch.randn((b, h, h, c), generator=g).to(cuda)
    w = (torch.randn((3, 3, c, c), generator=g) / (9 * c) ** 0.5).to(cuda)
    gy = torch.randn((b, h, h, c), generator=g).to(cuda)
    assert K.dgrad_route(gy, w, (1, 1), h, h, (1, 1)) == "composed"
    K.launch_cache.clear()
    before = dict(K.conv_lb.launches_by_route)
    dx = K.conv_lb_dgrad(gy, w, stride=(1, 1), padding=(1, 1), h=h, wd=h)
    torch.cuda.synchronize()
    assert _sm90_launched(before) == _on_conv("sm90_tf32")
    assert not any(key[0] == "dgrad" for key in K.launch_cache.entries)
    xg = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(conv2d_ref(xg, w, padding=1), xg, gy)
    _close(dx, want)


@pytest.mark.parametrize("b,h,ci,co,k,s,p", RESNET_STRIDED)
def test_tf32_strided_wgrad_matches_plain(cuda, b, h, ci, co, k, s, p):
    """Their weight gradients on ``sm90_tf32``: one launch, within 2e-4
    of max |plain|."""
    x, _, _, gy = _strided(cuda, b, h, ci, co, k, s, p, seed=33)
    geom = W.WgradGeometry(hk=k, wk=k, stride=(s, s), padding=(p, p))
    assert W.route(x, gy, geom) == "sm90_tf32"
    before = dict(W.wgrad_lb.launches_by_route)
    dw = W.wgrad_lb(x, gy, geom)
    torch.cuda.synchronize()
    assert _wgrad_launched(before) == _one_on("sm90_tf32")
    _close(dw, wgrad_ref(x, gy, k, k, stride=s, padding=p), tol=2e-4)


def test_strided_controls_fail_their_gates(cuda):
    """At ResNet-20/32's s2b0_a: halo boxes loaded at stride 1 (K1
    forward, K2), the fullest phase's taps one gy column off (K1 dgrad)
    fail the f32 gates; 1xTF32 errs at least 4x the route."""
    b, h, ci, co, k, s, p = RESNET_STRIDED[0]
    x, w, bias, gy = _strided(cuda, b, h, ci, co, k, s, p, seed=34)
    st, pd = (s, s), (p, p)

    def rel(out, ref):
        return ((out - ref).abs().max() / ref.abs().max()).item()

    ref = conv2d_ref(x, w, bias, stride=st, padding=pd)
    plan = K.plan_of(x, w, bias, stride=st, padding=pd)[1]
    args = (x, w, bias, None, 16, 16, pd, False, 1)
    right = rel(K._sm90_tf32(*args, plan), ref)
    assert right <= 1e-4
    assert rel(K._sm90_tf32(*args, K.halo_at_stride_one(plan)), ref) > 1e-4
    assert rel(K._sm90_tf32(*args, plan, lo_terms=False), ref) >= 4 * right
    xg = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(conv2d_ref(xg, w, stride=st, padding=pd),
                                  xg, gy)
    dplan = K.sm90_tf32_dgrad_plan(b, h, h, ci, co, k, k, st, pd)

    def phased(pl, lo_terms=True):
        return K.Tf32Launch((b, h, h, ci), K.tf32_args(
            gy.shape, w.shape, pl, (h, h), (0, 0), False, 1,
            lo_terms))(gy, w, None, None)

    right = rel(phased(dplan), want)
    assert right <= 1e-4
    assert rel(phased(K.dgrad_phase_shifted(dplan)), want) > 1e-4
    assert rel(phased(dplan, False), want) >= 4 * right
    geom = W.WgradGeometry(hk=k, wk=k, stride=st, padding=pd)
    dref = wgrad_ref(x, gy, k, k, stride=s, padding=p)
    wplan = W.plan_of(x, gy, geom)[1]
    right = rel(W._sm90_tf32(x, gy, geom, wplan), dref)
    assert right <= 2e-4
    assert rel(W._sm90_tf32(x, gy, geom, K.halo_at_stride_one(wplan)),
               dref) > 2e-4
    assert rel(W._sm90_tf32(x, gy, geom, wplan, lo_terms=False),
               dref) >= 4 * right


def _loop_server(cuda, **kw):
    from repro_torch.models.cnn import init_vgg, vgg_graph
    from repro_torch.serve import ImageServer
    params = init_vgg(torch.Generator().manual_seed(40), width_mult=0.25,
                      device=cuda)
    graph = vgg_graph(params)
    return ImageServer(params, 32, 32, graph=graph, device=cuda,
                       buckets=(1, 2, 4), wait_budget=0.0, **kw), graph


def test_serving_loop_async_on_the_card_matches_plain(cuda):
    """``run_async(max_inflight=2)`` with faults: every rid DONE once,
    13 K1 launches a computed dispatch (each enqueued under the launch
    lock, from the worker threads), logits within 1e-4 of max |plain|."""
    import asyncio

    from repro_torch.serve import FaultPlan, RequestState, ServingLoop
    srv, graph = _loop_server(cuda)
    loop = ServingLoop(srv, deadline_s=None, max_inflight=2,
                       fault_plan=FaultPlan.parse("fail@1,delay@3:0.01"))
    g = torch.Generator().manual_seed(41)
    imgs = [torch.randn((n, 32, 32, 3), generator=g) for n in
            (1, 2, 4, 1, 2, 4, 3)]
    srv.warm()
    before = K.conv_lb.launches
    for x in imgs:
        loop.submit(x)
    results = asyncio.run(loop.run_async())
    assert sorted(r.rid for r in results) == list(range(len(imgs)))
    assert all(t.state is RequestState.DONE
               for t in loop.requests.values())
    assert loop.counters["retries"] == 1
    assert K.conv_lb.launches - before == 13 * srv.ledger.dispatches
    for r in results:
        want = graph_logits(graph, srv.params, imgs[r.rid].to(cuda),
                            conv=conv2d_ref)
        _close(r.logits, want)


def test_poisoned_kernel_path_degrades_to_account_only_on_the_card(cuda):
    """The kernel pipeline raises; the breaker degrades the retry to
    account-only, which launches nothing and returns no logits: no
    plain version and no library call stands in on the card."""
    from repro_torch.kernels.conv_lb.ops import exec_fallback_counts
    from repro_torch.serve import ServingLoop
    from repro_torch.serve import server as S

    fallbacks = exec_fallback_counts()
    srv, _ = _loop_server(cuda)

    def poisoned(tgt):
        raise RuntimeError("kernel path poisoned")

    srv.pipeline = lambda bucket, target=None: poisoned(target)
    loop = ServingLoop(srv, deadline_s=None, breaker_threshold=1,
                       max_retries=3, backoff_base_s=0.01)
    before = (K.conv_lb.launches, dict(K.conv_lb.launches_by_route))
    loop.submit(torch.randn((2, 32, 32, 3)))
    (res,) = loop.run_sync(tick_s=0.005)
    assert res.logits is None
    assert loop.breaker.mode.name == "account-only"
    assert srv.ledger.degraded_dispatches == 1
    assert (K.conv_lb.launches, dict(K.conv_lb.launches_by_route)) == before
    assert exec_fallback_counts() == fallbacks
    assert S.LAUNCH_LOCK.acquire(blocking=False)   # released after the raise
    S.LAUNCH_LOCK.release()


def test_traced_dispatch_times_each_layer_on_the_card(cuda):
    """A dispatch under an active tracer: every conv's
    ``kernel.conv2d_lb`` span carries the card's own time between CUDA
    events (``device_us`` > 0, within the ``graph.forward`` span), its
    K1 launches are the untraced dispatch's, and so are its logits, bit
    for bit."""
    from repro_torch.models.cnn import init_vgg
    from repro_torch.obs import Tracer
    from repro_torch.serve import ImageServer
    params = init_vgg(torch.Generator().manual_seed(16), width_mult=0.25,
                      device=cuda)
    x = torch.randn((4, 32, 32, 3), generator=torch.Generator()
                    .manual_seed(17))
    plain = ImageServer(params, 32, 32, device=cuda, buckets=(4,))
    plain.submit(x)
    before = dict(K.conv_lb.launches_by_route)
    (want,) = plain.drain()
    untraced = _sm90_launched(before)
    tr = Tracer()
    srv = ImageServer(params, 32, 32, device=cuda, buckets=(4,), tracer=tr)
    with tr.activate():
        srv.submit(x)
        before = dict(K.conv_lb.launches_by_route)
        (got,) = srv.drain()
    assert _sm90_launched(before) == untraced
    assert sum(untraced.values()) == 13
    assert torch.equal(got.logits, want.logits)
    (ex,) = tr.find(name="serve.execute")
    (fwd,) = tr.find(name="graph.forward")
    assert fwd.parent == ex.sid
    kernels = tr.find(name="kernel.conv2d_lb")
    assert len(kernels) == 13
    dev = [k.attrs["device_us"] for k in kernels]
    assert all(d > 0 for d in dev)
    assert all(k.attrs["device_gbps"] > 0 for k in kernels)
    assert sum(dev) <= fwd.dur * 1e6


@pytest.mark.parametrize("dtype,route,tol", [
    (torch.float32, "sm90_tf32", 1e-4), (torch.bfloat16, "sm90", 2e-2)])
def test_reduced_lm_decode_runs_k4(cuda, dtype, route, tol):
    """A reduced phi3 (head dim 128, window 8) on the card: a 12-token
    prefill, then 4 decode steps across the 8-slot ring's wrap, each
    attention one K4 launch on the route of its type and nothing on any
    other, the logits within ``tol`` of max |plain| of the same calls
    with ``attn="plain"`` (f32: sums in other orders; bf16: activations
    rounded after attentions that round differently)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.api import build
    cfg = dataclasses.replace(
        reduced(get_config("phi3-medium-14b"), head_dim=128, window=8),
        compute_dtype=dtype)
    api = build(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(0),
                      cast_blocks=True)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    before = dict(K4.attention.launches_by_route)
    got, caches = api.prefill(params, {"tokens": toks[:, :12]}, max_seq=32)
    want, plain_caches = api.prefill(params, {"tokens": toks[:, :12]},
                                     max_seq=32, attn="plain")
    _close(got, want, tol)
    for pos in range(12, 16):
        got, caches = api.decode_step(params, caches, toks[:, pos:pos + 1],
                                      pos)
        want, plain_caches = api.decode_step(params, plain_caches,
                                             toks[:, pos:pos + 1], pos,
                                             attn="plain")
        _close(got, want, tol)
    torch.cuda.synchronize()
    launched = {r: K4.attention.launches_by_route[r] - before[r]
                for r in before}
    assert launched == dict.fromkeys(K4.ROUTES, 0) | {
        route: 5 * cfg.n_layers}
    assert caches[0]["sub0"]["pos"].tolist() == list(range(8, 16))


def test_mixtral_moe_layer_on_the_card_matches_the_cpu(cuda):
    """One mixtral-8x7b MoE FFN at full width (d_model 4096, d_ff 14336,
    8 experts, top-2, capacity factor 1.25), bf16, 64 tokens: the same
    PyTorch ops on the card and on the CPU choose the same experts and
    give outputs within 2e-2 of max |cpu| (the LM path's bf16 gate:
    bf16 products summed in other orders)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("mixtral-8x7b")
    gen = torch.Generator().manual_seed(0)
    p = M.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                   torch.bfloat16)
    x = torch.randn((64, cfg.d_model), generator=gen).to(torch.bfloat16)
    on_card = {n: t.to(cuda) for n, t in p.items()}
    _, idx = M.router_top_k(x, p["router"], cfg.top_k)
    _, idx_card = M.router_top_k(x.to(cuda), on_card["router"], cfg.top_k)
    assert torch.equal(idx_card.cpu(), idx)
    want = M.moe_ffn_dense(x, p, cfg.top_k, cfg.capacity_factor)
    got = M.moe_ffn_dense(x.to(cuda), on_card, cfg.top_k,
                          cfg.capacity_factor)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.cpu().float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item(), err


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_whisper_encoder_layer_and_cross_decode_on_the_card(cuda):
    """whisper-medium at full width (d_model 1024, 16 heads of 64, d_ff
    4096) in f32: one encoder layer over 1500 frames (K4 non-causal,
    1500 x 1500, ragged last query and key tiles) and one
    cross-attention decode of 4 rows against 1500 cross slots, each one
    K4 ``sm90_tf32`` launch, within 1e-4 of max |cpu| of the same
    weights and inputs on the CPU (K4's plain version)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models import encdec as E
    cfg = dataclasses.replace(get_config("whisper-medium"), enc_layers=1,
                              n_layers=1, compute_dtype=torch.float32)
    params = E.init_params(cfg, torch.Generator().manual_seed(0))
    card = _to(params, cuda)
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn((1, E.ENC_FRAMES, cfg.d_model), generator=gen) * .02
    before = dict(K4.attention.launches_by_route)
    got = E.encode(card, frames.to(cuda), cfg)
    _close(got.cpu(), E.encode(params, frames, cfg))
    nh, nkv = cfg.padded_heads(1)
    bp = params["dec_blocks"][0]["cross_attn"]
    h = torch.randn((4, 1, cfg.d_model), generator=gen)
    ck, cv = (torch.randn((4, E.ENC_FRAMES, nkv, cfg.head_dim),
                          generator=gen) for _ in range(2))
    cpos = torch.arange(E.ENC_FRAMES, dtype=torch.int32)
    want, _ = A.decode_block(bp, h, None, 7, cfg, nh, nkv,
                             cross_kv=(ck, cv, cpos))
    got, _ = A.decode_block(_to(bp, cuda), h.to(cuda), None, 7, cfg, nh, nkv,
                            cross_kv=(ck.to(cuda), cv.to(cuda), cpos))
    _close(got.cpu(), want)
    torch.cuda.synchronize()
    launched = {r: K4.attention.launches_by_route[r] - before[r]
                for r in before}
    assert launched == dict.fromkeys(K4.ROUTES, 0) | {"sm90_tf32": 2}


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.float32, 64, "sm90_tf32"), (torch.bfloat16, 128, "sm90")])
@pytest.mark.parametrize("window,causal", [(0, True), (24, True),
                                           (0, False)])
def test_attention_grads_on_the_card_match_the_cpu(cuda, dtype, hd, route,
                                                   window, causal):
    """``flash_attention`` under autograd on the card: one K4 launch on
    the route of its type, then the reference's VJP; dq, dk and dv
    against the same call on the CPU (K4's plain version forward, the
    same VJP): f32 within 1e-5 of max |cpu| (f32 sums in other orders,
    TF32 off), bf16 within the bf16 ``CARD_TOL`` (both round the f32
    gradients once)."""
    from repro_torch.launch.yardstick import within
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen).to(dtype) for s in (
        (2, 96, 8, hd), (2, 80 if not causal else 96, 2, hd),
        (2, 80 if not causal else 96, 2, hd)))
    do = torch.randn((2, 96, 8, hd), generator=gen).to(dtype)

    def grads(device):
        ins = [t.to(device).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*ins, window=window, causal=causal)
        return torch.autograd.grad(out, ins, do.to(device))
    before = dict(K4.attention.launches_by_route)
    card = grads(cuda)
    torch.cuda.synchronize()
    assert {r: K4.attention.launches_by_route[r] - before[r]
            for r in before} == dict.fromkeys(K4.ROUTES, 0) | {route: 1}
    for got, want in zip(card, grads("cpu")):
        assert got.dtype == dtype
        if dtype == torch.float32:
            _close(got.cpu(), want, 1e-5)
        else:
            gate = within(got.cpu(), want, dtype)
            assert gate["worst_over_tol"] <= 1.0, gate


@pytest.mark.parametrize("dtype,route", [(torch.float32, "sm90_tf32"),
                                         (torch.bfloat16, "sm90")])
def test_loss_backward_through_k4_reaches_every_wq(cuda, dtype, route):
    """A reduced minitron (head dim 128) on the card: after
    ``loss.backward()`` every block's wq, wk and wv has a non-zero
    ``.grad`` (K4's launch fills its output through ctypes, so without
    the autograd Function they would get none), each attention two K4
    launches (the forward and its remat recompute); in f32 the
    gradients within 1e-3 of each tensor's max |cpu| of the same loss on
    the CPU."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.api import build
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(
        reduced(get_config("minitron-4b"), head_dim=128),
        compute_dtype=dtype)
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    card = _to(params, cuda)
    for t in leaves(card):
        t.requires_grad_(True)
    before = dict(K4.attention.launches_by_route)
    loss = api.train_loss(card, _to(batch, cuda))
    loss.backward()
    torch.cuda.synchronize()
    assert {r: K4.attention.launches_by_route[r] - before[r]
            for r in before} == dict.fromkeys(K4.ROUTES, 0) | {
        route: 2 * cfg.n_layers}
    assert torch.isfinite(loss)
    for block in card["blocks"]:
        for name in ("wq", "wk", "wv"):
            grad = block["sub0"]["attn"][name].grad
            assert grad is not None and grad.abs().max() > 0, name
    if dtype == torch.float32:
        cpu_loss, cpu_g = value_and_grad(api, params, batch)
        assert abs(float(loss.detach()) - float(cpu_loss)) \
            <= 1e-4 * float(cpu_loss)
        for got, want in zip(leaves(card), leaves(cpu_g)):
            _close(got.grad.cpu(), want, 1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kv,hd,win,causal", ROUTED)
def test_attention_lse_on_every_route(cuda, b, sq, skv, h, kv, hd, win,
                                      causal, dtype):
    """``lse=True`` on every route that takes the case: ``out`` the same
    bits as without it, each row's log-sum-exp within the route's gate of
    the plain version's (``-inf`` exactly where a row keeps no key), and
    one ``lse`` launch counted for the route."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(s, generator=g).to(cuda, dtype)
               for s in ((b * h, sq, hd), (b * kv, skv, hd),
                         (b * kv, skv, hd)))
    _, want = attention_plain(q, k, v, groups=h // kv, window=win,
                              causal=causal, return_lse=True)
    routes = ["fma"]
    if dtype == torch.bfloat16 and K4.sm90_head_dim(hd) is not None:
        routes.append("sm90")
    if dtype == torch.float32 and K4.sm90_tf32_head_dim(hd) is not None:
        routes.append("sm90_tf32")
    for rt in routes:
        args = dict(groups=h // kv, window=win, causal=causal, via=rt)
        plain_out = K4.attention(q, k, v, **args)
        before = dict(K4.attention.lse_launches_by_route)
        out, lse = K4.attention(q, k, v, lse=True, **args)
        torch.cuda.synchronize()
        assert K4.attention.lse_launches_by_route == dict(
            before, **{rt: before[rt] + 1})
        assert torch.equal(out, plain_out)
        assert lse.dtype == torch.float32 and lse.shape == (b * h, sq)
        empty = torch.isneginf(want)
        assert torch.equal(torch.isneginf(lse), empty)
        _within(lse[~empty], want[~empty], dtype)


def test_mesh_trainer_on_a_one_rank_nccl_group(cuda, tmp_path):
    """``make_trainer(cfg, mesh)`` on a one-rank NCCL group's (1, 1)
    mesh: reduced minitron-4b in f32, 4 steps equal to the mesh-free
    trainer's bit for bit with K4 ``sm90_tf32`` in every attention; then
    ``run_resilient`` with a failure and ``on_restart`` onto a fresh
    mesh ends in the clean mesh-free run's state, bit for bit."""
    import datetime

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.synthetic import DataConfig, global_batch_at
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_step, make_trainer
    from repro_torch.parallel import collectives as col
    from repro_torch.runtime.elastic import plan_remesh
    from repro_torch.runtime.fault_tolerance import (ResilienceConfig,
                                                     run_resilient)
    cfg = reduced(get_config("minitron-4b"), n_layers=2)
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    kw = dict(global_batch=8, seq_len=32, peak_lr=3e-3, total_steps=8)

    def train(mesh):
        run, state, _api, _rules = make_trainer(cfg, mesh, device="cuda",
                                                **kw)
        out = []
        for i in range(4):
            state, m = run(state, global_batch_at(dc, i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, [t.clone() for t in tree.leaves(state.params)]

    def resilient(mesh, fail):
        run, state, _api, _rules = make_trainer(cfg, mesh, device="cuda",
                                                **kw)
        fired = []

        def hook(step):
            if fail and step == 5 and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        def on_restart(_n):
            plan = plan_remesh(1, 1, 8)
            return make_step(cfg, plan.build_mesh("cuda"), **kw)
        return run_resilient(
            state, run, lambda s: global_batch_at(dc, s), 8,
            ResilienceConfig(ckpt_dir=str(tmp_path / f"ckpt_{fail}"),
                             ckpt_every=4), failure_hook=hook,
            on_restart=on_restart if fail else None).final_state

    launches = dict(K4.attention.launches_by_route)
    free, free_params = train(None)
    clean = resilient(None, False)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh("cuda")
        col.reset()
        on_mesh, mesh_params = train(mesh)
        resumed = resilient(mesh, True)
        assert col.COUNTS == {}
    finally:
        dist.destroy_process_group()
    assert on_mesh == free
    assert all(torch.equal(a, b) for a, b in zip(mesh_params, free_params))
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(resumed),
                                                 tree.leaves(clean)))
    ran = {r: K4.attention.launches_by_route[r] - launches[r]
           for r in launches}
    assert ran["sm90_tf32"] > 0 and ran["fma"] == 0 and ran["sm90"] == 0


def test_sharded_mamba_mixer_at_16_shards_on_the_card(cuda):
    """mamba2-1.3b's mixer at full width in f32 as 16 shards run in turn
    (``ssm.run_shards``): a 512-token prefill and 2 decode steps, every
    output and the final caches within 1e-5 of max |whole|; the
    reference's contiguous split of the conv channels read as whole
    heads misses by over 100x."""
    from _torch_mesh_worker import contiguous_cut
    from repro_torch.configs import get_config
    from repro_torch.models import ssm as S
    cfg = get_config("mamba2-1.3b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = S.init_mamba(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                     cfg.ssm_expand, cfg.ssm_conv, torch.float32)
    p["A_log"] = torch.randn(cfg.ssm_heads, generator=gen,
                             device="cuda") * 0.5
    p["dt_bias"] = torch.randn(cfg.ssm_heads, generator=gen,
                               device="cuda") * 0.5
    x = torch.randn((1, 512, cfg.d_model), generator=gen, device="cuda")
    xs = [torch.randn((1, 1, cfg.d_model), generator=gen, device="cuda")
          for _ in range(2)]

    def run(mp=None, cut=S.heads_cut):
        if mp is None:
            y, (st, tail) = S.mamba_forward(p, x, cfg)
        else:
            y, (st, tail) = S.run_shards(p, x, cfg, mp, cut=cut)
        outs = [y]
        for xt in xs:
            if mp is None:
                y, (st, tail) = S.mamba_decode(p, xt, cfg, st, tail)
            else:
                y, (st, tail) = S.run_shards(p, xt, cfg, mp,
                                             caches=(st, tail), cut=cut)
            outs.append(y)
        return outs + [st, tail]

    with torch.no_grad():
        whole = run()
        for got, ref in zip(run(16), whole):
            err = (got - ref).abs().max().item()
            assert err <= 1e-5 * ref.abs().max().item(), err
        wrong = run(16, contiguous_cut)[0]
    assert (wrong - whole[0]).abs().max().item() \
        > 1e-3 * whole[0].abs().max().item()


def test_dryrun_one_rank_cell_counts_what_the_card_runs(cuda, tmp_path):
    """mamba2-1.3b at full width, a decode step at batch 4 against a
    64-slot context: on a one-rank ``"fake"`` (1, 1) mesh of ``meta``
    tensors, then on a one-rank NCCL (1, 1) mesh on the card with
    ``make_batch``'s inputs (``launch.dryrun.run_cell``): the same FLOPs
    counted, and the memory model's bytes equal to those allocated for
    the card's params and caches."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.analysis.memory_model import sharded_bytes_per_chip
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build
    from repro_torch.parallel import sharding as sh
    cfg = get_config("mamba2-1.3b")
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                global_batch=4)
    api = build(cfg, tp=1)
    with D.fake_world(1):
        mesh = D.Mesh((1, 1), ("data", "model"), "meta")
        rules = sh.axis_rules(mesh, shape.global_batch, shape.seq_len)
        meta, *_ = D.run_cell(api, shape, mesh, rules)
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh("cuda")
        rules = sh.axis_rules(mesh, shape.global_batch, shape.seq_len)
        with torch.no_grad():
            card, memo, params, caches = D.run_cell(
                api, shape, mesh, rules,
                key=torch.Generator(device="cuda").manual_seed(0))
        analytic = sum(sharded_bytes_per_chip(t, s, mesh)
                       for t, s in memo.values())
    finally:
        dist.destroy_process_group()
    allocated = sum(t.numel() * t.element_size()
                    for t in tree.leaves((params, caches))
                    if isinstance(t, torch.Tensor))
    assert card["flops"] == meta["flops"] > 0
    assert allocated == analytic
