"""The port's CUDA kernels on the card, held against their plain
PyTorch versions on the same inputs (TF32 off on both sides): the conv
kernel (also in its dgrad geometry), the wgrad kernel, and a ResNet-20
training step against the plain version's autograd.

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

from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb import wgrad as W
from repro_torch.kernels.conv_lb.ops import conv2d_lb
from repro_torch.kernels.conv_lb.ref import conv2d_ref, flip_w, wgrad_ref
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


def test_lhs_dilated_forward_backward_raises_on_the_card(cuda):
    x = torch.randn((2, 7, 7, 4), device=cuda, requires_grad=True)
    w = torch.randn((3, 3, 4, 6), device=cuda, requires_grad=True)
    out = conv2d_lb(x, w, padding=2, lhs_dilation=2)
    with pytest.raises(NotImplementedError, match="lhs-dilated"):
        out.sum().backward()


def test_profile_step_sees_the_ports_kernels(cuda):
    from repro_torch.launch.profile_step import profile_steps
    rep = profile_steps("resnet", image=32, batch=4, width_mult=0.25,
                        steps=1, warmup=1, lr=1e-3)
    own = {r["kernel"]: r for r in rep["own_kernels"]}
    assert own["K1 conv_lb"]["launches_per_step"] == 62
    assert own["K2 wgrad_lb"]["launches_per_step"] == 21
    assert 0.0 <= rep["device_idle_share"] < 1.0
