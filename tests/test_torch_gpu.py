"""The port's CUDA conv kernel on the card, held against its plain
PyTorch version on the same inputs (TF32 off on both sides).

Marked ``gpu``: on a host without a CUDA device these skip with a
reason.  Run them on the card with ``pytest -m gpu tests/test_torch_gpu.py``.
Tolerance: max |kernel - plain| <= 1e-4 * max |plain| (f32 sums in
another order).
"""

import pytest
import torch

from repro_torch.kernels.conv_lb import kernel as K
from repro_torch.kernels.conv_lb.ops import conv2d_lb
from repro_torch.kernels.conv_lb.ref import conv2d_ref
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


def _close(out, ref):
    assert out.shape == ref.shape
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err


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
