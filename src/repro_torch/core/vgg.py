"""VGG-16 workload (paper Sec. VI: VGGNet-16, batch size 3, as in
Eyeriss [10]).  The 13 conv layers; FC layers as R=1 matmul workloads.

The port's copy of ``repro/core/vgg.py``.
"""

from __future__ import annotations

from repro_torch.core.layer import ConvLayer, fc_layer

_CFG = [
    # name,      ci,  co,  hi,  wi
    ("conv1_1",   3,  64, 224, 224),
    ("conv1_2",  64,  64, 224, 224),
    ("conv2_1",  64, 128, 112, 112),
    ("conv2_2", 128, 128, 112, 112),
    ("conv3_1", 128, 256,  56,  56),
    ("conv3_2", 256, 256,  56,  56),
    ("conv3_3", 256, 256,  56,  56),
    ("conv4_1", 256, 512,  28,  28),
    ("conv4_2", 512, 512,  28,  28),
    ("conv4_3", 512, 512,  28,  28),
    ("conv5_1", 512, 512,  14,  14),
    ("conv5_2", 512, 512,  14,  14),
    ("conv5_3", 512, 512,  14,  14),
]


def vgg16_conv_layers(batch: int = 3) -> list[ConvLayer]:
    return [ConvLayer(name=n, batch=batch, ci=ci, co=co, hi=h, wi=w,
                      hk=3, wk=3, stride=1, pad=1)
            for n, ci, co, h, w in _CFG]


def vgg16_fc_layers(batch: int = 3) -> list[ConvLayer]:
    return [fc_layer(batch, 25088, 4096, "fc6"),
            fc_layer(batch, 4096, 4096, "fc7"),
            fc_layer(batch, 4096, 1000, "fc8")]


def vgg16_total_macs(batch: int = 3) -> int:
    return sum(l.macs for l in vgg16_conv_layers(batch))
