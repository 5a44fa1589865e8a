"""PyTorch/CUDA port of the paper-dataflow conv system.

``repro_torch`` serves conv networks (VGG16, ResNet-20) through a
hand-written Hopper conv kernel and charges each request the words of
the paper's Eq. (15)-scored accounting plans.  It stands beside the
JAX reference package ``repro`` and imports nothing of it: modules
mirror the reference's names, each keeping its own copy of what it
needs.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
