"""PyTorch/CUDA port of the paper-dataflow conv system.

``repro_torch`` serves and trains conv networks (VGG16, ResNet-20)
through hand-written Hopper conv and wgrad kernels and charges each
request the words of the paper's Eq. (15)-scored accounting plans; its
lower-bound matmul and blocked attention run on hand-written kernels
too, and it serves and trains the LMs (``launch/serve.py``,
``launch/train.py``) with every attention forward on the attention
kernel.  It stands beside the
JAX reference package ``repro`` and imports nothing of it: modules
mirror the reference's names, each keeping its own copy of what it
needs.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
