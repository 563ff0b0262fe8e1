"""facegen_torch: the PyTorch + CUDA port of facegen for NVIDIA Hopper.

A second package beside ``facegen`` (the JAX reference, which it never
imports). Its module tree mirrors facegen's: ``nn``, ``ops``, ``models``,
``utils``, ``data`` and ``sample``. Activations are NHWC at every public
boundary, as in facegen, and checkpoints use facegen's on-disk format.
G's fused upsample + conv runs as a hand-written CUDA kernel on the GPU
(``ops/upsample_conv.py``, ``csrc/upsample_conv.cu``).
"""
