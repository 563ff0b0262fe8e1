"""facegen_torch: the PyTorch + CUDA port of facegen for NVIDIA Hopper.

A second package beside ``facegen`` (the JAX reference, which it never
imports). Its module tree mirrors facegen's: ``nn``, ``ops``, ``models``,
``train``, ``utils``, ``data``, ``sample``, ``train_c2f``,
``train_autoencoder`` and ``train_denoiser``. Activations
are NHWC at every public boundary, as in facegen, and checkpoints use facegen's
on-disk format. G's fused upsample + conv runs as hand-written CUDA
kernels on the GPU, forward and both gradients (``ops/upsample_conv.py``,
``csrc/upsample_conv.cu``, ``csrc/upsample_conv_bwd.cu``).
"""
