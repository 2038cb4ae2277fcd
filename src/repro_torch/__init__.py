"""PyTorch + CUDA port of the ``repro`` model zoo, for NVIDIA Hopper.

Mirrors ``repro``'s module layout.  Plain tensor code is PyTorch; each
Pallas TPU kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built at first use by ``repro_torch.kernels._build``.
"""
