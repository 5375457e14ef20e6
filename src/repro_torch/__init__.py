"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Mirrors the reference layout (``configs``, ``kernels/<family>``,
``models``, ``serve``, ``launch``); every TPU kernel on a ported path is a
hand-written CUDA kernel under ``kernels/csrc`` with its plain torch version
beside it. The reference package stays the oracle: the port imports
nothing of it and no JAX.
"""
