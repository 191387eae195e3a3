"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Imports torch and numpy only.  The layout follows ``repro`` module by
module (``configs``, ``models``, ``kernels``, ``serve``); ``bridge`` turns
a ``repro`` parameter tree, as numpy arrays, into this package's
parameters.  Entry points take ``device=`` and default to ``"cuda"``.
"""
