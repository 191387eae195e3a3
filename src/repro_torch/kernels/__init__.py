"""Hand-written Hopper kernels and their plain PyTorch versions.

``flash_attention`` — K1, CUDA C++ (``csrc/flash_attention.cu``).
``ssd``             — K2, CUDA C++ (``csrc/ssd.cu``).
``ref``             — the plain versions.
``ops``             — device dispatch between the two.
``_build``          — the nvcc build both kernels share.
"""
