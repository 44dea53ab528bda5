"""Kernels of the hot spots, hand-written for Hopper.

``gear_cdc`` — CDC boundary scan (the paper's hashing hot loop, Fig. 10),
a CUDA kernel in ``csrc/gear_cdc.cu``.

``ops`` holds the public wrappers; ``ref`` the plain PyTorch versions;
``build`` compiles ``csrc/`` with ``nvcc`` at first use.
"""

from . import ops, ref
