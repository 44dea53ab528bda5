"""repro_torch: the CDMT container/artifact delivery stack on PyTorch, with
its CDC boundary scan in a hand-written CUDA kernel for Hopper (``sm_90a``).

The package keeps the JAX package's module layout (``core``, ``obs``,
``kernels``, ``delivery``) so each module's counterpart is found under the
same relative path.  It imports ``torch``, ``numpy`` and the standard
library only.  Entry points that chunk bytes take a ``device`` and default to
``"cuda"``; the CPU runs the kernels' plain PyTorch versions only when the
caller asks for ``device="cpu"``.
"""
__version__ = "0.1.0"
