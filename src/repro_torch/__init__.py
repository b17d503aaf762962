"""repro_torch: the consistent distributed mesh-based GNN on PyTorch + CUDA.

A port of ``repro`` (JAX/Pallas) to PyTorch with hand-written Hopper CUDA
kernels (``repro_torch/csrc``).  The module layout mirrors ``repro`` so each
counterpart is found under the same name; ``repro`` stays the numerical
reference (``tests/test_torch_*.py`` run both packages on the same inputs).

Importing this package never imports ``jax`` or ``repro``.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; CUDA kernels are built
with ``nvcc`` at first use (``repro_torch.kernels.build``).
"""

__version__ = "0.1.0"
