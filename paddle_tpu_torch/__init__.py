"""paddle_tpu_torch: the port of paddle_tpu to PyTorch and CUDA on an
NVIDIA H100.

It mirrors paddle_tpu's module layout and names, imports torch and numpy
and nothing of paddle_tpu or JAX, and keeps its own copies of what it
needs. Every Pallas kernel on a ported path becomes a kernel written by
hand for Hopper under ``csrc/``. Entry points run on ``cuda`` unless the
caller asks for the CPU.
"""

from paddle_tpu_torch import layers  # noqa: F401  (registers layer types)
