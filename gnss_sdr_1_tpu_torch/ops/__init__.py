"""Hand-written GPU kernels with their plain torch versions.

Each kernel module holds the plain function (`*_plain`), the wrapper that
launches the kernel for CUDA tensors (and calls the plain function only for
CPU tensors), and a launch counter.  Sources live in `../csrc`; `_build`
compiles them with nvcc at first use.
"""

from .multicorrelator import multicorrelate, multicorrelate_batch

__all__ = ["multicorrelate", "multicorrelate_batch"]
