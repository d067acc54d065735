"""Hand-written CUDA kernels of the port: nvcc build and ctypes bindings.

Nothing here builds or loads at import time; a kernel's shared library is
compiled from ``lightgbm_tpu_torch/csrc`` on its first launch.  A kernel
that fails to build or launch raises a :class:`KernelError`."""

from .build import KernelBuildError, KernelError, KernelLaunchError

__all__ = ["KernelBuildError", "KernelError", "KernelLaunchError"]
