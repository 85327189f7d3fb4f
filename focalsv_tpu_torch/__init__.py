"""FocalSV in PyTorch + CUDA: the port of ``focalsv_tpu`` to an NVIDIA GPU.

Paths mirror ``focalsv_tpu/``.  Modules that never touch jax (I/O, the
config tree, the wire layouts, signatures, phasing, refinement, scanning,
the native C++ helpers) are imported from ``focalsv_tpu``, not copied; the
modules on the device path are forked here.  The region step is PyTorch
tensor code and the banded affine-gap DP is a hand-written CUDA kernel
(``csrc/banded_align.cu``).  This package imports torch and never jax.
"""

__version__ = "0.1.0"

from focalsv_tpu.config import (  # noqa: F401
    DataType,
    PipelineConfig,
    preset,
)
