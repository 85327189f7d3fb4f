"""FocalSV in PyTorch + CUDA: the port of ``focalsv_tpu`` to an NVIDIA GPU.

Paths mirror ``focalsv_tpu/``.  The package imports nothing of
``focalsv_tpu``: modules that never touch jax (I/O, the config tree, the
wire layouts, signatures, phasing, refinement, scanning, the complex-SV
callers, the evaluation tools, the native C++ helpers) are its own copies
with only the package name changed, and the modules on the device path are
forked here.  The region step and the pair-HMM are PyTorch tensor code; the
banded affine-gap DP and its traceback are hand-written CUDA kernels
(``csrc/banded_align.cu``, ``csrc/traceback.cu``).  This package imports
torch and never jax.
"""

__version__ = "0.1.0"

from focalsv_tpu_torch.config import (  # noqa: F401
    DataType,
    PipelineConfig,
    preset,
)
