"""DRBA on PyTorch and CUDA: the port of ``drba_tpu`` to an NVIDIA H100.

Same module names and NHWC layouts as ``drba_tpu`` at every public function,
so each module can be held against its JAX counterpart. Plain tensor code is
PyTorch; the kernels of the RIFE and GMFSS paths (forward splat, backward
warp, 3x3 conv chain, window and flash attention, the transformer layer) are
CUDA C++ written for ``sm_90a`` under ``csrc/``, built at first use
(``_build.py``). This package never imports JAX.
"""

__version__ = "0.1.0"

from drba_tpu_torch.config import Config  # noqa: F401
