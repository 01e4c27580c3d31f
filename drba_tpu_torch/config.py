"""Global configuration for the PyTorch/CUDA port (mirrors drba_tpu/config.py).

Each of ``splat_backend``, ``warp_backend``, ``conv_backend`` and
``attn_backend`` takes ``auto | torch | cuda``:

  * ``auto``  launches the hand-written CUDA kernel for a CUDA tensor and the
    plain PyTorch version for a CPU tensor;
  * ``torch`` always takes the plain PyTorch version (tests, and the
    kernel-vs-plain comparisons of ``chip_smoke.py``);
  * ``cuda``  always launches the kernel, and raises on a CPU tensor.

There is no fallback: on a CUDA tensor ``auto`` launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import torch

BACKENDS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class Config:
    """Framework-wide settings (defaults match drba_tpu.config.DEFAULT).

    Attributes:
      compute_dtype: dtype inside the networks; parameters are cast to it
        once when a model is built.
      flow_scale: optical-flow resolution scale (reference ``-scale``).
      splat_backend / warp_backend / conv_backend / attn_backend: see the
        module docstring (attn_backend selects GMFlow's attention kernels).
      drm_splat_scale: resolution scale of the DRM alignment splats
        (drm._splat_avg_scaled), for RIFE and GMFSS: 0.5 by default, 1.0 is
        exact.
      scdet_threshold: SSIM threshold for scene-change detection.
      seed: seed of the random parameters used when no checkpoint is given.
      strict_load: fail on missing/extra checkpoint keys or absent files.
    """

    compute_dtype: torch.dtype = torch.bfloat16
    flow_scale: float = 1.0
    splat_backend: str = "auto"
    warp_backend: str = "auto"
    conv_backend: str = "auto"
    attn_backend: str = "auto"
    drm_splat_scale: float = 0.5
    scdet_threshold: float = 0.3
    seed: int = 0
    strict_load: bool = False

    def __post_init__(self):
        for name in ("splat_backend", "warp_backend", "conv_backend", "attn_backend"):
            v = getattr(self, name)
            if v not in BACKENDS:
                raise ValueError(f"{name}={v!r}; valid: {', '.join(BACKENDS)}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


F32 = Config(compute_dtype=torch.float32)
DEFAULT = Config()


def full_f32_products() -> None:
    """Make PyTorch's float32 convolutions and matrix products run in full
    f32: cuDNN runs a float32 convolution in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
    decimal digits. The port's f32 (``--fp32``) is the arithmetic its parity
    tests hold against drba_tpu on the CPU, so the entry points set both
    flags False before they build a model (bf16 work is not affected). The
    hand-written kernels' f32 products are f32-accurate either way (3xTF32,
    csrc/tf32.cuh)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def model_device(device: str | torch.device) -> torch.device:
    """The device a model runs on. The models and the CLI default to CUDA;
    asking for CUDA where PyTorch sees none, or for a card index it does not
    see, raises instead of falling back to another device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (torch.cuda.is_available() is False); "
                           "pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if dev.type == "cuda" and dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} does not exist: PyTorch sees {torch.cuda.device_count()} "
                           "CUDA device(s)")
    return dev
