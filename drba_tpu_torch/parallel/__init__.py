"""Window parallelism over several devices (counterpart of drba_tpu/parallel)."""

from drba_tpu_torch.parallel.mesh import make_devices

__all__ = ["make_devices"]
