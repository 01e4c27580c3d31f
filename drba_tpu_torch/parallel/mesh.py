"""The devices a multi-device run uses (counterpart of drba_tpu/parallel/mesh.py).

The JAX package shards a window batch over a one-axis mesh. Here each device
holds a replica of the model and runs one window of a group on a dispatch
thread and CUDA stream of its own (``parallel/batch.py``), in one process, so
no mesh is needed: a list of devices is the plan.
"""

from __future__ import annotations

import torch


def make_devices(n: int, device: str | torch.device = "cuda") -> list[torch.device]:
    """The first ``n`` devices of ``device``'s type: ``cuda:0 .. cuda:n-1``,
    or ``n`` CPU replicas. Raises when ``n`` exceeds the CUDA devices PyTorch
    sees, or when there is none."""
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"devices of type {kind!r} are not supported; use cuda or cpu")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > count:
        raise RuntimeError(f"{n} devices asked for, but PyTorch sees {count} CUDA device(s)")
    return [torch.device("cuda", i) for i in range(n)]
