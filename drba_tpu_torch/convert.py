"""Parameter conversion into the port's PyTorch layouts.

Counterpart of drba_tpu/convert.py. Two sources:

  * ``from_jax_params``: a JAX param dict (numpy arrays, as
    ``drba_tpu`` builds them or ``init_from_spec`` here returns them):

      kind      JAX layout          port layout
      conv      (kh, kw, I, O)      (O, I, kh, kw)
      convT     (kh, kw, I, O)      (I, O, kh, kw)   (un-flipped in both)
      linear    (I, O)              (I, O)           (as the JAX package stores it)
      others    as is               as is            (bias/beta (C,), scalar ())

    Keys outside the spec, such as the TPU-only ``*.lastconv.fold4.*``, are
    dropped.
  * ``load_network``: the reference ``.pkl`` state dicts, which already hold
    PyTorch tensors in these layouts, except ``nn.Linear``'s (O, I), which is
    transposed; ``module.`` prefixes are stripped and per-channel vectors (the
    ResConv ``beta``, stored (1, C, 1, 1)) flattened.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from drba_tpu_torch.models.layers import init_from_spec
from drba_tpu_torch.utils.log import get_logger

log = get_logger("drba_tpu_torch.convert")

_FROM_JAX = {"conv": (3, 2, 0, 1), "convT": (2, 3, 0, 1)}


def from_jax_params(params: Mapping[str, np.ndarray], spec: Mapping[str, tuple]) -> dict:
    """JAX-layout arrays -> f32 CPU tensors in PyTorch layouts, for the keys of ``spec``."""
    out = {}
    for key, desc in spec.items():
        v = np.array(params[key], np.float32)  # a writable copy
        perm = _FROM_JAX.get(desc[0])
        if perm is not None:
            v = np.transpose(v, perm)
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def from_torch_state_dict(state: Mapping[str, object], spec: Mapping[str, tuple],
                          seed: int = 0, strict: bool = False) -> dict:
    """A reference state dict -> port params; missing keys keep the seeded init."""
    flat = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in state.items()}
    extra = sorted(set(flat) - set(spec))
    missing = sorted(set(spec) - set(flat))
    if strict and (missing or extra):
        raise ValueError(f"strict load failed: {len(missing)} missing spec keys "
                         f"(e.g. {missing[:3]}), {len(extra)} unexpected checkpoint keys "
                         f"(e.g. {extra[:3]})")
    params = from_jax_params(init_from_spec(spec, seed=seed), spec)
    for key, desc in spec.items():
        if key in flat:
            v = torch.as_tensor(flat[key]).detach().to("cpu", torch.float32)
            if desc[0] in ("bias", "ones", "zeros"):
                v = v.reshape(-1)
            elif desc[0] == "scalar":
                v = v.reshape(())
            elif desc[0] == "linear":
                v = v.t()
            if tuple(v.shape) != tuple(params[key].shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(v.shape)} != "
                                 f"{tuple(params[key].shape)}")
            params[key] = v.contiguous()
    if missing:
        log.warning("%d spec keys missing from checkpoint (random init kept), e.g. %s",
                    len(missing), missing[:3])
    if extra:
        log.warning("%d unexpected checkpoint keys ignored, e.g. %s", len(extra), extra[:3])
    return params


def load_network(weights_dir: str | None, filename: str, spec: Mapping[str, tuple],
                 seed: int = 0, strict: bool = False) -> dict:
    """Resolve a network's params: reference ``.pkl`` in ``weights_dir``, else
    the seeded random init. ``strict`` fails when the file is absent."""
    if weights_dir is not None:
        pkl = os.path.join(weights_dir, filename)
        if os.path.exists(pkl):
            state = torch.load(pkl, map_location="cpu", weights_only=True)
            return from_torch_state_dict(state, spec, seed=seed, strict=strict)
        if strict:
            raise FileNotFoundError(f"strict load: checkpoint {pkl} not found")
        log.warning("%s not found; using random init", pkl)
    elif strict:
        raise ValueError("strict load requires a weights directory")
    return from_jax_params(init_from_spec(spec, seed=seed), spec)
