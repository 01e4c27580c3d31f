"""Parameter conversion into the port's PyTorch layouts, and the ``.npz``
parameter cache (counterpart of drba_tpu/convert.py).

``load_network`` resolves a network's params as ``drba_tpu`` does:

  1. ``<name>.npz``: ``drba_tpu``'s cache, in its JAX layouts, as
     ``tools/convert_weights.py`` writes it, or ``save_npz`` and
     ``python -m drba_tpu_torch.convert_weights`` here (the same keys and
     arrays), read through ``from_jax_params``, so one weights directory
     serves both packages;
  2. ``<name>.pkl``: the reference state dict, which already holds PyTorch
     tensors (or numpy arrays) in the port's layouts, except ``nn.Linear``'s
     (O, I), which is transposed; ``module.`` prefixes are stripped and
     per-channel vectors (the ResConv ``beta``, stored (1, C, 1, 1))
     flattened; spec keys the file lacks take the seed-0 init, whatever the
     network's seed, as in ``drba_tpu``;
  3. the network's seeded random init (``init_from_spec``, drawn as
     ``drba_tpu`` draws it).

A ``.pkl`` is read as data (``torch.load(weights_only=True)``): besides
tensors, only numpy's array, scalar and dtype reconstruction is allowed,
under numpy 1's and numpy 2's module names alike; any other global is
refused, and the error names it.

The JAX layouts (``from_jax_params``; ``to_jax_params`` reverses them):

      kind      JAX layout          port layout
      conv      (kh, kw, I, O)      (O, I, kh, kw)
      convT     (kh, kw, I, O)      (I, O, kh, kw)   (un-flipped in both)
      linear    (I, O)              (I, O)           (as the JAX package stores it)
      scalar    ()                  (1,)             (a PReLU slope, as nn.PReLU holds it)
      others    as is               as is            (bias/beta (C,))

Keys outside the spec, such as the TPU-only ``*.lastconv.fold4.*``, are
dropped.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Mapping

import numpy as np
import torch

from drba_tpu_torch.models.layers import init_from_spec
from drba_tpu_torch.utils.log import get_logger

log = get_logger("drba_tpu_torch.convert")

_FROM_JAX = {"conv": (3, 2, 0, 1), "convT": (2, 3, 0, 1)}
_TO_JAX = {kind: tuple(int(i) for i in np.argsort(perm)) for kind, perm in _FROM_JAX.items()}


def from_jax_params(params: Mapping[str, np.ndarray], spec: Mapping[str, tuple]) -> dict:
    """JAX-layout arrays -> f32 CPU tensors in PyTorch layouts, for the keys of ``spec``."""
    out = {}
    for key, desc in spec.items():
        v = np.array(params[key], np.float32)  # a writable copy
        perm = _FROM_JAX.get(desc[0])
        if perm is not None:
            v = np.transpose(v, perm)
        elif desc[0] == "scalar":
            v = v.reshape(1)
        out[key] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def from_torch_state_dict(state: Mapping[str, object], spec: Mapping[str, tuple],
                          strict: bool = False) -> dict:
    """A reference state dict (tensors or ndarrays) -> port params; missing
    keys keep the seed-0 init, as ``drba_tpu`` fills them."""
    flat = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in state.items()}
    extra = sorted(set(flat) - set(spec))
    missing = sorted(set(spec) - set(flat))
    if strict and (missing or extra):
        raise ValueError(f"strict load failed: {len(missing)} missing spec keys "
                         f"(e.g. {missing[:3]}), {len(extra)} unexpected checkpoint keys "
                         f"(e.g. {extra[:3]})")
    params = from_jax_params(init_from_spec(spec), spec)
    for key, desc in spec.items():
        if key in flat:
            v = torch.as_tensor(flat[key]).detach().to("cpu", torch.float32)
            if desc[0] in ("bias", "ones", "zeros"):
                v = v.reshape(-1)
            elif desc[0] == "scalar":
                v = v.reshape(1)
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


def to_jax_params(params: Mapping[str, torch.Tensor], spec: Mapping[str, tuple]) -> dict:
    """Port params -> f32 numpy arrays in the JAX layouts (``from_jax_params``
    reversed), for the keys of ``spec``."""
    out = {}
    for key, desc in spec.items():
        v = params[key].detach().to("cpu", torch.float32).numpy()
        perm = _TO_JAX.get(desc[0])
        if perm is not None:
            v = np.transpose(v, perm)
        # np.ascontiguousarray would give a 0-d array a dimension
        out[key] = v.reshape(()).copy() if desc[0] == "scalar" else np.ascontiguousarray(v)
    return out


def to_torch_state_dict(params: Mapping[str, torch.Tensor],
                        spec: Mapping[str, tuple]) -> dict:
    """Port params -> a state dict in the reference's layouts
    (``from_torch_state_dict`` reversed: ``nn.Linear`` weights (O, I)), e.g.
    to write a stand-in ``.pkl``."""
    return {key: (params[key].t() if desc[0] == "linear" else params[key]).contiguous()
            for key, desc in spec.items()}


def _jax_shape(desc: tuple) -> tuple:
    kind = desc[0]
    if kind in ("conv", "convT", "linear"):
        return tuple(desc[1:])
    if kind == "scalar":
        return ()
    if kind == "bias":
        return (desc[1],)
    return tuple(np.atleast_1d(desc[1]))  # ones / zeros: (C,)


def save_npz(path: str, params: Mapping[str, torch.Tensor], spec: Mapping[str, tuple]) -> None:
    """Write ``params`` as ``drba_tpu``'s ``.npz`` cache (its JAX layouts)."""
    np.savez(path, **to_jax_params(params, spec))


def load_npz(path: str, spec: Mapping[str, tuple], strict: bool = False) -> dict:
    """Read a ``.npz`` cache in the JAX layouts into port params.

    Every spec key must be there at its JAX shape, else ``ValueError`` names
    the file and the key. Keys outside the spec are dropped with a warning
    (``strict`` raises on them).
    """
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    for key, desc in spec.items():
        if key not in arrays:
            raise ValueError(f"{path}: spec key {key!r} missing")
        if arrays[key].shape != _jax_shape(desc):
            raise ValueError(f"{path}: {key!r} has shape {arrays[key].shape}, the spec "
                             f"{_jax_shape(desc)}")
    extra = sorted(set(arrays) - set(spec))
    if strict and extra:
        raise ValueError(f"strict load failed: {path}: {len(extra)} unexpected keys "
                         f"(e.g. {extra[:3]})")
    if extra:
        log.warning("%d unexpected checkpoint keys ignored, e.g. %s", len(extra), extra[:3])
    return from_jax_params(arrays, spec)


def _numpy_globals() -> list:
    """What a state dict of numpy arrays names beside tensors: the array and
    scalar reconstructors under both numpy modules' names (numpy 1 pickles
    ``numpy.core.multiarray``, numpy 2 ``numpy._core.multiarray``), and the
    dtype classes its arrays are built with."""
    reconstruct = np.empty(0).__reduce__()[0]
    scalar = np.float32(0).__reduce__()[0]
    allowed = [np.ndarray, np.dtype, *{type(np.dtype(c)) for c in "?bhilqBHILQefd"}]
    for module in ("numpy.core.multiarray", "numpy._core.multiarray"):
        allowed += [(reconstruct, f"{module}._reconstruct"), (scalar, f"{module}.scalar")]
    return allowed


def load_pickle(path: str, spec: Mapping[str, tuple], strict: bool = False) -> dict:
    """Read a reference ``.pkl`` state dict (tensors or numpy arrays) into
    port params, as data: any global beyond numpy's arrays is refused."""
    with torch.serialization.safe_globals(_numpy_globals()):
        try:
            state = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            refused = (torch.serialization.get_unsafe_globals_in_checkpoint(path)
                       if zipfile.is_zipfile(path) else [])
            if not refused:  # a legacy file, or not a global: torch's error says what
                raise
            raise pickle.UnpicklingError(
                f"{path}: refused {sorted(refused)}: a weights .pkl is read as data and "
                f"may hold only tensors and numpy arrays") from e
    return from_torch_state_dict(state, spec, strict=strict)


def load_network(weights_dir: str | None, filename: str, spec: Mapping[str, tuple],
                 seed: int = 0, strict: bool = False) -> dict:
    """Resolve a network's params as ``drba_tpu`` does: ``<name>.npz`` in
    ``weights_dir``, else the reference ``<name>.pkl`` (missing keys at seed
    0), else the random init at ``seed``. ``strict`` fails when neither file
    is there."""
    if weights_dir is not None:
        pkl = os.path.join(weights_dir, filename)
        npz = os.path.splitext(pkl)[0] + ".npz"
        if os.path.exists(npz):
            return load_npz(npz, spec, strict=strict)
        if os.path.exists(pkl):
            return load_pickle(pkl, spec, strict=strict)
        if strict:
            raise FileNotFoundError(f"strict load: checkpoint {pkl} (or .npz cache) not found")
        log.warning("%s (or .npz cache) not found; using random init", pkl)
    elif strict:
        raise ValueError("strict load requires a weights directory")
    return from_jax_params(init_from_spec(spec, seed=seed), spec)
