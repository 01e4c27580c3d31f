"""Layer primitives over flat param dicts, NHWC at every function.

Counterpart of drba_tpu/models/layers.py. Parameters keep PyTorch's layouts
(conv OIHW, transposed conv (in, out, kh, kw)); the NHWC activations reach
cuDNN as ``x.permute(0, 3, 1, 2)``, a channels_last view that costs no copy.
These convs are left to cuDNN as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from drba_tpu_torch.ops.shuffle import conv_transpose2d as _convT

Params = Mapping[str, torch.Tensor]


def conv2d(p: Params, name: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dilation: int = 1, weight: str = "weight") -> torch.Tensor:
    """``{name}.{weight}`` (OIHW) and ``{name}.bias`` of ``p`` on NHWC ``x``."""
    w = p[f"{name}.{weight}"].to(x.dtype)
    b = p.get(f"{name}.bias")
    y = F.conv2d(x.permute(0, 3, 1, 2), w, None if b is None else b.to(x.dtype),
                 stride=stride, padding=padding, dilation=dilation)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(p: Params, name: str, x: torch.Tensor, stride: int = 2,
                     padding: int = 1, weight: str = "weight",
                     bias: str = "bias") -> torch.Tensor:
    """``{name}.{weight}`` ((in, out, kh, kw)) and ``{name}.{bias}`` of ``p``
    on NHWC ``x``."""
    return _convT(x, p[f"{name}.{weight}"], p.get(f"{name}.{bias}"), stride=stride,
                  padding=padding)


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ W (+ b)`` with W stored (in, out), as in the JAX package: the
    product accumulates in f32 and is cast back to x's dtype, then the bias is
    added in that dtype."""
    out = torch.matmul(x.float(), p[f"{name}.weight"].to(x.dtype).float()).to(x.dtype)
    b = p.get(f"{name}.bias")
    return out if b is None else out + b.to(out.dtype)


def layer_norm(p: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel axis with f32 statistics, cast back."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p[f"{name}.weight"].float() + p[f"{name}.bias"].float()).to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.InstanceNorm2d`` default (no affine): per (N, C) over H, W in f32."""
    xf = x.float()
    mu = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mu).square().mean(dim=(1, 2), keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def prelu(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``nn.PReLU()`` with one shared slope."""
    a = p[f"{name}.weight"].to(x.dtype).reshape(())
    return torch.where(x >= 0, x, x * a)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, 0)


# sqrt(1/2) in each dtype, as jax.nn.gelu casts it before use
_SQRT_HALF = {dt: torch.tensor(math.sqrt(0.5), dtype=torch.float32).to(dt)
              for dt in (torch.float32, torch.bfloat16)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU ``0.5 * x * erfc(-x * sqrt(1/2))`` with jax.nn.gelu's
    rounding points: the argument and 0.5 * x in x's dtype, erfc in f32 and
    rounded to x's dtype, their product in x's dtype."""
    arg = -x * _SQRT_HALF[x.dtype]  # a CPU scalar: no copy to the card
    e = torch.special.erfc(arg.float()).to(x.dtype)
    return (0.5 * x) * e


def init_from_spec(spec: Mapping[str, tuple], seed: int = 0) -> dict:
    """Random params from a spec of {torch_key: (kind, *dims)}, as numpy arrays
    in the JAX package's layouts (conv/convT (kh, kw, cin, cout)).

    Draw for draw the same as drba_tpu.models.layers.init_from_spec, so one
    seed gives the same model in both packages; ``convert.from_jax_params``
    turns the result into PyTorch layouts.
    """
    rng = np.random.default_rng(seed)
    params = {}
    for key, desc in spec.items():
        kind = desc[0]
        if kind in ("conv", "convT"):
            kh, kw, cin, cout = desc[1:]
            fan_in = kh * kw * (cin if kind == "conv" else cout)
            bound = 1.0 / math.sqrt(max(fan_in, 1))
            params[key] = rng.uniform(-bound, bound, (kh, kw, cin, cout)).astype(np.float32)
        elif kind == "bias":
            (c,) = desc[1:]
            params[key] = rng.uniform(-0.05, 0.05, (c,)).astype(np.float32)
        elif kind == "linear":
            cin, cout = desc[1:]
            bound = 1.0 / math.sqrt(cin)
            params[key] = rng.uniform(-bound, bound, (cin, cout)).astype(np.float32)
        elif kind == "scalar":
            params[key] = np.float32(desc[1] if len(desc) > 1 else 0.25)
        elif kind == "ones":
            params[key] = np.ones(desc[1], np.float32)
        elif kind == "zeros":
            params[key] = np.zeros(desc[1], np.float32)
        else:
            raise ValueError(f"unknown kind {kind} for {key}")
    return params
