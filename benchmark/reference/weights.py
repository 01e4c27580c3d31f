"""Seeded weights for both sides, and the checkpoint tree the program loads.

The benchmark has no published checkpoint, so every configuration runs on
weights drawn from ``--seed``: uniform in +-gain/sqrt(fan-in) for conv,
transposed-conv and linear weights (the configuration's ``init_gain``),
+-0.05 for biases, 0.25 for PReLU slopes, ones and zeros for the ResConv
betas and the norms. All of a
model's random values come from one ``torch.rand`` call on the device.
:func:`write_tree` writes them as the reference checkpoints do, one
``.pkl`` state dict per net (``nn.Linear`` weights (out, in)) under the
model's ``train_log_*`` directory.
"""

from __future__ import annotations

import math
import os

import torch

_RANDOM = ("conv", "convT", "linear", "bias")


def _shape(desc: tuple) -> tuple:
    """The tensor shape of a spec entry in the reference's parameter layout."""
    kind = desc[0]
    if kind == "conv":
        kh, kw, cin, cout = desc[1:]
        return (cout, cin, kh, kw)
    if kind == "convT":
        kh, kw, cin, cout = desc[1:]
        return (cin, cout, kh, kw)
    if kind == "linear":
        return tuple(desc[1:])
    if kind == "scalar":
        return (1,)
    return (desc[1],)


def _bound(desc: tuple) -> float:
    kind = desc[0]
    if kind in ("conv", "convT"):
        kh, kw, cin, cout = desc[1:]
        return 1.0 / math.sqrt(kh * kw * (cin if kind == "conv" else cout))
    if kind == "linear":
        return 1.0 / math.sqrt(desc[1])
    return 0.05


def draw(specs: dict, seed: int, device, gain: float = 1.0) -> dict:
    """{net: {key: f32 tensor}} for {net: spec}, from ``seed`` on ``device``."""
    numel = sum(math.prod(_shape(d)) for spec in specs.values() for d in spec.values()
                if d[0] in _RANDOM)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(numel, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for net, spec in specs.items():
        params = {}
        for key, desc in spec.items():
            shape = _shape(desc)
            if desc[0] in _RANDOM:
                n = math.prod(shape)
                scale = _bound(desc) * (1.0 if desc[0] == "bias" else gain)
                params[key] = u[at:at + n].reshape(shape) * scale
                at += n
            elif desc[0] == "scalar":
                params[key] = torch.full(shape, 0.25, device=device)
            elif desc[0] == "ones":
                params[key] = torch.ones(shape, device=device)
            else:
                params[key] = torch.zeros(shape, device=device)
        out[net] = params
    return out


def write_tree(root: str, subdir: str, files: dict, specs: dict, params: dict) -> str:
    """Write ``params[net]`` as ``root/subdir/files[net]`` state dicts;
    returns the model's directory."""
    d = os.path.join(root, subdir)
    os.makedirs(d, exist_ok=True)
    for net, fname in files.items():
        state = {k: (v.t() if specs[net][k][0] == "linear" else v).detach().cpu().contiguous()
                 for k, v in params[net].items()}
        torch.save(state, os.path.join(d, fname))
    return d
