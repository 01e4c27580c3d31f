"""IFNet 4.26-heavy (RIFE's flow/fusion network), NHWC, in PyTorch.

Counterpart of drba_tpu/models/ifnet.py, following the path the JAX package
takes on the CPU (its exact path):

  * ``Head`` encoder: 3 convs + transposed conv, 16 channels;
  * 5 coarse-to-fine IFBlocks (c = 192/128/96/64/32): two stride-2 convs,
    8 ResConvs ``leaky(conv(x) * beta + x)`` run through ``conv_chain``
    (the hand-written kernel on CUDA, in every block, on weights packed once
    per model by ``pack_resconv_weights``), then the lastconv in its reference
    form, ConvTranspose2d(4, s2) + PixelShuffle(2);
  * per stage the images and encoder features of both directions are
    backward-warped in one call (``backwarp2``, one kernel launch); at an
    even integer pyramid scale k the warp is evaluated only at the k-fold
    downsample's tap grid, which equals warping at full resolution and then
    downsampling;
  * a sigmoid-mask merge of the two final warps.

Each block's input is written once, at the block's working resolution,
into a buffer of ``BLOCK_IN_PADDED`` channels (a multiple of 8, so cuDNN
copies nothing to pad it) by ``ops/block_input.assemble``, each operand
resized as it is written; at an even scale the warps write their channel
slots themselves (``backwarp2(..., out=)``). Bilinear resizing is per channel, so this
equals the reference's concatenate-then-resize. The layout of blocks 1-4
keeps each direction's warped frame and features together (``IN_ORDER``);
``pack_resconv_weights`` permutes and zero-pads ``conv0.0.0``'s input
channels to match (``.wp``). The frames and features are read where they
lie: a window's shared frame with a batch stride of 0, the B side chosen
per plane (``ops/planes.py``). On a CUDA device under the kernel backends
the warp and assembly kernels write every block's input; on the CPU the
plain versions do, into the same layout (counters ``ifnet.assembled`` and
``ifnet.concat``, ``utils/profiling.py``).

Each block's output is written once, at full resolution, by
``ops/block_output.block_output``: the lastconv's pixel shuffle read as an
index map, the bilinear resize, the flow times the block's scale and its sum
with the running flow in one pass, each step rounded as the eager ops round
(the kernel on a CUDA device, the plain expression on the CPU; counters
``ifnet.out_fused`` and ``ifnet.out_plain``).
"""

from __future__ import annotations

import torch

from drba_tpu_torch._build import use_kernel
from drba_tpu_torch.models.layers import Params, conv2d, conv_transpose2d, leaky_relu
from drba_tpu_torch.ops.block_input import assemble
from drba_tpu_torch.ops.block_output import block_output
from drba_tpu_torch.ops.conv_chain import ChainStep, conv_chain, pack_step_weights
from drba_tpu_torch.ops.planes import Operand, dense, first_channels
from drba_tpu_torch.ops.resize import resize_bilinear
from drba_tpu_torch.ops.warp import backwarp2
from drba_tpu_torch.utils import profiling

BLOCK_CHANNELS = (192, 128, 96, 64, 32)
BLOCK_IN = (7 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32, 8 + 4 + 8 + 32)
# the assembled inputs' channels: BLOCK_IN padded to a multiple of 8
BLOCK_IN_PADDED = tuple(-(-c // 8) * 8 for c in BLOCK_IN)
WARPED = 3 + 16  # one direction's warped frame and encoder features
# the assembled input's channel j of blocks 1-4 is the reference layout's
# channel IN_ORDER[j]: [frame0, feat0] [frame1, feat1] timestep mask feat flow
# (reference: frame0 frame1 feat0 feat1 timestep mask feat flow); block 0
# keeps the reference's order (frame0 frame1 feat0 feat1 timestep)
IN_ORDER = (*range(0, 3), *range(6, 22), *range(3, 6), *range(22, BLOCK_IN[1]))
LASTCONV_PADDED = 56  # the lastconv's 4 x 13 output channels, padded to a multiple of 8


def build_spec() -> dict:
    """Param spec with torch state-dict key names; the same keys, kinds and
    (JAX-layout) dims as drba_tpu.models.ifnet.IFNET_SPEC."""
    spec = {}
    spec["encode.cnn0.weight"] = ("conv", 3, 3, 3, 16)
    spec["encode.cnn0.bias"] = ("bias", 16)
    spec["encode.cnn1.weight"] = ("conv", 3, 3, 16, 16)
    spec["encode.cnn1.bias"] = ("bias", 16)
    spec["encode.cnn2.weight"] = ("conv", 3, 3, 16, 16)
    spec["encode.cnn2.bias"] = ("bias", 16)
    spec["encode.cnn3.weight"] = ("convT", 4, 4, 16, 16)
    spec["encode.cnn3.bias"] = ("bias", 16)
    for i, (cin, c) in enumerate(zip(BLOCK_IN, BLOCK_CHANNELS)):
        b = f"block{i}"
        spec[f"{b}.conv0.0.0.weight"] = ("conv", 3, 3, cin, c // 2)
        spec[f"{b}.conv0.0.0.bias"] = ("bias", c // 2)
        spec[f"{b}.conv0.1.0.weight"] = ("conv", 3, 3, c // 2, c)
        spec[f"{b}.conv0.1.0.bias"] = ("bias", c)
        for j in range(8):
            spec[f"{b}.convblock.{j}.conv.weight"] = ("conv", 3, 3, c, c)
            spec[f"{b}.convblock.{j}.conv.bias"] = ("bias", c)
            spec[f"{b}.convblock.{j}.beta"] = ("ones", (c,))
        spec[f"{b}.lastconv.0.weight"] = ("convT", 4, 4, c, 4 * 13)
        spec[f"{b}.lastconv.0.bias"] = ("bias", 4 * 13)
    return spec


IFNET_SPEC = build_spec()


def ifnet_encode(p: Params, img: torch.Tensor) -> torch.Tensor:
    """Head feature encoder (IFNet_HDv3.py:37-47)."""
    x = conv2d(p, "encode.cnn0", img, stride=2, padding=1)
    x = conv2d(p, "encode.cnn1", leaky_relu(x), stride=1, padding=1)
    x = conv2d(p, "encode.cnn2", leaky_relu(x), stride=1, padding=1)
    return conv_transpose2d(p, "encode.cnn3", leaky_relu(x), stride=2, padding=1)


def _in_order(idx: int) -> list[int]:
    """The reference layout's channel of each assembled channel of block ``idx``."""
    return list(IN_ORDER if idx else range(BLOCK_IN[0]))


def input_weight(w: torch.Tensor, idx: int) -> torch.Tensor:
    """Block ``idx``'s ``conv0.0.0`` weight (O, BLOCK_IN, 3, 3) for its
    assembled input: input channels in ``IN_ORDER`` (blocks 1-4), zeros for
    the pad channels, channels-last as cuDNN reads it."""
    wp = w.new_zeros((w.shape[0], BLOCK_IN_PADDED[idx]) + tuple(w.shape[2:]))
    wp[:, :BLOCK_IN[idx]] = w[:, _in_order(idx)]
    return wp.contiguous(memory_format=torch.channels_last)


def assembled_layout(x: torch.Tensor, idx: int) -> torch.Tensor:
    """``x`` (N, H, W, BLOCK_IN[idx]) in block ``idx``'s reference layout,
    in its assembled one: channels in ``IN_ORDER``, zeros to
    ``BLOCK_IN_PADDED[idx]``."""
    pad = x.new_zeros(tuple(x.shape[:3]) + (BLOCK_IN_PADDED[idx] - BLOCK_IN[idx],))
    return torch.cat([x[..., _in_order(idx)], pad], dim=-1)


def pack_resconv_weights(p: Params) -> Params:
    """``p`` plus every ResConv weight packed for the conv kernel of its
    dtype (ops/conv_chain.pack_step_weights: split for f32) under
    ``{b}.convblock.{j}.conv.wp``, each block's first conv weight for its
    assembled input (``input_weight``) under ``{b}.conv0.0.0.wp``, and its
    lastconv's weight and bias with LASTCONV_PADDED output channels, zeros
    past the reference's 52, under ``{b}.lastconv.0.wp`` and
    ``{b}.lastconv.0.bias.wp`` (cuDNN pads 52 to 56 itself, by a copy at
    every call): built once, where a model builds its parameters, from the
    weights in the compute dtype."""
    out = dict(p)
    for i in range(len(BLOCK_CHANNELS)):
        b = f"block{i}"
        out[f"{b}.conv0.0.0.wp"] = input_weight(p[f"{b}.conv0.0.0.weight"], i)
        w, bias = p[f"{b}.lastconv.0.weight"], p[f"{b}.lastconv.0.bias"]
        pad = LASTCONV_PADDED - w.shape[1]
        out[f"{b}.lastconv.0.wp"] = torch.cat([w, w.new_zeros((w.shape[0], pad) + w.shape[2:])], 1)
        out[f"{b}.lastconv.0.bias.wp"] = torch.cat([bias, bias.new_zeros(pad)])
        for j in range(8):
            name = f"block{i}.convblock.{j}.conv"
            out[f"{name}.wp"] = pack_step_weights(p[f"{name}.weight"])
    return out


def _resconv_steps(p: Params, b: str, dtype: torch.dtype) -> tuple[ChainStep, ...]:
    """The 8 ResConvs ``leaky(conv(x) * beta + x)`` of block ``b``
    (IFNet_HDv3.py:12-20,71) as ChainSteps in ``dtype``, on the weights
    ``pack_resconv_weights`` packed, as packed (the kernel refuses a layout
    packed for another dtype)."""
    return tuple(ChainStep(w=p[f"{b}.convblock.{j}.conv.weight"].to(dtype),
                           b=p[f"{b}.convblock.{j}.conv.bias"].to(dtype),
                           beta=p[f"{b}.convblock.{j}.beta"].to(dtype),
                           wp=p[f"{b}.convblock.{j}.conv.wp"])
                 for j in range(8))


def ifnet_block_at_scale(p: Params, idx: int, x: torch.Tensor, scale: float,
                         out_size: tuple[int, int], conv_backend: str = "auto",
                         flow: torch.Tensor | None = None, warp_backend: str = "auto"):
    """IFBlock ``idx`` on its assembled input ``x`` (``BLOCK_IN_PADDED[idx]``
    channels, read by ``conv0.0.0.wp``) at its working resolution; returns
    (flow, mask, feat) at ``out_size``: the block's flow times ``scale``,
    plus the running ``flow`` where given, written by the block-output
    kernel or its plain version (``warp_backend`` picks, as it does for the
    block inputs)."""
    b = f"block{idx}"
    feat = leaky_relu(conv2d(p, f"{b}.conv0.0.0", x, stride=2, padding=1, weight="wp"))
    feat = leaky_relu(conv2d(p, f"{b}.conv0.1.0", feat, stride=2, padding=1))
    feat = conv_chain(feat, _resconv_steps(p, b, feat.dtype), backend=conv_backend)
    tmp = conv_transpose2d(p, f"{b}.lastconv.0", feat, weight="wp", bias="bias.wp")
    kernel = use_kernel(warp_backend, tmp)
    _count(kernel, "ifnet.out_fused", "ifnet.out_plain")
    return block_output(tmp, scale, flow, out_size, "cuda" if kernel else "torch")


def ifnet_block(p: Params, idx: int, x: torch.Tensor, flow: torch.Tensor | None,
                scale: float, conv_backend: str = "auto"):
    """One IFBlock at pyramid scale ``scale`` (IFNet_HDv3.py:84-96) on ``x``
    at full resolution in the reference layout (``BLOCK_IN[idx]`` channels
    with ``flow``): ``x`` and the flow resized, concatenated, put in the
    assembled layout, then ``ifnet_block_at_scale``. Returns (flow
    (N,H,W,4), mask (N,H,W,1), feat (N,H,W,8))."""
    h, w = x.shape[1], x.shape[2]
    hs, ws = int(h / scale), int(w / scale)
    x = resize_bilinear(x, (hs, ws))
    if flow is not None:
        flow = resize_bilinear(flow, (hs, ws)) * (1.0 / scale)
        x = torch.cat([x, flow], dim=-1)
    return ifnet_block_at_scale(p, idx, assembled_layout(x, idx), scale, (h, w), conv_backend)


def _integer_scale(sc: float, h: int, w: int) -> int | None:
    if float(sc).is_integer() and sc >= 2 and h % int(sc) == 0 and w % int(sc) == 0:
        return int(sc)
    return None


def _count(kernel: bool, fused: str, plain: str) -> None:
    """One block input or output, written by the kernels (counter ``fused``)
    or by the plain versions (``plain``)."""
    tr = profiling.active()
    if tr is not None:
        tr.add(fused, int(kernel))
        tr.add(plain, int(not kernel))


def block0_input(img0: Operand, img1: Operand, f0: Operand, f1: Operand, timestep: Operand,
                 scale: float, backend: str = "auto") -> torch.Tensor:
    """Block 0's assembled input at pyramid scale ``scale``: the two frames'
    first 3 channels, both features and the timestep map, each resized to
    the block's resolution as it is written; zeros to BLOCK_IN_PADDED[0]."""
    n, h, w = f0.shape[:3]
    x = torch.empty((n, int(h / scale), int(w / scale), BLOCK_IN_PADDED[0]), dtype=f0.dtype,
                    device=f0.device)
    _count(use_kernel(backend, x), "ifnet.assembled", "ifnet.concat")
    return assemble(x, [(first_channels(img0, 3), 1.0), (first_channels(img1, 3), 1.0),
                        (f0, 1.0), (f1, 1.0), (timestep, 1.0)], backend)


def stage_input(a, b, flow, timestep, mask, feat, scale: float, backend: str) -> torch.Tensor:
    """Block 1-4's assembled input at pyramid scale ``scale``: each
    direction's warped frame and features (``a``, ``b``: operands side by
    side), then the timestep, mask and features, and the flow divided by
    ``scale``, each resized to the block's resolution as it is written.

    At an even integer scale k the warps are taken at the k-fold
    downsample's tap grid and written into their slots by the warp itself.
    Elsewhere (1 included) they are warped at full resolution into a buffer
    of their own and the assembly resizes and places them with the rest:
    written in place at full resolution, the warps would fill 38 of each
    pixel's 56 channels and leave 32-byte sectors part-written for the
    assembly to complete, which the card pays for in extra reads (stage 4's
    warps: 1.44 ms against 0.82 ms at 1088x1920, T = 3)."""
    n, h, w = flow.shape[:3]
    x = torch.empty((n, int(h / scale), int(w / scale), BLOCK_IN_PADDED[1]), dtype=flow.dtype,
                    device=flow.device)
    _count(use_kernel(backend, x), "ifnet.assembled", "ifnet.concat")
    rest = [(timestep, 1.0), (mask, 1.0), (feat, 1.0), (flow, 1.0 / scale)]
    k = _integer_scale(scale, h, w)
    if k is not None and k % 2 == 0:
        backwarp2(a, b, flow, k, backend=backend, out=x, offsets=(0, WARPED))
        return assemble(x, rest, backend, first=2 * WARPED)
    both = backwarp2(a, b, flow, backend=backend)
    return assemble(x, [(both[:n], 1.0), (both[n:], 1.0)] + rest, backend)


def ifnet_apply(p: Params, img0: Operand, img1: Operand, timestep: Operand,
                scale_list: tuple[float, ...], f0: Operand | None = None,
                f1: Operand | None = None, warp_backend: str = "auto",
                conv_backend: str = "auto"):
    """Full 5-stage inference (IFNet_HDv3.py:126-177).

    ``img0``, ``img1`` (N,H,W,C>=3), ``f0``, ``f1`` (N,H,W,16) and the
    timestep map (N,H,W,1, in any float dtype: converted to the features')
    are operands (ops/planes.py): tensors, also sharing one frame among the
    N planes with a batch stride of 0, or Picks choosing one of two frames
    per plane (then give the features). ``p`` holds the packed weights
    (``pack_resconv_weights``). ``warp_backend`` also picks who writes each
    block's input and output (the warp, assembly and block-output kernels,
    or their plain versions).
    Returns (merged_frame, flow_list).
    """
    if f0 is None:
        f0 = ifnet_encode(p, dense(img0)[..., :3])
    if f1 is None:
        f1 = ifnet_encode(p, dense(img1)[..., :3])
    h, w = f0.shape[1], f0.shape[2]
    a = (first_channels(img0, 3), f0)  # each direction's frame and features, side by side
    b = (first_channels(img1, 3), f1)
    x = block0_input(img0, img1, f0, f1, timestep, scale_list[0], warp_backend)
    flow, mask, feat = ifnet_block_at_scale(p, 0, x, scale_list[0], (h, w), conv_backend,
                                            warp_backend=warp_backend)
    flow_list = [flow]
    for i in range(1, 5):
        sc = scale_list[i]
        x = stage_input(a, b, flow, timestep, mask, feat, sc, warp_backend)
        flow, mask, feat = ifnet_block_at_scale(p, i, x, sc, (h, w), conv_backend, flow,
                                                warp_backend)
        flow_list.append(flow)

    n = flow.shape[0]
    both = backwarp2(img0, img1, flow, backend=warp_backend)
    warped0, warped1 = both[:n], both[n:]
    m = torch.sigmoid(mask.float()).to(warped0.dtype)
    return warped0 * m + warped1 * (1 - m), flow_list
