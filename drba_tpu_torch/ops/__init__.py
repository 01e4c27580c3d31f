"""Core image/tensor ops of the port, NHWC like drba_tpu.ops.

Flow tensors are (N, H, W, 2) with ``flow[..., 0]`` the horizontal and
``flow[..., 1]`` the vertical displacement in pixels.
"""

from drba_tpu_torch.ops.conv_chain import ChainStep, conv_chain
from drba_tpu_torch.ops.distance import flow_distance
from drba_tpu_torch.ops.resize import resize_bilinear, resize_to
from drba_tpu_torch.ops.shuffle import conv_transpose2d, pixel_shuffle
from drba_tpu_torch.ops.softsplat import softsplat, splat
from drba_tpu_torch.ops.warp import backwarp, backwarp2, warp_downsample

__all__ = [
    "ChainStep",
    "conv_chain",
    "flow_distance",
    "resize_bilinear",
    "resize_to",
    "conv_transpose2d",
    "pixel_shuffle",
    "softsplat",
    "splat",
    "backwarp",
    "backwarp2",
    "warp_downsample",
]
