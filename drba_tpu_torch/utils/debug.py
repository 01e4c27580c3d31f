"""Debug helper: burn text into a frame (counterpart of drba_tpu/utils/debug.py;
reference mark_tensor, tools.py:91-117), to stamp timesteps onto output
frames while debugging the frame loop (infer.py:145-147 keeps a commented
call). ``PIL`` is imported where it is used.
"""

from __future__ import annotations

import numpy as np
import torch


def mark_tensor(frame: torch.Tensor, text: str) -> torch.Tensor:
    """Burn ``text`` into the top-right corner of a (1, H, W, 3) frame in
    [0, 1]; returns a new frame of the same dtype on the same device."""
    from PIL import Image, ImageDraw, ImageFont

    arr = (frame[0].float() * 255.0).clamp(0, 255).to(torch.uint8).cpu().numpy()
    img = Image.fromarray(arr)
    draw = ImageDraw.Draw(img)
    try:
        font = ImageFont.truetype("arial.ttf", 24)
    except OSError:
        font = ImageFont.load_default()
    bbox = draw.textbbox((0, 0), text, font=font)
    x_pos = arr.shape[1] - (bbox[2] - bbox[0]) - 10
    draw.text((max(x_pos, 0), 10), text, font=font, fill=(255, 255, 255))
    out = torch.from_numpy(np.asarray(img, dtype=np.float32) / 255.0)
    return out[None].to(frame.device, frame.dtype)
