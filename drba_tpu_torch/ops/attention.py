"""Window and flash attention (counterpart of drba_tpu/ops/attn_mxu.py).

Three entry points, each with its plain PyTorch version beside it:

  * ``window_attention(q, k, v, rid, with_mask)``: q/k/v (B, L, c), one
    window per batch entry, optional region ids (B, L);
  * ``window_attention_nhwc(q, k, v, k_splits, labels, with_mask)``: the swin
    windows of a (B, H, W, c) map, read in place; ``labels`` (k^2, wh, ww)
    region ids per window position (the caller rolls the map for the shifted
    layers);
  * ``flash_attention(q, k, v, rid, with_mask, out_dtype)``: any L with a
    narrow value (GMFlow's global correlation and flow propagation, value
    width 2); the (B, L, L) scores are never materialised by the kernel.

All compute ``softmax(q k^T / sqrt(c)) v`` with the scores and the softmax in
f32 and the value product in f32 (the einsum semantics of
drba_tpu/models/gmflow_net.py). A key is dead where its region id differs
from the query's; dead keys get weight exactly 0, as the JAX kernels' -1e9
gives. The einsum path and the original model add -100 instead, which leaves
each dead key a weight of at most e^-100 (about 4e-44) of the live ones:
below any tolerance used here.

On a CUDA tensor the wrappers launch the hand-written kernels of
``csrc/attention.cu`` (c = 128; bfloat16 on wgmma, float32 on the tensor
cores in 3xTF32, f32-accurate); on a CPU tensor they run the plain
version. ``backend`` is ``auto | torch | cuda`` as elsewhere.

Flash attention with few query tiles splits the keys over several blocks
(``flash_split_plan``), in f32 and bf16 alike, and combines their partial
softmax states in a second launch; ``flash_partials`` and ``flash_combine``
are those two launches in plain PyTorch.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from drba_tpu_torch._build import FLASH, WINDOW, check_cuda_input, dtype_code, stream_of, use_kernel

HEAD_DIM = 128  # the kernels' head width (GMFlow's feature channels)
TILE = 64  # the kernels' key tile (csrc/attention.cu kKT)
ROWS = 128  # query rows per block (kRowsWG; bf16: two warpgroups, f32: eight warps)
MAX_SPLITS = 8
LOG2E = 1.4426950408889634


# ------------------------------------------------------------------------------ plain versions


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     dead: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """q/k (N, L, c), v (N, L, cv), dead (N or 1, L, L) bool or None -> (N, L, cv)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (1.0 / math.sqrt(q.shape[-1]))
    if dead is not None:
        s = s.masked_fill(dead, -1e9)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(out_dtype)


def _rid_dead(rid: torch.Tensor) -> torch.Tensor:
    return rid[:, :, None] != rid[:, None, :]


def split_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*k*k, H/k, W/k, C), window-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`split_windows`."""
    bkk, hk, wk, c = x.shape
    x = x.reshape(bkk // (k * k), k, k, hk, wk, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(bkk // (k * k), k * hk, k * wk, c)


def _window_nhwc_plain(q, k, v, k_splits, labels, with_mask):
    b, h, w, c = q.shape
    kk = k_splits
    wh, ww = h // kk, w // kk
    s = split_windows(torch.cat([q, k, v], dim=0), kk).reshape(3, b * kk * kk, wh * ww, c)
    dead = None
    if with_mask:
        lab = device_labels(np.asarray(labels).reshape(kk * kk, wh * ww), q.device)
        dead = _rid_dead(lab).repeat(b, 1, 1)
    out = _attention_plain(s[0], s[1], s[2], dead, q.dtype)
    return merge_windows(out.reshape(b * kk * kk, wh, ww, c), kk)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_split_plan(b: int, L: int, sms: int) -> tuple[int, int]:
    """(key splits, key tiles per split) of the flash kernel.

    A block takes 128 queries. Where the ``b * cdiv(L, 128)`` query blocks
    are fewer than four per SM of the card, each one's keys are split over
    up to 8 blocks, every split holding at least one 64-key tile.
    """
    k_tiles = _cdiv(L, TILE)
    n = max(1, min(MAX_SPLITS, k_tiles, _cdiv(4 * sms, b * _cdiv(L, ROWS))))
    per = _cdiv(k_tiles, n)
    return _cdiv(k_tiles, per), per


def flash_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   dead: torch.Tensor | None, n_split: int, tiles: int) -> torch.Tensor:
    """The split flash kernel's first launch: for each key split z (key
    tiles [z * tiles, (z + 1) * tiles)) and query row, the online-softmax
    state (m, l, acc) over that split's live keys, in the log2 domain and
    f32. q/k (B, L, c), v (B, L, cv), dead (B or 1, L, L) bool or None ->
    (n_split, B, L, 2 + cv); m is -1e30 where a split has no live key."""
    L = q.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * (LOG2E / math.sqrt(q.shape[-1]))
    if dead is not None:
        s = s.masked_fill(dead, -math.inf)
    parts = []
    for z in range(n_split):
        keys = slice(z * tiles * TILE, min(L, (z + 1) * tiles * TILE))
        sz = s[:, :, keys]
        m = sz.amax(-1, keepdim=True).clamp_min(-1e30)
        p = torch.exp2(sz - m)  # dead keys: exp2(-inf) = 0
        parts.append(torch.cat([m, p.sum(-1, keepdim=True),
                                torch.matmul(p, v[:, keys].float())], dim=-1))
    return torch.stack(parts)


def flash_combine(part: torch.Tensor) -> torch.Tensor:
    """The split flash kernel's second launch: (n_split, B, L, 2 + cv)
    partials -> (B, L, cv) f32."""
    m = part[..., :1]
    w = torch.exp2(m - m.amax(0))
    return (part[..., 2:] * w).sum(0) / (part[..., 1:2] * w).sum(0)


# ------------------------------------------------------------------------------------ kernels


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device``; 1 for a CPU device, which
    reaches the kernel path only with its launch mocked (the input checks
    refuse CPU tensors)."""
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def _device_labels(data: bytes, shape: tuple, device: str) -> torch.Tensor:
    # a blocking host-to-device copy: PyTorch synchronises the uploading
    # stream before ``to`` returns, so the cached tensor has landed before any
    # thread's stream can read it (tests/test_torch_gpu.py checks this)
    return torch.from_numpy(np.frombuffer(data, np.int32).reshape(shape).copy()).to(device)


def device_labels(labels, device: torch.device) -> torch.Tensor:
    """Static numpy region ids as a cached int32 tensor on ``device``, safe
    to read on any stream of that device."""
    a = np.ascontiguousarray(np.asarray(labels, np.int32))
    return _device_labels(a.tobytes(), a.shape, str(device))


def _check_aligned(name: str, t: torch.Tensor, elems: int) -> None:
    """Raise unless ``t``'s data pointer and a stride of ``elems`` elements
    keep the kernels' 16-byte vector loads aligned."""
    if t.data_ptr() % 16 or (elems * t.element_size()) % 16:
        raise ValueError(f"{name}: the attention kernels need 16-byte aligned rows")


def launch_window(q, k, v, out, b, h, w, kk, strides, labels, lab_strides, half) -> None:
    """Launch the window-attention kernel on token maps addressed by strides.

    q/k/v/out: tensors (or views) whose tokens lie ``strides[i]`` elements
    apart with 128 contiguous channels each, laid out as ``b`` images of
    ``h`` x ``w`` tokens; attention runs within each of the ``kk`` x ``kk``
    windows of an image. Keys and values of image ``i`` come from image
    ``(i + half) % b``. ``labels``: int32 CUDA tensor or None, indexed
    ``window * lab_strides[0] + image * lab_strides[1] + token``.
    """
    for name, t, st in (("q", q, strides[0]), ("k", k, strides[1]), ("v", v, strides[2]),
                        ("out", out, strides[3])):
        _check_aligned(name, t, st)
    WINDOW.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if labels is None else labels.data_ptr(), b, h, w, kk, *strides,
                  *lab_strides, half, dtype_code(q), stream_of(q), device=q.device)


def _check_qkv(q, k, v, ndim, vdim=HEAD_DIM):
    check_cuda_input("q", q, ndim=ndim)
    check_cuda_input("k", k, dtypes=(q.dtype,), ndim=ndim)
    check_cuda_input("v", v, ndim=ndim)
    if q.shape[-1] != HEAD_DIM or k.shape != q.shape or v.shape[:-1] != q.shape[:-1] \
            or v.shape[-1] != vdim:
        raise ValueError(f"attention kernels take c={HEAD_DIM} and value width {vdim}; got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must lie on one device")


def _window_cuda(q, k, v, rid, with_mask):
    _check_qkv(q, k, v, 3)
    if v.dtype != q.dtype:
        raise TypeError(f"v dtype {v.dtype} != q dtype {q.dtype}")
    b, L, c = q.shape
    lab = None
    if with_mask:
        lab = rid.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(lab.shape) != (b, L):
            raise ValueError(f"rid {tuple(rid.shape)} does not match (B, L) = {(b, L)}")
    out = torch.empty_like(q)
    launch_window(q, k, v, out, b, 1, L, 1, (c, c, c, c), lab, (0, L), 0)
    return out


def _window_nhwc_cuda(q, k, v, k_splits, labels, with_mask):
    _check_qkv(q, k, v, 4)
    if v.dtype != q.dtype:
        raise TypeError(f"v dtype {v.dtype} != q dtype {q.dtype}")
    b, h, w, c = q.shape
    kk = k_splits
    wh, ww = h // kk, w // kk
    lab = None
    if with_mask:
        lab = device_labels(np.asarray(labels, np.int32).reshape(kk * kk, wh * ww), q.device)
    out = torch.empty_like(q)
    launch_window(q, k, v, out, b, h, w, kk, (c, c, c, c), lab, (wh * ww, 0), 0)
    return out


def _flash_cuda(q, k, v, rid, with_mask):
    v = v.float().contiguous()
    _check_qkv(q, k, v, 3, vdim=2)
    b, L, _ = q.shape
    lab = None
    if with_mask:
        lab = rid.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(lab.shape) != (b, L):
            raise ValueError(f"rid {tuple(rid.shape)} does not match (B, L) = {(b, L)}")
    for name, t in (("q", q), ("k", k)):
        _check_aligned(name, t, HEAD_DIM)
    if v.data_ptr() % 8:
        raise ValueError("v: the flash kernel needs an 8-byte aligned value")
    out = torch.empty((b, L, 2), dtype=torch.float32, device=q.device)
    n_split, _ = flash_split_plan(b, L, _sm_count(q.device))
    part = torch.empty((n_split, b, L, 4), dtype=torch.float32, device=q.device) \
        if n_split > 1 else None
    stream = stream_of(q)
    FLASH.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lab is None else lab.data_ptr(), b, L, dtype_code(q),
                 None if part is None else part.data_ptr(), n_split, stream,
                 device=q.device)
    if part is not None:
        FLASH.launch(part.data_ptr(), out.data_ptr(), b * L, n_split, stream,
                     device=q.device, entry="drba_flash_combine")
    return out


# -------------------------------------------------------------------------------- entry points


def _check_splits(k_splits, h, w):
    if h % k_splits or w % k_splits:
        raise ValueError(f"a {h}x{w} map does not split into {k_splits}x{k_splits} windows")


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rid: torch.Tensor | None = None, with_mask: bool = False,
                     backend: str = "auto") -> torch.Tensor:
    """``softmax(q k^T / sqrt(c) [masked by region id]) v`` per window.

    q, k, v: (B, L, c); ``rid`` (B, L) int region ids, used when
    ``with_mask``. Returns (B, L, c) in q's dtype.
    """
    if with_mask and rid is None:
        raise ValueError("with_mask needs rid")
    if use_kernel(backend, q):
        return _window_cuda(q.contiguous(), k.contiguous(), v.contiguous(), rid, with_mask)
    dead = _rid_dead(rid.to(q.device)) if with_mask else None
    return _attention_plain(q, k, v, dead, q.dtype)


def window_attention_nhwc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_splits: int,
                          labels=None, with_mask: bool = False,
                          backend: str = "auto") -> torch.Tensor:
    """Swin window attention straight off (B, H, W, c) maps.

    The map splits into ``k_splits`` x ``k_splits`` windows of
    (H/k, W/k) tokens. ``labels``: numpy (k^2, H/k, W/k) int region ids per
    window position, used when ``with_mask``. Returns (B, H, W, c).
    """
    _check_splits(k_splits, q.shape[1], q.shape[2])
    if with_mask and labels is None:
        raise ValueError("with_mask needs labels")
    if use_kernel(backend, q):
        return _window_nhwc_cuda(q.contiguous(), k.contiguous(), v.contiguous(), k_splits,
                                 labels, with_mask)
    return _window_nhwc_plain(q, k, v, k_splits, labels, with_mask)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    rid: torch.Tensor | None = None, with_mask: bool = False,
                    out_dtype: torch.dtype | None = None, backend: str = "auto") -> torch.Tensor:
    """``softmax(q k^T / sqrt(c) [masked by region id]) v`` for any L.

    q, k: (B, L, c); v: (B, L, cv), narrow (the kernel takes cv = 2, in f32);
    ``rid`` (B, L) as for :func:`window_attention`. Returns (B, L, cv) in
    ``out_dtype`` (default q's dtype).
    """
    if with_mask and rid is None:
        raise ValueError("with_mask needs rid")
    out_dtype = out_dtype or q.dtype
    if use_kernel(backend, q):
        return _flash_cuda(q.contiguous(), k.contiguous(), v, rid, with_mask).to(out_dtype)
    dead = _rid_dead(rid.to(q.device)) if with_mask else None
    return _attention_plain(q, k, v, dead, out_dtype)
