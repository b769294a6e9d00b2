"""Separable resampling: resize and gaussian blur of (..., H, W) tensors.

Port of ``surround360_tpu/ops/resize.py`` (the reference's cv::resize and
cv::GaussianBlur uses, PixFlow.h:477-491). The 1-D interpolation matrices
are built on the host in float64 (the same constructions as the reference) and
applied as two float32 matrix products; long axes switch to the same
exact shortcuts as the reference (pairwise means, polyphase convolutions,
depthwise 1-D convolutions) so no O(n^2) matrix is formed there.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.math_util import disable_tf32

__all__ = [
    "resize_bilinear",
    "resize_cubic",
    "resize_area",
    "gaussian_blur",
    "pyramid_down",
    "resize_matrix_bilinear",
    "resize_matrix_cubic",
    "resize_matrix_area",
    "conv_separable_1d",
    "on_device",
    "device_constant",
    "pinning",
]


def _k01(s, a=-0.75):
    return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0


def _k12(s, a=-0.75):
    return ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a


@lru_cache(maxsize=256)
def resize_matrix_bilinear(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear sampling matrix, OpenCV pixel-center
    convention src = (dst + 0.5) * n_in/n_out - 0.5, clamped."""
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    src = np.clip(src, 0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    t = src - i0
    m = np.zeros((n_out, n_in), dtype=np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0), (1.0 - t).astype(np.float32))
    np.add.at(m, (rows, i1), t.astype(np.float32))
    return m


@lru_cache(maxsize=256)
def resize_matrix_cubic(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bicubic (a=-0.75, INTER_CUBIC) matrix, clamped borders."""
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    m = np.zeros((n_out, n_in), dtype=np.float64)
    rows = np.arange(n_out)
    weights = [_k12(t + 1.0), _k01(t), _k01(1.0 - t), _k12(2.0 - t)]
    for tap, w in enumerate(weights):
        j = np.clip(i0 - 1 + tap, 0, n_in - 1)
        np.add.at(m, (rows, j), w)
    return m.astype(np.float32)


@lru_cache(maxsize=256)
def resize_matrix_area(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) box-average (INTER_AREA) matrix."""
    scale = n_in / n_out
    m = np.zeros((n_out, n_in), dtype=np.float64)
    for o in range(n_out):
        lo = o * scale
        hi = (o + 1) * scale
        i_lo = int(np.floor(lo))
        i_hi = int(np.ceil(hi))
        for i in range(i_lo, min(i_hi, n_in)):
            cover = min(hi, i + 1) - max(lo, i)
            if cover > 0:
                m[o, i] = cover
        m[o] /= m[o].sum()
    return m.astype(np.float32)


@lru_cache(maxsize=256)
def _gaussian_band_matrix(
    n: int, sigma: float, boundary: str, ksize: int = 0
) -> np.ndarray:
    """(n, n) Toeplitz gaussian-blur matrix with reflect/wrap boundary;
    radius (ksize-1)/2, or ceil(3 sigma) when ksize=0."""
    radius = (ksize - 1) // 2 if ksize else max(1, int(np.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    m = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n)
    for off, w in zip(xs, k):
        j = idx + off
        if boundary == "wrap":
            j = np.mod(j, n)
        else:  # reflect (BORDER_REFLECT_101-like fold)
            j = np.abs(j)
            j = np.where(j >= n, 2 * (n - 1) - j, j)
        np.add.at(m, (idx, j), w)
    return m.astype(np.float32)


# Axis length from which banded operators run as 1-D convolutions and 2x
# resizes as polyphase filters instead of dense (n, n) matrix products
# (the same threshold as the reference, so both take the same route).
CONV_MIN_AXIS = 2500


@lru_cache(maxsize=128)
def _cached_on_device(make, device: torch.device, *args) -> torch.Tensor:
    return torch.from_numpy(make(*args)).to(device)


# device tensors that a CUDA graph reads: (make, device, args) -> tensor
_PINNED: dict = {}
_PINNING = threading.local()  # .on while pinning() is open on this thread


def on_device(make, device: torch.device, *args) -> torch.Tensor:
    """Device copy of a cached host matrix ``make(*args)``: the pinned copy
    where there is one, else the cache's (which keeps the 128 last used);
    pinned for the process when asked inside :func:`pinning`."""
    key = (make, device, args)
    t = _PINNED.get(key)
    if t is None:
        t = _cached_on_device(make, device, *args)
        if getattr(_PINNING, "on", False):
            _PINNED[key] = t
    return t


@contextmanager
def pinning():
    """While open, every tensor :func:`on_device` hands out on this thread
    is pinned: kept for the process and handed out again for the same
    arguments. A CUDA graph reads such tensors by address, so the cache
    must neither free them nor upload a second copy."""
    prev = getattr(_PINNING, "on", False)
    _PINNING.on = True
    try:
        yield
    finally:
        _PINNING.on = prev


def _float32(values) -> np.ndarray:
    return np.asarray(values, np.float32)


def device_constant(values: tuple, device: torch.device) -> torch.Tensor:
    """float32 ``values`` (a tuple of numbers or of tuples) on ``device``,
    uploaded once through :func:`on_device`: work captured into a CUDA
    graph may not copy from pageable host memory."""
    return on_device(_float32, device, values)


def conv_separable_1d(img: torch.Tensor, kernel_np, boundary: str, axis: int):
    """Depthwise 1-D cross-correlation of (..., H, W) along ``axis`` with an
    odd host kernel; boundary "reflect" (BORDER_REFLECT_101) or "wrap"."""
    k = device_constant(tuple(np.asarray(kernel_np, np.float32).tolist()), img.device)
    r = (k.numel() - 1) // 2
    moved = img.float().movedim(axis, -1)
    lead = moved.shape[:-1]
    n = moved.shape[-1]
    flat = moved.reshape(-1, 1, n)
    disable_tf32()
    if r > 0:
        flat = F.pad(flat, (r, r), mode="circular" if boundary == "wrap" else "reflect")
    out = F.conv1d(flat, k.view(1, 1, -1))
    return out.reshape(lead + (n,)).movedim(-1, axis)


def per_image(fn, img: torch.Tensor) -> torch.Tensor:
    """``fn`` of each image of ``img``'s leading dim, stacked (a 2-D image
    goes whole). A library picks a reduction's algorithm by its shape (how
    a sum splits across blocks), so a sum over a batch of 2 images would
    round apart from one over 14, and a frame's pixels would depend on how
    its camera pairs are batched (parallel/mesh.py splits the ring); one
    image at a time, each call has one shape."""
    if img.ndim < 3:
        return fn(img)
    return torch.stack([fn(x) for x in img.unbind(0)])


def matmul_batched(left, img: torch.Tensor, right) -> torch.Tensor:
    """``left @ x @ right`` for every (H, W) matrix x of ``img`` (``left``
    (O, H) or None, ``right`` (W, P) or None) as strided-batched products,
    one matrix a batch entry. A GEMM that folds the batch into its rows or
    columns takes its kernel (split-K or not) from the batch size, so a
    frame's pixels would depend on how its camera pairs are batched
    (parallel/mesh.py splits the ring); the batched products give the
    same bits for any batch count from 2 up (measured on the H100; one
    matrix alone goes to a plain GEMM, so it is paired with itself)."""
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = img.reshape(-1, H, W)
    n = x.shape[0]
    if n == 1:
        x = x.expand(2, H, W)
    if left is not None:
        x = torch.bmm(left.expand(x.shape[0], *left.shape), x)
    if right is not None:
        x = torch.bmm(x, right.expand(x.shape[0], *right.shape))
    return x[:n].reshape(lead + x.shape[-2:])


def _apply_separable_axis(img: torch.Tensor, mat: torch.Tensor, axis: int):
    """Apply one (n_out, n_in) matrix along ``axis`` (-2 rows / -1 cols)
    (:func:`matmul_batched`)."""
    if axis in (-2, img.ndim - 2):
        return matmul_batched(mat, img, None)
    return matmul_batched(None, img, mat.T)


def _halve_axis_area(img: torch.Tensor, axis: int):
    """Exact INTER_AREA 2:1 box downsample along one even axis."""
    moved = img.float().movedim(axis, -1)
    n = moved.shape[-1]
    pair = moved.reshape(moved.shape[:-1] + (n // 2, 2))
    return pair.mean(dim=-1).movedim(-1, axis)


def _double_axis_cubic(img: torch.Tensor, axis: int):
    """Exact INTER_CUBIC 2x upsample along one axis as two 4-tap polyphase
    convolutions + interleave (equals resize_matrix_cubic(n, 2n))."""

    def taps(t):
        return np.array(
            [_k12(t + 1.0), _k01(t), _k01(1.0 - t), _k12(2.0 - t)], np.float32
        )

    moved = img.float().movedim(axis, -1)
    lead = moved.shape[:-1]
    n = moved.shape[-1]
    padded = F.pad(moved.reshape(-1, 1, n), (2, 2), mode="replicate")
    disable_tf32()

    def phase(kernel, off):
        k = device_constant(tuple(kernel.tolist()), img.device).view(1, 1, -1)
        return F.conv1d(padded[..., 1 + off : 1 + off + n + 3], k)

    even = phase(taps(0.75), -1)  # i0 = j - 1, t = 0.75
    odd = phase(taps(0.25), 0)  # i0 = j,     t = 0.25
    inter = torch.stack([even, odd], dim=-1).reshape(-1, 1, 2 * n)
    return inter.reshape(lead + (2 * n,)).movedim(-1, axis)


def _double_axis_bilinear(img: torch.Tensor, axis: int):
    """Exact INTER_LINEAR 2x upsample along one axis (polyphase)."""
    moved = img.float().movedim(axis, -1)
    lead = moved.shape[:-1]
    n = moved.shape[-1]
    padded = F.pad(moved.reshape(-1, 1, n), (1, 1), mode="replicate")[:, 0]
    even = 0.25 * padded[:, :n] + 0.75 * padded[:, 1 : n + 1]
    odd = 0.75 * padded[:, 1 : n + 1] + 0.25 * padded[:, 2 : n + 2]
    inter = torch.stack([even, odd], dim=-1).reshape(-1, 2 * n)
    return inter.reshape(lead + (2 * n,)).movedim(-1, axis)


def resize_bilinear(img: torch.Tensor, shape) -> torch.Tensor:
    """Resize (..., H, W) -> (..., *shape) with bilinear sampling."""
    H, W = img.shape[-2:]
    out = img.float()
    if shape[0] == 2 * H and 2 * H >= CONV_MIN_AXIS:
        out = _double_axis_bilinear(out, -2)
    elif shape[0] != H:
        m = on_device(resize_matrix_bilinear, img.device, H, shape[0])
        out = _apply_separable_axis(out, m, -2)
    if shape[1] == 2 * W and 2 * W >= CONV_MIN_AXIS:
        out = _double_axis_bilinear(out, -1)
    elif shape[1] != W:
        m = on_device(resize_matrix_bilinear, img.device, W, shape[1])
        out = _apply_separable_axis(out, m, -1)
    return out


def resize_cubic(img: torch.Tensor, shape) -> torch.Tensor:
    """Resize (..., H, W) -> (..., *shape) with bicubic sampling
    (INTER_CUBIC), the reference's choice for flow-field rescales."""
    H, W = img.shape[-2:]
    out = img.float()
    if shape[0] == 2 * H and 2 * H >= CONV_MIN_AXIS:
        out = _double_axis_cubic(out, -2)
    elif shape[0] != H:
        m = on_device(resize_matrix_cubic, img.device, H, shape[0])
        out = _apply_separable_axis(out, m, -2)
    if shape[1] == 2 * W and 2 * W >= CONV_MIN_AXIS:
        out = _double_axis_cubic(out, -1)
    elif shape[1] != W:
        m = on_device(resize_matrix_cubic, img.device, W, shape[1])
        out = _apply_separable_axis(out, m, -1)
    return out


def resize_area(img: torch.Tensor, shape) -> torch.Tensor:
    """Resize (..., H, W) -> (..., *shape) with box averaging (INTER_AREA),
    the reference's choice for downscales."""
    H, W = img.shape[-2:]
    out = img.float()
    if H == 2 * shape[0] and H >= CONV_MIN_AXIS:
        out = _halve_axis_area(out, -2)
    elif shape[0] != H:
        m = on_device(resize_matrix_area, img.device, H, shape[0])
        out = _apply_separable_axis(out, m, -2)
    if W == 2 * shape[1] and W >= CONV_MIN_AXIS:
        out = _halve_axis_area(out, -1)
    elif shape[1] != W:
        m = on_device(resize_matrix_area, img.device, W, shape[1])
        out = _apply_separable_axis(out, m, -1)
    return out


def gaussian_blur(
    img: torch.Tensor, sigma: float, boundary: str = "reflect", ksize: int = 0
) -> torch.Tensor:
    """Separable gaussian blur of (..., H, W); ``ksize`` (odd) fixes the
    truncation width like cv::GaussianBlur's ksize argument."""
    img = img.float()
    if sigma <= 0:
        return img
    H, W = img.shape[-2:]
    if max(H, W) < CONV_MIN_AXIS:
        band = _gaussian_band_matrix
        rm = on_device(band, img.device, H, float(sigma), boundary, ksize)
        cm = on_device(band, img.device, W, float(sigma), boundary, ksize)
        return matmul_batched(rm, img, cm.T)
    radius = (ksize - 1) // 2 if ksize else max(1, int(np.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    k /= k.sum()
    out = conv_separable_1d(img, k, boundary, -2)
    return conv_separable_1d(out, k, boundary, -1)


def pyramid_down(img: torch.Tensor, factor: float = 0.5) -> torch.Tensor:
    """One pyramid level: area-downsample by ``factor``."""
    H, W = img.shape[-2:]
    return resize_area(img, (max(1, int(H * factor)), max(1, int(W * factor))))
