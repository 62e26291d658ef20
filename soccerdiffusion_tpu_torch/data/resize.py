"""The INTER_AREA and INTER_CUBIC resizes of uint8 frames, in numpy (the JAX
package calls ``cv2.resize(..., interpolation=cv2.INTER_AREA)`` and, where
``ingest/`` upscales a camera frame, ``cv2.INTER_CUBIC``; the port does not
use cv2). INTER_AREA follows OpenCV's three paths, with their arithmetic:

  * integer factors (e.g. 448 -> 224): each output pixel is the sum of its
    block in integers, then ``(sum + 2) >> 2`` for 2 x 2 blocks and
    ``round(float32(sum) * float32(1 / n))`` for other n-pixel blocks;
  * other downscales: OpenCV's area tables (each output pixel covers the
    source interval [i s, (i + 1) s), a source pixel weighted by its overlap
    over s, in float32), applied along the width and then the height with
    the taps accumulated in OpenCV's order, rounded half to even;
  * upscales: OpenCV's area-upscale rule, a linear interpolation with the
    weight of the far pixel ``frac((i + 1) - (floor(i s) + 1) / s)`` in
    11-bit fixed point, its rows combined as OpenCV's vector path does.

On random frames this equals cv2 5.0 pixel for pixel, non-square frames
and upscales included (tests/test_torch_resize.py).

INTER_CUBIC follows OpenCV's own 8-bit path (``resize_cubic``): Keys' cubic
with A = -0.75, the coefficients in float32 at the source position
``(d + 0.5) * (1 / (dsize / ssize)) - 0.5`` and then in 11-bit fixed point
(``INTER_RESIZE_COEF_SCALE`` = 2048), border indices clamped; the horizontal
pass sums into integers, the vertical pass is OpenCV's vector path, in
float32 (no fused multiply-add) over the first multiple of 8 values of each
output row and in integers with rounding over the rest, both saturated.
It equals cv2 5.0 pixel for pixel where cv2 runs that path
(``cv2.ipp.setUseIPP(False)``); a cv2 built with Intel's IPP hands the
resize to IPP by default, whose float arithmetic lands ~4% of the pixels one
level away (tests/test_torch_resize.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=64)
def _area_taps(ssize: int, dsize: int) -> tuple[np.ndarray, np.ndarray]:
    """(index, weight) (dsize, taps) of OpenCV's computeResizeAreaTab; the
    unused taps of a row have weight 0 (read-only arrays: they are shared)."""
    scale = ssize / dsize
    rows = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s2 = min(math.floor(fs2), ssize - 1)
        s1 = min(math.ceil(fs1), s2)
        taps = []
        if s1 - fs1 > 1e-3:
            taps.append((s1 - 1, (s1 - fs1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            taps.append((s2, min(fs2 - s2, 1.0, cell) / cell))
        rows.append(taps)
    width = max(len(t) for t in rows)
    index = np.zeros((dsize, width), np.int64)
    weight = np.zeros((dsize, width), np.float32)
    for d, taps in enumerate(rows):
        for k, (s, a) in enumerate(taps):
            index[d, k], weight[d, k] = s, a
    index.setflags(write=False)
    weight.setflags(write=False)
    return index, weight


@functools.lru_cache(maxsize=64)
def _upscale_taps(ssize: int, dsize: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source index, near weight, far weight) (dsize,) of OpenCV's area
    upscale, the weights in 11-bit fixed point (read-only arrays)."""
    scale, inv = ssize / dsize, dsize / ssize
    index = np.empty(dsize, np.int64)
    frac = np.empty(dsize, np.float32)
    for d in range(dsize):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - math.floor(f))
        if s >= ssize - 1:
            f, s = np.float32(0.0), ssize - 1
        index[d], frac[d] = s, f
    near = np.rint((np.float32(1.0) - frac) * np.float32(2048)).astype(np.int64)
    far = np.rint(frac * np.float32(2048)).astype(np.int64)
    for a in (index, near, far):
        a.setflags(write=False)
    return index, near, far


def _downscale(img: np.ndarray, height: int, width: int) -> np.ndarray:
    xi, xw = _area_taps(img.shape[1], width)
    yi, yw = _area_taps(img.shape[0], height)
    src = img.astype(np.float32)
    rows = np.zeros((img.shape[0], width, img.shape[2]), np.float32)
    for t in range(xi.shape[1]):  # OpenCV's order: one tap at a time, from 0
        rows = rows + src[:, xi[:, t]] * xw[None, :, t, None]
    out = np.zeros((height, width, img.shape[2]), np.float32)
    for t in range(yi.shape[1]):
        out = out + rows[yi[:, t]] * yw[:, t, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _integer_downscale(img: np.ndarray, height: int, width: int) -> np.ndarray:
    fy, fx = img.shape[0] // height, img.shape[1] // width
    sums = img.reshape(height, fy, width, fx, img.shape[2]).astype(np.int64).sum(axis=(1, 3))
    if fy == fx == 2:
        return ((sums + 2) >> 2).astype(np.uint8)
    scaled = sums.astype(np.float32) * np.float32(1.0 / (fy * fx))
    return np.clip(np.rint(scaled), 0, 255).astype(np.uint8)


def _upscale(img: np.ndarray, height: int, width: int) -> np.ndarray:
    xi, xa0, xa1 = _upscale_taps(img.shape[1], width)
    yi, yb0, yb1 = _upscale_taps(img.shape[0], height)
    src = img.astype(np.int64)
    rows = (src[:, xi] * xa0[None, :, None]
            + src[:, np.minimum(xi + 1, img.shape[1] - 1)] * xa1[None, :, None])
    s0, s1 = rows[yi], rows[np.minimum(yi + 1, img.shape[0] - 1)]
    b0, b1 = yb0[:, None, None], yb1[:, None, None]
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (height, width, C), OpenCV's INTER_AREA."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_area takes uint8 (H, W, C) frames, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    if h >= height and w >= width:
        if h % height == 0 and w % width == 0:
            return _integer_downscale(img, height, width)
        return _downscale(img, height, width)
    return _upscale(img, height, width)


def _cubic_weights(x: np.float32) -> list[np.float32]:
    """OpenCV's interpolateCubic at the fraction ``x``, in float32."""
    a, one = np.float32(-0.75), np.float32(1.0)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) * (x + one) \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    c2 = ((a + np.float32(2)) * (one - x) - (a + np.float32(3))) * (one - x) * (one - x) + one
    return [c0, c1, c2, one - c0 - c1 - c2]


@functools.lru_cache(maxsize=64)
def _cubic_taps(ssize: int, dsize: int) -> tuple[np.ndarray, np.ndarray]:
    """(source index, 11-bit weight) (dsize, 4) of OpenCV's INTER_CUBIC, the
    indices clamped to the frame (read-only arrays)."""
    scale = 1.0 / (dsize / ssize)
    index = np.empty((dsize, 4), np.int64)
    weight = np.empty((dsize, 4), np.int64)
    for d in range(dsize):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        for k, c in enumerate(_cubic_weights(np.float32(f - np.float32(s)))):
            index[d, k] = min(max(s - 1 + k, 0), ssize - 1)
            weight[d, k] = int(np.rint(c * np.float32(2048)))
    index.setflags(write=False)
    weight.setflags(write=False)
    return index, weight


def resize_cubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (height, width, C), OpenCV's INTER_CUBIC."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_cubic takes uint8 (H, W, C) frames, got {img.dtype} {img.shape}")
    if img.shape[:2] == (height, width):
        return img
    xi, xw = _cubic_taps(img.shape[1], width)
    yi, yw = _cubic_taps(img.shape[0], height)
    src = img.astype(np.int64)
    rows = sum(src[:, xi[:, k]] * xw[None, :, k, None] for k in range(4))  # (H, width, C)
    taps = [rows[yi[:, k]] for k in range(4)]  # (height, width, C) each
    n = width * img.shape[2]
    vec = n - n % 8  # the vector path's share of each output row
    fixed = sum(t * yw[:, k, None, None] for k, t in enumerate(taps))
    out = ((fixed + (1 << 21)) >> 22).reshape(height, n)
    beta = [(yw[:, k].astype(np.float32) * np.float32(1.0 / (1 << 22)))[:, None] for k in range(4)]
    flat = [t.reshape(height, n)[:, :vec].astype(np.float32) for t in taps]
    acc = flat[3] * beta[3]  # OpenCV's order: ((s3 b3 + s2 b2) + s1 b1) + s0 b0
    for k in (2, 1, 0):
        acc = flat[k] * beta[k] + acc
    out[:, :vec] = np.rint(acc)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(height, width, img.shape[2])


@functools.lru_cache(maxsize=64)
def _linear_taps(ssize: int, dsize: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(source index, near weight, far weight) (dsize,) of OpenCV's
    INTER_LINEAR in 11-bit fixed point, the border taps held at the edge
    pixel (read-only arrays)."""
    scale = 1.0 / (dsize / ssize)
    index = np.empty(dsize, np.int64)
    frac = np.empty(dsize, np.float32)
    for d in range(dsize):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        f = np.float32(f - np.float32(s))
        if s < 0:
            f, s = np.float32(0.0), 0
        if s >= ssize - 1:
            f, s = np.float32(0.0), ssize - 1
        index[d], frac[d] = s, f
    near = np.rint((np.float32(1.0) - frac) * np.float32(2048)).astype(np.int64)
    far = np.rint(frac * np.float32(2048)).astype(np.int64)
    for a in (index, near, far):
        a.setflags(write=False)
    return index, near, far


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (height, width, C), OpenCV's INTER_LINEAR:
    11-bit weights, the rows combined as its vector path does (as
    ``_upscale``). Exact along one axis; in two, cv2 5.0 lands <= 0.3% of
    the pixels one level away (its tail of each row rounds otherwise)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_linear takes uint8 (H, W, C) frames, got {img.dtype} {img.shape}")
    if img.shape[:2] == (height, width):
        return img
    xi, xa0, xa1 = _linear_taps(img.shape[1], width)
    yi, yb0, yb1 = _linear_taps(img.shape[0], height)
    src = img.astype(np.int64)
    rows = (src[:, xi] * xa0[None, :, None]
            + src[:, np.minimum(xi + 1, img.shape[1] - 1)] * xa1[None, :, None])
    s0, s1 = rows[yi], rows[np.minimum(yi + 1, img.shape[0] - 1)]
    b0, b1 = yb0[:, None, None], yb1[:, None, None]
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
