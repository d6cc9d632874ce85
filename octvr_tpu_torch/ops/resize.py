"""cv::resize INTER_LINEAR and INTER_NEAREST (octvr_tpu/ops/resize.py),
on the host and on torch planes.

``resize_bilinear_host`` is the host version, numpy in and out, for the
offline stage (vignette maps, seam masks): the original's numpy path,
bit for bit.  On the device the sample indices and weights depend only
on the two sizes, so the host computes them once in numpy with the same
f32 arithmetic (``resize_plan``); per frame the device gathers four taps
and lerps (``resize_apply``).  ``resize_bilinear``, ``resize_nearest``
and ``resize_area`` keep the original's names and signatures on numpy
arrays (``xp`` is numpy, the only array module of the port's host code).
"""

from dataclasses import dataclass

import numpy as np

__all__ = [
    "ResizePlan",
    "resize_apply",
    "resize_area",
    "resize_bilinear",
    "resize_bilinear_host",
    "resize_nearest",
    "resize_plan",
]


@dataclass(frozen=True)
class ResizePlan:
    """Taps and weights of one (input size, output size) pair: rows
    y0/y1 with weight wy (and 1 - wy), columns x0/x1 with wx."""

    y0: np.ndarray  # int64 [out_h]
    y1: np.ndarray
    x0: np.ndarray  # int64 [out_w]
    x1: np.ndarray
    wy: np.ndarray  # f32 [out_h, 1]
    wy1: np.ndarray  # f32 [out_h, 1], 1 - wy
    wx: np.ndarray  # f32 [out_w]
    wx1: np.ndarray  # f32 [out_w], 1 - wx
    in_shape: tuple
    out_shape: tuple


def _axis(dst, src):
    """INTER_LINEAR taps along one axis: sx = (dx + 0.5) * scale - 0.5."""
    f = (np.arange(dst, dtype=np.float32) + 0.5) * (src / dst) - 0.5
    i0 = np.clip(np.floor(f), 0, src - 1).astype(np.int32)
    i1 = np.clip(i0 + 1, 0, src - 1)
    w = np.clip(f - i0.astype(np.float32), 0.0, 1.0)
    return i0.astype(np.int64), i1.astype(np.int64), w, (1 - w).astype(np.float32)


def resize_bilinear_host(img, out_h, out_w):
    """numpy [H, W] or [H, W, C] -> [out_h, out_w(, C)] with the same taps
    and f32 lerp as the device path; integer images are rounded and
    clipped (the numpy path of octvr_tpu.ops.resize.resize_bilinear,
    term for term)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    y0, y1, wy, wy1 = _axis(out_h, h)
    x0, x1, wx, wx1 = _axis(out_w, w)
    c = (None,) * (img.ndim - 2)  # broadcast over a trailing channel axis
    wx, wx1 = wx[(slice(None),) + c], wx1[(slice(None),) + c]
    wy, wy1 = wy[(slice(None), None) + c], wy1[(slice(None), None) + c]
    work = img.astype(np.float32)
    top = work[y0][:, x0] * wx1 + work[y0][:, x1] * wx
    bot = work[y1][:, x0] * wx1 + work[y1][:, x1] * wx
    out = top * wy1 + bot * wy
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255).astype(img.dtype)
    return out


def resize_plan(h, w, out_h, out_w) -> ResizePlan:
    y0, y1, wy, wy1 = _axis(out_h, h)
    x0, x1, wx, wx1 = _axis(out_w, w)
    return ResizePlan(
        y0=y0, y1=y1, x0=x0, x1=x1,
        wy=wy[:, None], wy1=wy1[:, None], wx=wx, wx1=wx1,
        in_shape=(h, w), out_shape=(out_h, out_w),
    )


def resize_apply(img, plan: ResizePlan):
    """img: f32 [..., H, W] -> [..., out_h, out_w]; ``plan`` is a device
    plan (utils/device.tree_to).  The JAX package's lerp, term for term:
    columns within each of the two rows, then rows."""
    if tuple(plan.in_shape) == tuple(plan.out_shape):
        return img
    r0 = img.index_select(-2, plan.y0)
    r1 = img.index_select(-2, plan.y1)
    top = r0.index_select(-1, plan.x0) * plan.wx1 + r0.index_select(-1, plan.x1) * plan.wx
    bot = r1.index_select(-1, plan.x0) * plan.wx1 + r1.index_select(-1, plan.x1) * plan.wx
    return top * plan.wy1 + bot * plan.wy


def resize_bilinear(img, out_h, out_w, xp=np):
    """The original's name for ``resize_bilinear_host``."""
    return resize_bilinear_host(img, out_h, out_w)


def resize_nearest(img, out_h, out_w, xp=np):
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    # INTER_NEAREST mapping: sx = floor(dx * scale)
    ys = xp.clip(
        xp.floor(xp.arange(out_h, dtype=np.float32) * (h / out_h)), 0, h - 1
    ).astype(np.int32)
    xs = xp.clip(
        xp.floor(xp.arange(out_w, dtype=np.float32) * (w / out_w)), 0, w - 1
    ).astype(np.int32)
    return img[ys][:, xs]


def resize_area(img, out_h, out_w, xp=np):
    """Integer-factor box downsample (used for working-scale thumbnails when
    exact cv parity is not required)."""
    h, w = img.shape[:2]
    if h % out_h == 0 and w % out_w == 0:
        fh, fw = h // out_h, w // out_w
        shape = (out_h, fh, out_w, fw) + img.shape[2:]
        return img.reshape(shape).mean(axis=(1, 3))
    return resize_bilinear(img, out_h, out_w, xp=xp)
