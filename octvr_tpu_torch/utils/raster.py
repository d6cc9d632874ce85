"""Tiny CPU rasterization helpers (offline path only).

The reference leans on cv::fillPoly / cv::imdecode for mask preparation
(camera.cpp:146-187); we provide minimal NumPy equivalents so the offline
template compiler has zero OpenCV dependency.
"""

import numpy as np

__all__ = ["fill_poly", "fill_rect"]


def fill_rect(mask: np.ndarray, left: int, right: int, top: int, bottom: int, value: int):
    """Fill the rectangle spanned by [left,right) x [top,bottom) (the
    reference draws the polygon (l,t)-(l,b-1)-(r-1,b-1)-(r-1,t), which
    covers exactly that half-open box)."""
    h, w = mask.shape
    left = max(0, left)
    top = max(0, top)
    right = min(w, right)
    bottom = min(h, bottom)
    if right > left and bottom > top:
        mask[top:bottom, left:right] = value


def fill_poly(mask: np.ndarray, points, value: int):
    """Scanline polygon fill (even-odd rule), near-equivalent of
    cv::fillPoly for the simple polygons PTGui/Hugin masks produce.

    ``points``: sequence of (x, y) integer vertices.
    """
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) < 3:
        return
    h, w = mask.shape
    ymin = max(0, int(np.floor(pts[:, 1].min())))
    ymax = min(h - 1, int(np.ceil(pts[:, 1].max())))
    x0 = pts[:, 0]
    y0 = pts[:, 1]
    x1 = np.roll(x0, -1)
    y1 = np.roll(y0, -1)
    for y in range(ymin, ymax + 1):
        yc = y + 0.0
        # edges crossing this scanline (half-open rule avoids double count)
        cond = ((y0 <= yc) & (y1 > yc)) | ((y1 <= yc) & (y0 > yc))
        if not cond.any():
            continue
        xs = x0[cond] + (yc - y0[cond]) / (y1[cond] - y0[cond]) * (x1[cond] - x0[cond])
        xs = np.sort(xs)
        for i in range(0, len(xs) - 1, 2):
            a = int(np.ceil(xs[i]))
            b = int(np.floor(xs[i + 1]))
            a = max(a, 0)
            b = min(b, w - 1)
            if b >= a:
                mask[y, a : b + 1] = value
