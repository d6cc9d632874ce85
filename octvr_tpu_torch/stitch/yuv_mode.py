"""YUV420-native pipeline helpers (octvr_tpu/stitch/yuv_mode.py).

Y is remapped at full resolution and U|V at half resolution through
half-resolution maps (the reference FastMapper's approach,
octvr/src/mapper_fast.cpp:27-109).  Gains scale Y and the centred chroma
(U-128, V-128) alike, which is exact because YUV is affine in RGB.  The
host helpers here build the chroma-grid geometry from the template's
full-resolution per-input arrays; ``yuv_rgb_norm`` is the per-frame
gain norm.
"""

import numpy as np
import torch

__all__ = ["half_maps", "half_mask", "half_roi", "yuv_rgb_norm"]


def yuv_rgb_norm(y, u, v):
    """Per-pixel RGB L2 norm (the reference's elementNorm,
    gpu_mat.cu:444-485) from pooled luma ``y`` and pooled centred chroma
    ``u``/``v``."""
    r = torch.clamp(y + 1.402 * v, 0.0, 255.0)
    g = torch.clamp(y - 0.344136 * u - 0.714136 * v, 0.0, 255.0)
    b = torch.clamp(y + 1.772 * u, 0.0, 255.0)
    return torch.sqrt(r * r + g * g + b * b)


def half_roi(roi):
    """Chroma-grid ROI covering a luma-grid ROI (canvas pixel (2i, 2j)
    family per chroma pixel (i, j))."""
    x, y, w, h = roi
    cx0, cy0 = x // 2, y // 2
    cx1 = -(-(x + w) // 2)
    cy1 = -(-(y + h) // 2)
    return (cx0, cy0, cx1 - cx0, cy1 - cy0)


def _quad_mean(arr, roi, valid_src=None):
    """Mean over each chroma pixel's <=4 in-ROI luma samples.  Returns
    (mean, count) on the half_roi grid; entries with count 0 are 0."""
    x, y, w, h = roi
    cx0, cy0, cw, ch = half_roi(roi)
    acc = np.zeros((ch, cw), dtype=np.float64)
    cnt = np.zeros((ch, cw), dtype=np.int32)
    rows_c = np.arange(cy0, cy0 + ch)
    cols_c = np.arange(cx0, cx0 + cw)
    for dy in (0, 1):
        for dx in (0, 1):
            rows = 2 * rows_c + dy - y
            cols = 2 * cols_c + dx - x
            rin = (rows >= 0) & (rows < h)
            cin = (cols >= 0) & (cols < w)
            rr = np.clip(rows, 0, h - 1)
            cc = np.clip(cols, 0, w - 1)
            sub = arr[np.ix_(rr, cc)]
            ok = rin[:, None] & cin[None, :]
            if valid_src is not None:
                ok = ok & valid_src[np.ix_(rr, cc)]
            acc += np.where(ok, sub, 0.0)
            cnt += ok
    mean = np.where(cnt > 0, acc / np.maximum(cnt, 1), 0.0)
    return mean, cnt


def half_maps(map1, map2, roi):
    """Half-resolution chroma maps for one input: each chroma pixel's
    source coordinate is the mean of its valid luma samples' normalized
    coordinates; -1 where no luma sample is valid.  Returns
    (hm1, hm2, chroma_roi)."""
    valid = map1 >= 0
    hm1, cnt = _quad_mean(map1.astype(np.float64), roi, valid_src=valid)
    hm2, _ = _quad_mean(map2.astype(np.float64), roi, valid_src=valid)
    ok = cnt > 0
    hm1 = np.where(ok, hm1, -1.0).astype(np.float32)
    hm2 = np.where(ok, hm2, -1.0).astype(np.float32)
    return hm1, hm2, half_roi(roi)


def half_mask(mask, roi):
    """Chroma-grid mask: mean of the 2x2 luma mask samples (float in
    [0, 255], kept for seam weights)."""
    mean, _ = _quad_mean(mask.astype(np.float64), roi)
    return mean.astype(np.float32)
