"""Fixed-geometry blenders, feather and multiband (Laplacian)
(octvr_tpu/stitch/blenders.py).

Masks, ROIs, feather weights and weight pyramids are fixed at plan time
on the host (the
reference's "GPUStaticBlender" idea, stitching/src/blenders.cpp:479-736);
the per-frame work is dense torch math.  The host plan is always f32;
``compute_dtype="bfloat16"`` makes its float fields bf16 when the plan
moves to the device (utils/device.tree_to), rounding to nearest-even as
the JAX package's ``ml_dtypes`` cast does.
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
from scipy.ndimage import correlate1d, distance_transform_edt

from ..ops.pyramid import down_matrix, pyr_down_mm, pyr_up_mm, up_matrix
from ..utils.device import tree_to

_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0

WEIGHT_EPS = 1e-5

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

__all__ = [
    "FeatherPlan",
    "MultiBandPlan",
    "build_feather_plan",
    "build_multiband_plan",
    "feather_blend",
    "multiband_blend",
]


def np_pyr_down(x):
    """NumPy 5-tap reflect-101 pyramid step for [H, W] arrays (plan time)."""
    y = correlate1d(x, _K5, axis=0, mode="mirror")
    y = correlate1d(y, _K5, axis=1, mode="mirror")
    return y[::2, ::2]


def _union_roi(rois):
    x0 = min(r[0] for r in rois)
    y0 = min(r[1] for r in rois)
    x1 = max(r[0] + r[2] for r in rois)
    y1 = max(r[1] + r[3] for r in rois)
    return (x0, y0, x1 - x0, y1 - y0)


@dataclass
class FeatherPlan:
    rois: List[tuple]
    result_roi: tuple
    weights: list  # f32 [rh, rw] per image, already normalized

    def to(self, device):
        return tree_to(self, device)


def build_feather_plan(masks, rois, border: int) -> FeatherPlan:
    """weights = max(EDT(mask) - border, 0), normalized by the canvas total
    including WEIGHT_EPS (blenders.cpp:531-594)."""
    result_roi = _union_roi(rois)
    rx, ry, rw, rh = result_roi
    dst_w = np.full((rh, rw), WEIGHT_EPS, dtype=np.float32)
    raw = []
    for m, roi in zip(masks, rois):
        w = distance_transform_edt(m > 0).astype(np.float32) - border
        np.maximum(w, 0.0, out=w)
        raw.append(w)
        ox, oy = roi[0] - rx, roi[1] - ry
        dst_w[oy : oy + roi[3], ox : ox + roi[2]] += w
    weights = []
    for w, roi in zip(raw, rois):
        ox, oy = roi[0] - rx, roi[1] - ry
        weights.append(w / dst_w[oy : oy + roi[3], ox : ox + roi[2]])
    return FeatherPlan(rois=list(rois), result_roi=result_roi, weights=weights)


def feather_blend(plan: FeatherPlan, imgs, canvas_size):
    """imgs: [C, rh, rw] warped images.  Returns the weighted sum on a
    [C, H, W] canvas of the images' dtype."""
    w, h = canvas_size
    canvas = torch.zeros(
        (imgs[0].shape[0], h, w), dtype=imgs[0].dtype, device=imgs[0].device
    )
    for img, wmap, (x, y, rw, rh) in zip(imgs, plan.weights, plan.rois):
        canvas[:, y : y + rh, x : x + rw] += img * wmap[None]
    return canvas


@dataclass
class MultiBandPlan:
    num_bands: int
    rois: List[tuple]
    align_rois: List[tuple]  # per-image padded rois, 2^bands aligned
    align_result_roi: tuple
    weight_pyrs: list  # per image, per level [h_l, w_l]
    inv_band_weights: list  # per level reciprocal total band weight
    down_mats: dict = field(default_factory=dict)  # {n: [n/2, n]}
    up_mats: dict = field(default_factory=dict)  # {n: [2n, n]}
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    def to(self, device):
        """Device copy; float fields in ``compute_dtype``."""
        return tree_to(self, device, _DTYPES[self.compute_dtype])


def build_multiband_plan(
    seam_masks, rois, num_bands: int, canvas_size, dtype: str = "float32"
) -> MultiBandPlan:
    """Aligned-ROI geometry + precomputed Gaussian weight pyramids
    (blenders.cpp:594-668), host arrays in f32 whatever ``dtype``."""
    assert num_bands >= 1
    if dtype not in _DTYPES:
        raise ValueError(
            f"multiband dtype must be 'float32' or 'bfloat16', got {dtype!r}"
        )
    result_roi = _union_roi(rois)
    step = 1 << num_bands

    def rdown(v):
        return (v >> num_bands) << num_bands

    def rup(v):
        return v + (step - v % step) % step

    arx = rdown(result_roi[0])
    ary = rdown(result_roi[1])
    arx1 = rup(result_roi[0] + result_roi[2])
    ary1 = rup(result_roi[1] + result_roi[3])
    align_result_roi = (arx, ary, arx1 - arx, ary1 - ary)

    gap = 5 * step
    align_rois = []
    for x, y, w, h in rois:
        left = max(arx, rdown(x) - gap)
        top = max(ary, rdown(y) - gap)
        right = min(arx1, rup(x + w) + gap)
        bottom = min(ary1, rup(y + h) + gap)
        assert (right - left) >> num_bands > 0
        assert (bottom - top) >> num_bands > 0
        align_rois.append((left, top, right - left, bottom - top))

    weight_pyrs = []
    band_weights = [
        np.full(
            (align_result_roi[3] >> i, align_result_roi[2] >> i),
            WEIGHT_EPS,
            dtype=np.float32,
        )
        for i in range(num_bands + 1)
    ]
    for (x, y, w, h), (ax, ay, aw, ah), mask in zip(rois, align_rois, seam_masks):
        w0 = np.zeros((ah, aw), dtype=np.float32)
        w0[y - ay : y - ay + h, x - ax : x - ax + w] = (
            mask.astype(np.float32) / 255.0
        )
        pyr = [w0]
        for _ in range(num_bands):
            pyr.append(np_pyr_down(pyr[-1]))
        weight_pyrs.append(pyr)
        for i in range(num_bands + 1):
            ox, oy = (ax - arx) >> i, (ay - ary) >> i
            band_weights[i][
                oy : oy + (ah >> i), ox : ox + (aw >> i)
            ] += pyr[i]

    down_mats, up_mats = {}, {}
    lengths = set()
    for (ax, ay, aw, ah) in align_rois + [align_result_roi]:
        for l in range(num_bands + 1):
            lengths.add(aw >> l)
            lengths.add(ah >> l)
    for nl in lengths:
        if nl >= 2:
            down_mats[nl] = down_matrix(nl)
            up_mats[nl >> 1] = up_matrix(nl >> 1)

    return MultiBandPlan(
        num_bands=num_bands,
        rois=list(rois),
        align_rois=align_rois,
        align_result_roi=align_result_roi,
        weight_pyrs=weight_pyrs,
        inv_band_weights=[(1.0 / b).astype(np.float32) for b in band_weights],
        down_mats=down_mats,
        up_mats=up_mats,
        compute_dtype=dtype,
    )


def multiband_blend(plan: MultiBandPlan, imgs, canvas_size):
    """imgs: [C, rh, rw] warped images (roi-sized), any float dtype.
    ``plan`` is a device plan (MultiBandPlan.to).  Builds per-image
    Laplacian pyramids in ``plan.compute_dtype`` (each banded product in
    f32, cast back after it), accumulates the weighted bands, normalizes
    and collapses (blenders.cpp:676-736).  Returns an f32 [C, H, W]
    canvas."""
    B = plan.num_bands
    arx, ary, arw, arh = plan.align_result_roi
    c = imgs[0].shape[0]
    dtype = _DTYPES[plan.compute_dtype]
    dev = imgs[0].device

    def down(z):
        _, hh, ww = z.shape
        return pyr_down_mm(z, plan.down_mats[hh], plan.down_mats[ww]).to(dtype)

    def up(z):
        _, hh, ww = z.shape
        return pyr_up_mm(z, plan.up_mats[hh], plan.up_mats[ww]).to(dtype)

    dst_pyr = [
        torch.zeros((c, arh >> i, arw >> i), dtype=dtype, device=dev)
        for i in range(B + 1)
    ]
    for img, roi, aroi, wpyr in zip(imgs, plan.rois, plan.align_rois, plan.weight_pyrs):
        x, y, w, h = roi
        ax, ay, aw, ah = aroi
        src0 = torch.zeros((c, ah, aw), dtype=dtype, device=dev)
        src0[:, y - ay : y - ay + h, x - ax : x - ax + w] = img.to(dtype)
        gauss = [src0]
        for _ in range(B):
            gauss.append(down(gauss[-1]))
        for i in range(B + 1):
            lap = gauss[i] - up(gauss[i + 1]) if i < B else gauss[B]
            ox, oy = (ax - arx) >> i, (ay - ary) >> i
            dst_pyr[i][:, oy : oy + (ah >> i), ox : ox + (aw >> i)] += (
                lap * wpyr[i][None]
            )

    for i in range(B + 1):
        dst_pyr[i] = dst_pyr[i] * plan.inv_band_weights[i][None]

    acc = dst_pyr[B]
    for i in range(B - 1, -1, -1):
        acc = up(acc) + dst_pyr[i]

    w, h = canvas_size
    canvas = torch.zeros((c, h, w), dtype=torch.float32, device=dev)
    cw = min(arw, w - arx)
    ch = min(arh, h - ary)
    canvas[:, ary : ary + ch, arx : arx + cw] = acc[:, :ch, :cw].float()
    return canvas
