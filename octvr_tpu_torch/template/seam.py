"""Seam finders (offline, CPU).

Distance seam finder with 360-degree wrap-aware distance transform —
semantics of the reference's custom cv::detail::DistanceSeamFinder
(stitching/src/seam_finders.cpp:85-135): at every canvas pixel, keep the
``max_n`` masks with the greatest interior distance and zero the rest.
Also BFSSeamFinder (iterative border erosion, seam_finders.cpp:137-210),
the Voronoi partition and the pairwise dp seam.  The port's numpy copy
of octvr_tpu/template/seam.py.

These run once at template-compile time; artifacts (seam masks) flow into
the online path as constants.
"""

import numpy as np
from scipy.ndimage import distance_transform_edt

__all__ = ["distance_seam_find", "bfs_seam_find", "result_roi"]


def result_roi(corners, sizes):
    """Union rect of (corner, size) pairs; corners are (x, y),
    sizes (h, w)."""
    x0 = min(c[0] for c in corners)
    y0 = min(c[1] for c in corners)
    x1 = max(c[0] + s[1] for c, s in zip(corners, sizes))
    y1 = max(c[1] + s[0] for c, s in zip(corners, sizes))
    return x0, y0, x1 - x0, y1 - y0


def _warped_distance_transform(mask: np.ndarray) -> np.ndarray:
    """L2 EDT on a horizontally 3x-tiled copy so seams stay continuous
    across the +-180 degree wrap (seam_finders.cpp:85-96)."""
    tiled = np.concatenate([mask, mask, mask], axis=1)
    d = distance_transform_edt(tiled > 0)
    w = mask.shape[1]
    return d[:, w : 2 * w]


def distance_seam_find(masks, corners, max_n: int = 1, return_distances=False):
    """Update ``masks`` (list of uint8 arrays, modified copies returned) so
    at most ``max_n`` overlapping masks survive per canvas pixel, ranked by
    interior distance.  ``corners`` are (x, y) canvas offsets per mask."""
    masks = [np.array(m, dtype=np.uint8, copy=True) for m in masks]
    sizes = [m.shape for m in masks]
    rx, ry, rw, rh = result_roi(corners, sizes)

    distances = []
    for m, c in zip(masks, corners):
        if c[0] == 0 and m.shape[1] == rw:
            d = _warped_distance_transform(m)
        else:
            d = distance_transform_edt(m > 0)
        distances.append(d.astype(np.float32))

    n = len(masks)
    stack = np.full((n, rh, rw), -1.0, dtype=np.float32)
    for i, (d, c) in enumerate(zip(distances, corners)):
        ox, oy = c[0] - rx, c[1] - ry
        h, w = d.shape
        stack[i, oy : oy + h, ox : ox + w] = d

    # rank masks per pixel by distance, descending (ties break by index,
    # matching insertion order closely enough)
    order = np.argsort(-stack, axis=0, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(n)[:, None, None], axis=0)
    kill = (rank >= max_n) & (stack >= 0)

    for i, (m, c) in enumerate(zip(masks, corners)):
        ox, oy = c[0] - rx, c[1] - ry
        h, w = m.shape
        m[kill[i, oy : oy + h, ox : ox + w]] = 0

    if return_distances:
        return masks, distances
    return masks


def bfs_seam_find(masks, corners):
    """Iterative bitmask border erosion (BFSSeamFinder).  Pixels on a mask
    border that are still covered by another mask are peeled until every
    pixel belongs to one mask.  CPU/offline only."""
    masks = [np.array(m, dtype=np.uint8, copy=True) for m in masks]
    sizes = [m.shape for m in masks]
    rx, ry, rw, rh = result_roi(corners, sizes)
    n = len(masks)
    assert n < 32

    bits = np.zeros((rh, rw), dtype=np.int32)
    views = []
    for i, (m, c) in enumerate(zip(masks, corners)):
        ox, oy = c[0] - rx, c[1] - ry
        h, w = m.shape
        view = bits[oy : oy + h, ox : ox + w]
        view |= (m > 0).astype(np.int32) << i
        views.append((ox, oy, h, w))

    changed = True
    while changed:
        changed = False
        for i, m in enumerate(masks):
            ox, oy, h, w = views[i]
            fg = m > 0
            pad = np.pad(fg, 1, mode="constant")
            nb_all = (
                pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
            )
            border = fg & ~nb_all
            sub_bits = bits[oy : oy + h, ox : ox + w]
            peel = border & ((sub_bits & ~(1 << i)) != 0)
            if peel.any():
                m[peel] = 0
                sub_bits[peel] &= ~(1 << i)
                changed = True
    return masks


def voronoi_seam_find(masks, corners):
    """Voronoi partition of the overlaps: each pixel goes to the mask with
    the greatest interior distance (the VoronoiSeamFinder role — identical
    machinery to the distance finder with max_n=1)."""
    return distance_seam_find(masks, corners, max_n=1)


def dp_seam_find(images, masks, corners, cost_type="color"):
    """Pairwise dynamic-programming seam (DpSeamFinder,
    seam_finders.hpp:135-242): for every overlapping pair, carve the min
    cost path through the overlap and split the masks along it.

    cost_type "color": cost = color difference (COLOR).  "color_grad":
    the difference is normalized by the Sobel gradient magnitudes of
    both images (COLOR_GRAD) — the seam prefers textured areas.
    Offline/CPU."""
    assert cost_type in ("color", "color_grad")
    masks = [np.array(m, dtype=np.uint8, copy=True) for m in masks]
    n = len(masks)
    all_grads = None
    if cost_type == "color_grad":
        from .graphcut import grad_magnitude

        all_grads = []
        for im in images:
            gx, gy = grad_magnitude(im)
            all_grads.append(gx + gy)
    for i in range(n):
        for j in range(i + 1, n):
            xi, yi = corners[i]
            xj, yj = corners[j]
            hi, wi = masks[i].shape
            hj, wj = masks[j].shape
            ox0, oy0 = max(xi, xj), max(yi, yj)
            ox1 = min(xi + wi, xj + wj)
            oy1 = min(yi + hi, yj + hj)
            if ox1 <= ox0 or oy1 <= oy0:
                continue
            si = (slice(oy0 - yi, oy1 - yi), slice(ox0 - xi, ox1 - xi))
            sj = (slice(oy0 - yj, oy1 - yj), slice(ox0 - xj, ox1 - xj))
            m1, m2 = masks[i][si], masks[j][sj]
            both = (m1 > 0) & (m2 > 0)
            if not both.any():
                continue
            a = np.asarray(images[i])[si].astype(np.float64)
            b = np.asarray(images[j])[sj].astype(np.float64)
            cost = np.sqrt(((a - b) ** 2).sum(-1) if a.ndim == 3 else (a - b) ** 2)
            if all_grads is not None:
                cost = cost / (all_grads[i][si] + all_grads[j][sj] + 1.0)
            cost = np.where(both, cost, 1e6)
            oh, ow = cost.shape
            # vertical seam (transpose if the overlap is wide and short)
            transposed = ow > oh * 2
            if transposed:
                cost = cost.T
                oh, ow = ow, oh
            acc = cost.copy()
            for r in range(1, oh):
                prev = acc[r - 1]
                left = np.concatenate([[np.inf], prev[:-1]])
                right = np.concatenate([prev[1:], [np.inf]])
                acc[r] += np.minimum(prev, np.minimum(left, right))
            seam = np.empty(oh, dtype=np.int64)
            seam[-1] = int(np.argmin(acc[-1]))
            for r in range(oh - 2, -1, -1):
                c = seam[r + 1]
                lo, hi2 = max(0, c - 1), min(ow, c + 2)
                seam[r] = lo + int(np.argmin(acc[r, lo:hi2]))
            cols = np.arange(ow)[None, :]
            keep_first = cols <= seam[:, None]
            if transposed:
                keep_first = keep_first.T
            # decide which side belongs to which image: image i keeps the
            # side nearer its exclusive region
            left_i = xi <= xj if not transposed else yi <= yj
            if not left_i:
                keep_first = ~keep_first
            m1[both & ~keep_first] = 0
            m2[both & keep_first] = 0
    return masks
