"""Seam finders (offline, CPU).

Distance seam finder with 360-degree wrap-aware distance transform —
semantics of the reference's custom cv::detail::DistanceSeamFinder
(stitching/src/seam_finders.cpp:85-135): at every canvas pixel, keep the
``max_n`` masks with the greatest interior distance and zero the rest.
The port's copy of octvr_tpu/template/seam.py: what ``compile_rig`` and
``MapperTemplate.create_masks`` reach.  The BFS, Voronoi and dp finders
of the original serve the ``dump`` CLI and are not in the port yet.

These run once at template-compile time; artifacts (seam masks) flow into
the online path as constants.
"""

import numpy as np
from scipy.ndimage import distance_transform_edt

__all__ = ["distance_seam_find", "result_roi"]


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
