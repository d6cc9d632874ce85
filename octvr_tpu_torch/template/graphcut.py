"""Graph-cut seam finder (content-aware): pairwise min-cut over the
overlap region — the GraphCutSeamFinder role
(stitching/src/seam_finders.cpp:1235-1410), built on
scipy.sparse.csgraph.maximum_flow instead of GCGraph.

Two cost types, like the reference:

* COST_COLOR (``cost_type="color"``): edge weight = color difference at
  both edge endpoints (setGraphWeightsColor).
* COST_COLOR_GRAD (``cost_type="color_grad"``): the color difference is
  normalized by the Sobel gradient magnitudes at both endpoints in both
  images (setGraphWeightsColorGrad, seam_finders.cpp:1283-1335) — seams
  prefer high-gradient (textured) areas where blends hide better.

Pairwise like the stock finder: for every overlapping image pair, solve
one min-cut where the terminal costs pin pixels owned exclusively by one
image and the edge weights are color differences, then zero the losing
mask pixels.  The port's numpy copy of octvr_tpu/template/graphcut.py.
"""

import numpy as np
from scipy.ndimage import sobel
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_flow

__all__ = ["graphcut_seam_find", "grad_magnitude"]

_INF = 10**9
_SCALE = 1000.0  # float costs -> int capacities


def _color_diff(a, b):
    return np.sqrt(np.sum((a.astype(np.float64) - b.astype(np.float64)) ** 2, -1))


def grad_magnitude(img):
    """Squared-L2 of the per-channel 3x3 Sobel gradients, per axis —
    the reference's dx_/dy_ prep (seam_finders.cpp:1205-1230, normL2 of a
    3-channel Sobel response; its normL2 is the SQUARED norm)."""
    a = np.asarray(img, dtype=np.float64)
    if a.ndim == 2:
        a = a[..., None]
    # scipy.ndimage.sobel(axis=1) matches cv::Sobel(dx=1) up to sign
    dx = np.stack([sobel(a[..., c], axis=1) for c in range(a.shape[-1])], -1)
    dy = np.stack([sobel(a[..., c], axis=0) for c in range(a.shape[-1])], -1)
    return (dx**2).sum(-1), (dy**2).sum(-1)


def _pair_cut(img1, img2, m1, m2, ox, oy, ow, oh, grads=None):
    """Min-cut over the overlap rect; returns keep1 mask over the rect
    (True = pixel stays with image 1).  ``grads``: ((dx1, dy1), (dx2,
    dy2)) enables the COLOR_GRAD weights."""
    n = ow * oh
    src, dst = n, n + 1
    idx = np.arange(n).reshape(oh, ow)

    d = _color_diff(img1, img2)  # [oh, ow]

    # terminal links: pixels covered only by img1 -> source, only img2 -> sink
    only1 = idx[(m1 > 0) & ~(m2 > 0)]
    only2 = idx[(m2 > 0) & ~(m1 > 0)]

    if grads is None:
        # COST_COLOR: weight = color diff at both ends
        # (setGraphWeightsColor), quantized
        wh = d[:, :-1] + d[:, 1:]
        wv = d[:-1, :] + d[1:, :]
    else:
        # COST_COLOR_GRAD: normalize by gradient sums at both ends
        (dx1, dy1), (dx2, dy2) = grads
        eps = 1.0
        gx = dx1[:, :-1] + dx1[:, 1:] + dx2[:, :-1] + dx2[:, 1:] + eps
        gy = dy1[:-1, :] + dy1[1:, :] + dy2[:-1, :] + dy2[1:, :] + eps
        wh = (d[:, :-1] + d[:, 1:]) / gx + eps
        wv = (d[:-1, :] + d[1:, :]) / gy + eps
    wgt_h = (wh * _SCALE + 1).astype(np.int64).ravel()
    wgt_v = (wv * _SCALE + 1).astype(np.int64).ravel()
    uh, vh = idx[:, :-1].ravel(), idx[:, 1:].ravel()
    uv, vv = idx[:-1, :].ravel(), idx[1:, :].ravel()

    rows = np.concatenate(
        [
            np.full(len(only1), src),
            only2,
            uh,
            vh,
            uv,
            vv,
        ]
    )
    cols = np.concatenate(
        [
            only1,
            np.full(len(only2), dst),
            vh,
            uh,
            vv,
            uv,
        ]
    )
    caps = np.concatenate(
        [
            np.full(len(only1), _INF, dtype=np.int64),
            np.full(len(only2), _INF, dtype=np.int64),
            wgt_h,
            wgt_h,
            wgt_v,
            wgt_v,
        ]
    )
    g = csr_matrix((caps, (rows, cols)), shape=(n + 2, n + 2))
    res = maximum_flow(g, src, dst)
    # source side = pixels reachable from src in the residual graph
    residual = g - res.flow
    residual.data = np.maximum(residual.data, 0)
    from scipy.sparse.csgraph import breadth_first_order

    order = breadth_first_order(
        residual, src, directed=True, return_predecessors=False
    )
    source_side = np.zeros(n + 2, dtype=bool)
    source_side[order] = True
    return source_side[:n].reshape(oh, ow)


def graphcut_seam_find(images, masks, corners, cost_type="color"):
    """images: float [h, w, 3] in [0,1] per input (roi-sized); masks: u8;
    corners: (x, y) canvas offsets; cost_type: "color" | "color_grad".
    Returns updated masks."""
    assert cost_type in ("color", "color_grad")
    masks = [np.array(m, dtype=np.uint8, copy=True) for m in masks]
    n = len(masks)
    all_grads = (
        [grad_magnitude(im) for im in images]
        if cost_type == "color_grad"
        else None
    )
    for i in range(n):
        for j in range(i + 1, n):
            xi, yi = corners[i]
            xj, yj = corners[j]
            hi, wi = masks[i].shape
            hj, wj = masks[j].shape
            ox0 = max(xi, xj)
            oy0 = max(yi, yj)
            ox1 = min(xi + wi, xj + wj)
            oy1 = min(yi + hi, yj + hj)
            if ox1 <= ox0 or oy1 <= oy0:
                continue
            ow, oh = ox1 - ox0, oy1 - oy0
            si = (slice(oy0 - yi, oy0 - yi + oh), slice(ox0 - xi, ox0 - xi + ow))
            sj = (slice(oy0 - yj, oy0 - yj + oh), slice(ox0 - xj, ox0 - xj + ow))
            mi = masks[i][si]
            mj = masks[j][sj]
            both = (mi > 0) & (mj > 0)
            if not both.any():
                continue
            grads = None
            if all_grads is not None:
                grads = (
                    tuple(g[si] for g in all_grads[i]),
                    tuple(g[sj] for g in all_grads[j]),
                )
            keep1 = _pair_cut(
                np.asarray(images[i])[si],
                np.asarray(images[j])[sj],
                mi,
                mj,
                ox0,
                oy0,
                ow,
                oh,
                grads=grads,
            )
            mi[both & ~keep1] = 0
            mj[both & keep1] = 0
    return masks
