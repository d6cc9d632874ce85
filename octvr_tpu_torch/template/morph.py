"""Control-point morphing: warp the remap tables so matched feature
pairs coincide on the canvas (template_morph.cpp:69-237).

A control point [n0, n1, x0, y0, x1, y1] names one physical feature seen
by inputs n0 and n1 at normalized image coords.  Both observations are
projected to canvas coordinates; their seam-distance-weighted midpoint
is the morph target.  Per input, the control-point displacements plus a
pinned boundary grid are Delaunay-triangulated and each triangle's
affine warp is applied to map1/map2/mask (scipy.spatial.Delaunay
replaces cv::Subdiv2D; the per-triangle warpAffine is an inverse-affine
bilinear resample of the maps).  The port's numpy copy of
octvr_tpu/template/morph.py.
"""

import sys

import numpy as np
from scipy.spatial import Delaunay

from .seam import distance_seam_find

__all__ = ["morph_control_points"]


def _affine_from_tris(src, dst):
    """3x2 point triangles -> 3x3 affine A with dst = A @ src (homog)."""
    S = np.concatenate([src.T, np.ones((1, 3))])  # [3, 3]
    D = np.concatenate([dst.T, np.ones((1, 3))])
    return D @ np.linalg.inv(S)


def _fill_tri_mask(shape, tri):
    """Boolean mask of the triangle (rounded vertices, like fillPoly on
    rounded dst points, template_morph.cpp:214-219)."""
    from ..utils.raster import fill_poly

    m = np.zeros(shape, dtype=np.uint8)
    pts = [(int(round(x)), int(round(y))) for x, y in tri]
    fill_poly(m, pts, 255)
    return m > 0


def _sample_bilinear(arr, xs, ys):
    h, w = arr.shape
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = np.clip(xs - x0, 0, 1)
    fy = np.clip(ys - y0, 0, 1)
    a = arr.astype(np.float64)
    return (
        a[y0, x0] * (1 - fx) * (1 - fy)
        + a[y0, x1] * fx * (1 - fy)
        + a[y1, x0] * (1 - fx) * fy
        + a[y1, x1] * fx * fy
    )


def morph_control_points(mt, control_points):
    """mt: freshly compiled MapperTemplate (needs live camera objects)."""
    assert mt._input_cams, "morph requires a freshly compiled template"
    W, H = mt.out_size

    masks = [inp.mask for inp in mt.inputs]
    corners = [(inp.roi[0], inp.roi[1]) for inp in mt.inputs]
    _, distances = distance_seam_find(
        masks, corners, max_n=2, return_distances=True
    )

    def translate(x, y, n):
        ll = mt._input_cams[n].image_to_obj(np.array([[x, y]]))
        xy = mt._output_cam.obj_to_image(ll)
        return float(xy[0, 0]), float(xy[0, 1])

    cps = []
    for a in control_points:
        n0, n1 = int(a[0]), int(a[1])
        assert n0 < n1
        d0 = translate(float(a[2]), float(a[3]), n0)
        d1 = translate(float(a[4]), float(a[5]), n1)
        if not (np.isfinite(d0).all() and np.isfinite(d1).all()):
            continue
        if abs(d0[0] - d1[0]) + abs(d0[1] - d1[1]) > 0.1:
            continue  # too far apart to be the same feature

        def local(d, n):
            lx = int(d[0] * W) - mt.inputs[n].roi[0]
            ly = int(d[1] * H) - mt.inputs[n].roi[1]
            h, w = distances[n].shape
            return min(max(ly, 0), h - 1), min(max(lx, 0), w - 1)

        w0 = float(distances[n0][local(d0, n0)])
        w1 = float(distances[n1][local(d1, n1)])
        if w0 + w1 < 1e-3:
            w0 = w1 = 1.0
        mid = (
            (d0[0] * w0 + d1[0] * w1) / (w0 + w1),
            (d0[1] * w0 + d1[1] * w1) / (w0 + w1),
        )
        cps.append((n0, n1, d0, d1, mid))
    print(f"Number of control points: {len(cps)}", file=sys.stderr)

    for i, inp in enumerate(mt.inputs):
        src_v, dst_v = [], []
        for n0, n1, d0, d1, mid in cps:
            if n0 == i:
                src_v.append(d0)
                dst_v.append(mid)
            if n1 == i:
                src_v.append(d1)
                dst_v.append(mid)
        if not src_v:
            continue

        allv = np.array(src_v + dst_v)
        bb_l = max(1e-3, allv[:, 0].min() - 0.05)
        bb_t = max(1e-3, allv[:, 1].min() - 0.05)
        bb_r = min(1 - 1e-3, allv[:, 0].max() + 0.05)
        bb_b = min(1 - 1e-3, allv[:, 1].max() + 0.05)
        # pinned boundary grid (template_morph.cpp:171-182)
        for x in np.arange(bb_l, bb_r + 1e-3, (bb_r - bb_l) / 10):
            for yb in (bb_t, bb_b):
                src_v.append((x, yb))
                dst_v.append((x, yb))
        for y in np.arange(
            bb_t + (bb_b - bb_t) / 10,
            bb_b - (bb_b - bb_t) / 10 + 1e-3,
            (bb_b - bb_t) / 10,
        ):
            for xb in (bb_l, bb_r):
                src_v.append((xb, y))
                dst_v.append((xb, y))

        src_v = np.asarray(src_v, dtype=np.float64)
        dst_v = np.asarray(dst_v, dtype=np.float64)
        try:
            tri = Delaunay(src_v)
        except Exception:
            continue

        rx, ry, rw, rh = inp.roi

        def to_local(pts):
            out = pts.copy()
            out[:, 0] = out[:, 0] * W - rx
            out[:, 1] = out[:, 1] * H - ry
            return out

        new_map1 = inp.map1.copy()
        new_map2 = inp.map2.copy()
        new_mask = inp.mask.copy()
        for simplex in tri.simplices:
            s_tri = to_local(src_v[simplex])
            d_tri = to_local(dst_v[simplex])
            if np.allclose(s_tri, d_tri):
                continue
            A = _affine_from_tris(s_tri, d_tri)
            Ainv = np.linalg.inv(A)
            mask_tri = _fill_tri_mask((rh, rw), d_tri)
            if not mask_tri.any():
                continue
            yy, xx = np.nonzero(mask_tri)
            sx = Ainv[0, 0] * xx + Ainv[0, 1] * yy + Ainv[0, 2]
            sy = Ainv[1, 0] * xx + Ainv[1, 1] * yy + Ainv[1, 2]
            new_map1[yy, xx] = _sample_bilinear(inp.map1, sx, sy).astype(
                np.float32
            )
            new_map2[yy, xx] = _sample_bilinear(inp.map2, sx, sy).astype(
                np.float32
            )
            new_mask[yy, xx] = (
                _sample_bilinear(inp.mask, sx, sy) > 127
            ).astype(np.uint8) * 255
        inp.map1 = new_map1
        inp.map2 = new_map2
        inp.mask = new_mask
    return mt
