"""The reference's offline stage: projection maps, masks, distance seams
and vignette maps worked out from a rig description.

A frozen, trimmed copy of the arithmetic of the system's offline stage
(OwlLive's template.cpp, camera.cpp, fullframe_fisheye_cam.cpp,
equirectangular, eqarea poles, vignette.cpp, the distance seam finder),
in NumPy f64, for the camera types the benchmark's configurations use.
It imports nothing of the system under test.

A camera that sees nothing of an output (a polar cap seen from the
other pole) keeps its slot in the template's ``inputs``, at its index in
the rig, as the explicit empty input ``{"empty": True, "roi": None}``;
the distance seams are worked out over the covering inputs alone.  So
every covering input is, array for array, the one compiled over the rig
without the empty cameras.  An output that no camera covers raises.
"""

import math

import numpy as np
from scipy.ndimage import distance_transform_edt

PI = math.pi
ROI_PAD = 8
SEAM_WORK_WIDTH = 960.0
VIG_MAP_SIZE = 512


# ------------------------------------------------------------ geometry


def lonlat_to_xyz(ll):
    lon, lat = ll[..., 0], ll[..., 1]
    c = np.cos(lat)
    return np.stack([np.cos(lon) * c, np.sin(lat), -np.sin(lon) * c], axis=-1)


def xyz_to_lonlat(xyz):
    p = xyz / np.sqrt(np.sum(xyz * xyz, axis=-1, keepdims=True))
    return np.stack([np.arctan2(-p[..., 2], p[..., 0]), np.arcsin(np.clip(p[..., 1], -1.0, 1.0))], axis=-1)


def _axis_rotation(axis, angle):
    c, s = math.cos(angle), math.sin(angle)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def rotation(opts):
    r = opts.get("rotation")
    if r is None:
        return np.eye(3)
    return (_axis_rotation(0, r["roll"]) @ _axis_rotation(2, -r["pitch"])) @ _axis_rotation(1, -r["yaw"])


# ------------------------------------------------------------- cameras


class _Cam:
    def __init__(self, opts):
        self.opts = opts
        self.R = rotation(opts)

    def aspect(self):
        return 1.0

    def obj_to_image(self, ll):
        """Sphere -> normalised image coordinates, NaN where invalid."""
        ll = xyz_to_lonlat(lonlat_to_xyz(ll) @ self.R.T)
        return self._fwd(ll)

    def image_to_obj(self, xy):
        ll = self._bwd(xy)
        return xyz_to_lonlat(lonlat_to_xyz(ll) @ np.linalg.inv(self.R).T)


class Equirect(_Cam):
    def __init__(self, opts):
        super().__init__(opts)
        self.min_lat = float(opts.get("min_lat", -PI / 2))
        self.max_lat = float(opts.get("max_lat", PI / 2))

    def aspect(self):
        return 2.0 / ((self.max_lat - self.min_lat) / PI)

    def _fwd(self, ll):
        return np.stack([ll[..., 0] / (2 * PI) + 0.5, (ll[..., 1] - self.max_lat) / (self.min_lat - self.max_lat)], -1)

    def _bwd(self, xy):
        return np.stack([(xy[..., 0] - 0.5) * 2 * PI, (self.min_lat - self.max_lat) * xy[..., 1] + self.max_lat], -1)


class NorthPole(_Cam):
    def __init__(self, opts):
        super().__init__(opts)
        self.circle = float(opts.get("arctic_circle", PI / 3))

    def _fwd(self, ll):
        lon, lat = ll[..., 0], ll[..., 1]
        rho = (PI / 2 - lat) / (PI / 2 - self.circle)
        xy = np.stack([-rho * np.sin(lon) / 2 + 0.5, -rho * np.cos(lon) / 2 + 0.5], -1)
        return np.where((lat < self.circle)[..., None], np.nan, xy)

    def _bwd(self, xy):
        dx, dy = xy[..., 0] - 0.5, xy[..., 1] - 0.5
        rho = np.sqrt(dx * dx + dy * dy) * 2
        return np.stack([np.arctan2(-dx, -dy), PI / 2 - (PI / 2 - self.circle) * rho], -1)


class SouthPole(_Cam):
    def __init__(self, opts):
        super().__init__(opts)
        self.circle = float(opts.get("antarctic_circle", -PI / 3))

    def _fwd(self, ll):
        lon, lat = ll[..., 0], ll[..., 1]
        rho = (lat + PI / 2) / (self.circle + PI / 2)
        xy = np.stack([rho * np.sin(lon) / 2 + 0.5, -rho * np.cos(lon) / 2 + 0.5], -1)
        return np.where((lat > self.circle)[..., None], np.nan, xy)

    def _bwd(self, xy):
        dx, dy = xy[..., 0] - 0.5, xy[..., 1] - 0.5
        rho = np.sqrt(dx * dx + dy * dy) * 2
        return np.stack([np.arctan2(dx, -dy), -PI / 2 + (self.circle + PI / 2) * rho], -1)


class FullFrameFisheye(_Cam):
    """Horizontal fov and the cubic radial polynomial scale(r) =
    d + c r + b r^2 + a r^3, d = 1 - a - b - c; no crop."""

    def __init__(self, opts):
        super().__init__(opts)
        self.w, self.h = int(opts["width"]), int(opts["height"])
        self.hfov = float(opts["hfov"])
        self.cdx, self.cdy = float(opts["center_dx"]), float(opts["center_dy"])
        a, b, c = (float(v) for v in opts["radial"][:3])
        self.k = (1.0 - a - b - c, c, b, a)
        self.norm = min(self.w, self.h) / 2.0
        der = [self.k[0], 2 * self.k[1], 3 * self.k[2], 4 * self.k[3]]
        roots = np.roots(der[::-1]) if any(der[1:]) else np.array([])
        best = 1000.0
        for r in np.atleast_1d(roots):
            if abs(r.imag) < 1e-9 and 0 < r.real < best:
                best = float(r.real)
        self.rc = best

    def aspect(self):
        return self.w / self.h

    def _scale(self, r):
        c0, c1, c2, c3 = self.k
        return ((c3 * r + c2) * r + c1) * r + c0

    def _fwd(self, ll):
        lon, lat = ll[..., 0], ll[..., 1]
        s = np.cos(lat) * np.cos(lon)
        v1 = np.sin(lat)
        v0 = -np.cos(lat) * np.sin(lon)
        r = np.sqrt(v0 * v0 + v1 * v1)
        theta = np.arctan2(r, s)
        dist = self.w / self.hfov
        rs = np.where(r > 0, r, 1.0)
        x = -(theta * v0 / rs) * dist
        y = -(theta * v1 / rs) * dist
        centre = (np.abs(lon) < 1e-5) & (np.abs(lat) < 1e-5)
        x = np.where(centre, 0.0, x)
        y = np.where(centre, 0.0, y)
        rr = np.sqrt(x * x + y * y) / self.norm
        sc = np.where(rr < self.rc, self._scale(rr), 1000.0)
        x = (x * sc + self.cdx) / self.w + 0.5
        y = (y * sc + self.cdy) / self.h + 0.5
        return np.stack([x, y], -1)

    def _bwd(self, xy):
        x = (xy[..., 0] - 0.5) * self.w - self.cdx
        y = (xy[..., 1] - 0.5) * self.h - self.cdy
        centre = (np.abs(x) < 1e-5) & (np.abs(y) < 1e-5)
        xs, ys = np.where(centre, 1.0, x), np.where(centre, 1.0, y)
        target = np.sqrt(xs * xs + ys * ys) / self.norm
        lo, hi = np.zeros_like(target), np.full_like(target, self.rc)
        for _ in range(48):
            mid = 0.5 * (lo + hi)
            below = mid * self._scale(mid) < target
            lo, hi = np.where(below, mid, lo), np.where(below, hi, mid)
        r = 0.5 * (lo + hi)
        ok = (target > 0) & (target <= self.rc * self._scale(self.rc)) & (r > 0)
        sc = np.where(ok, target / np.where(r > 0, r, 1.0), 1000.0)
        xs, ys = xs / sc, ys / sc
        dist = self.w / self.hfov
        alpha = np.arctan2(-ys, xs)
        sa, ca = np.sin(alpha), np.cos(alpha)
        theta = np.where(
            np.abs(sa) < 1e-3,
            xs / dist / np.where(np.abs(ca) > 1e-12, ca, 1.0),
            -ys / dist / np.where(np.abs(sa) > 1e-12, sa, 1.0),
        )
        lon = np.arctan2(np.sin(theta) * ca, np.cos(theta))
        lat = np.arctan(np.tan(alpha) * np.sin(lon))
        return np.stack([np.where(centre, 0.0, lon), np.where(centre, 0.0, lat)], -1)


CAMERAS = {
    "equirectangular": Equirect,
    "eqareanorthpole": NorthPole,
    "eqareasouthpole": SouthPole,
    "fullframe_fisheye": FullFrameFisheye,
}


def camera(spec):
    kind = spec["type"]
    if kind not in CAMERAS:
        raise ValueError(f"the reference has no camera type {kind!r}")
    return CAMERAS[kind](spec.get("options", {}))


# ------------------------------------------------ vignette, resize, seams


def vignette_map(opts):
    """PTGui vignette 1 / (a + b r^2 + c r^4 + d r^6) on a 512^2 grid."""
    if "vignette" not in opts:
        return None
    a, b, c, d = (np.float32(v) for v in opts["vignette"][:4])
    if "exposure" in opts:
        ev = np.float32(2.0) ** np.float32(opts["exposure"])
        a, b, c, d = a / ev, b / ev, c / ev, d / ev
    n = VIG_MAP_SIZE
    i = np.arange(n, dtype=np.float32) - n // 2
    rmax = np.sqrt(np.float32(n // 2) ** 2 + np.float32(n // 2) ** 2)
    r = np.sqrt(i[None, :] ** 2 + i[:, None] ** 2) / rmax
    r2 = r * r
    return (1.0 / (a + r2 * (b + r2 * (c + d * r2)))).astype(np.float32)


def _taps(dst, src):
    f = (np.arange(dst, dtype=np.float32) + 0.5) * (src / dst) - 0.5
    i0 = np.clip(np.floor(f), 0, src - 1).astype(np.int64)
    i1 = np.clip(i0 + 1, 0, src - 1)
    w = np.clip(f - i0.astype(np.float32), 0.0, 1.0)
    return i0, i1, w, (1 - w).astype(np.float32)


def resize_bilinear(img, out_h, out_w):
    """cv::resize INTER_LINEAR on an [H, W] array in f32; integer images
    are rounded and clipped."""
    h, w = img.shape
    if (h, w) == (out_h, out_w):
        return img
    y0, y1, wy, wy1 = _taps(out_h, h)
    x0, x1, wx, wx1 = _taps(out_w, w)
    a = img.astype(np.float32)
    top = a[y0][:, x0] * wx1 + a[y0][:, x1] * wx
    bot = a[y1][:, x0] * wx1 + a[y1][:, x1] * wx
    out = top * wy1[:, None] + bot * wy[:, None]
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255).astype(img.dtype)
    return out


def distance_seams(masks, corners):
    """Per canvas pixel keep the mask with the greatest interior distance
    (wrap-aware for masks spanning the whole width)."""
    masks = [np.array(m, dtype=np.uint8, copy=True) for m in masks]
    x0 = min(c[0] for c in corners)
    y0 = min(c[1] for c in corners)
    x1 = max(c[0] + m.shape[1] for c, m in zip(corners, masks))
    y1 = max(c[1] + m.shape[0] for c, m in zip(corners, masks))
    rw, rh = x1 - x0, y1 - y0
    stack = np.full((len(masks), rh, rw), -1.0, dtype=np.float32)
    for i, (m, c) in enumerate(zip(masks, corners)):
        if c[0] == 0 and m.shape[1] == rw:
            w = m.shape[1]
            d = distance_transform_edt(np.concatenate([m, m, m], axis=1) > 0)[:, w : 2 * w]
        else:
            d = distance_transform_edt(m > 0)
        ox, oy = c[0] - x0, c[1] - y0
        stack[i, oy : oy + m.shape[0], ox : ox + m.shape[1]] = d.astype(np.float32)
    order = np.argsort(-stack, axis=0, kind="stable")
    rank = np.empty_like(order)
    np.put_along_axis(rank, order, np.arange(len(masks))[:, None, None], axis=0)
    kill = (rank >= 1) & (stack >= 0)
    for i, (m, c) in enumerate(zip(masks, corners)):
        ox, oy = c[0] - x0, c[1] - y0
        m[kill[i, oy : oy + m.shape[0], ox : ox + m.shape[1]]] = 0
    return masks


# ----------------------------------------------------------- the template


def compile_template(output, inputs, width, height):
    """One output of a rig -> {"size": (W, H), "inputs": [{roi, map1,
    map2, mask, seam, vignette}]}: every output pixel projected through
    each input camera, the ROI padded, distance seams at <= 960 px over
    the covering inputs; a camera that covers no pixel is the empty
    input ``{"empty": True, "roi": None}``."""
    out_cam = camera(output)
    if height <= 0:
        height = int(width / out_cam.aspect())
    xs = np.arange(width, dtype=np.float64) / width
    ys = np.arange(height, dtype=np.float64) / height
    ll = out_cam.image_to_obj(np.stack(np.meshgrid(xs, ys), axis=-1))
    ins = []
    for spec in inputs:
        xy = camera(spec).obj_to_image(ll)
        x = xy[..., 0].astype(np.float32)
        y = xy[..., 1].astype(np.float32)
        valid = np.isfinite(x) & np.isfinite(y) & (x >= 0) & (x < 1) & (y >= 0) & (y < 1)
        if not valid.any():
            ins.append({"empty": True, "roi": None})
            continue
        rows = np.flatnonzero(valid.any(axis=1))
        cols = np.flatnonzero(valid.any(axis=0))
        c0, r0 = max(0, cols[0] - ROI_PAD), max(0, rows[0] - ROI_PAD)
        c1, r1 = min(width - 1, cols[-1] + ROI_PAD), min(height - 1, rows[-1] + ROI_PAD)
        roi = (int(c0), int(r0), int(c1 + 1 - c0), int(r1 + 1 - r0))
        sl = (slice(roi[1], roi[1] + roi[3]), slice(roi[0], roi[0] + roi[2]))
        ins.append({
            "roi": roi,
            "map1": np.where(valid, x, np.float32(-1.0))[sl],
            "map2": np.where(valid, y, np.float32(-1.0))[sl],
            "mask": np.where(valid, np.uint8(255), np.uint8(0))[sl],
            "vignette": vignette_map(spec.get("options", {})),
        })
    covering = [i for i in ins if not i.get("empty")]
    if not covering:
        raise ValueError("no input covers any output pixel")
    scale = min(1.0, SEAM_WORK_WIDTH / width)
    small, corners = [], []
    for i in covering:
        rx, ry, rw, rh = i["roi"]
        corners.append((int(rx * scale), int(ry * scale)))
        small.append(resize_bilinear(i["mask"], int(rh * scale), int(rw * scale)))
    for i, s in zip(covering, distance_seams(small, corners)):
        i["seam"] = resize_bilinear(s, i["roi"][3], i["roi"][2])
    return {"size": (width, height), "inputs": ins}
