"""Lens-distortion camera models: pinhole (full OpenCV distortion model),
fisheye (equidistant + theta polynomial), PTGui/Hugin full-frame fisheye,
and the Scaramuzza omnidirectional (ocam) model.

Re-implemented from scratch as vectorized array math; semantics follow the
reference models in modules/octvr/src/cameras/
(pinhole_cam.cpp, fisheye_cam.cpp, fullframe_fisheye_cam.cpp,
ocam_fisheye.cpp).  The per-pixel polynomial inversion of the reference
(cv::solvePoly per point, fullframe_fisheye_cam.cpp:180-204) is replaced by
a vectorized bisection on the monotonic branch, equally accurate (the
port's copy of octvr_tpu/cameras/fisheye.py).
"""

import math

import numpy as np

from ..geometry import lonlat_to_xyz, rotate_points, xyz_to_lonlat
from .base import Camera

PI = math.pi

__all__ = [
    "PinholeCamera",
    "FisheyeCamera",
    "FullFrameFisheyeCamera",
    "OcamFisheyeCamera",
]


class PinholeCamera(Camera):
    """K + OpenCV distortion coefficients; forward projection only
    (pinhole_cam.cpp).  Points behind the camera (z<=0) are culled."""

    def __init__(self, options):
        super().__init__(options)
        self.fx = float(options["fx"])
        self.fy = float(options["fy"])
        self.cx = float(options["cx"])
        self.cy = float(options["cy"])
        d = [float(v) for v in options["dist_coeffs"]]
        # OpenCV layout: k1 k2 p1 p2 [k3 [k4 k5 k6]]
        d = d + [0.0] * (8 - len(d))
        self.dist = d[:8]
        self.width = int(options["width"])
        self.height = int(options["height"])

    def get_aspect_ratio(self):
        return self.width / self.height

    def _distort(self, a, b, xp):
        k1, k2, p1, p2, k3, k4, k5, k6 = self.dist
        r2 = a * a + b * b
        radial = (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (
            1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
        )
        xd = a * radial + 2.0 * p1 * a * b + p2 * (r2 + 2.0 * a * a)
        yd = b * radial + p1 * (r2 + 2.0 * b * b) + 2.0 * p2 * a * b
        return xd, yd

    def _project(self, xyz, xp):
        z = xyz[..., 2]
        zsafe = xp.where(z > 0, z, 1.0)
        a = xyz[..., 0] / zsafe
        b = xyz[..., 1] / zsafe
        xd, yd = self._distort(a, b, xp)
        u = self.fx * xd + self.cx
        v = self.fy * yd + self.cy
        nan = xp.full(u.shape, np.nan, dtype=u.dtype)
        bad = ~(z > 0)
        return xp.stack(
            [xp.where(bad, nan, u), xp.where(bad, nan, v)], axis=-1
        )

    def obj_to_image(self, lonlat, xp=np):
        # overrides the base composition: no longitude windowing is applied
        # in the reference's PinholeCamera::obj_to_image (pinhole_cam.cpp:30-51)
        xyz = lonlat_to_xyz(lonlat, xp=xp)
        xyz = rotate_points(xyz, self.rotate_matrix, xp=xp)
        uv = self._project(xyz, xp)
        x = uv[..., 0] / self.width
        y = 1.0 - uv[..., 1] / self.height
        return xp.stack([x, y], axis=-1)


class FisheyeCamera(PinholeCamera):
    """OpenCV fisheye model (equidistant + theta polynomial); cannot cover
    more than half the sphere (fisheye_cam.cpp:12)."""

    def _project(self, xyz, xp):
        z = xyz[..., 2]
        zsafe = xp.where(z > 0, z, 1.0)
        a = xyz[..., 0] / zsafe
        b = xyz[..., 1] / zsafe
        k1, k2, k3, k4 = self.dist[:4]
        r = xp.sqrt(a * a + b * b)
        theta = xp.arctan(r)
        t2 = theta * theta
        theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = xp.where(r > 1e-12, theta_d / xp.where(r > 1e-12, r, 1.0), 1.0)
        u = self.fx * (a * scale) + self.cx
        v = self.fy * (b * scale) + self.cy
        nan = xp.full(u.shape, np.nan, dtype=u.dtype)
        bad = ~(z > 0)
        return xp.stack(
            [xp.where(bad, nan, u), xp.where(bad, nan, v)], axis=-1
        )


def _poly3(r, c0, c1, c2, c3):
    return ((c3 * r + c2) * r + c1) * r + c0


class FullFrameFisheyeCamera(Camera):
    """PTGui/Hugin-compatible full-frame fisheye: horizontal fov + cubic
    radial polynomial a,b,c (fullframe_fisheye_cam.cpp).

    radial scale(r) = d + c*r + b*r^2 + a*r^3 with d = 1-a-b-c;
    the correction radius is the smallest positive stationary point of
    r*scale(r), beyond which the mapping is disabled (scale -> 1000).
    """

    def __init__(self, options):
        super().__init__(options)
        self.width = int(options["width"])
        self.height = int(options["height"])

        crop = options.get("crop")
        if crop and "rect" in crop:
            r = [int(v) for v in crop["rect"]]
            self.crop_x, self.crop_y = r[0], r[2]
            self.crop_w, self.crop_h = r[1] - r[0], r[3] - r[2]
            self.crop_is_circular = bool(crop.get("is_circular", False))
        else:
            self.crop_x = self.crop_y = 0
            self.crop_w, self.crop_h = self.width, self.height
            self.crop_is_circular = False
        if self.crop_w * self.crop_h == 0:
            self.crop_x = self.crop_y = 0
            self.crop_w, self.crop_h = self.width, self.height
            self.crop_is_circular = False

        self.hfov = float(options["hfov"])
        self.center_dx = float(options["center_dx"])
        self.center_dy = float(options["center_dy"])

        a, b, c = (float(v) for v in options["radial"][:3])
        # coeffs[k] multiplies r^k in scale(r) (reference stores reversed)
        self.coeffs = (1.0 - a - b - c, c, b, a)
        self.norm_radius = min(self.crop_w, self.crop_h) / 2.0
        self.correction_radius = self._correction_radius()

    def _correction_radius(self):
        """Smallest positive root of d/dr [r * scale(r)]
        (CalcCorrectionRadius, fullframe_fisheye_cam.cpp:100-115)."""
        c0, c1, c2, c3 = self.coeffs
        # derivative coefficients of sum coeffs[k] r^(k+1): (k+1)*coeffs[k]
        der = [1.0 * c0, 2.0 * c1, 3.0 * c2, 4.0 * c3]
        roots = np.roots(der[::-1]) if any(der[1:]) else np.array([])
        best = 1000.0
        for r in np.atleast_1d(roots):
            if abs(r.imag) < 1e-9 and r.real > 0 and r.real < best:
                best = float(r.real)
        return best

    def get_aspect_ratio(self):
        return self.width / self.height

    def _radial_distort(self, x, y, xp):
        r = xp.sqrt(x * x + y * y) / self.norm_radius
        c0, c1, c2, c3 = self.coeffs
        scale = xp.where(
            r < self.correction_radius, _poly3(r, c0, c1, c2, c3), 1000.0
        )
        return x * scale, y * scale

    def _reverse_radial_distort(self, x, y, xp):
        """Invert r_dst = r * scale(r): bisection on the monotonic branch
        [0, correction_radius] (replaces per-pixel cv::solvePoly)."""
        s = xp.sqrt(x * x + y * y)
        target = s / self.norm_radius
        c0, c1, c2, c3 = self.coeffs
        rc = self.correction_radius

        def f(r):
            return r * _poly3(r, c0, c1, c2, c3)

        lo = xp.zeros_like(target)
        hi = xp.full_like(target, rc)
        for _ in range(48):
            mid = 0.5 * (lo + hi)
            below = f(mid) < target
            lo = xp.where(below, mid, lo)
            hi = xp.where(below, hi, mid)
        r = 0.5 * (lo + hi)
        solvable = (
            (target > 0)
            & (target <= f(xp.asarray(rc, dtype=target.dtype)))
            & (r > 0)
        )
        scale = xp.where(
            solvable,
            target / xp.where(r > 0, r, 1.0),
            1000.0,
        )
        return x / scale, y / scale

    def _obj_to_image(self, lonlat, xp):
        lon, lat = lonlat[..., 0], lonlat[..., 1]
        s = xp.cos(lat) * xp.cos(lon)
        v1 = xp.sin(lat)
        v0 = -xp.cos(lat) * xp.sin(lon)
        r = xp.sqrt(v0 * v0 + v1 * v1)
        theta = xp.arctan2(r, s)
        distance = self.crop_w / self.hfov
        rsafe = xp.where(r > 0, r, 1.0)
        x = -(theta * v0 / rsafe) * distance
        y = -(theta * v1 / rsafe) * distance
        at_center = (xp.abs(lon) < 1e-5) & (xp.abs(lat) < 1e-5)
        x = xp.where(at_center, 0.0, x)
        y = xp.where(at_center, 0.0, y)

        x, y = self._radial_distort(x, y, xp)
        x = x + self.center_dx
        y = y + self.center_dy

        x = x / self.crop_w + 0.5
        y = y / self.crop_h + 0.5

        if self.crop_is_circular:
            bad = (x - 0.5) ** 2 + (y - 0.5) ** 2 > 0.25
        else:
            bad = xp.zeros(x.shape, dtype=bool)

        x = (x * self.crop_w + self.crop_x) / self.width
        y = (y * self.crop_h + self.crop_y) / self.height
        nan = xp.full(x.shape, np.nan, dtype=x.dtype)
        return xp.stack(
            [xp.where(bad, nan, x), xp.where(bad, nan, y)], axis=-1
        )

    def _image_to_obj(self, xy, xp):
        # reference asserts crop == full frame on this path
        x = (xy[..., 0] - 0.5) * self.crop_w - self.center_dx
        y = (xy[..., 1] - 0.5) * self.crop_h - self.center_dy
        at_center = (xp.abs(x) < 1e-5) & (xp.abs(y) < 1e-5)
        xs = xp.where(at_center, 1.0, x)
        ys = xp.where(at_center, 1.0, y)

        xs, ys = self._reverse_radial_distort(xs, ys, xp)

        distance = self.crop_w / self.hfov
        alpha = xp.arctan2(-ys, xs)
        sin_a = xp.sin(alpha)
        cos_a = xp.cos(alpha)
        # Forward model: x = theta*d*cos(alpha), y = -theta*d*sin(alpha).
        # NOTE deviation from the reference: its fallback branch
        # (fullframe_fisheye_cam.cpp:243-245) uses -x/d/cos(alpha), which has
        # the wrong sign for alpha ~ 0 (a <0.06 degree sliver); we use the
        # correct +x/d/cos(alpha).
        theta = xp.where(
            xp.abs(sin_a) < 1e-3,
            xs / distance / xp.where(xp.abs(cos_a) > 1e-12, cos_a, 1.0),
            -ys / distance / xp.where(xp.abs(sin_a) > 1e-12, sin_a, 1.0),
        )
        lon = xp.arctan2(xp.sin(theta) * cos_a, xp.cos(theta))
        lat = xp.arctan(xp.tan(alpha) * xp.sin(lon))
        lon = xp.where(at_center, 0.0, lon)
        lat = xp.where(at_center, 0.0, lat)
        return xp.stack([lon, lat], axis=-1)


class OcamFisheyeCamera(Camera):
    """Scaramuzza omnidirectional model (ocam_fisheye.cpp): forward
    polynomial pol(r) for back-projection, inverse polynomial invpol(theta)
    for projection, affine (c, d, e) pixel mapping."""

    def __init__(self, options):
        super().__init__(options)
        if "file" in options:
            self._load_txt(options["file"])
        else:
            self.pol = [float(v) for v in options["pol"]]
            self.invpol = [float(v) for v in options["invpol"]]
            self.xc = float(options["xc"])
            self.yc = float(options["yc"])
            self.c = float(options["c"])
            self.d = float(options["d"])
            self.e = float(options["e"])
            self.width = int(options["width"])
            self.height = int(options["height"])

    def _load_txt(self, path):
        """Parse a Scaramuzza calib .txt (same layout as get_ocam_model)."""
        with open(path) as f:
            lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
        pol = [float(v) for v in lines[0].split()]
        self.pol = pol[1 : 1 + int(pol[0])]
        inv = [float(v) for v in lines[1].split()]
        self.invpol = inv[1 : 1 + int(inv[0])]
        self.xc, self.yc = (float(v) for v in lines[2].split())
        self.c, self.d, self.e = (float(v) for v in lines[3].split())
        h, w = (int(v) for v in lines[4].split())
        self.width, self.height = w, h

    def get_aspect_ratio(self):
        return self.width / self.height

    def _obj_to_image(self, lonlat, xp):
        xyz = lonlat_to_xyz(lonlat, xp=xp)
        # axis swizzle (ocam_fisheye.cpp:227-235): p = (-y, -z, -x)
        p0 = -xyz[..., 1]
        p1 = -xyz[..., 2]
        p2 = -xyz[..., 0]
        norm = xp.sqrt(p0 * p0 + p1 * p1)
        nsafe = xp.where(norm > 0, norm, 1.0)
        theta = xp.arctan(p2 / nsafe)
        rho = xp.zeros_like(theta) + self.invpol[0]
        t_i = xp.ones_like(theta)
        for coef in self.invpol[1:]:
            t_i = t_i * theta
            rho = rho + t_i * coef
        x = p0 / nsafe * rho
        y = p1 / nsafe * rho
        u = x * self.c + y * self.d + self.xc
        v = x * self.e + y + self.yc
        u = xp.where(norm > 0, u, self.xc)
        v = xp.where(norm > 0, v, self.yc)
        # (row, col) -> normalized (x, y) (ocam_fisheye.cpp:237-244)
        return xp.stack([v / self.width, u / self.height], axis=-1)

    def _image_to_obj(self, xy, xp):
        u = xy[..., 1] * self.height  # row
        v = xy[..., 0] * self.width  # col
        invdet = 1.0 / (self.c - self.d * self.e)
        xp_ = invdet * ((u - self.xc) - self.d * (v - self.yc))
        yp = invdet * (-self.e * (u - self.xc) + self.c * (v - self.yc))
        r = xp.sqrt(xp_ * xp_ + yp * yp)
        zp = xp.zeros_like(r) + self.pol[0]
        r_i = xp.ones_like(r)
        for coef in self.pol[1:]:
            r_i = r_i * r
            zp = zp + r_i * coef
        invnorm = 1.0 / xp.sqrt(xp_ * xp_ + yp * yp + zp * zp)
        p0, p1, p2 = invnorm * xp_, invnorm * yp, invnorm * zp
        # inverse swizzle: xyz = (-p2, -p0, -p1)
        xyz = xp.stack([-p2, -p0, -p1], axis=-1)
        return xyz_to_lonlat(xyz, xp=xp)
