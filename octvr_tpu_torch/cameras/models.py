"""Simple camera models: equirectangular, normal, perspective, stupidoval,
cubic (3x2 cube map), equal-area polar caps.

Each mirrors the corresponding reference model under
modules/octvr/src/cameras/ but is written as vectorized array math (the
port's copy of octvr_tpu/cameras/models.py, run with numpy f64).
"""

import math

import numpy as np

from ..geometry import lonlat_to_xyz, xyz_to_lonlat
from .base import Camera

PI = math.pi

__all__ = [
    "Equirectangular",
    "Normal",
    "PerspectiveCamera",
    "StupidOval",
    "Cubic",
    "EqareaNorthPole",
    "EqareaSouthPole",
]


class Equirectangular(Camera):
    """2:1 lat/lon panorama (cameras/equirectangular.{hpp,cpp}).
    Options: min_lat, max_lat (default -pi/2, pi/2), scale_lon (aspect only).
    """

    def __init__(self, options):
        super().__init__(options)
        self.min_lat = float(options.get("min_lat", -PI / 2))
        self.max_lat = float(options.get("max_lat", PI / 2))
        self.scale_lon = float(options.get("scale_lon", 1.0))

    def get_aspect_ratio(self):
        return (2.0 * self.scale_lon) / ((self.max_lat - self.min_lat) / PI)

    def _obj_to_image(self, lonlat, xp):
        x = lonlat[..., 0] / (2.0 * PI) + 0.5
        y = (lonlat[..., 1] - self.max_lat) / (self.min_lat - self.max_lat)
        return xp.stack([x, y], axis=-1)

    def _image_to_obj(self, xy, xp):
        lon = (xy[..., 0] - 0.5) * 2.0 * PI
        lat = (self.min_lat - self.max_lat) * xy[..., 1] + self.max_lat
        return xp.stack([lon, lat], axis=-1)


class Normal(Camera):
    """Simplified pinhole via cam_opt/aspect_ratio (cameras/normal.cpp)."""

    def __init__(self, options):
        super().__init__(options)
        self.aspect_ratio = float(options["aspect_ratio"])
        self.cam_x = float(options["cam_opt"])
        self.cam_z = math.sqrt(
            (1.0 - self.cam_x * self.cam_x)
            / (1.0 + 1.0 / self.aspect_ratio / self.aspect_ratio)
        )
        self.cam_y = self.cam_z / self.aspect_ratio

    def get_aspect_ratio(self):
        return self.aspect_ratio

    def _image_to_obj(self, xy, xp):
        xx = xp.full(xy[..., 0].shape, self.cam_x, dtype=xy.dtype)
        yy = self.cam_y - xy[..., 1] * 2.0 * self.cam_y
        zz = self.cam_z - xy[..., 0] * 2.0 * self.cam_z
        return xyz_to_lonlat(xp.stack([xx, yy, zz], axis=-1), xp=xp)

    def _obj_to_image(self, lonlat, xp):
        xyz = lonlat_to_xyz(lonlat, xp=xp)
        scale = xyz[..., 0] / self.cam_x
        y = xyz[..., 1] / scale
        z = xyz[..., 2] / scale
        px = (self.cam_z - z) / (2.0 * self.cam_z)
        py = (self.cam_y - y) / (2.0 * self.cam_y)
        bad = xyz[..., 0] < 0
        nan = xp.full(px.shape, np.nan, dtype=px.dtype)
        return xp.stack(
            [xp.where(bad, nan, px), xp.where(bad, nan, py)], axis=-1
        )


class PerspectiveCamera(Camera):
    """ocam-style perspective with scale factor sf (cameras/perspective.cpp)."""

    def __init__(self, options):
        super().__init__(options)
        self.aspect_ratio = float(options["aspect_ratio"])
        self.sf = float(options["sf"])

    def get_aspect_ratio(self):
        return self.aspect_ratio

    def _image_to_obj(self, xy, xp):
        z = (0.5 - xy[..., 0]) * self.aspect_ratio
        y = 0.5 - xy[..., 1]
        x = xp.full(z.shape, 1.0 / self.sf, dtype=z.dtype)
        return xyz_to_lonlat(xp.stack([x, y, z], axis=-1), xp=xp)

    def _obj_to_image(self, lonlat, xp):
        xyz = lonlat_to_xyz(lonlat, xp=xp)
        y_ = xyz[..., 1] / (self.sf * xyz[..., 0])
        z_ = xyz[..., 2] / (self.sf * xyz[..., 0])
        return xp.stack([0.5 - z_ / self.aspect_ratio, 0.5 - y_], axis=-1)


class StupidOval(Camera):
    """Oval 2:1 projection, lon scaled by cos(lat) (cameras/stupidoval.hpp)."""

    def get_aspect_ratio(self):
        return 2.0

    def _obj_to_image(self, lonlat, xp):
        x = xp.cos(lonlat[..., 1]) * lonlat[..., 0] / (2.0 * PI) + 0.5
        y = -lonlat[..., 1] / PI + 0.5
        return xp.stack([x, y], axis=-1)

    def _image_to_obj(self, xy, xp):
        lat = (0.5 - xy[..., 1]) * PI
        lon = (xy[..., 0] - 0.5) * 2.0 * PI / xp.cos(lat)
        nan = xp.full(lon.shape, np.nan, dtype=lon.dtype)
        lon = xp.where((lon < -PI) | (lon > PI), nan, lon)
        return xp.stack([lon, lat], axis=-1)


class Cubic(Camera):
    """Facebook-style 3x2 cube map (cameras/cubic.hpp).

    Face layout: index = row * 3 + col over a 3-wide, 2-high grid.
    """

    def get_aspect_ratio(self):
        return 1.5

    @staticmethod
    def _face_to_img(index, fx, fy, xp):
        x = (index % 3).astype(fx.dtype) / 3.0 + (fx + 1.0) / 6.0
        y = (index // 3).astype(fy.dtype) / 2.0 + (fy + 1.0) / 4.0
        return x, y

    def _obj_to_image(self, lonlat, xp):
        p = lonlat_to_xyz(lonlat, xp=xp)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        eps = 1e-2

        def within(a, b):
            return (a >= -1.0) & (a <= 1.0) & (b >= -1.0) & (b <= 1.0)

        ax = xp.abs(x)
        az = xp.abs(z)
        ay = xp.abs(y)
        # guard divisions
        sx = xp.where(ax > eps, ax, 1.0)
        sz = xp.where(az > eps, az, 1.0)
        sy = xp.where(ay > eps, ay, 1.0)

        # x-faces (0: +x, 1: -x)
        px_y, px_z = y / sx, z / sx
        ok_x = (ax > eps) & within(px_y, px_z)
        idx_x = xp.where(x < 0, 1, 0)
        fx_x = xp.where(x < 0, -px_z, px_z)
        fy_x = px_y

        # z-faces (4: -z, 5: +z)
        pz_x, pz_y = x / sz, y / sz
        ok_z = (az > eps) & within(pz_x, pz_y)
        idx_z = xp.where(z < 0, 4, 5)
        fx_z = xp.where(z < 0, pz_x, -pz_x)
        fy_z = pz_y

        # y-faces (2: -y, 3: +y)
        py_x, py_z = x / sy, z / sy
        ok_y = (ay > eps) & within(py_x, py_z)
        idx_y = xp.where(y < 0, 2, 3)
        fx_y = py_x
        fy_y = xp.where(y < 0, -py_z, py_z)

        # priority: x faces, then z, then y (cubic.hpp:46-80)
        index = xp.where(ok_x, idx_x, xp.where(ok_z, idx_z, idx_y))
        fx = xp.where(ok_x, fx_x, xp.where(ok_z, fx_z, fx_y))
        fy = xp.where(ok_x, fy_x, xp.where(ok_z, fy_z, fy_y))
        ok = ok_x | ok_z | ok_y

        ix, iy = self._face_to_img(index, fx, fy, xp)
        nan = xp.full(ix.shape, np.nan, dtype=ix.dtype)
        return xp.stack(
            [xp.where(ok, ix, nan), xp.where(ok, iy, nan)], axis=-1
        )

    def _image_to_obj(self, xy, xp):
        x, y = xy[..., 0], xy[..., 1]
        index_y = xp.where(y >= 0.5, 1, 0)
        index_x = xp.where(x >= 2.0 / 3.0, 2, xp.where(x >= 1.0 / 3.0, 1, 0))
        face = index_y * 3 + index_x
        fx = (x - index_x.astype(x.dtype) / 3.0) * 6.0 - 1.0
        fy = (y - index_y.astype(y.dtype) / 2.0) * 4.0 - 1.0
        one = xp.ones_like(fx)

        # per-face xyz (cubic.hpp:86-103)
        cand = [
            xp.stack([one, fy, fx], axis=-1),        # 0: +x
            xp.stack([-one, fy, -fx], axis=-1),      # 1: -x
            xp.stack([fx, -one, -fy], axis=-1),      # 2: -y
            xp.stack([fx, one, fy], axis=-1),        # 3: +y
            xp.stack([fx, fy, -one], axis=-1),       # 4: -z
            xp.stack([-fx, fy, one], axis=-1),       # 5: +z
        ]
        xyz = cand[0]
        for i in range(1, 6):
            xyz = xp.where((face == i)[..., None], cand[i], xyz)
        return xyz_to_lonlat(xyz, xp=xp)


class EqareaNorthPole(Camera):
    """Equal-area polar cap above the arctic circle
    (cameras/eqareanorthpole.hpp)."""

    circle_key = "arctic_circle"
    default_circle = PI / 3

    def __init__(self, options):
        super().__init__(options)
        self.circle = float(options.get(self.circle_key, self.default_circle))

    def get_aspect_ratio(self):
        return 1.0

    def _obj_to_image(self, lonlat, xp):
        lon, lat = lonlat[..., 0], lonlat[..., 1]
        rho = (PI / 2 - lat) / (PI / 2 - self.circle)
        x = -rho * xp.sin(lon) / 2 + 0.5
        y = -rho * xp.cos(lon) / 2 + 0.5
        nan = xp.full(x.shape, np.nan, dtype=x.dtype)
        bad = lat < self.circle
        return xp.stack(
            [xp.where(bad, nan, x), xp.where(bad, nan, y)], axis=-1
        )

    def _image_to_obj(self, xy, xp):
        dx = xy[..., 0] - 0.5
        dy = xy[..., 1] - 0.5
        rho = xp.sqrt(dx * dx + dy * dy) * 2
        lat = PI / 2 - (PI / 2 - self.circle) * rho
        lon = xp.arctan2(-dx, -dy)
        return xp.stack([lon, lat], axis=-1)


class EqareaSouthPole(Camera):
    """Equal-area polar cap below the antarctic circle
    (cameras/eqareasouthpole.hpp)."""

    circle_key = "antarctic_circle"
    default_circle = -PI / 3

    def __init__(self, options):
        super().__init__(options)
        self.circle = float(options.get(self.circle_key, self.default_circle))

    def get_aspect_ratio(self):
        return 1.0

    def _obj_to_image(self, lonlat, xp):
        lon, lat = lonlat[..., 0], lonlat[..., 1]
        rho = (lat + PI / 2) / (self.circle + PI / 2)
        x = rho * xp.sin(lon) / 2 + 0.5
        y = -rho * xp.cos(lon) / 2 + 0.5
        nan = xp.full(x.shape, np.nan, dtype=x.dtype)
        bad = lat > self.circle
        return xp.stack(
            [xp.where(bad, nan, x), xp.where(bad, nan, y)], axis=-1
        )

    def _image_to_obj(self, xy, xp):
        dx = xy[..., 0] - 0.5
        dy = xy[..., 1] - 0.5
        rho = xp.sqrt(dx * dx + dy * dy) * 2
        lat = -PI / 2 + (self.circle + PI / 2) * rho
        lon = xp.arctan2(dx, -dy)
        return xp.stack([lon, lat], axis=-1)
