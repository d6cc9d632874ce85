"""Camera model base: sphere <-> image mapping with rotation, masks and
longitude windowing.

Functional re-design of the reference's vr::Camera (camera.{hpp,cpp}):
each model supplies a pair of vectorized pure functions

    _image_to_obj(xy, xp)    : [..., 2] in [0,1)  ->  [..., 2] (lon, lat)
    _obj_to_image(lonlat, xp): [..., 2] (lon,lat) ->  [..., 2] in [0,1) or NaN

and the base class composes rotation / longitude window / exclude masks
around them exactly like camera.cpp:212-315.  The port's copy of
octvr_tpu/cameras/base.py; its offline stage calls it with numpy (f64).
"""

import math

import numpy as np

from ..geometry import (
    lonlat_to_xyz,
    rotate_points,
    rotation_matrix_from_rpy,
    xyz_to_lonlat,
)
from ..utils.raster import fill_poly, fill_rect

__all__ = ["Camera"]


class Camera:
    """Base camera.  Subclasses implement _obj_to_image / _image_to_obj
    (either may raise NotImplementedError, mirroring the reference)."""

    def __init__(self, options: dict):
        self.options = options

        if "rotation" in options:
            rot = options["rotation"]
            self.rotate_matrix = rotation_matrix_from_rpy(
                rot["roll"], rot["yaw"], rot["pitch"]
            )
        else:
            self.rotate_matrix = np.eye(3)

        if "rotation_matrix" in options:
            self.rotate_matrix = np.array(
                options["rotation_matrix"], dtype=np.float64
            ).reshape(3, 3)

        # masks apply to the input direction (obj_to_image) only
        self.exclude_mask = None  # uint8 HxW; nonzero = excluded
        self.include_mask = None  # uint8 HxW; nonzero = forced-visible

        def prepare(initial):
            w = int(options["width"])
            h = int(options["height"])
            return np.full((h, w), initial, dtype=np.uint8)

        if "selection" in options:
            # exclude everything outside the selection rect (camera.cpp:96-112)
            self.exclude_mask = prepare(255)
            left, right, top, bottom = (int(v) for v in options["selection"])
            fill_rect(self.exclude_mask, left, right, top, bottom, 0)

        if "exclude_masks" in options:
            if self.exclude_mask is None:
                self.exclude_mask = prepare(0)
            if self.include_mask is None:
                self.include_mask = prepare(0)
            self._draw_mask(options["exclude_masks"])

        if "include_masks" in options:
            if self.include_mask is None:
                self.include_mask = prepare(0)
            self._draw_mask(options["include_masks"], include=True)

        if "longitude_selection" in options:
            # max may exceed +pi to express wrapped windows (camera.cpp:125-135)
            self.min_longitude = float(options["longitude_selection"][0])
            self.max_longitude = float(options["longitude_selection"][1])
            assert self.max_longitude > self.min_longitude
        else:
            self.min_longitude = -math.pi
            self.max_longitude = math.pi

    # ------------------------------------------------------------------ masks

    def _draw_mask(self, areas, include=False):
        for area in areas:
            kind = area["type"]
            if kind == "polygonal":
                args = area["args"]
                pts = [(int(args[i]), int(args[i + 1])) for i in range(0, len(args), 2)]
                target = self.include_mask if include else self.exclude_mask
                fill_poly(target, pts, 255)
            elif kind == "png":
                from ..utils.png import decode_png

                data = bytes(bytearray(int(v) & 0xFF for v in area["args"]))
                img = decode_png(data)  # HxWxC, RGB(A)
                assert img.shape[:2] == self.exclude_mask.shape
                # red channel -> exclude, green channel -> include
                self.exclude_mask[img[..., 0] > 0] = 255
                self.include_mask[img[..., 1] > 0] = 255
            else:
                raise ValueError(f"unknown mask type {kind!r}")

    # ------------------------------------------------------- per-model hooks

    def get_aspect_ratio(self) -> float:
        return 1.0

    def _obj_to_image(self, lonlat, xp):
        raise NotImplementedError

    def _image_to_obj(self, xy, xp):
        raise NotImplementedError

    # ------------------------------------------------------------ public API

    def _is_valid_longitude(self, lon, xp):
        lo, hi = self.min_longitude, self.max_longitude
        valid = xp.zeros(lon.shape, dtype=bool)
        for k in (-2, -1, 0, 1, 2):
            shifted = lon + 2.0 * math.pi * k
            valid = valid | ((shifted >= lo) & (shifted <= hi))
        return valid

    def obj_to_image(self, lonlat, xp=np):
        """Sphere -> input-image coordinates.  Mirrors camera.cpp:212-253:
        rotate, per-model projection, longitude-window and exclude-mask
        filtering (invalid points become NaN)."""
        xyz = lonlat_to_xyz(lonlat, xp=xp)
        valid = self._is_valid_longitude(lonlat[..., 0], xp)
        xyz = rotate_points(xyz, self.rotate_matrix, xp=xp)
        ll = xyz_to_lonlat(xyz, xp=xp)
        p = self._obj_to_image(ll, xp)
        nan2 = xp.full_like(p, np.nan)
        p = xp.where(valid[..., None], p, nan2)
        if self.exclude_mask is not None:
            h, w = self.exclude_mask.shape
            inb = (
                (p[..., 0] >= 0)
                & (p[..., 0] < 1)
                & (p[..., 1] >= 0)
                & (p[..., 1] < 1)
            )
            px = xp.clip((xp.nan_to_num(p[..., 0]) * w).astype(np.int32), 0, w - 1)
            py = xp.clip((xp.nan_to_num(p[..., 1]) * h).astype(np.int32), 0, h - 1)
            mask = xp.asarray(self.exclude_mask)
            excluded = inb & (mask[py, px] > 0)
            p = xp.where(excluded[..., None], nan2, p)
        return p

    def get_include_mask(self, lonlat, xp=np):
        """Force-visible flags per point, or None if the camera carries no
        include mask.  Mirrors camera.cpp:255-294 (note: no longitude
        windowing and no exclude-mask veto on this path)."""
        if self.include_mask is None:
            return None
        xyz = lonlat_to_xyz(lonlat, xp=xp)
        xyz = rotate_points(xyz, self.rotate_matrix, xp=xp)
        ll = xyz_to_lonlat(xyz, xp=xp)
        p = self._obj_to_image(ll, xp)
        h, w = self.include_mask.shape
        inb = (
            (p[..., 0] >= 0) & (p[..., 0] < 1) & (p[..., 1] >= 0) & (p[..., 1] < 1)
        )
        px = xp.clip((xp.nan_to_num(p[..., 0]) * w).astype(np.int32), 0, w - 1)
        py = xp.clip((xp.nan_to_num(p[..., 1]) * h).astype(np.int32), 0, h - 1)
        mask = xp.asarray(self.include_mask)
        # reference quirk (camera.cpp:280-287): the include-mask lookup is
        # gated on exclude_mask being present
        if self.exclude_mask is None:
            return xp.zeros(inb.shape, dtype=bool)
        return inb & (mask[py, px] > 0)

    def image_to_obj(self, xy, xp=np):
        """Output-image -> sphere coordinates.  Mirrors camera.cpp:296-315."""
        ll = self._image_to_obj(xy, xp)
        xyz = lonlat_to_xyz(ll, xp=xp)
        rinv = np.linalg.inv(self.rotate_matrix)
        xyz = rotate_points(xyz, rinv, xp=xp)
        return xyz_to_lonlat(xyz, xp=xp)
