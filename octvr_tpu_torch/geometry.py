"""Spherical geometry primitives shared by every camera model.

Coordinate conventions (identical to the reference engine, see
modules/octvr/src/camera.hpp:33-43):

  * left-handed system, viewed from inside the sphere
  * x axis -> right, points at the center of the equirectangular image
  * y axis -> up
  * z axis -> inward
  * (1, 0, 0)  is (lon, lat) = (0, 0)
  * (0, 1, 0)  is lat = +pi/2
  * (0, 0, 1)  is (lon, lat) = (-pi/2, 0)

The port's copy of octvr_tpu/geometry.py, for its own offline stage: the
functions keep the generic array namespace ``xp`` of the original, and
the port calls them with float64 NumPy only.  Arrays of points use a
trailing axis of size 2 (lon, lat) or (x, y), or 3 (xyz).
"""

import math

import numpy as np

__all__ = [
    "lonlat_to_xyz",
    "xyz_to_lonlat",
    "rotation_matrix_from_rpy",
    "rotate_points",
]


def lonlat_to_xyz(lonlat, xp=np):
    """(lon, lat) -> unit xyz.  Mirrors camera.cpp:194-200."""
    lon = lonlat[..., 0]
    lat = lonlat[..., 1]
    coslat = xp.cos(lat)
    return xp.stack(
        [xp.cos(lon) * coslat, xp.sin(lat), -xp.sin(lon) * coslat], axis=-1
    )


def xyz_to_lonlat(xyz, xp=np):
    """xyz -> (lon, lat); normalizes first.  Mirrors camera.cpp:189-192."""
    norm = xp.sqrt(xp.sum(xyz * xyz, axis=-1, keepdims=True))
    p = xyz / norm
    lon = xp.arctan2(-p[..., 2], p[..., 0])
    lat = xp.arcsin(xp.clip(p[..., 1], -1.0, 1.0))
    return xp.stack([lon, lat], axis=-1)


def _axis_rotation(axis: int, angle: float) -> np.ndarray:
    """Rotation matrix about a coordinate axis (Rodrigues of an axis-aligned
    rotation vector)."""
    c, s = math.cos(angle), math.sin(angle)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def rotation_matrix_from_rpy(roll: float, yaw: float, pitch: float) -> np.ndarray:
    """Camera rotation from roll/yaw/pitch.

    The reference builds rotate_vector = (roll, -yaw, -pitch) and composes
    R = Rx(roll) @ Rz(-pitch) @ Ry(-yaw)  (camera.cpp:49-64).
    """
    rx = _axis_rotation(0, roll)
    ry = _axis_rotation(1, -yaw)
    rz = _axis_rotation(2, -pitch)
    return (rx @ rz) @ ry


def rotate_points(points, rmat, xp=np):
    """Apply a 3x3 rotation to [..., 3] points (row-vector convention:
    p' = p @ R^T, matching camera.cpp:202-210)."""
    rmat = xp.asarray(rmat, dtype=points.dtype)
    return points @ rmat.T
