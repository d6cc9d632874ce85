"""Camera model registry.

Replaces the reference's Camera::New string factory (camera.cpp:27-47) with
a plain dict registry.  All models accept a parsed rig-JSON options dict.
The port's copy of octvr_tpu/cameras (numpy); the feature warpers of
registration (cameras/warpers.py) are not in the port yet.
"""

from .base import Camera
from .fisheye import (
    FisheyeCamera,
    FullFrameFisheyeCamera,
    OcamFisheyeCamera,
    PinholeCamera,
)
from .models import (
    Cubic,
    EqareaNorthPole,
    EqareaSouthPole,
    Equirectangular,
    Normal,
    PerspectiveCamera,
    StupidOval,
)

REGISTRY = {
    "normal": Normal,
    "perspective": PerspectiveCamera,
    "pinhole": PinholeCamera,
    "fisheye": FisheyeCamera,
    "equirectangular": Equirectangular,
    "fullframe_fisheye": FullFrameFisheyeCamera,
    "ocam_fisheye": OcamFisheyeCamera,
    "stupidoval": StupidOval,
    "cubic": Cubic,
    "eqareanorthpole": EqareaNorthPole,
    "eqareasouthpole": EqareaSouthPole,
}


def new_camera(cam_type: str, options: dict) -> Camera:
    try:
        cls = REGISTRY[cam_type]
    except KeyError:
        raise ValueError(f"unknown camera type {cam_type!r}") from None
    return cls(options)


__all__ = ["Camera", "REGISTRY", "new_camera"]
