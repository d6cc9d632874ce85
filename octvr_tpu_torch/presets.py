"""Output projection presets — the OwlLive GUI's projection modes
(apps/livestitching/projection_modes.cpp:11-113): each mode is a list of
canvas regions, every region carrying its own output camera spec, blend/
gain enables and eye index (for stereo rigs with per-eye templates).

`build_region_outputs` turns a mode into per-region (rig-output spec,
pixel rect, blend, gain_mode, eye); `RegionComposer` pastes the stitched
region frames into the final canvas.  The port's numpy copy of
octvr_tpu/presets.py.
"""

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

PI = math.pi

__all__ = [
    "Region",
    "PROJECTION_MODES",
    "build_region_outputs",
    "RegionComposer",
]


@dataclass
class Region:
    rect: tuple  # (x, y, w, h) as fractions of the canvas
    blend: bool
    gain: bool
    eye: int
    out_type: str
    out_opts: dict


PROJECTION_MODES = {
    "mono360": dict(
        aspect=2.0,
        regions=[
            Region((0.0, 0.0, 1.0, 1.0), True, True, 0, "equirectangular", {}),
        ],
    ),
    # over/under full equirect stereo
    "3dv": dict(
        aspect=1.0,
        regions=[
            Region((0.0, 0.0, 1.0, 0.5), True, True, 0, "equirectangular", {}),
            Region((0.0, 0.5, 1.0, 0.5), True, True, 1, "equirectangular", {}),
        ],
    ),
    # 2304x1024-style stereo cylinder slice + equal-area polar caps
    "cylinder_slice_2x25_3dv": dict(
        aspect=2304.0 / 1024.0,
        regions=[
            Region(
                (0.0, 0.0, 2048 / 2304, 0.5),
                True,
                True,
                0,
                "equirectangular",
                {"max_lat": PI / 4, "min_lat": -PI / 4},
            ),
            Region(
                (2048 / 2304, 0.0, 256 / 2304, 0.25),
                False,
                False,
                0,
                "eqareanorthpole",
                {"arctic_circle": PI / 4},
            ),
            Region(
                (2048 / 2304, 0.25, 256 / 2304, 0.25),
                False,
                False,
                0,
                "eqareasouthpole",
                {"antarctic_circle": -PI / 4},
            ),
            Region(
                (0.0, 0.5, 2048 / 2304, 0.5),
                True,
                True,
                1,
                "equirectangular",
                {"max_lat": PI / 4, "min_lat": -PI / 4},
            ),
            Region(
                (2048 / 2304, 0.5, 256 / 2304, 0.25),
                False,
                False,
                1,
                "eqareanorthpole",
                {"arctic_circle": PI / 4},
            ),
            Region(
                (2048 / 2304, 0.75, 256 / 2304, 0.25),
                False,
                False,
                1,
                "eqareasouthpole",
                {"antarctic_circle": -PI / 4},
            ),
        ],
    ),
}


def build_region_outputs(mode_name: str, width: int, height: int = 0):
    """Returns (canvas_size, list of dicts): each entry has the pixel
    rect, the output spec for compile_rig, blend flag, gain mode (first
    gain-enabled region per eye solves; later ones copy it — the
    async.cpp:75-91 sharing), and eye index."""
    mode = PROJECTION_MODES[mode_name]
    if height <= 0:
        height = int(round(width / mode["aspect"]))
    outs = []
    eye_gain_owner = {}
    for k, reg in enumerate(mode["regions"]):
        x, y, w, h = reg.rect
        rect = (
            int(round(x * width)),
            int(round(y * height)),
            int(round(w * width)),
            int(round(h * height)),
        )
        if reg.gain:
            gain_mode = eye_gain_owner.setdefault(reg.eye, k)
        else:
            gain_mode = -1
        outs.append(
            dict(
                rect=rect,
                output={"type": reg.out_type, "options": dict(reg.out_opts)},
                blend=reg.blend,
                gain_mode=gain_mode,
                eye=reg.eye,
            )
        )
    return (width, height), outs


class RegionComposer:
    """Paste per-region stitched frames (RGB or YUV-converted) into the
    final canvas."""

    def __init__(self, canvas_size, rects):
        self.canvas_size = canvas_size  # (W, H)
        self.rects = rects

    def compose(self, region_frames):
        w, h = self.canvas_size
        canvas = np.zeros((h, w, 3), dtype=np.uint8)
        for frame, (x, y, rw, rh) in zip(region_frames, self.rects):
            f = np.asarray(frame)
            assert f.shape[0] == rh and f.shape[1] == rw, (
                f"region frame {f.shape} != rect {(rh, rw)}"
            )
            canvas[y : y + rh, x : x + rw] = f
        return canvas
