"""Offline template compiler.

Builds per-input remap tables, masks, ROIs, seam masks and vignette maps
from a rig description — the MapperTemplate of the reference
(modules/octvr/src/template.cpp) re-designed as vectorized NumPy f64 math
(the offline path never touches the card; its *artifacts* feed the online
path as constants).  The port's copy of octvr_tpu/template/compiler.py:
seam masks by the distance seam finder; the image-driven finders
(graph cut, dp) are not in the port yet.
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..cameras import new_camera
from ..ops.resize import resize_bilinear_host
from ..vignette import vignette_map
from .seam import distance_seam_find

ROI_PAD = 8  # template.cpp:124-133
SEAM_WORK_WIDTH = 960.0  # template.cpp:158

__all__ = ["TemplateInput", "MapperTemplate", "compile_rig"]


@dataclass
class TemplateInput:
    roi: Tuple[int, int, int, int]  # x, y, w, h on the output canvas
    map1: np.ndarray  # f32 [rh, rw] normalized input x, -1 where invalid
    map2: np.ndarray  # f32 [rh, rw] normalized input y
    mask: np.ndarray  # u8  [rh, rw]
    vignette: Optional[np.ndarray]  # f32 [512, 512] gain map or None


@dataclass
class MapperTemplate:
    out_size: Tuple[int, int]  # (width, height)
    out_type: str = "equirectangular"
    out_opts: dict = field(default_factory=dict)
    inputs: List[TemplateInput] = field(default_factory=list)
    overlay_inputs: List[TemplateInput] = field(default_factory=list)
    seam_masks: List[np.ndarray] = field(default_factory=list)

    # build-time state
    _visible_mask: Optional[np.ndarray] = None
    _output_cam: object = None
    _out_lonlat: Optional[np.ndarray] = None
    _input_cams: List = field(default_factory=list)

    # ------------------------------------------------------------ building

    @classmethod
    def create(cls, out_type: str, out_opts: dict, width: int, height: int):
        cam = new_camera(out_type, out_opts)
        if width <= 0 and height <= 0:
            raise ValueError("output width/height invalid")
        ar = cam.get_aspect_ratio()
        if height <= 0:
            height = int(width / ar)
        if width <= 0:
            width = int(height * ar)
        mt = cls(out_size=(width, height), out_type=out_type, out_opts=out_opts)
        mt._output_cam = cam
        mt._visible_mask = np.zeros((height, width), dtype=bool)
        return mt

    def _output_lonlat(self):
        """Sphere coordinates of every output pixel (cached).  The grid uses
        x = i/W, y = j/H exactly like template.cpp:53-60."""
        if self._out_lonlat is None:
            w, h = self.out_size
            xs = np.arange(w, dtype=np.float64) / w
            ys = np.arange(h, dtype=np.float64) / h
            grid = np.stack(np.meshgrid(xs, ys), axis=-1)  # [h, w, 2]
            self._out_lonlat = self._output_cam.image_to_obj(grid)
        return self._out_lonlat

    def add_input(self, cam_type: str, cam_opts: dict, overlay=False, use_roi=True):
        """Project every output pixel through the input camera; build
        map1/map2/mask, tighten the ROI, apply include-mask priority
        (template.cpp:46-153)."""
        cam = new_camera(cam_type, cam_opts)
        w, h = self.out_size
        lonlat = self._output_lonlat()

        xy = cam.obj_to_image(lonlat)  # [h, w, 2], NaN = invalid
        visible = cam.get_include_mask(lonlat)  # [h, w] bool or None

        x = xy[..., 0].astype(np.float32)
        y = xy[..., 1].astype(np.float32)
        finite = np.isfinite(x) & np.isfinite(y)
        inb = finite & (x >= 0) & (x < 1) & (y >= 0) & (y < 1)

        valid = inb & ~self._visible_mask  # prior force-visible pixels win
        mask = np.where(valid, np.uint8(255), np.uint8(0))
        map1 = np.where(valid, x, np.float32(-1.0))
        map2 = np.where(valid, y, np.float32(-1.0))

        if valid.sum() == 0:
            raise ValueError("input does not cover any output pixel")

        rows = np.flatnonzero(valid.any(axis=1))
        cols = np.flatnonzero(valid.any(axis=0))
        min_h, max_h = int(rows[0]), int(rows[-1])
        min_w, max_w = int(cols[0]), int(cols[-1])
        min_w = max(0, min_w - ROI_PAD)
        min_h = max(0, min_h - ROI_PAD)
        max_w = min(w - 1, max_w + ROI_PAD)
        max_h = min(h - 1, max_h + ROI_PAD)
        roi = (min_w, min_h, max_w + 1 - min_w, max_h + 1 - min_h)
        if not use_roi:
            roi = (0, 0, w, h)

        if visible is not None:
            newly = visible & ~self._visible_mask
            # zero prior non-overlay inputs' masks where this input demands
            # visibility (include-mask priority, template.cpp:100-118)
            for prior in self.inputs:
                px, py, pw, ph = prior.roi
                sub = newly[py : py + ph, px : px + pw]
                prior.mask[sub] = 0
            self._visible_mask |= visible

        rx, ry, rw, rh = roi
        inp = TemplateInput(
            roi=roi,
            map1=map1[ry : ry + rh, rx : rx + rw],
            map2=map2[ry : ry + rh, rx : rx + rw],
            mask=mask[ry : ry + rh, rx : rx + rw],
            vignette=vignette_map(cam_opts),
        )
        (self.overlay_inputs if overlay else self.inputs).append(inp)
        self._input_cams.append(cam)
        return inp

    # ---------------------------------------------------------- seam masks

    def create_masks(self, imgs=None, seam="auto"):
        """Compute seam masks at <=960 px working width (template.cpp:155-204)
        with the distance seam finder.  ``seam``: "auto" or "distance"
        without images, as in octvr_tpu; the image-driven finders of the
        original ("graphcut", "dp" and their *_grad variants, and "auto"
        with images) are not in the port yet."""
        w, h = self.out_size
        scale = min(1.0, SEAM_WORK_WIDTH / w)

        scaled, corners = [], []
        for inp in self.inputs:
            rx, ry, rw, rh = inp.roi
            sw, sh = int(rw * scale), int(rh * scale)
            corners.append((int(rx * scale), int(ry * scale)))
            scaled.append(resize_bilinear_host(inp.mask, sh, sw))

        if seam == "auto":
            seam = "graphcut" if imgs else "distance"
        if seam != "distance":
            raise NotImplementedError(
                f"seam kind {seam!r}: the image-driven seam finders are not in the port "
                "(ROADMAP queue 1 item 13)"
            )
        seams = distance_seam_find(scaled, corners, max_n=1)

        self.seam_masks = []
        for inp, sm in zip(self.inputs, seams):
            _, _, rw, rh = inp.roi
            self.seam_masks.append(resize_bilinear_host(sm, rh, rw))
        return self.seam_masks


def _remap_image_cpu(img: np.ndarray, map1: np.ndarray, map2: np.ndarray):
    """Bilinear gather of ``img`` at normalized map coordinates (CPU/NumPy,
    offline use: seam-finding sources, golden references)."""
    h, w = img.shape[:2]
    px = map1.astype(np.float64) * w - 0.5
    py = map2.astype(np.float64) * h - 0.5
    invalid = (map1 < 0) | (map2 < 0)
    x0 = np.clip(np.floor(px).astype(np.int64), 0, w - 1)
    y0 = np.clip(np.floor(py).astype(np.int64), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    fx = np.clip(px - np.floor(px), 0.0, 1.0)[..., None]
    fy = np.clip(py - np.floor(py), 0.0, 1.0)[..., None]
    im = img.astype(np.float64)
    if im.ndim == 2:
        im = im[..., None]
    out = (
        im[y0, x0] * (1 - fx) * (1 - fy)
        + im[y0, x1] * fx * (1 - fy)
        + im[y1, x0] * (1 - fx) * fy
        + im[y1, x1] * fx * fy
    )
    out[invalid] = 0
    if img.ndim == 2:
        out = out[..., 0]
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), 0, 255).astype(img.dtype)
    return out


def compile_rig(rig: dict, width: int, height: int = 0) -> MapperTemplate:
    """rig JSON (reference schema, modules/octvr/readme.md:32-81) ->
    compiled template.  ``rig`` = {"output": {...}, "inputs": [...],
    "overlay_inputs": [...]}."""
    out = rig["output"]
    mt = MapperTemplate.create(out["type"], out.get("options", {}), width, height)
    for inp in rig.get("inputs", []):
        mt.add_input(inp["type"], inp.get("options", {}), overlay=False)
    # the reference CLI uses the key "overlays" (dump.cpp:87)
    for inp in rig.get("overlays", rig.get("overlay_inputs", [])):
        mt.add_input(inp["type"], inp.get("options", {}), overlay=True)
    return mt
