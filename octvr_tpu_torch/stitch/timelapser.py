"""Timelapser (stitching/src/timelapsers.cpp role): place each warped
frame onto the full panorama canvas without blending, producing one
output frame per input frame (AS_IS), or cropped to the union ROI
(CROP).  The port's numpy copy of octvr_tpu/stitch/timelapser.py.
"""

import numpy as np

__all__ = ["Timelapser"]


class Timelapser:
    AS_IS = 0
    CROP = 1

    def __init__(self, kind=AS_IS):
        self.kind = kind
        self.dst_roi = None
        self.frame = None

    def initialize(self, corners, sizes):
        """corners: (x, y) per input; sizes: (w, h) per input."""
        x0 = min(c[0] for c in corners)
        y0 = min(c[1] for c in corners)
        x1 = max(c[0] + s[0] for c, s in zip(corners, sizes))
        y1 = max(c[1] + s[1] for c, s in zip(corners, sizes))
        self.dst_roi = (x0, y0, x1 - x0, y1 - y0)

    def process(self, img, mask, corner):
        """Place one warped frame; returns the canvas ([H, W, 3] uint8)."""
        assert self.dst_roi is not None, "initialize() first"
        x0, y0, w, h = self.dst_roi
        canvas = np.zeros((h, w, 3), dtype=np.uint8)
        cx, cy = corner[0] - x0, corner[1] - y0
        ih, iw = img.shape[:2]
        sel = np.asarray(mask) > 0
        region = canvas[cy : cy + ih, cx : cx + iw]
        region[sel] = np.asarray(img, dtype=np.uint8)[sel]
        self.frame = canvas
        return canvas
