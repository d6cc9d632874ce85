"""Multiband blend scenes that import no JAX, for the port's CPU tests
(tests/test_torch_blend.py) and its on-card tests."""

import numpy as np

CANVAS = (160, 96)  # (W, H)


def blend_scene(seed, c=1, n=3, bands=3):
    """n overlapping ROIs on the canvas with random seam masks and
    smooth-plus-noise images in [0, 255]."""
    rng = np.random.default_rng(seed)
    W, H = CANVAS
    rois, masks, imgs = [], [], []
    for _ in range(n):
        w = int(rng.integers(40, 90))
        h = int(rng.integers(30, 70))
        x = int(rng.integers(0, W - w))
        y = int(rng.integers(0, H - h))
        rois.append((x, y, w, h))
        masks.append((rng.uniform(size=(h, w)) > 0.3).astype(np.uint8) * 255)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 127 + 100 * np.sin(xx / (5 + 10 * rng.uniform()) + yy / 9.0)
        imgs.append(
            np.clip(base[None] + rng.normal(0, 8, (c, h, w)), 0, 255).astype(
                np.float32
            )
        )
    return masks, rois, imgs, bands


RING_CANVAS = (640, 96)  # (W, H)


def ring_scene(seed, c=1, n=16, empty=3, bands=3):
    """n ROIs in two clusters at the ends of RING_CANVAS (the first half
    of the cameras on the left, the rest on the right), so that the
    aligned ROIs leave the middle of every band level uncovered; camera
    ``empty`` has an empty seam mask (None: none)."""
    rng = np.random.default_rng(seed)
    W, H = RING_CANVAS
    rois, masks, imgs = [], [], []
    for k in range(n):
        w = int(rng.integers(30, 50))
        h = int(rng.integers(40, 80))
        span = 150 - w
        x = int(rng.integers(0, span)) if k < n // 2 else W - w - int(rng.integers(0, span))
        y = int(rng.integers(0, H - h))
        rois.append((x, y, w, h))
        mask = (rng.uniform(size=(h, w)) > 0.3).astype(np.uint8) * 255
        masks.append(mask * 0 if k == empty else mask)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 127 + 100 * np.sin(xx / (5 + 10 * rng.uniform()) + yy / 9.0)
        imgs.append(np.clip(base[None] + rng.normal(0, 8, (c, h, w)), 0, 255).astype(np.float32))
    return masks, rois, imgs, bands
