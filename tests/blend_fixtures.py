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
