"""The port's band-sharded stitcher against the JAX package's on the rgb
pipeline with a feather blend (border 8), an overlay input,
``out_format="rgb"`` and mixed camera sizes (the 256^2 + 192^2 rig of
tests/test_sharded_product.py, the overlay in the first camera's size
group) at make_mesh(1, 4), both in f32.  Bars: the planar RGB canvases
within mean abs 0.2 and max 2, gains within 1e-3.  The JAX mapper runs
its Pallas remap in interpret mode, so it is built once."""

import numpy as np
import pytest
import torch

from sharded_fixtures import mixed_rig, stitch_both, with_overlay

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both():
    mt, sizes, frames = with_overlay(*mixed_rig())
    kw = dict(blend=-8, enable_gain=True, out_format="rgb")
    return (mt,) + stitch_both(mt, sizes, frames, 4, pipeline="rgb", **kw)


def test_same_plan(both):
    """Two size groups (the 192^2 camera alone; the 256^2 camera with
    the overlay), no band pyramids, the overlay's paste masks."""
    _, jsm, sm, _, _ = both
    assert sm.plan.group_idx == jsm.plan.group_idx == ((0, 2), (1,))
    assert len(sm.plan.remap_groups) == 2 and sm.plan.remap is None
    assert sm.plan.blend_kind == "feather" and sm.plan.weight_pyrs is None
    assert np.array_equal(sm.plan.overlay_masks.numpy(), jsm.plan.overlay_masks)


def test_rgb_canvas_matches_jax(both):
    mt, jsm, _, (ref, _), (got, _) = both
    S, obh, oW = jsm.plan.S, jsm.plan.obh, jsm.plan.oW
    assert got.shape == ref.shape == (3, S * obh, oW) and got.dtype == ref.dtype == np.float32
    d = np.abs(got - ref)
    print(f"rgb feather + overlay + mixed sizes: mean {d.mean():.4f} max {d.max():.3f}")
    assert d.mean() < 0.2 and d.max() <= 2


def test_gains_match_jax(both):
    _, _, _, (_, g_ref), (_, g) = both
    assert not np.allclose(g_ref, 1.0)
    assert np.abs(g - g_ref).max() < 1e-3
