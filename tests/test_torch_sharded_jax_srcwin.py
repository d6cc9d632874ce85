"""The port's band-sharded stitcher against the JAX package's with
source windows (the concat-source remap, TPU kernel 6), on the
six-camera 240^2 -> 480x240 rig of tests/test_sharded_srcwin.py at
make_mesh(1, 4), blend 32, both yuv420 in f32, at the Mapper bars: Y and
UV mean abs < 0.2, max <= 2, gains within 1e-3.  The JAX mapper runs its
Pallas remap in interpret mode, so it is built once."""

import numpy as np
import pytest
import torch

from sharded_fixtures import mapper_bar_errors, six_cam_small, stitch_both

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both():
    mt, sizes, frames = six_cam_small()
    return (mt,) + stitch_both(mt, sizes, frames, 4, blend=32, enable_gain=True, src_windows=True)


def test_both_take_the_concat_source_layout(both):
    """Side cameras sliced, poles whole, one concat launch per plane."""
    _, jsm, sm, _, _ = both
    assert any(rp.concat_heights for rp in jsm.plan.remap_groups)
    assert sm.plan.src_h == jsm.plan.src_h and any(h < 240 for h in sm.plan.src_h)
    assert np.array_equal(sm.plan.src_row0, jsm.plan.src_row0)
    assert sm.plan.remap.concat and sm.plan.remap_uv.concat


def test_canvas_matches_jax(both):
    mt, _, _, (ref, _), (got, _) = both
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    y_mean, y_max, uv_mean, uv_max = mapper_bar_errors(got, ref, mt.out_size[1])
    print(f"six cameras S=4, source windows: Y mean {y_mean:.4f} max {y_max}, UV mean {uv_mean:.4f} max {uv_max}")
    assert y_mean < 0.2 and uv_mean < 0.2 and y_max <= 2 and uv_max <= 2


def test_gains_match_jax(both):
    _, _, _, (_, g_ref), (_, g) = both
    assert np.abs(g - g_ref).max() < 1e-3
