"""The port's band-sharded stitcher on the rgb pipeline (TPU kernel 6's
NC=3 launch shape) against the JAX package's, on the two-fisheye rig of
tests/test_sharded.py at make_mesh(1, 4), multiband blend 32 with the
two-level split on, both in f32, at the Mapper bars: Y and UV mean abs
< 0.2, max <= 2, gains within 1e-3.  The JAX mapper runs its Pallas
remap in interpret mode, so it is built once."""

import numpy as np
import pytest
import torch

from sharded_fixtures import fisheye_rig, mapper_bar_errors, stitch_both

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both():
    mt, sizes, frames = fisheye_rig()
    return (mt,) + stitch_both(mt, sizes, frames, 4, pipeline="rgb", blend=32, enable_gain=True)


def test_same_plan_geometry(both):
    mt, jsm, sm, _, _ = both
    assert sm.plan.pipeline == jsm.plan.pipeline == "rgb"
    assert sm.plan.split_level == jsm.plan.split_level == 2
    assert (sm.plan.bh, sm.plan.halo, sm.plan.ext) == (jsm.plan.bh, jsm.plan.halo, jsm.plan.ext)
    assert sm.plan.remap_uv is None and len(sm.plan.remap_groups) == 1


def test_canvas_matches_jax(both):
    mt, _, _, (ref, _), (got, _) = both
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    y_mean, y_max, uv_mean, uv_max = mapper_bar_errors(got, ref, mt.out_size[1])
    print(f"rgb S=4: Y mean {y_mean:.4f} max {y_max}, UV mean {uv_mean:.4f} max {uv_max}")
    assert y_mean < 0.2 and uv_mean < 0.2 and y_max <= 2 and uv_max <= 2


def test_gains_match_jax(both):
    _, _, _, (_, g_ref), (_, g) = both
    assert not np.allclose(g_ref, 1.0)  # the exposure gap is seen
    assert np.abs(g - g_ref).max() < 1e-3
