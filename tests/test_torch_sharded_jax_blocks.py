"""The port's band-sharded stitcher against the JAX package's on the
yuv420 pipeline with blocks gains, the averaged paste (blend 0), NV12
frames in and out and ``scale_output=(192, 96)``, on the two-fisheye
rig of tests/test_sharded.py at make_mesh(1, 4), both in f32, at the
Mapper bars: Y and UV mean abs < 0.2, max <= 2.  The JAX mapper runs its
Pallas remap in interpret mode, so it is built once."""

import numpy as np
import pytest
import torch

from sharded_fixtures import fisheye_rig, mapper_bar_errors, nv12_frames, stitch_both

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both():
    mt, sizes, frames = fisheye_rig()
    kw = dict(blend=0, enable_gain="blocks", frame_format="nv12", scale_output=(192, 96))
    return (mt,) + stitch_both(mt, sizes, nv12_frames(frames), 4, **kw)


def test_same_plan(both):
    _, jsm, sm, _, _ = both
    assert sm.plan.gain_blocks is not None and sm.plan.blend_kind == "none"
    for f in ("cover", "N", "A_static", "b"):
        assert np.array_equal(getattr(sm.plan.gain_blocks, f).numpy(), getattr(jsm.plan.gain_blocks, f))
    assert (sm.plan.obh, sm.plan.oW, sm.plan.halo) == (jsm.plan.obh, jsm.plan.oW, jsm.plan.halo)
    for k in ("y0", "y1", "fy"):
        assert np.array_equal(sm.plan.resize_v[k].numpy(), jsm.plan.resize_v[k])


def test_nv12_canvas_matches_jax(both):
    _, _, _, (ref, _), (got, _) = both
    assert got.shape == ref.shape == (96 * 3 // 2, 192) and got.dtype == ref.dtype == np.uint8
    y_mean, y_max, uv_mean, uv_max = mapper_bar_errors(got, ref, 96)
    print(f"yuv420 blocks + paste + nv12 + scale: Y mean {y_mean:.4f} max {y_max}, "
          f"UV mean {uv_mean:.4f} max {uv_max}")
    assert y_mean < 0.2 and uv_mean < 0.2 and y_max <= 2 and uv_max <= 2


def test_blocks_gains_are_ones(both):
    """Blocks gains return ones, as the JAX package's do: the gain maps
    act inside the stitch."""
    _, _, _, (_, g_ref), (_, g) = both
    assert np.array_equal(g_ref, np.ones(2, np.float32)) and np.array_equal(g, g_ref)
