"""The port's yuv420 pipeline with the options beyond multiband and
global gains, against the JAX Mapper(pipeline="yuv420") in f32 on the
small two-fisheye rig of tests/test_torch_mapper.py.  The JAX yuv420
Mapper runs its Pallas kernels in interpret mode on the CPU, at some
20 s of compile per Mapper, so each case combines several options:
feather, NV12, an overlay in a size group of its own and output scaling
(FastMapper); the no-blend paste with blocks gains and the overlay.

Bars (the Mapper bars): Y and UV mean abs < 0.2, max <= 2, gains
within 1e-3."""

import numpy as np
import pytest
import torch

from octvr_tpu.stitch import FastMapper as JaxFastMapper
from octvr_tpu.stitch import Mapper as JaxMapper
from octvr_tpu.template import compile_rig
from octvr_tpu_torch.stitch import FastMapper, Mapper
from test_stitch import render_camera_frames
from test_torch_mapper import _assert_close, _rig, nv12, overlay_rig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rig_ov():
    """256x128 canvas, two 256^2 fisheyes with skewed exposures, and
    input 0 again as a 192^2 overlay input."""
    rig = _rig()
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    frames = render_camera_frames(rig, exposure_gains=[1.15, 0.85])
    return overlay_rig(mt, frames)


def test_yuv420_fast_mapper_feather_nv12_overlay_scaled(rig_ov):
    mt, sizes, frames = rig_ov
    frames = [nv12(f) for f in frames]
    kw = {"pipeline": "yuv420", "scale_output": (128, 64)}
    ref = np.asarray(JaxFastMapper(mt, sizes, **kw).stitch_nv12(frames))
    m = FastMapper(mt, sizes, device="cpu", **kw)
    assert m.plan.blend_kind == "feather" and m.plan.overlays
    assert len(m.plan.group_idx) == 2
    out = m.stitch_nv12(frames)
    assert out.shape == ref.shape == (96, 128)
    _assert_close(out, ref)


def test_yuv420_paste_blocks_gains_overlay(rig_ov):
    """No blend (later inputs overwrite earlier ones), blocks gains
    sampled on the luma and on the chroma grid, the overlay pasted
    last."""
    mt, sizes, frames = rig_ov
    kw = {"blend": 0, "enable_gain": "blocks", "pipeline": "yuv420"}
    ref, g_ref = JaxMapper(mt, sizes, blend_dtype="float32", **kw).stitch(frames)
    m = Mapper(mt, sizes, device="cpu", **kw)
    assert m.plan.blend_kind == "none" and m.plan.gain_blocks is not None
    out, g = m.stitch(frames)
    _assert_close(out, np.asarray(ref))
    assert np.array_equal(g.numpy(), np.asarray(g_ref))  # ones: blocks gains are maps
    # the gain maps act: the same stitch with the gains off differs
    plain, _ = Mapper(mt, sizes, blend=0, enable_gain=False, pipeline="yuv420",
                      device="cpu").stitch(frames)
    assert (plain.float() - out.float()).abs()[:128].mean() > 1.0
