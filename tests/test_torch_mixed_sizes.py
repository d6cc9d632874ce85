"""Mixed camera sizes: the port's yuv420 and rgb Mappers against the JAX
Mapper on the mixed rig of tests/test_yuv420_product.py (two opposing
fisheyes of different sensor sizes, blend 16, gains), shrunk to a
256x128 canvas and 240^2 + 200^2 cameras so that the JAX yuv420 Mapper's
interpret mode stays short; the two sizes stay distinct, so each
pipeline runs two size groups, each a group of one input (the shape of
the JAX package's single-input rgb kernel).

Bars (the Mapper bars): Y and UV mean abs < 0.2, max <= 2, gains
within 1e-3."""

import numpy as np
import pytest
import torch

from octvr_tpu.stitch import Mapper as JaxMapper
from octvr_tpu.template import compile_rig
from octvr_tpu_torch.stitch import Mapper
from test_stitch import render_camera_frames
from test_torch_mapper import _assert_close
from test_yuv420_product import mixed_size_rig

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mixed():
    rig = mixed_size_rig()
    for s, cam in zip(rig["inputs"], (240, 200)):
        s["options"]["width"] = s["options"]["height"] = cam
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(s["options"]["height"], s["options"]["width"]) for s in rig["inputs"]]
    frames = render_camera_frames(rig, exposure_gains=[1.15, 0.85])
    return mt, sizes, frames


@pytest.mark.parametrize("pipeline", ["yuv420", "rgb"])
def test_mixed_sizes_match_jax(mixed, pipeline):
    mt, sizes, frames = mixed
    assert len(set(sizes)) == 2
    kw = {"blend": 16, "enable_gain": True, "pipeline": pipeline}
    ref, g_ref = JaxMapper(mt, sizes, blend_dtype="float32", **kw).stitch(frames)
    m = Mapper(mt, sizes, device="cpu", **kw)
    assert m.plan.group_idx == ((0,), (1,))
    assert [g.in_shape for g in m.plan.remap_groups] == [(240, 240), (200, 200)]
    out, g = m.stitch(frames)
    _assert_close(out, np.asarray(ref))
    assert np.abs(g.numpy() - np.asarray(g_ref)).max() < 1e-3
    assert g[0] < 1.0 < g[1]  # the gains counteract the exposure skew


@pytest.mark.parametrize("enable_gain", [True, "blocks"])
def test_mixed_sizes_rgb_bf16_match_jax(mixed, enable_gain):
    """The rgb Mapper with a bf16 blend on mixed sizes: the JAX Mapper
    remaps each input into f32 there, applies the gains (or the blocks
    gain maps) in f32 and casts inside the blend; so does the port, at
    the same bars."""
    mt, sizes, frames = mixed
    kw = {"blend": 16, "enable_gain": enable_gain, "pipeline": "rgb", "blend_dtype": "bfloat16"}
    ref, g_ref = JaxMapper(mt, sizes, **kw).stitch(frames)
    m = Mapper(mt, sizes, device="cpu", **kw)
    assert m.plan.blender.compute_dtype == "bfloat16" and m._remap_dtype() == torch.float32
    out, g = m.stitch(frames)
    _assert_close(out, np.asarray(ref))
    assert np.abs(g.numpy() - np.asarray(g_ref)).max() < 1e-3
