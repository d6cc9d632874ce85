"""Every option of the port's band-sharded stitcher against the port's
own Mapper on the same option, both in f32 on the CPU, at the JAX
package's sharded-vs-single bars for that option (tests/test_sharded.py,
tests/test_sharded_product.py): rgb and yuv420 multiband, feather,
blocks gains, scale_output, NV12, mixed sizes, overlays and source
windows at make_mesh(1, 4).  The averaged paste of ``blend == 0`` is a
sharded-only blend and is held against the JAX package in
tests/test_torch_sharded_jax_blocks.py; ``out_format="rgb"`` is held
here against the same stitch's packed output."""

import numpy as np
import pytest
import torch

from octvr_tpu_torch.ops.color import rgb_planar_to_yuv420p
from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
from octvr_tpu_torch.stitch import Mapper
from sharded_fixtures import fisheye_rig, mixed_rig, nv12_frames, six_cam_small, with_overlay

torch.set_num_threads(2)

# Y mean, Y interior-row mean (8 rows in from top and bottom), UV mean,
# gains rtol: tests/test_sharded.py:69-71 and :178-185 (multiband and
# feather), tests/test_sharded_product.py:72-78 (mixed sizes), :101-106
# (blocks gains), :131-136 (scale_output), :168 (NV12)
BARS = {
    "single": (0.1, 0.05, 0.2, 5e-3),
    "mixed": (0.5, 0.5, 0.5, 2e-3),
    "blocks": (0.75, 0.75, 1.0, 5e-3),
    "scale": (0.5, 0.5, 0.75, 5e-3),
    "nv12": (0.75, 0.75, 0.75, 5e-3),
}

CASES = {
    # name: (rig, pipeline, options, bars)
    "rgb_multiband": ("fisheye", "rgb", {}, "single"),
    "rgb_multiband_nosplit": ("fisheye", "rgb", {"coarse_split": 3}, "single"),
    "rgb_srcwin": ("sixcam", "rgb", {"src_windows": True}, "single"),
    "rgb_feather": ("fisheye", "rgb", {"blend": -8}, "single"),
    "yuv420_feather": ("fisheye", "yuv420", {"blend": -8}, "single"),
    "rgb_blocks": ("fisheye", "rgb", {"enable_gain": "blocks"}, "blocks"),
    "yuv420_blocks": ("fisheye", "yuv420", {"enable_gain": "blocks"}, "blocks"),
    "rgb_scale": ("fisheye", "rgb", {"scale_output": (128, 64)}, "scale"),
    "yuv420_scale": ("fisheye", "yuv420", {"scale_output": (128, 64)}, "scale"),
    "rgb_nv12": ("fisheye", "rgb", {"frame_format": "nv12"}, "nv12"),
    "yuv420_nv12": ("fisheye", "yuv420", {"frame_format": "nv12"}, "nv12"),
    "rgb_mixed": ("mixed", "rgb", {}, "mixed"),
    "yuv420_mixed_srcwin": ("mixed", "yuv420", {"src_windows": True}, "mixed"),
    "rgb_overlay": ("overlay", "rgb", {}, "single"),
    "yuv420_overlay": ("overlay", "yuv420", {}, "single"),
}

_SHARDED_ONLY = ("coarse_split", "src_windows")


@pytest.fixture(scope="module")
def rigs():
    fisheye = fisheye_rig()
    return {"fisheye": fisheye, "mixed": mixed_rig(), "overlay": with_overlay(*fisheye), "sixcam": six_cam_small()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_option_matches_mapper(rigs, name):
    rig, pipeline, kw, bars = CASES[name]
    mt, sizes, frames = rigs[rig]
    if kw.get("frame_format") == "nv12":
        frames = nv12_frames(frames)
    kw = {"blend": 16, "enable_gain": True, "pipeline": pipeline, "blend_dtype": "float32", **kw}
    mkw = {k: v for k, v in kw.items() if k not in _SHARDED_ONLY}
    ref, g_ref = Mapper(mt, sizes, device="cpu", **mkw).stitch(frames)
    sm = ShardedMapper(mt, sizes, make_mesh(1, 4, device="cpu"), **kw)
    assert sm.plan.pipeline == pipeline
    if rig == "sixcam":  # the side cameras read row slices: kernel 6's NC=3 layout
        assert sm.plan.sliced and all(g.concat for g in sm.plan.remap_groups)
    out, g = sm.stitch_batch([torch.from_numpy(f[None].copy()) for f in frames])
    got = sm.assemble_yuv(out[0])
    assert got.shape == ref.shape and got.dtype == torch.uint8
    oh = got.shape[0] * 2 // 3
    d = (got.float() - ref.float()).abs()
    y_bar, int_bar, uv_bar, g_bar = BARS[bars]
    y, y_int, uv = d[:oh].mean().item(), d[8 : oh - 8].mean().item(), d[oh:].mean().item()
    print(f"{name}: Y {y:.4f}, interior {y_int:.4f}, UV {uv:.4f}")
    assert y < y_bar and y_int < int_bar and uv < uv_bar
    if kw["enable_gain"] != "blocks" and rig != "sixcam":  # blocks gains return ones
        assert not torch.allclose(g_ref, torch.ones(2))
    np.testing.assert_allclose(g[0].numpy(), g_ref.numpy(), rtol=g_bar)


def test_rgb_out_format_is_the_packed_output_before_packing(rigs):
    """out_format="rgb" gives the planar RGB f32 bands [B, 3, S*obh, oW]
    that the packed output is made from: packing each band gives the
    yuv420p stitch's bytes."""
    mt, sizes, frames = rigs["fisheye"]
    mesh = make_mesh(1, 4, device="cpu")
    kw = dict(blend=16, pipeline="rgb", blend_dtype="float32")
    batch = [torch.from_numpy(f[None].copy()) for f in frames]
    rgb, g_rgb = ShardedMapper(mt, sizes, mesh, out_format="rgb", **kw).stitch_batch(batch)
    sm = ShardedMapper(mt, sizes, mesh, **kw)
    packed, g = sm.stitch_batch(batch)
    S, obh, oW = sm.plan.S, sm.plan.obh, sm.plan.oW
    assert rgb.shape == (1, 3, S * obh, oW) and rgb.dtype == torch.float32
    assert 0.0 <= rgb.min() and rgb.max() <= 255.0
    bands = [rgb_planar_to_yuv420p(b) for b in rgb[0].unflatten(1, (S, obh)).unbind(1)]
    assert torch.equal(torch.cat(bands), packed[0]) and torch.equal(g, g_rgb)
    with pytest.raises(ValueError, match="out_format"):
        ShardedMapper(mt, sizes, mesh, out_format="rgb", **kw).assemble_yuv(packed[0])
