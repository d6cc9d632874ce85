"""The port's band-sharded stitcher against the port's own Mapper, at
the JAX package's sharded-vs-single bars (tests/test_sharded.py:178-185,
tests/test_sharded_split.py:66-72): Y mean < 0.1, interior rows (8 rows
in from the canvas top and bottom) < 0.02, chroma mean < 0.2, gains
rtol 5e-3.  Both in f32 on the CPU; ``stitch_batch`` frames against
one-frame calls bit for bit."""

import numpy as np
import pytest
import torch

from octvr_tpu_torch.ops.color import split_yuv420p
from octvr_tpu_torch.parallel import LocalBands, ShardedMapper, make_mesh
from octvr_tpu_torch.stitch import Mapper
from sharded_fixtures import fisheye_rig, six_cam_small

torch.set_num_threads(2)

BLEND = 32


@pytest.fixture(scope="module")
def rigs():
    out = {}
    for name, (mt, sizes, frames) in (("fisheye", fisheye_rig()), ("sixcam", six_cam_small())):
        single = Mapper(mt, sizes, blend=BLEND, enable_gain=True, pipeline="yuv420",
                        blend_dtype="float32", device="cpu")
        out[name] = (mt, sizes, frames, single, single.stitch(frames))
    return out


def _check_vs_single(yuv, g, ref, g_ref, oh):
    err = (yuv.float() - ref.float()).abs()
    assert err[:oh].mean() < 0.1, err[:oh].mean()
    assert err[8 : oh - 8].mean() < 0.02, err[8 : oh - 8].mean()
    assert err[oh:].mean() < 0.2, err[oh:].mean()
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=5e-3)


CASES = {
    "fisheye_s1": ("fisheye", 1, {}),
    "fisheye_s2_split": ("fisheye", 2, {}),
    "fisheye_s4_split": ("fisheye", 4, {}),
    "fisheye_s4_nosplit": ("fisheye", 4, {"coarse_split": 4}),
    "sixcam_s4": ("sixcam", 4, {}),
    "sixcam_s4_srcwin": ("sixcam", 4, {"src_windows": True}),
    "sixcam_s2_srcwin": ("sixcam", 2, {"src_windows": True}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_single_mapper(rigs, name):
    rig, S, kw = CASES[name]
    mt, sizes, frames, _, (ref, g_ref) = rigs[rig]
    sm = ShardedMapper(mt, sizes, make_mesh(1, S, device="cpu"), blend=BLEND, **kw)
    assert sm.plan.compute_dtype == "float32"  # the CPU default
    assert (sm.plan.split_level >= 0) == (S > 1 and "coarse_split" not in kw)
    assert sm.plan.sliced == ("src_windows" in kw)
    out, g = sm.stitch_batch([torch.from_numpy(f[None].copy()) for f in frames])
    assert out.shape == (1, S * sm.plan.bh * 3 // 2, sm.plan.Wp) and out.dtype == torch.uint8
    _check_vs_single(sm.assemble_yuv(out[0]), g[0], ref, g_ref, mt.out_size[1])


def test_injected_gains_and_stacked_input(rigs):
    """``gains=`` replaces the solve (as Mapper.stitch(gains=) does); the
    stacked [B, n, H*3/2, W] input gives what the per-input list gives."""
    mt, sizes, frames, single, _ = rigs["fisheye"]
    gains = torch.tensor([1.3, 0.7])
    ref, g_ref = single.stitch(frames, gains=gains)
    assert torch.equal(g_ref, gains)
    sm = ShardedMapper(mt, sizes, make_mesh(1, 4, device="cpu"), blend=BLEND)
    out, g = sm.stitch_batch([torch.from_numpy(f[None].copy()) for f in frames], gains=gains[None])
    assert torch.equal(g[0], gains)
    _check_vs_single(sm.assemble_yuv(out[0]), g[0], ref, g_ref, mt.out_size[1])
    stacked = torch.from_numpy(np.stack(frames)[None].copy())
    out_s, g_s = sm.stitch_batch(stacked)
    out_l, g_l = sm.stitch_batch(list(stacked.unbind(1)))
    assert torch.equal(out_s, out_l) and torch.equal(g_s, g_l)


@pytest.mark.parametrize("n_data,rig,kw", [(1, "fisheye", {}), (2, "fisheye", {}), (2, "sixcam", {"src_windows": True})])
def test_stitch_batch_frames_equal_one_frame_calls(rigs, n_data, rig, kw):
    """B=2 frame sets in one call (the remap's frames axis when a data
    part holds both) equal two one-frame calls, output and gains."""
    mt, sizes, frames, _, _ = rigs[rig]
    sm = ShardedMapper(mt, sizes, make_mesh(n_data, 4, device="cpu"), blend=BLEND, **kw)
    sets = [frames, [255 - f for f in frames]]
    batch = [torch.from_numpy(np.stack(fs)) for fs in zip(*sets)]
    out, g = sm.stitch_batch(batch)
    one = ShardedMapper.from_plan(sm.plan, make_mesh(1, 4, device="cpu"))
    for b, fs in enumerate(sets):
        o, gb = one.stitch_batch([torch.from_numpy(f[None].copy()) for f in fs])
        assert torch.equal(out[b], o[0]) and torch.equal(g[b], gb[0])


def test_batch_must_divide_by_data_parts(rigs):
    mt, sizes, frames, _, _ = rigs["fisheye"]
    sm = ShardedMapper(mt, sizes, make_mesh(2, 2, device="cpu"), blend=BLEND)
    with pytest.raises(ValueError, match="divisible"):
        sm.stitch_batch([torch.from_numpy(f[None].copy()) for f in frames])


def test_assemble_yuv_layout(rigs):
    """assemble_yuv cuts the per-band packed buffers back into the packed
    YUV420P canvas: its planes are the bands' planes, concatenated."""
    mt, sizes, frames, _, _ = rigs["fisheye"]
    sm = ShardedMapper(mt, sizes, make_mesh(1, 4, device="cpu"), blend=BLEND)
    out, _ = sm.stitch_batch([torch.from_numpy(f[None].copy()) for f in frames])
    W, H = mt.out_size
    bands = out[0].reshape(4, sm.plan.bh * 3 // 2, sm.plan.Wp)
    y, u, v = split_yuv420p(sm.assemble_yuv(out[0]))
    parts = [split_yuv420p(b) for b in bands]
    assert torch.equal(y, torch.cat([p[0] for p in parts])[:H, :W])
    assert torch.equal(u, torch.cat([p[1] for p in parts])[: H // 2, : W // 2])
    assert torch.equal(v, torch.cat([p[2] for p in parts])[: H // 2, : W // 2])


def test_local_band_group():
    """The band group's two collectives over the leading band axis."""
    x = torch.arange(24.0).reshape(4, 1, 3, 2)
    group = LocalBands(4)
    assert torch.equal(group.sum(x), x[0] + x[1] + x[2] + x[3])
    assert torch.equal(group.concat(x, dim=1), torch.cat([x[s] for s in range(4)], dim=1))
