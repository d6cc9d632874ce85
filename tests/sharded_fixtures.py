"""Rigs and frames of the band-sharded stitcher's tests, shared by the
port's tests (tests/test_torch_sharded*.py): the two-fisheye rig of
tests/test_sharded.py and the six-camera rig of
tests/test_sharded_srcwin.py, at their sizes there."""

import numpy as np

from octvr_tpu.template import compile_rig
from rigs import two_fisheye_rig
from test_stitch import render_camera_frames


def fisheye_rig():
    """(mt, sizes, frames): two 256^2 fisheyes -> 256x128, the rendered
    world with exposure gains 1.15 and 0.85."""
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"].update(width=256, height=256)
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    return mt, [(256, 256)] * 2, render_camera_frames(rig, exposure_gains=[1.15, 0.85])


def six_cam_small():
    """(mt, sizes, frames): bench.six_cam_rig at 240^2 -> 480x240, with
    the blocky frames of tests/test_sharded_srcwin.py (seed 0).  At S=4
    with source windows the side cameras read 172 of their 240 rows."""
    from bench import six_cam_rig

    rig = six_cam_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = spec["options"]["height"] = 240
    mt = compile_rig(rig, 480, 240)
    mt.create_masks()
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(6):
        base = rng.integers(40, 220, (8, 8)).astype(np.float32)
        up = np.kron(base, np.ones((45, 45)))[:360, :240]
        frames.append(np.clip(up[: 240 * 3 // 2], 16, 235).astype(np.uint8))
    return mt, [(240, 240)] * 6, frames


def stitch_both(mt, sizes, frames, n_space, **kw):
    """One frame set through the JAX ShardedMapper (yuv420, f32, its
    Pallas remap in interpret mode on the CPU mesh) and the port's (f32
    on the CPU).  Returns (jax_sm, port_sm, jax (canvas, gains), port
    (canvas, gains)), canvases as numpy packed YUV420P."""
    import torch

    from octvr_tpu.parallel.sharded import ShardedMapper as JaxShardedMapper
    from octvr_tpu.parallel.sharded import make_mesh as jax_make_mesh
    from octvr_tpu_torch.parallel import ShardedMapper, make_mesh

    jsm = JaxShardedMapper(mt, sizes, jax_make_mesh(1, n_space), pipeline="yuv420",
                           blend_dtype="float32", **kw)
    out, g = jsm.stitch_batch([np.stack([f]) for f in frames])
    ref = (jsm.assemble_yuv(np.asarray(out)[0]), np.asarray(g)[0])
    sm = ShardedMapper(mt, sizes, make_mesh(1, n_space, device="cpu"), blend_dtype="float32", **kw)
    out, g = sm.stitch_batch([torch.from_numpy(f[None].copy()) for f in frames])
    return jsm, sm, ref, (sm.assemble_yuv(out[0]).numpy(), g[0].numpy())


def mapper_bar_errors(got, ref, oh):
    """(Y mean, Y max, UV mean, UV max) abs err of two packed canvases."""
    d = np.abs(got.astype(np.float32) - ref.astype(np.float32))
    return d[:oh].mean(), d[:oh].max(), d[oh:].mean(), d[oh:].max()
