"""Rigs and frames of the band-sharded stitcher's tests, shared by the
port's tests (tests/test_torch_sharded*.py): the two-fisheye rig of
tests/test_sharded.py, the six-camera rig of
tests/test_sharded_srcwin.py and the mixed-size rig of
tests/test_sharded_product.py, at their sizes there."""

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


def mixed_rig():
    """(mt, sizes, frames): a 256^2 and a 192^2 fisheye -> 256x128
    (tests/test_sharded_product.py's mixed-size rig), the rendered
    world with exposure gains 1.15 and 0.85."""
    rig = two_fisheye_rig()
    rig["inputs"][0]["options"].update(width=256, height=256)
    rig["inputs"][1]["options"].update(width=192, height=192)
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    return mt, [(256, 256), (192, 192)], render_camera_frames(rig, exposure_gains=[1.15, 0.85])


def with_overlay(mt, sizes, frames):
    """The rig with its first camera again as an overlay input (its own
    frame), as the Mapper tests add one."""
    import dataclasses

    return dataclasses.replace(mt, overlay_inputs=[mt.inputs[0]]), list(sizes) + [sizes[0]], list(frames) + [frames[0]]


def nv12_frames(frames):
    """Packed YUV420P frames -> NV12 (chroma rows interleaved UVUV)."""
    out = []
    for f in frames:
        h, w = f.shape[0] * 2 // 3, f.shape[1]
        uv = np.stack([f[h:, : w // 2], f[h:, w // 2 :]], axis=-1).reshape(h // 2, w)
        out.append(np.concatenate([f[:h], uv]))
    return out


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


def stitch_both(mt, sizes, frames, n_space, pipeline="yuv420", **kw):
    """One frame set through the JAX ShardedMapper (f32, its Pallas
    remap in interpret mode on the CPU mesh) and the port's (f32 on the
    CPU), both on ``pipeline``.  Returns (jax_sm, port_sm, jax (canvas,
    gains), port (canvas, gains)), canvases as numpy packed YUV420P (or
    NV12), or planar RGB f32 [3, S*obh, oW] with out_format="rgb"."""
    import torch

    from octvr_tpu.parallel.sharded import ShardedMapper as JaxShardedMapper
    from octvr_tpu.parallel.sharded import make_mesh as jax_make_mesh
    from octvr_tpu_torch.parallel import ShardedMapper, make_mesh

    rgb_out = kw.get("out_format") == "rgb"
    jsm = JaxShardedMapper(mt, sizes, jax_make_mesh(1, n_space), pipeline=pipeline,
                           blend_dtype="float32", **kw)
    out, g = jsm.stitch_batch([np.stack([f]) for f in frames])
    out = np.asarray(out)[0]
    ref = (out if rgb_out else jsm.assemble_yuv(out), np.asarray(g)[0])
    sm = ShardedMapper(mt, sizes, make_mesh(1, n_space, device="cpu"), pipeline=pipeline,
                       blend_dtype="float32", **kw)
    out, g = sm.stitch_batch([torch.from_numpy(f[None].copy()) for f in frames])
    got = out[0] if rgb_out else sm.assemble_yuv(out[0])
    return jsm, sm, ref, (got.numpy(), g[0].numpy())


def mapper_bar_errors(got, ref, oh):
    """(Y mean, Y max, UV mean, UV max) abs err of two packed canvases."""
    d = np.abs(got.astype(np.float32) - ref.astype(np.float32))
    return d[:oh].mean(), d[:oh].max(), d[oh:].mean(), d[oh:].max()
