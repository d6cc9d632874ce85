"""The port's yuv420 Mapper (octvr_tpu_torch.stitch) against the JAX
Mapper(pipeline="yuv420", blend_dtype="float32") on a small two-fisheye
rig, the carry-across of a JAX plan, and what the slice refuses.

Bars (BASELINE.md multichip bars): Y and UV mean abs < 0.2, max <= 2,
gains within 1e-3."""

import dataclasses

import numpy as np
import pytest
import torch

from octvr_tpu.stitch import Mapper as JaxMapper
from octvr_tpu.template import compile_rig
from octvr_tpu_torch.stitch import Mapper
from octvr_tpu_torch.stitch.convert import plan_from_jax
from octvr_tpu_torch.stitch.mapper import build_plan
from rigs import two_fisheye_rig
from test_stitch import render_camera_frames

torch.set_num_threads(2)

CAM = 256
SIZES = [(CAM, CAM)] * 2


def _rig():
    rig = two_fisheye_rig()
    for s in rig["inputs"]:
        s["options"]["width"] = CAM
        s["options"]["height"] = CAM
    return rig


@pytest.fixture(scope="module")
def small():
    """256x128 canvas, two 256^2 fisheyes, blend 16, gains on; the JAX
    Mapper's outputs for solved and for injected gains."""
    rig = _rig()
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    frames = render_camera_frames(rig, exposure_gains=[1.15, 0.85])
    jm = JaxMapper(
        mt, SIZES, blend=16, enable_gain=True, pipeline="yuv420",
        blend_dtype="float32",
    )
    out, g = jm.stitch(frames)
    inj = np.array([1.1, 0.9], np.float32)
    out_inj, g_inj = jm.stitch(frames, gains=inj)
    return {
        "mt": mt,
        "frames": frames,
        "jax_mapper": jm,
        "ref": (np.asarray(out), np.asarray(g)),
        "ref_inj": (np.asarray(out_inj), np.asarray(g_inj)),
        "inj": inj,
    }


def _port(small, **kw):
    return Mapper(small["mt"], SIZES, blend=16, enable_gain=True,
                  pipeline="yuv420", device="cpu", **kw)


def _assert_close(out, ref):
    h = ref.shape[0] * 2 // 3
    d = np.abs(out.numpy().astype(np.float32) - ref.astype(np.float32))
    for plane in (d[:h], d[h:]):
        assert plane.mean() < 0.2, plane.mean()
        assert plane.max() <= 2, plane.max()


@pytest.mark.parametrize("injected", [False, True])
def test_mapper_matches_jax(small, injected):
    m = _port(small)
    assert m.plan.blender.compute_dtype == "float32"  # CPU default
    if injected:
        out, g = m.stitch(small["frames"], gains=small["inj"])
        ref, g_ref = small["ref_inj"]
    else:
        out, g = m.stitch(small["frames"])
        ref, g_ref = small["ref"]
    assert out.dtype == torch.uint8 and out.shape == ref.shape == (192, 256)
    _assert_close(out, ref)
    assert np.abs(g.numpy() - g_ref).max() < 1e-3
    # the gains counteract the exposure skew
    assert injected or g[0] < 1.0 < g[1]


def test_mapper_bf16_tracks_f32(small):
    out32, _ = _port(small).stitch(small["frames"])
    out16, _ = _port(small, blend_dtype="bfloat16").stitch(small["frames"])
    d = np.abs(out16.numpy().astype(np.float32) - out32.numpy().astype(np.float32))
    assert d[:128].mean() < 1.5, d[:128].mean()


def test_plan_from_jax_gives_identical_output(small):
    own = _port(small)
    carried = Mapper.from_plan(
        plan_from_jax(small["jax_mapper"].plan, small["mt"], "cpu"), "cpu"
    )
    a, ga = own.stitch(small["frames"])
    b, gb = carried.stitch(small["frames"])
    assert torch.equal(a, b) and torch.equal(ga, gb)


def test_plan_from_jax_at_working_stride_4():
    """A 2048x1024 canvas pools the working grid at stride 4 (chroma at
    2, through the column matrices): the port's host plan equals the JAX
    plan's fields, and the carried-across bf16 plan stitches bit for bit
    like the port's own."""
    rig = _rig()
    mt = compile_rig(rig, 2048, 1024)
    mt.create_masks()
    jm = JaxMapper(mt, SIZES, blend=16, pipeline="yuv420", blend_dtype="bfloat16")
    host = build_plan(mt, SIZES, 16, True, "bfloat16")
    for ip, jp in zip(host.inputs, jm.plan.inputs):
        assert ip.work_sub == jp.work_sub and ip.work_sub[2] == 4
        assert ip.work_sub_uv == jp.work_sub_uv
        for f in ("vignette", "vig_half", "pool_cols", "pool_cols_uv"):
            a, b = getattr(ip, f), getattr(jp, f)
            assert (a is None and b is None) or np.array_equal(a, b), f
    assert host.gain.N == jm.plan.gain.N
    assert np.array_equal(host.gain.A_static, jm.plan.gain.A_static)

    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (CAM * 3 // 2, CAM), dtype=np.uint8) for _ in SIZES]
    own = Mapper(mt, SIZES, blend=16, pipeline="yuv420", blend_dtype="bfloat16", device="cpu")
    carried = Mapper.from_plan(plan_from_jax(jm.plan, mt, "cpu"), "cpu")
    assert carried.plan.blender.weight_pyrs[0][0].dtype == torch.bfloat16
    a, ga = own.stitch(frames)
    b, gb = carried.stitch(frames)
    assert torch.equal(a, b) and torch.equal(ga, gb)


@pytest.mark.parametrize(
    "kw",
    [
        {"pipeline": "rgb"},
        {"pipeline": "auto"},  # rgb on the CPU, as in the JAX package
        {"blend": -8},
        {"blend": 0},
        {"enable_gain": "blocks"},
        {"scale_output": (128, 64)},
        {"frame_format": "nv12"},
    ],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_unported_options_raise(small, kw):
    args = {"blend": 16, "pipeline": "yuv420", **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Mapper(small["mt"], SIZES, device="cpu", **args)


def test_overlays_stitch_batch_and_cuda_without_card_raise(small):
    mt_ov = dataclasses.replace(small["mt"], overlay_inputs=[small["mt"].inputs[0]])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Mapper(mt_ov, SIZES + SIZES[:1], blend=16, pipeline="yuv420", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _port(small).stitch_batch([small["frames"]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Mapper(small["mt"], SIZES, blend=16, device="cuda")
