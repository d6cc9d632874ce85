"""The port's Mapper (octvr_tpu_torch.stitch) against the JAX Mapper in
f32 on a small two-fisheye rig: the yuv420 pipeline with multiband and
gains; every other option on the rgb pipeline, whose JAX Mapper runs its
XLA gather on the CPU and so costs little; overlays, stitch_batch and
FastMapper; the carry-across of JAX plans.  The yuv420 pipeline's other
options are held against the JAX package in
tests/test_torch_yuv420_options.py, mixed camera sizes in
tests/test_torch_mixed_sizes.py.

Bars (BASELINE.md multichip bars): Y and UV mean abs < 0.2, max <= 2,
gains within 1e-3."""

import dataclasses

import numpy as np
import pytest
import torch

from octvr_tpu.stitch import FastMapper as JaxFastMapper
from octvr_tpu.stitch import Mapper as JaxMapper
from octvr_tpu.template import compile_rig
from octvr_tpu_torch.stitch import FastMapper, Mapper
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
    """Y and UV planes: mean abs < 0.2, max <= 2."""
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
    host = build_plan(mt, SIZES, 16, True, "bfloat16", "yuv420")
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


OPTIONS = [
    {"pipeline": "rgb"},
    {"pipeline": "auto"},  # rgb on the CPU, as in the JAX package
    {"blend": -8},
    {"blend": 0},
    {"enable_gain": "blocks"},
    {"scale_output": (128, 64)},
    {"frame_format": "nv12"},
]


def nv12(buf):
    """Packed YUV420P [H*3/2, W] -> NV12 (U and V interleaved)."""
    h, w = buf.shape[0] * 2 // 3, buf.shape[1]
    u, v = buf[h:, : w // 2], buf[h:, w // 2 :]
    return np.concatenate([buf[:h], np.stack([u, v], -1).reshape(h // 2, w)])


def _frames_for(kw, frames):
    return [nv12(f) for f in frames] if kw.get("frame_format") == "nv12" else frames


def _jax_vs_port(mt, sizes, frames, kw, gains=None, jcls=JaxMapper, pcls=Mapper):
    """(port output, port gains, JAX output, JAX gains) for the same
    options, f32 on both sides."""
    jm = jcls(mt, sizes, blend_dtype="float32", **kw)
    ref, g_ref = jm.stitch(frames, gains=gains)
    out, g = pcls(mt, sizes, device="cpu", **kw).stitch(frames, gains=gains)
    return out, g, np.asarray(ref), np.asarray(g_ref)


@pytest.mark.parametrize("kw", OPTIONS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_options_raise(small, kw):
    """Each option that the port once refused with NotImplementedError
    now runs: on the rgb pipeline, against the JAX Mapper with the same
    options (which runs its XLA gather on the CPU), at the Mapper bars.
    The name and ids are kept from then, so each case keeps its id."""
    args = {"blend": 16, "enable_gain": True, "pipeline": "rgb", **kw}
    frames = _frames_for(kw, small["frames"])
    out, g, ref, g_ref = _jax_vs_port(small["mt"], SIZES, frames, args)
    W, H = kw.get("scale_output", (256, 128))
    assert out.dtype == torch.uint8 and out.shape == ref.shape == (H * 3 // 2, W)
    _assert_close(out, ref)
    assert np.abs(g.numpy() - g_ref).max() < 1e-3


def test_rgb_injected_gains_match_jax(small):
    kw = {"blend": 16, "enable_gain": True, "pipeline": "rgb"}
    out, g, ref, g_ref = _jax_vs_port(small["mt"], SIZES, small["frames"], kw, gains=small["inj"])
    _assert_close(out, ref)
    assert np.array_equal(g.numpy(), small["inj"]) and np.array_equal(g_ref, small["inj"])


def overlay_rig(mt, frames, size=192):
    """The template with input 0 again as an overlay input, sampled from
    a source of its own size (so it forms a size group of its own), and
    the frames with that overlay frame appended."""
    mt_ov = dataclasses.replace(mt, overlay_inputs=[mt.inputs[0]])
    rng = np.random.default_rng(12)
    ov = rng.integers(0, 256, (size * 3 // 2, size), dtype=np.uint8)
    return mt_ov, SIZES + [(size, size)], list(frames) + [ov]


def test_overlays_stitch_batch_and_cuda_without_card_raise(small):
    """Overlays (a third, own-size input pasted after the blend, no gain)
    and stitch_batch, which the port once refused, now run on the rgb
    pipeline and match the JAX Mapper.  The name is kept from then; the
    check that device="cuda" without a card raises is
    test_cuda_without_card_raises."""
    mt_ov, sizes, frames = overlay_rig(small["mt"], small["frames"])
    kw = {"blend": 16, "enable_gain": True, "pipeline": "rgb"}
    out, g, ref, g_ref = _jax_vs_port(mt_ov, sizes, frames, kw)
    assert g.shape == (2,)
    _assert_close(out, ref)
    assert np.abs(g.numpy() - g_ref).max() < 1e-3

    batch = [np.stack([f, 255 - f]) for f in small["frames"]]
    ref_b, g_ref_b = JaxMapper(small["mt"], SIZES, blend_dtype="float32", **kw).stitch_batch(batch)
    out_b, g_b = Mapper(small["mt"], SIZES, device="cpu", **kw).stitch_batch(batch)
    assert out_b.shape == (2, 192, 256) and g_b.shape == (2, 2)
    for b in range(2):
        _assert_close(out_b[b], np.asarray(ref_b)[b])
    assert np.abs(g_b.numpy() - np.asarray(g_ref_b)).max() < 1e-3


def test_cuda_without_card_raises(small):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for kw in ({"pipeline": "yuv420"}, {"pipeline": "rgb"}, {}):
        with pytest.raises(RuntimeError, match="is_available"):
            Mapper(small["mt"], SIZES, blend=16, device="cuda", **kw)


def test_fast_mapper_matches_jax(small):
    """FastMapper: NV12 in and out, feather with border 8, no gains (rgb
    on the CPU, as in the JAX package)."""
    frames = [nv12(f) for f in small["frames"]]
    ref = np.asarray(JaxFastMapper(small["mt"], SIZES).stitch_nv12(frames))
    m = FastMapper(small["mt"], SIZES, device="cpu")
    assert m.plan.pipeline == "rgb" and m.plan.blend_kind == "feather"
    out = m.stitch_nv12(frames)
    _assert_close(out, ref)


@pytest.mark.parametrize("pipeline", ["rgb", "yuv420"])
def test_stitch_batch_equals_stitch(small, pipeline):
    """B=2 in one call gives what two stitch calls give, bit for bit,
    with solved and with injected [B, n] gains."""
    m = Mapper(small["mt"], SIZES, blend=16, enable_gain=True, pipeline=pipeline, device="cpu")
    sets = [small["frames"], [255 - f for f in small["frames"]]]
    batch = [torch.from_numpy(np.stack(fs)) for fs in zip(*sets)]
    inj = np.array([[1.1, 0.9], [0.95, 1.05]], np.float32)
    for gains in (None, inj):
        out, g = m.stitch_batch(batch, gains=gains)
        for b, fs in enumerate(sets):
            o, gb = m.stitch(fs, gains=None if gains is None else gains[b])
            assert torch.equal(out[b], o) and torch.equal(g[b], gb)


def test_plan_from_jax_rgb_feather(small):
    """An rgb feather plan (the JAX package's XLA gather plans give the
    input sizes) carried across stitches bit for bit like the port's
    own."""
    kw = {"blend": -8, "enable_gain": True, "pipeline": "rgb"}
    jm = JaxMapper(small["mt"], SIZES, **kw)
    carried = Mapper.from_plan(plan_from_jax(jm.plan, small["mt"], "cpu"), "cpu")
    own = Mapper(small["mt"], SIZES, device="cpu", **kw)
    assert carried.plan.blend_kind == "feather" and carried.in_sizes == own.in_sizes
    a, ga = own.stitch(small["frames"])
    b, gb = carried.stitch(small["frames"])
    assert torch.equal(a, b) and torch.equal(ga, gb)


def test_plan_from_jax_yuv420_blocks_overlays_scaled(small):
    """A yuv420 plan with blocks gains, an overlay in its own size group
    and output scaling, carried across in NV12: bit for bit."""
    mt_ov, sizes, frames = overlay_rig(small["mt"], small["frames"])
    kw = {"blend": 16, "enable_gain": "blocks", "pipeline": "yuv420",
          "scale_output": (192, 96), "frame_format": "nv12"}
    jm = JaxMapper(mt_ov, sizes, blend_dtype="float32", **kw)
    assert jm.plan.gain_blocks is not None and len(jm.plan.group_idx) == 2
    carried = Mapper.from_plan(plan_from_jax(jm.plan, mt_ov, "cpu"), "cpu", frame_format="nv12")
    own = Mapper(mt_ov, sizes, device="cpu", **kw)
    frames = [nv12(f) for f in frames]
    a, ga = own.stitch(frames)
    b, gb = carried.stitch(frames)
    assert a.shape == (144, 192)
    assert torch.equal(a, b) and torch.equal(ga, gb)
