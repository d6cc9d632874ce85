"""The port's streaming runtime (octvr_tpu_torch.runtime) against the JAX
package's on the CPU: the AsyncMultiMapper over CPU mappers against the
JAX AsyncMultiMapper on the same numpy frames (order, outputs, gains
under each gain-mode encoding), the checksum drain's contract, a
ShardedMapper stream (padded last batch included) against the
single-Mapper stream, the stereo preset end to end through both
packages, a failing stage, and the timers.

Rig: two 128^2 fisheyes -> a 128x64 canvas, 6 frames of a drifting
scene (tests/test_stream_sharded.py:19-77).  The JAX side runs the rgb
pipeline, whose XLA gather costs little on the CPU.

Bars: stitched frames as tests/test_torch_mapper.py (Y and UV mean abs
< 0.2, max <= 2 per plane); gains within 1e-3; the sharded stream
against the single-Mapper stream at tests/test_stream_sharded.py's bars
(mean < 0.5, per-frame mean < 1.0).  The pipeline itself adds nothing:
its outputs equal the port's direct ``stitch`` bit for bit."""

import math
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from octvr_tpu.presets import RegionComposer as JaxRegionComposer
from octvr_tpu.presets import build_region_outputs as jax_build_region_outputs
from octvr_tpu.runtime import AsyncMultiMapper as JaxAsyncMultiMapper
from octvr_tpu.runtime import FpsMeter as JaxFpsMeter
from octvr_tpu.runtime import Timer as JaxTimer
from octvr_tpu.stitch import Mapper as JaxMapper
from octvr_tpu.template import compile_rig as jax_compile_rig
from octvr_tpu_torch.ops.color import rgb_planar_to_yuv420p, yuv420p_to_rgb
from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
from octvr_tpu_torch.presets import RegionComposer, build_region_outputs
from octvr_tpu_torch.runtime import BUF_SIZE, AsyncMultiMapper, FpsMeter, Timer
from octvr_tpu_torch.stitch import Mapper
from octvr_tpu_torch.template import compile_rig
from rigs import two_fisheye_rig

torch.set_num_threads(2)

PI = math.pi
CAM = 128
SIZES = [(CAM, CAM)] * 2
N_FRAMES = 6


def stream_rig():
    lens = {"width": CAM, "height": CAM, "hfov": PI * 1.15, "center_dx": 0.0,
            "center_dy": 0.0, "radial": [0.0, 0.0, 0.0]}
    return {
        "output": {"type": "equirectangular", "options": {}},
        "inputs": [
            {"type": "fullframe_fisheye", "options": dict(lens)},
            {"type": "fullframe_fisheye",
             "options": {**lens, "rotation": {"roll": 0.0, "yaw": PI, "pitch": 0.0}}},
        ],
    }


def drifting_frames(n=N_FRAMES, size=CAM):
    """n frame sets x 2 cameras of a drifting gradient scene, packed
    YUV420P (the scene of tests/test_stream_sharded.py)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    sets = []
    for t in range(n):
        frames = []
        for cam in range(2):
            base = 120 + 60 * np.sin(2 * PI * (xx + 0.1 * t + 0.3 * cam)) * np.cos(2 * PI * yy)
            rgb = np.stack([base, base * 0.9 + 10, base * 1.1 - 10]).clip(0, 255)
            frames.append(rgb_planar_to_yuv420p(torch.from_numpy(rgb.astype(np.float32))).numpy())
        sets.append(frames)
    return sets


@pytest.fixture(scope="module")
def rig():
    spec = stream_rig()
    mt = compile_rig(spec, 128, 64)
    mt.create_masks()
    jmt = jax_compile_rig(spec, 128, 64)
    jmt.create_masks()
    return {"mt": mt, "jmt": jmt, "sets": drifting_frames()}


def run_pipeline(amm, sets):
    """Pushes every set, then the end of the stream, from a thread while
    popping here; returns the popped outputs in order (close()
    included)."""

    def push_all():
        for s in sets:
            amm.push(s)
        amm.close_input()  # flushes a partial sharded batch

    pusher = threading.Thread(target=push_all)
    got = []
    try:
        pusher.start()
        for _ in sets:
            got.append(amm.pop())
        pusher.join(timeout=30)
        assert not pusher.is_alive()
        with pytest.raises(StopIteration):
            amm.pop()
    finally:
        amm.close()
    return got


def assert_mapper_bars(out, ref):
    """Y and UV planes: mean abs < 0.2, max <= 2."""
    h = ref.shape[0] * 2 // 3
    d = np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32))
    for plane in (d[:h], d[h:]):
        assert plane.mean() < 0.2, plane.mean()
        assert plane.max() <= 2, plane.max()


@pytest.mark.parametrize("gain_modes", [[0], [-1], [0, 0]], ids=["solve", "off", "copy"])
def test_pipeline_matches_jax(rig, gain_modes):
    """The same frames through both pipelines: every frame, in order,
    within the Mapper bars; each output equal to the port's direct
    stitch; the gains of each output within 1e-3 of the JAX Mapper's;
    a gain copier's output is its owner's gains applied."""
    kw = [dict(blend=8 if k == 0 else -4, enable_gain=mode >= 0, pipeline="rgb")
          for k, mode in enumerate(gain_modes)]
    ports = [Mapper(rig["mt"], SIZES, device="cpu", **k) for k in kw]
    jaxes = [JaxMapper(rig["jmt"], SIZES, blend_dtype="float32", **k) for k in kw]
    sets = rig["sets"]
    got = run_pipeline(AsyncMultiMapper(ports, gain_modes=gain_modes), sets)
    ref = run_pipeline(JaxAsyncMultiMapper(jaxes, gain_modes=gain_modes), sets)
    assert len(got) == len(ref) == N_FRAMES
    for n, (outs, routs, frames) in enumerate(zip(got, ref, sets)):
        assert len(outs) == len(gain_modes)
        direct, gains = [], []
        for k, (m, jm) in enumerate(zip(ports, jaxes)):
            mode = gain_modes[k]
            g_in = None if mode in (-1, k) else gains[mode]
            o, g = m.stitch(frames, gains=g_in)
            _, jg = jm.stitch(frames, gains=None if g_in is None else g_in.numpy())
            direct.append(o.numpy())
            gains.append(g)
            assert np.abs(g.numpy() - np.asarray(jg)).max() < 1e-3, (n, k)
            assert isinstance(outs[k], np.ndarray) and outs[k].dtype == np.uint8
            assert np.array_equal(outs[k], direct[k]), (n, k)  # in order, nothing added
            assert_mapper_bars(outs[k], routs[k])
        if gain_modes == [0, 0]:
            assert torch.equal(gains[1], gains[0])


def test_pipeline_frames_are_the_callers(rig):
    """pop() hands out arrays the pipeline no longer touches: writing to
    one leaves the next frames right."""
    m = Mapper(rig["mt"], SIZES, blend=8, pipeline="rgb", device="cpu")
    amm = AsyncMultiMapper([m])
    sets = rig["sets"][:4]
    try:
        for s in sets[:BUF_SIZE]:
            amm.push(s)
        first = amm.pop()[0]
        first[:] = 0
        amm.push(sets[BUF_SIZE])
        rest = [amm.pop()[0] for _ in sets[1:]]
    finally:
        amm.close()
    for out, frames in zip(rest, sets[1:]):
        assert np.array_equal(out, m.stitch(frames)[0].numpy())


@pytest.mark.parametrize("sharded", [False, True], ids=["mapper", "sharded"])
def test_checksum_drain_contract(rig, sharded):
    """drain="checksum": one strided int sum per output, fetched on every
    8th frame (for a batch: when it holds a frame at 7 mod 8), 0.0 on
    the others.  The values are those of the host drain's frames; a
    sharded batch's covers its band buffers, padded rows included."""
    sets = (rig["sets"] * 2)[:9]
    if sharded:
        m = ShardedMapper(rig["mt"], SIZES, make_mesh(2, 2, device="cpu"), blend=8)
    else:
        m = Mapper(rig["mt"], SIZES, blend=8, pipeline="rgb", device="cpu")
    chk = run_pipeline(AsyncMultiMapper([m], drain="checksum"), sets)
    assert len(chk) == len(sets)
    for n, vals in enumerate(chk):
        assert isinstance(vals, list) and len(vals) == 1
        if sharded:
            b0 = n - n % 2
            nreal = min(2, len(sets) - b0)
            batch = [sets[min(b, len(sets) - 1)] for b in (b0, b0 + 1)]
            out, _ = m.stitch_batch([torch.from_numpy(np.stack(x)) for x in zip(*batch)])
            fetch = b0 % 8 >= 8 - nreal
            want = int(out[:, ::101, ::103].to(torch.int64).sum()) if fetch else 0.0
        else:
            out, _ = m.stitch(sets[n])
            want = int(out[::101, ::103].to(torch.int64).sum()) if n % 8 == 7 else 0.0
        assert vals[0] == want, (n, vals, want)


@pytest.mark.parametrize("n_frames", [6, 5], ids=["even", "padded"])
@pytest.mark.parametrize("gain_modes", [[0], [0, 0]], ids=["solve", "copy"])
def test_sharded_stream_matches_single(rig, n_frames, gain_modes):
    """ShardedMapper outputs on make_mesh(2, 2): two frame sets per
    stitch_batch, the last batch padded when the count is odd.  Every
    real frame comes out, in order, and no padding frame; each equals
    stitch_batch called directly; against the single-Mapper stream at
    the JAX test's bars.  A gain copier's stream equals its owner's."""
    sets = rig["sets"][:n_frames]
    mesh = make_mesh(2, 2, device="cpu")
    sm = [ShardedMapper(rig["mt"], SIZES, mesh, blend=8) for _ in gain_modes]
    single = Mapper(rig["mt"], SIZES, blend=8, pipeline="yuv420", device="cpu")
    got = run_pipeline(AsyncMultiMapper(sm, gain_modes=gain_modes), sets)
    ref = run_pipeline(AsyncMultiMapper([single]), sets)
    assert len(got) == n_frames
    per_frame = []
    for b0 in range(0, n_frames, 2):
        batch = sets[b0 : b0 + 2]
        batch = batch + batch[-1:] * (2 - len(batch))
        out, _ = sm[0].stitch_batch([torch.from_numpy(np.stack(x)) for x in zip(*batch)])
        for b in range(min(2, n_frames - b0)):
            outs = got[b0 + b]
            assert np.array_equal(outs[0], sm[0].assemble_yuv(out[b]).numpy())
            if len(gain_modes) == 2:
                assert np.array_equal(outs[1], outs[0])
            per_frame.append(np.abs(outs[0].astype(np.float32) - ref[b0 + b][0].astype(np.float32)).mean())
    assert np.mean(per_frame) < 0.5 and max(per_frame) < 1.0, per_frame


def test_stereo_preset_end_to_end():
    """The cylinder-slice stereo layout (tests/test_stereo_regions.py)
    through both packages: equal region specs, gain sharing [0, -1, -1,
    3, -1, -1], every region landed, the eyes agree, and the port's
    composed canvas within the Mapper bars' RGB reach of the JAX one."""
    from test_stitch import render_camera_frames

    (W, H), outs = build_region_outputs("cylinder_slice_2x25_3dv", 576)
    assert ((W, H), outs) == jax_build_region_outputs("cylinder_slice_2x25_3dv", 576)
    spec = two_fisheye_rig()
    for s in spec["inputs"]:
        s["options"]["width"] = s["options"]["height"] = CAM
    frames = render_camera_frames(spec)
    ports, jaxes, gain_modes, rects = [], [], [], []
    for o in outs:
        region = {"output": o["output"], "inputs": spec["inputs"]}
        rw, rh = o["rect"][2:]
        mt, jmt = compile_rig(region, rw, rh), jax_compile_rig(region, rw, rh)
        mt.create_masks()
        jmt.create_masks()
        kw = dict(blend=16 if o["blend"] else 0, enable_gain=o["gain_mode"] >= 0)
        ports.append(Mapper(mt, SIZES, pipeline="rgb", device="cpu", **kw))
        jaxes.append(JaxMapper(jmt, SIZES, pipeline="rgb", blend_dtype="float32", **kw))
        gain_modes.append(o["gain_mode"])
        rects.append(o["rect"])
    assert gain_modes == [0, -1, -1, 3, -1, -1]
    region_out = run_pipeline(AsyncMultiMapper(ports, gain_modes=gain_modes), [frames])[0]
    jax_out = run_pipeline(JaxAsyncMultiMapper(jaxes, gain_modes=gain_modes), [frames])[0]
    for o, r in zip(region_out, jax_out):
        assert_mapper_bars(o, r)
    rgb = [yuv420p_to_rgb(torch.from_numpy(o)).numpy().astype(np.uint8) for o in region_out]
    canvas = RegionComposer((W, H), rects).compose(rgb)
    jcanvas = JaxRegionComposer((W, H), rects).compose(rgb)
    assert np.array_equal(canvas, jcanvas) and canvas.shape == (H, W, 3) == (256, 576, 3)
    for x, y, rw, rh in rects:
        assert (canvas[y : y + rh, x : x + rw] > 0).mean() > 0.5, (x, y, rw, rh)
    top = canvas[: H // 2, : outs[0]["rect"][2]].astype(np.float32)
    bot = canvas[H // 2 :, : outs[3]["rect"][2]].astype(np.float32)
    assert np.abs(top - bot).mean() < 1.0


def test_stage_failure_reaches_pop(rig):
    """A stage that raises (here the mapper, on a frame of the wrong
    shape) makes pop() raise instead of waiting forever, and close()
    returns promptly."""
    m = Mapper(rig["mt"], SIZES, blend=8, pipeline="rgb", device="cpu")
    amm = AsyncMultiMapper([m])
    amm.push([np.zeros((10, 10), np.uint8)] * 2)
    with pytest.raises(RuntimeError, match="pipeline failed") as e:
        amm.pop()
    assert isinstance(e.value.__cause__, ValueError)
    t0 = time.perf_counter()
    amm.close()
    assert time.perf_counter() - t0 < 10


def test_pipeline_rejects_bad_arguments(rig):
    m = Mapper(rig["mt"], SIZES, blend=8, pipeline="rgb", device="cpu")
    sm = ShardedMapper(rig["mt"], SIZES, make_mesh(2, 2, device="cpu"), blend=8)
    for kw in (dict(drain="disk"), dict(gain_modes=[0, 1])):
        with pytest.raises(ValueError):
            AsyncMultiMapper([m], **kw)
    with pytest.raises(ValueError, match="mixing"):
        AsyncMultiMapper([sm, m])


_TIMER = re.compile(r"^\[Timer (\w+)\] (.+): (\d+\.\d\d) ms$")


def test_timers_match_jax(rig, capfd):
    """Timer prints the reference's ``[Timer name] msg: X ms`` as the JAX
    Timer does; FpsMeter's rolling rate; the pipeline's stage timers
    every ``timer_interval`` frames, and its stats."""
    for cls in (Timer, JaxTimer):
        t = cls("stream", out=sys.stderr)  # the default is bound at import
        time.sleep(0.01)
        assert t.tick("frame 1") >= 10.0
    err = capfd.readouterr().err.splitlines()
    assert len(err) == 2 and all(_TIMER.match(line) for line in err)
    assert [_TIMER.match(line).group(1, 2) for line in err] == [("stream", "frame 1")] * 2
    silent = Timer("x", enabled=False)
    assert silent.tick("y") >= 0.0 and capfd.readouterr().err == ""

    for cls in (FpsMeter, JaxFpsMeter):
        meter = cls(window=4)
        assert meter.value() == 0.0 and meter.tick() == 0.0
        for _ in range(5):
            time.sleep(0.005)
            meter.tick()
        assert len(meter.times) == 4 and 0 < meter.value() <= 200

    m = Mapper(rig["mt"], SIZES, blend=8, pipeline="rgb", device="cpu")
    amm = AsyncMultiMapper([m], timers=True, timer_interval=2)
    run_pipeline(amm, rig["sets"][:4])
    lines = [_TIMER.match(line) for line in capfd.readouterr().err.splitlines()]
    assert all(lines) and [x.group(1, 2) for x in lines] == [
        ("stitch", s) for s in ("upload", "dispatch", "drain")
    ] * 2
    stats = amm.stats()
    assert stats["frames"] == 4 and stats["dispatch_ms"] > 0
    assert stats["h2d_GBps"] is None and stats["d2h_GBps"] is None  # no copies on the CPU
    assert amm.fps.value() > 0
