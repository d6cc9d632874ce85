#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (octvr_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each failing the run on any error:
  1. environment: torch, CUDA, triton, the card and its power limit;
  2. build of the CUDA kernels from csrc/ (nvcc, sm_90a), with its time;
  3. the remap kernel against its plain torch version on the card, NC=1
     and NC=2, f32 and bf16, on small fixtures and at one 1920^2
     camera's Y and U|V plans from the 4K template;
  4. a small rig (two fisheyes, 512x256): the port on CUDA in f32
     against the port on the CPU, and bf16 against f32 on CUDA;
  5. the main path: 6 x 1920^2 fisheyes -> 3840x1920 equirect,
     yuv420 + bf16 + gains, 24 frame sets from seed 0 on the device;
     ms/frame, first-call time, frame-0 checksum, peak memory, a kernel
     launch count, and one torch.profiler pass.
The line before the last is a JSON summary of the kernels; the last line
is {"ok": true, "device": {...}}.  Imports no JAX.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

CANVAS_W, CANVAS_H = 3840, 1920
CAM = 1920
ITERS = 24


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of one ``fn()`` in ms, by CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def phase_env():
    log("== 1. environment")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, "
        f"triton importable: {importlib.util.find_spec('triton') is not None}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    log(smi)
    return smi


def phase_build():
    from octvr_tpu_torch.utils import build

    log("== 2. kernel build")
    t0 = time.time()
    build.load_library()
    log(f"built/loaded {build.library_path().name} in {time.time() - t0:.2f} s")
    ptxas = build.library_path().with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())


def _check_kernel(planes, group, label):
    """Kernel vs plain version on the card; returns the f32 max abs err."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import remap_apply_reference

    k32 = cuda_remap.remap_apply(planes, group, torch.float32)
    k16 = cuda_remap.remap_apply(planes, group, torch.bfloat16)
    r32 = remap_apply_reference(planes, group, torch.float32)
    torch.cuda.synchronize()
    err32 = max((a - b).abs().max().item() for a, b in zip(k32, r32))
    err16 = max((a.float() - b).abs().max().item() for a, b in zip(k16, k32))
    log(f"  {label}: f32 max abs err {err32:.3g} (bar < 1e-3), "
        f"bf16 vs f32 {err16:.3g} (bar <= 1.0)")
    if not (err32 < 1e-3 and err16 <= 1.0):
        raise AssertionError(f"remap kernel disagrees with plain version: {label}")
    return err32


def _time_kernel(planes, group, dtype, label):
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import remap_apply_reference

    ms = cuda_ms(lambda: cuda_remap.remap_apply(planes, group, dtype))
    plain = cuda_ms(lambda: remap_apply_reference(planes, group, dtype), iters=3, warmup=1)
    log(f"  {label}: kernel {ms:.4f} ms, plain torch {plain:.4f} ms "
        f"({group.starts[-1]} output pixels x {planes.shape[1]} channels)")
    return ms, plain


def phase_kernel_small():
    from octvr_tpu_torch.ops.remap import remap_group, remap_plan
    from remap_fixtures import IN_H, IN_W, arc_maps, edge_maps

    log("== 3a. remap kernel vs plain version, small fixtures")
    rng = np.random.default_rng(7)
    err = 0.0
    for name, maps in (("arc", arc_maps(64, 256)), ("edge", edge_maps())):
        plans = [remap_plan(*maps, IN_H, IN_W),
                 remap_plan(*arc_maps(64, 256)[::-1], IN_H, IN_W)]
        group = remap_group(plans, "cuda")
        for nc in (1, 2):
            planes = torch.from_numpy(
                rng.integers(0, 256, (2, nc, IN_H, IN_W), dtype=np.uint8)
            ).cuda()
            err = max(err, _check_kernel(planes, group, f"{name} maps, NC={nc}"))
    return err


def phase_kernel_4k_camera(mt):
    from octvr_tpu_torch.ops.remap import remap_group, remap_plan
    from octvr_tpu_torch.stitch.yuv_mode import half_maps

    log("== 3b. remap kernel vs plain version, one 1920^2 camera of the 4K template")
    inp = mt.inputs[0]
    rng = np.random.default_rng(11)
    hm1, hm2, _ = half_maps(inp.map1, inp.map2, inp.roi)
    err = 0.0
    for nc, maps, (h, w) in (
        (1, (inp.map1, inp.map2), (CAM, CAM)),
        (2, (hm1, hm2), (CAM // 2, CAM // 2)),
    ):
        group = remap_group([remap_plan(*maps, h, w)], "cuda")
        planes = torch.from_numpy(rng.integers(0, 256, (1, nc, h, w), dtype=np.uint8)).cuda()
        err = max(err, _check_kernel(planes, group, f"camera 0, NC={nc}, ROI {maps[0].shape}"))
        for dtype in (torch.float32, torch.bfloat16):
            _time_kernel(planes, group, dtype, f"camera 0, NC={nc}, {str(dtype)[6:]}")
    return err


def _in_gamut_frames(rng, n, size, gains):
    """Packed YUV420P frames of smooth in-gamut RGB scenes (bench.py's
    default-path fixture), each scaled by its exposure gain."""
    frames = []
    for k in range(n):
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        rgb = np.stack(
            [
                127 + 90 * np.sin(6.3 * xx + 2 * yy + rng.uniform(0, 6)),
                127 + 90 * np.cos(4.1 * yy - 3 * xx + rng.uniform(0, 6)),
                127 + 90 * np.sin(2.7 * (xx + yy) + rng.uniform(0, 6)),
            ],
            axis=-1,
        ) * gains[k] + rng.normal(0.0, 6.0, (size, size, 3))
        r, g, b = (np.clip(rgb, 0, 255)[..., c] for c in range(3))
        y = 0.299 * r + 0.587 * g + 0.114 * b
        u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
        v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
        h2 = size // 2
        u2 = u.reshape(h2, 2, h2, 2).mean(axis=(1, 3))
        v2 = v.reshape(h2, 2, h2, 2).mean(axis=(1, 3))
        buf = np.concatenate([y, np.concatenate([u2, v2], axis=1)], axis=0)
        frames.append(np.clip(np.round(buf), 0, 255).astype(np.uint8))
    return frames


def phase_small_rig():
    from octvr_tpu.template import compile_rig
    from octvr_tpu_torch.stitch import Mapper
    from rigs import two_fisheye_rig

    log("== 4. small rig: two 1200^2 fisheyes -> 512x256, blend 16, gains")
    rig = two_fisheye_rig()
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [(s["options"]["height"], s["options"]["width"]) for s in rig["inputs"]]
    frames = _in_gamut_frames(np.random.default_rng(3), 2, sizes[0][0], [1.15, 0.85])
    kw = dict(blend=16, enable_gain=True, pipeline="yuv420")
    out_cpu, g_cpu = Mapper(mt, sizes, blend_dtype="float32", device="cpu", **kw).stitch(frames)
    out32, g32 = Mapper(mt, sizes, blend_dtype="float32", device="cuda", **kw).stitch(frames)
    out16, _ = Mapper(mt, sizes, device="cuda", **kw).stitch(frames)
    h = 256
    d = (out32.cpu().float() - out_cpu.float()).abs()
    y_err, uv_err = d[:h].mean().item(), d[h:].mean().item()
    g_err = (g32.cpu() - g_cpu).abs().max().item()
    bf_err = (out16.float() - out32.float()).abs()[:h].mean().item()
    log(f"  CUDA f32 vs CPU f32: Y mean abs err {y_err:.4f}, UV {uv_err:.4f} "
        f"(bar < 0.2), gains max err {g_err:.3g} (bar < 1e-3), gains {g32.tolist()}")
    log(f"  CUDA bf16 vs CUDA f32: Y mean abs err {bf_err:.4f} (bar < 1.5)")
    if not (y_err < 0.2 and uv_err < 0.2 and g_err < 1e-3 and bf_err < 1.5):
        raise AssertionError("small-rig parity failed")


def phase_main_path(mt, t_template):
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.stitch import Mapper

    log("== 5. main path: 6 x 1920^2 fisheyes -> 3840x1920, yuv420 + bf16 + gains")
    log(f"  template compiled in {t_template:.1f} s (host)")
    sizes = [(CAM, CAM)] * 6
    t0 = time.time()
    mapper = Mapper(mt, sizes, blend=128, enable_gain=True, device="cuda")
    torch.cuda.synchronize()
    log(f"  plan built and moved to the card in {time.time() - t0:.1f} s "
        f"(blend_dtype={mapper.plan.blender.compute_dtype})")
    if mapper.plan.blender.compute_dtype != "bfloat16":
        raise AssertionError("CUDA default blend dtype is not bfloat16")

    rng = np.random.default_rng(0)
    base = [rng.integers(0, 255, (CAM * 3 // 2, CAM), dtype=np.uint8) for _ in range(6)]
    base_t = torch.from_numpy(np.stack(base)).cuda().to(torch.int16)
    frame_sets = [
        list((base_t + i).clamp(0, 255).to(torch.uint8).unbind(0)) for i in range(ITERS)
    ]
    torch.cuda.synchronize()

    # the main path's launch count: reset just before, read just after
    cuda_remap.LAUNCHES = 0
    t0 = time.time()
    out, gains = mapper.stitch(frame_sets[0])
    checksum = int(out[::101, ::103].to(torch.int64).sum().item())
    t_first = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    for fs in frame_sets:
        mapper.stitch(fs)
    ms_enqueue = (time.time() - t0) / ITERS * 1e3
    torch.cuda.synchronize()
    ms_frame = (time.time() - t0) / ITERS * 1e3
    launches = cuda_remap.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    log(f"  first call {t_first:.3f} s")
    log(f"  output checksum (frame 0): {checksum}")
    log(f"  steady {ms_frame:.3f} ms/frame over {ITERS} frames "
        f"({1e3 / ms_frame:.2f} frames/s), synchronised; the host enqueued "
        f"them at {ms_enqueue:.3f} ms/frame")
    log(f"  peak device memory in the steady loop {peak / 2**30:.3f} GiB")
    log(f"  remap kernel launches: {launches} over {ITERS + 1} frames")
    if launches != 2 * (ITERS + 1):
        raise AssertionError(f"expected {2 * (ITERS + 1)} remap launches, got {launches}")
    if out.dtype != torch.uint8 or tuple(out.shape) != (CANVAS_H * 3 // 2, CANVAS_W):
        raise AssertionError(f"bad output {out.dtype} {tuple(out.shape)}")
    if not torch.isfinite(gains).all():
        raise AssertionError(f"non-finite gains {gains}")
    y = out[:CANVAS_H]
    if int(y.max()) == int(y.min()):
        raise AssertionError("constant Y plane")
    log(f"  gains {[round(g, 5) for g in gains.tolist()]}")

    # bf16 main path against the same path in f32 on the card
    out32, _ = Mapper(mt, sizes, blend=128, enable_gain=True, blend_dtype="float32",
                      device="cuda").stitch(frame_sets[0])
    y_err = (out32[:CANVAS_H].float() - y.float()).abs().mean().item()
    log(f"  bf16 vs f32 main path, frame 0: Y mean abs err {y_err:.4f} (bar < 1.5)")
    if not y_err < 1.5:
        raise AssertionError("bf16 main path drifts from f32")
    del out32

    # the kernel and its plain version at the main path's own launches
    from octvr_tpu_torch.ops.remap import remap_apply_reference

    ys, uvs = mapper._prep_yuv(frame_sets[0])
    planes_y = torch.stack([t[None] for t in ys])
    planes_uv = torch.stack(uvs)
    gy, guv = mapper.plan.remap_y_groups[0], mapper.plan.remap_uv_groups[0]
    err = 0.0
    for planes, g, nc in ((planes_y, gy, 1), (planes_uv, guv, 2)):
        k = cuda_remap.remap_apply(planes, g, torch.float32)
        r = remap_apply_reference(planes, g, torch.float32)
        err = max(err, max((a - b).abs().max().item() for a, b in zip(k, r)))
    log(f"  6-camera group launches, kernel vs plain f32: max abs err {err:.3g}")
    if not err < 1e-3:
        raise AssertionError("remap kernel disagrees at the main path's shapes")
    ms_y, plain_y = _time_kernel(planes_y, gy, torch.bfloat16, "Y group launch, NC=1, bf16")
    ms_uv, plain_uv = _time_kernel(planes_uv, guv, torch.bfloat16, "UV group launch, NC=2, bf16")
    plan_bytes = 16 * (gy.starts[-1] + guv.starts[-1])
    log(f"  per frame: kernel {ms_y + ms_uv:.4f} ms for {plan_bytes / 1e6:.1f} MB of plan "
        f"({plan_bytes / (ms_y + ms_uv) / 1e6:.1f} GB/s of plan reads)")
    del planes_y, planes_uv, ys, uvs

    profile(mapper, frame_sets, ms_frame)
    return {
        "launches": launches,
        "ms": ms_y + ms_uv,
        "plain_ms": plain_y + plain_uv,
        "err": err,
    }


_KERNEL_CLASSES = (
    ("remap (csrc/remap.cu)", ("remap_kernel",)),
    ("matmul (pyramid, pooling)", ("gemm", "xmma", "cutlass")),
    ("dtype casts and copies", ("copy",)),
    ("reductions (gain sums)", ("reduce",)),
)


def profile(mapper, frame_sets, ms_frame):
    """One torch.profiler pass over 3 frames: device time of the
    kernels, by class and by name, and the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for fs in frame_sets[:2]:
        mapper.stitch(fs)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fs in frame_sets[:3]:
            mapper.stitch(fs)
        torch.cuda.synchronize()
    kernels = sorted(
        (
            (e.self_device_time_total / 3e3, e.count / 3, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
        ),
        reverse=True,
    )
    busy = sum(k[0] for k in kernels)
    log(f"  profiler, 3 frames: kernels busy {busy:.3f} ms/frame, "
        f"{sum(k[1] for k in kernels):.0f} kernel launches/frame; busy share "
        f"{busy / ms_frame:.3f} of the unprofiled {ms_frame:.3f} ms/frame")
    by_class = {}
    for ms, _, key in kernels:
        cls = next(
            (c for c, words in _KERNEL_CLASSES if any(w in key for w in words)),
            "other elementwise",
        )
        by_class[cls] = by_class.get(cls, 0.0) + ms
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.4f} ms/frame  {cls}")
    for ms, count, key in kernels[:12]:
        log(f"    {ms:9.4f} ms/frame  x{count:5.1f}  {key[:90]}")


def main():
    smi = phase_env()
    phase_build()
    err_small = phase_kernel_small()

    from bench import six_cam_rig
    from octvr_tpu.template import compile_rig

    t0 = time.time()
    mt = compile_rig(six_cam_rig(), CANVAS_W, CANVAS_H)
    mt.create_masks()
    t_template = time.time() - t0
    err_cam = phase_kernel_4k_camera(mt)
    phase_small_rig()
    main_path = phase_main_path(mt, t_template)

    log("== summary")
    log(f"card: {smi}")
    print(json.dumps({"kernels": [{
        "name": "remap (yuv420 Y NC=1 + U|V NC=2)",
        "route": "cuda",
        "source": "octvr_tpu_torch/csrc/remap.cu",
        "replaces": "octvr_tpu/ops/pallas_remap.py:661",
        "launches": main_path["launches"],
        "max_abs_err": max(err_small, err_cam, main_path["err"]),
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
