#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (octvr_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each failing the run on any error:
  1. environment: torch, CUDA, triton, the card and its power limit;
  2. build of the two kernel libraries (utils/build.py: ``product``,
     csrc/remap.cu; ``tools``, csrc/mxu_taps.cu; nvcc, sm_90a), one nvcc
     each, started together, with each one's time and ptxas register
     and spill lines;
  3. the remap kernels (csrc/remap.cu: remap_kernel for one frame,
     remap_frames_kernel for B frames) against their plain torch
     version on the card:
     a. NC=1 and NC=2, f32 and bf16, on small fixtures;
     b. at one 1920^2 camera's Y and U|V plans from the 4K template;
     c. NC=3 (the rgb remap) on the small fixtures, at one 4K camera's
        plan and as a single-input launch (the mixed-size shape);
     d. frames launches (B = 1, 3, 4, 5; stacked and concat sources)
        against B one-frame launches, bit for bit;
     e. kernel 6, the concat-source mode (each input reads a slice of
        camera rows of its own height), NC=1/2, f32/bf16, on the 96x256
        fixture and on one band of the 4K band-sharded plan (S=4, source
        windows), and its frames launch (B=4) against B one-frame
        launches;
     f. kernel 6 at NC=3 (the rgb band path) on the 96x256 fixture, with
        its frames launch, and on one band of the 4K rgb band-sharded
        plan;
     g. kernel 8, the MXU-taps probe's three kernels (A a gather from
        the step's window staged in shared memory, plan in 16 B vectors;
        B the folded f32 weights as three bf16 products and B2 two exact
        bf16 selection products, both wgmma on the tensor cores), each
        against its plain version and the others, timed at the probe's
        defaults with the function's bound (bytes over 3.35 TB/s: the
        three compute one bilinear sample), its own formulation's
        operation floor (flops over 67 TFLOP/s f32 for A, 989 TFLOP/s
        bf16 for B and B2) and grid_sample on the same function; then the
        probe's entry point
        (octvr_tpu_torch.tools.mxu_taps_probe), whose launches are the
        kernels' counts;
     h. every 4K remap launch timed (``remap_rows``): device ms, the
        eager call's ms, the plain version's ms, the bytes it must move,
        its bound (bytes over 3.35 TB/s, or f32 flops over 67 TFLOP/s if
        larger) and share, and the device ms of
        torch.nn.functional.grid_sample on the same shapes (the library
        yardstick);
  4. small rigs (two fisheyes, 512x256): the port on CUDA in f32 against
     the port on the CPU, and bf16 against f32 on CUDA;
     b. every Mapper option on both pipelines, FastMapper, and a
        mixed-size rig (rgb also with a bf16 blend and gains, which
        stores f32 as the JAX Mapper does), CUDA against CPU;
     c. the default-path regression of bench.py: the CUDA defaults
        (yuv420 + bf16) against rgb + f32 on the card;
     d. the band-sharded stitcher (ShardedMapper, S=4) on CUDA in f32
        against the port on the CPU, source windows and the two-level
        blend split each on and off, and against the CUDA Mapper at the
        JAX package's sharded-vs-single bars;
     e. every ShardedMapper option on both pipelines at S=4 (split on
        and off, source windows, mixed sizes, feather, paste, blocks
        gains, an overlay, scale_output, NV12, out_format="rgb"), CUDA
        against CPU, with each option's launches;
  5. the main path: 6 x 1920^2 fisheyes -> 3840x1920, the rig of the JAX
     package's benchmark (its own copy here, ``six_cam_rig``), yuv420 +
     bf16 + gains, 24 frame sets from seed 0 on the device; ms/frame,
     first-call time, frame-0 checksum, peak memory, kernel launch
     counts, and one torch.profiler pass;
     b. the same rig on the rgb pipeline (blend 128, gains, bf16);
     c. stitch_batch at B=4 on the yuv420 pipeline against stitch;
  6. the band-sharded path: the same 4K rig through make_mesh(1, 4) with
     source windows (kernel 6), blend 128, gains, bf16, on phase 5's
     frame sets, at B=1 and at B=4 through the frames axis; plan-build
     and first-call times, ms/frame, enqueue ms/frame, peak memory,
     checksum, launches per frame, one profiler pass, and the output
     against phase 5's Mapper output;
     b. the rgb band path: the same through ShardedMapper(pipeline="rgb")
        (kernel 6 at NC=3, one launch per frame), against phase 5b's rgb
        Mapper output;
  7. the streaming path (runtime.AsyncMultiMapper: pinned and device
     rings on an H2D stream, the stitch on its own stream, a D2H
     stream), each run with the remap counts reset just before it and
     read just after:
     a. over phase 5's Mapper, 48 host frame sets in, host frames out:
        every output bit-identical to Mapper.stitch of its set, in
        order; frames/s host to host, the three stage timers, H2D and
        D2H GB/s beside phase 5's ms/frame;
     b. the checksum drain from host frame sets and from the
        device-resident ones (no H2D), its checksums the reference's;
        then 3 rounds, in turns, of the stitch dispatch's host ms/frame
        alone (main thread, own thread) and inside the pipeline (device
        frames with the checksum drain, host frames with the host
        drain), and their medians;
     c. two outputs on a small rig (two 512^2 fisheyes -> 512x256) with
        gain_modes [0, 0]: both bit-identical to direct stitch calls,
        the copier's with the owner's gains;
     d. over ShardedMapper: a make_mesh(2, 2) one on the small rig fed 5
        frame sets (the last batch padded: every real frame out, no
        padding frame), and phase 6's 4K one; each output equal to
        stitch_batch called directly;
     e. ``python -m octvr_tpu_torch.cli.stream`` as a process on the
        card: on the small rig from raw files (6 frames, each within the
        Mapper bars of the port on the CPU: per plane mean < 0.2 and max
        <= 2), and at 4K from the synthetic source with --timers (48
        frames, its "# done" fps); ``python -m octvr_tpu_torch.cli.map``
        on the card on the small rig's PNGs (feather blend, gains): the
        PNG within the map CLI's RGB bars of the same steps by the port
        on the CPU (per channel mean < 0.2, max <= 6), gains within 1e-3;
     f. ``python -m octvr_tpu_torch.cli.monkey`` on the small rig's NV12
        feeds: every frame equal to FastMapper.stitch_nv12's.
Kernel times (``ms``, ``library_ms``) are device times
(``device_ms``): K back-to-back calls captured in one CUDA graph, K
enough for ~2 ms of work, replayed in 5 CUDA-event windows; the median
over K, printed with its spread.  ``call_ms`` is the eager call's time
(``steady_ms``: the median of 5 CUDA-event windows of ~2 ms of eager
calls), which for a launch under ~50 MB reads the host's per-call path,
not the kernel.  The line before the last is a JSON summary of the
kernels; the last line is {"ok": true, "device": {...}}.  Imports no
JAX.

    python3 chip_smoke.py --time-remap ROOT
    python3 chip_smoke.py --time-taps ROOT

times only the 4K remap launches (phase 3h's rows, device and call ms),
or only kernel 8's three bodies at the probe's defaults (3g's timing,
each held to A), of the package in the checkout at ROOT and prints them
as one JSON line: run it on two checkouts in turns, in one call on one
card, to compare their kernels (an earlier commit's, or an edited copy
of a source).
"""

import importlib.util
import json
import math
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
RGB_ITERS = 8
BATCH = 4
SPACE = 4  # bands of the sharded phases
SHARD_ITERS = 12
TAPS = dict(steps=1917, g=8, kh=80, lo=16, hi=64)  # the MXU-taps probe's defaults
TAPS_CHECK_STEPS = 64


PI = math.pi


def six_cam_rig():
    """The 4K rig of the JAX package's benchmark (bench.py:32-69), its
    own copy: 4 side fisheyes (hfov 1.75) and 2 pole fisheyes (hfov 2.2),
    1920^2 each, with radial distortion and a vignette."""
    inputs = []
    for yaw in (0, PI / 2, PI, -PI / 2):
        inputs.append(
            {
                "type": "fullframe_fisheye",
                "options": {
                    "width": CAM,
                    "height": CAM,
                    "hfov": 1.75,
                    "center_dx": 0.0,
                    "center_dy": 0.0,
                    "radial": [0.01, -0.02, 0.0],
                    "vignette": [1.0, -0.15, 0.05, 0.0],
                    "rotation": {"roll": 0.0, "yaw": yaw, "pitch": 0.0},
                },
            }
        )
    for pitch in (PI / 2, -PI / 2):
        inputs.append(
            {
                "type": "fullframe_fisheye",
                "options": {
                    "width": CAM,
                    "height": CAM,
                    "hfov": 2.2,
                    "center_dx": 0.0,
                    "center_dy": 0.0,
                    "radial": [0.01, -0.02, 0.0],
                    "vignette": [1.0, -0.15, 0.05, 0.0],
                    "rotation": {"roll": 0.0, "yaw": 0.0, "pitch": pitch},
                },
            }
        )
    return {
        "output": {"type": "equirectangular", "options": {}},
        "inputs": inputs,
    }


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


def steady_ms(fn, windows=5, window_ms=2.0):
    """Time of one eager ``fn()`` call in ms as (median, min, max) over
    ``windows`` CUDA-event windows (``cuda_ms``), each of enough calls
    for about ``window_ms`` of work by a first estimate.  A call whose
    device work is shorter than its host path reads the host's pace:
    this is a call time, not a kernel time (``device_ms``)."""
    est = cuda_ms(fn, iters=3, warmup=2)
    iters = min(2000, max(1, math.ceil(window_ms / max(est, 1e-3))))
    times = sorted(cuda_ms(fn, iters=iters, warmup=1) for _ in range(windows))
    return times[windows // 2], times[0], times[-1]


def device_ms(fn, windows=5, window_ms=2.0):
    """Device time of one ``fn()`` in ms as (median, min, max), without
    the host's per-call path: K back-to-back calls are captured in one
    CUDA graph (K enough for about ``window_ms`` of work, from a replay
    of 8 calls), the graph is replayed in ``windows`` CUDA-event windows,
    and each window's time is divided by K.  ``fn`` must launch only
    capturable work (no host sync).  Calls run back to back, so a launch
    whose inputs fit the 50 MB L2 finds them there, for a kernel and its
    ``grid_sample`` yardstick alike."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)

    def replay_ms(graph, k):
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / k

    def capture(k):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(k):
                fn()
        graph.replay()  # the first replay uploads the graph
        return graph

    graph = capture(8)
    est = replay_ms(graph, 8)
    del graph
    k = min(4000, max(1, math.ceil(window_ms / max(est, 1e-4))))
    graph = capture(k)
    times = sorted(replay_ms(graph, k) for _ in range(windows))
    del graph
    torch.cuda.synchronize()
    return times[windows // 2], times[0], times[-1]


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
    """Builds the two kernel libraries, each from its own sources, with
    one nvcc process per library, all started together; prints each
    build's time and its ptxas register and spill lines."""
    from concurrent.futures import ThreadPoolExecutor

    from octvr_tpu_torch.utils import build

    log("== 2. kernel build")

    def timed(group):
        t0 = time.time()
        build.load_library(group)
        return time.time() - t0

    t0 = time.time()
    with ThreadPoolExecutor(len(build.GROUPS)) as pool:
        took = dict(zip(build.GROUPS, pool.map(timed, build.GROUPS)))
    log(f"  both built/loaded in {time.time() - t0:.2f} s")
    for group in build.GROUPS:
        lib = build.library_path(group)
        log(f"  {group}: {lib.name} ({', '.join(build.GROUPS[group])}) in {took[group]:.2f} s")
        ptxas = lib.with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "Compiling entry", "wgmma", "arning")):
                    log("    ptxas: " + line.strip())


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


# H100 SXM peaks at its full power limit (700 W): HBM3 bytes/s, f32
# FLOP/s outside the tensor cores and dense bf16 FLOP/s on the tensor
# cores (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def _bound(groups, dtype, frames=1):
    """(bytes, bound ms, "bytes" or "operations") of launches over
    ``groups`` ((RemapGroup, channels) pairs) on ``frames`` frames: each
    valid output pixel reads 16 B of plan (x0, y0, fx, fy), each invalid
    one 4 B (x0); every pixel stores its channels; the source bytes are
    read once.  The plan is read once for all frames, sources and stores
    once per frame.  4 FMAs per channel per valid pixel (8 f32 flops).
    The bound is the larger of bytes over the HBM rate and flops over
    the f32 rate."""
    store = 2 if dtype == torch.bfloat16 else 4
    nbytes = flops = 0
    for group, nc in groups:
        n = group.starts[-1]
        v = int((group.x0 >= 0).sum().item())
        nbytes += 16 * v + 4 * (n - v) + frames * nc * (store * n + group.src_rows * group.in_shape[1])
        flops += frames * 8 * nc * v
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return nbytes, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _grid_sample_ms(flat, group, nc):
    """The library yardstick: device ms (``device_ms``) of
    torch.nn.functional.grid_sample
    (bilinear, zeros padding, align_corners=False) computing the same
    output pixels from the same sources, converted to f32 beforehand;
    one call per distinct source height (its inputs stacked, each
    input's pixels a row of the sample grid, padded to the longest).
    Not the contract: it differs at the first half-pixel (F1) and gives
    no exact 0 for an invalid map."""
    import torch.nn.functional as F

    W = group.in_shape[1]
    b = flat.shape[0]
    calls = {}
    for i, (r0, h) in enumerate(zip(group.src_row0, group.src_h)):
        calls.setdefault(h, []).append((i, r0))
    work = []
    for h, members in calls.items():
        srcs, grids = [], []
        pmax = max(group.starts[i + 1] - group.starts[i] for i, _ in members)
        for i, r0 in members:
            s, e = group.starts[i], group.starts[i + 1]
            srcs.append(flat[:, nc * r0 * W : nc * (r0 + h) * W].view(b, nc, h, W))
            x = group.x0[s:e].float() + group.fx[s:e]
            y = group.y0[s:e].float() + group.fy[s:e]
            grid = torch.stack([2 * (x + 0.5) / W - 1, 2 * (y + 0.5) / h - 1], dim=-1)
            grid[group.x0[s:e] < 0] = -2.0
            grids.append(torch.nn.functional.pad(grid, (0, 0, 0, pmax - (e - s)), value=-2.0))
        inp = torch.stack(srcs, dim=1).flatten(0, 1).float()
        grid = torch.stack(grids)[:, None].repeat(b, 1, 1, 1)
        work.append((inp, grid))

    def run():
        for inp, grid in work:
            F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=False)

    ms = device_ms(run)[0]
    del work
    return ms


def _time_kernel(src, group, dtype, label, frames=False, full=True):
    """Times of one raw launch (``launch_flat``): ``ms``, its device time
    (``device_ms``), and ``call_ms``, the eager call's time
    (``steady_ms``), which below ~50 MB reads the host path of
    ``launch_flat``.  With ``full`` also the plain version's ms, the
    device ms of ``grid_sample`` on the same shapes and the launch's
    bound (``_bound``).  Returns {ms, call_ms[, plain_ms, bound_ms,
    bound_by, library_ms, bytes]}."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import flat_source, remap_apply_frames_reference, remap_apply_reference

    def launch():
        cuda_remap.launch_flat(src, group, dtype, frames=frames)

    ms, ms_lo, ms_hi = device_ms(launch)
    call = steady_ms(launch)[0]
    out = {"ms": ms, "call_ms": call}
    if not full:
        log(f"  {label}: device {ms:.5f} ms (median; spread {ms_lo:.5f}-{ms_hi:.5f}), call {call:.5f} ms")
        return out
    plain_fn = remap_apply_frames_reference if frames else remap_apply_reference
    plain = cuda_ms(lambda: plain_fn(src, group, dtype), iters=3, warmup=1)
    flat, c = flat_source(src, group, frames)
    nbytes, bound, by = _bound(((group, c),), dtype, flat.shape[0])
    lib = _grid_sample_ms(flat, group, c)
    valid = int((group.x0 >= 0).sum().item()) / group.starts[-1]
    log(f"  {label}: device {ms:.5f} ms (median; spread {ms_lo:.5f}-{ms_hi:.5f}), call {call:.5f} ms, "
        f"plain torch {plain:.4f} ms, grid_sample {lib:.5f} ms (device); {group.starts[-1]} output pixels "
        f"({valid:.3f} valid) x {c} channels{f' x {flat.shape[0]} frames' if frames else ''}, "
        f"{nbytes / 1e6:.1f} MB at least, {nbytes / ms / 1e9:.3f} TB/s; bound {bound:.5f} ms ({by}), "
        f"share {bound / ms:.3f}")
    out.update(plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib, bytes=nbytes)
    return out


def _sum_times(*ts):
    """The times of launches that run together, summed."""
    out = {k: sum(t[k] for t in ts) for k in ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms", "bytes")}
    out["bound_by"] = "bytes" if all(t["bound_by"] == "bytes" for t in ts) else "operations"
    return out


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
    return err


def phase_kernel_nc3(mt):
    """NC=3 against its plain version: f32 within 1e-3, bf16 within 1.0
    of f32, on the small fixtures and on one 4K camera's single-input
    launch (the mixed-size shape).  Returns the max f32 error."""
    from octvr_tpu_torch.ops.remap import remap_group, remap_plan
    from remap_fixtures import IN_H, IN_W, arc_maps, edge_maps

    log("== 3c. NC=3 (rgb) remap kernel vs plain version")
    rng = np.random.default_rng(13)
    err = 0.0
    for name, maps in (("arc", arc_maps(64, 256)), ("edge", edge_maps())):
        plans = [remap_plan(*maps, IN_H, IN_W),
                 remap_plan(*arc_maps(64, 256)[::-1], IN_H, IN_W)]
        planes = torch.from_numpy(
            rng.integers(0, 256, (2, 3, IN_H, IN_W), dtype=np.uint8)
        ).cuda()
        err = max(err, _check_kernel(planes, remap_group(plans, "cuda"), f"{name} maps, NC=3"))
    inp = mt.inputs[0]
    group = remap_group([remap_plan(inp.map1, inp.map2, CAM, CAM)], "cuda")
    planes = torch.from_numpy(rng.integers(0, 256, (1, 3, CAM, CAM), dtype=np.uint8)).cuda()
    err = max(err, _check_kernel(planes, group, f"camera 0 single-input launch, NC=3, ROI {inp.map1.shape}"))
    return err


def phase_frames_axis():
    """The frames kernel over B frames against B one-frame launches:
    bit-identical, B in (1, 3, 4, 5), NC=1 and NC=2 (the yuv420 planes)
    and NC=3, f32 and bf16, on stacked sources and on concat sources
    (kernel 6's fixture)."""
    from octvr_tpu_torch.ops.remap import concat_source, remap_group, remap_plan
    from remap_fixtures import H_B, IN_H, IN_W, LO, arc_maps, concat_maps, edge_maps

    log("== 3d. frames launch (B = 1, 3, 4, 5) vs B one-frame launches")
    stacked = remap_group(
        [remap_plan(*arc_maps(64, 256), IN_H, IN_W), remap_plan(*edge_maps(), IN_H, IN_W)], "cuda"
    )
    a, _, b_s = concat_maps()
    concat = remap_group([remap_plan(*a, IN_H, IN_W), remap_plan(*b_s, H_B, IN_W)], "cuda")
    rng = np.random.default_rng(17)
    for nc in (1, 2, 3):
        for b in (1, 3, BATCH, 5):
            planes = torch.from_numpy(rng.integers(0, 256, (b, 2, nc, IN_H, IN_W), dtype=np.uint8)).cuda()
            cat = concat_source([planes[:, 0], planes[:, 0, :, LO : LO + H_B]], frames=True)
            for name, src, group in (("stacked", planes, stacked), ("concat", cat, concat)):
                for dtype in (torch.float32, torch.bfloat16):
                    if not _frames_equal_one_frame(src, group, dtype):
                        raise AssertionError(
                            f"frames launch differs from one-frame launches: NC={nc}, B={b}, {name}, {dtype}")
        log(f"  NC={nc}: B = 1, 3, {BATCH}, 5, stacked and concat, f32 and bf16: bit-identical")


def _check_concat(src, group, label, frames=False):
    """Kernel 6 against its plain version: f32 within 1e-3 and the bf16
    store equal to the cast f32 store.  Returns the f32 max abs err."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import remap_apply_frames_reference, remap_apply_reference

    apply = cuda_remap.remap_apply_frames if frames else cuda_remap.remap_apply
    ref = remap_apply_frames_reference if frames else remap_apply_reference
    k32 = apply(src, group, torch.float32)
    k16 = apply(src, group, torch.bfloat16)
    r32 = ref(src, group, torch.float32)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(k32, r32))
    cast = all(torch.equal(a, b.to(torch.bfloat16)) for a, b in zip(k16, k32))
    log(f"  {label}: f32 max abs err {err:.3g} (bar < 1e-3), bf16 store == cast f32 store: {cast}")
    if not (err < 1e-3 and cast):
        raise AssertionError(f"kernel 6 disagrees with its plain version: {label}")
    return err


def _traffic(groups, t, label):
    """Logs the share of valid output pixels of a frame's launches
    (``groups``: (RemapGroup, channels) pairs), the bytes they must move
    (``_bound``) and the rate and bound share in their summed time ``t``."""
    total = sum(g.starts[-1] for g, _ in groups)
    valid = sum(int((g.x0 >= 0).sum().item()) for g, _ in groups)
    log(f"  {label}: {total} output pixels, {valid / total:.3f} of them valid; at least "
        f"{t['bytes'] / 1e6:.1f} MB moved in {t['ms']:.4f} ms ({t['bytes'] / t['ms'] / 1e9:.3f} TB/s); "
        f"bound {t['bound_ms']:.4f} ms, share {t['bound_ms'] / t['ms']:.3f}; grid_sample {t['library_ms']:.4f} ms")


def _frames_equal_one_frame(src, group, dtype):
    from octvr_tpu_torch.ops import cuda_remap

    got = cuda_remap.remap_apply_frames(src, group, dtype)
    return all(
        torch.equal(g[b], one)
        for b in range(src.shape[0])
        for g, one in zip(got, cuda_remap.remap_apply(src[b], group, dtype))
    )


def phase_kernel_concat(host, frame_sets):
    """Kernel 6 (concat-source mode) against its plain version, on the
    96x256 fixture and on one band of the 4K band-sharded plan: each
    input of the band's launch reads its own source block (sliced side
    cameras, whole pole cameras).  Returns the max f32 error."""
    from octvr_tpu_torch.ops.remap import concat_source, remap_group, remap_plan
    from remap_fixtures import H_B, IN_H, IN_W, LO, concat_maps

    log("== 3e. kernel 6 (concat-source remap) vs plain version")
    sm, _ = sharded_on_card(host)
    a, _, b_s = concat_maps()
    group = remap_group([remap_plan(*a, IN_H, IN_W), remap_plan(*b_s, H_B, IN_W)], "cuda")
    rng = np.random.default_rng(19)
    err = 0.0
    for nc in (1, 2):
        planes = torch.from_numpy(rng.integers(0, 256, (BATCH, nc, IN_H, IN_W), dtype=np.uint8)).cuda()
        src = concat_source([planes, planes[..., LO : LO + H_B, :]], frames=True)
        err = max(err, _check_concat(src[0], group, f"96x256 fixture, input B rows [{LO}, {LO + H_B}), NC={nc}"))
        err = max(err, _check_concat(src, group, f"96x256 fixture, frames axis B={BATCH}, NC={nc}", frames=True))

    band = 1
    log(f"  4K band-sharded plan, band {band} of {host.S}: source heights {host.src_h}, "
        f"rows from {host.src_row0[band].tolist()}")
    bufs = sm._frames_to_device([torch.stack(f) for f in zip(*frame_sets[:BATCH])])
    ys, uvs = sm._prep_band_yuv(bufs)
    for nc, parts, plans in ((1, ys, host.remap), (2, uvs, host.remap_uv)):
        group = remap_group([p[band] for p in plans], "cuda", concat=True)
        blocks = [x[:, band if x.shape[1] > 1 else 0] for x in parts]  # [B, C, h, W] each
        src = concat_source(blocks, frames=True)
        label = f"4K band {band}, NC={nc}, {len(plans)} inputs"
        err = max(err, _check_concat(src[0], group, label))
        err = max(err, _check_concat(src, group, f"{label}, frames axis B={BATCH}", frames=True))
        for dtype in (torch.float32, torch.bfloat16):
            same = _frames_equal_one_frame(src, group, dtype)
            log(f"  {label}, frames axis B={BATCH} vs {BATCH} one-frame launches, "
                f"{str(dtype)[6:]}: bit-identical {same}")
            if not same:
                raise AssertionError(f"kernel 6 frames axis differs from one-frame launches: {label}")
    return err


def phase_kernel_concat_nc3(host, frame_sets):
    """Kernel 6 at NC=3, the rgb band path's launch, against its plain
    version: f32 within 1e-3 and the bf16 store equal to the cast f32
    store, on the 96x256 fixture (and its frames axis, bit-identical to
    one-frame launches) and on one band of the 4K rgb band-sharded plan.
    Returns the max f32 error."""
    from octvr_tpu_torch.ops.remap import concat_source, remap_group, remap_plan
    from remap_fixtures import H_B, IN_H, IN_W, LO, concat_maps

    log("== 3f. kernel 6 at NC=3 (rgb band path) vs plain version")
    a, _, b_s = concat_maps()
    group = remap_group([remap_plan(*a, IN_H, IN_W), remap_plan(*b_s, H_B, IN_W)], "cuda")
    rng = np.random.default_rng(23)
    planes = torch.from_numpy(rng.integers(0, 256, (BATCH, 3, IN_H, IN_W), dtype=np.uint8)).cuda()
    src = concat_source([planes, planes[..., LO : LO + H_B, :]], frames=True)
    err = _check_concat(src[0], group, f"96x256 fixture, input B rows [{LO}, {LO + H_B}), NC=3")
    err = max(err, _check_concat(src, group, f"96x256 fixture, frames axis B={BATCH}, NC=3", frames=True))
    for dtype in (torch.float32, torch.bfloat16):
        same = _frames_equal_one_frame(src, group, dtype)
        log(f"  96x256 fixture, NC=3, frames axis vs {BATCH} one-frame launches, {str(dtype)[6:]}: "
            f"bit-identical {same}")
        if not same:
            raise AssertionError("kernel 6 NC=3 frames axis differs from one-frame launches")

    band = 1
    sm, _ = sharded_on_card(host)
    log(f"  4K rgb band-sharded plan, band {band} of {host.S}: source heights {host.src_h}, "
        f"rows from {host.src_row0[band].tolist()}")
    parts = sm._prep_band_rgb(sm._frames_to_device([f[None] for f in frame_sets[0]]))
    group = remap_group([p[band] for p in host.remap], "cuda", concat=True)
    src = concat_source([x[0, band if x.shape[1] > 1 else 0] for x in parts])
    label = f"4K rgb band {band}, NC=3, {len(host.remap)} inputs"
    err = max(err, _check_concat(src, group, label))
    return err


def remap_rows(mt, host, host_rgb):
    """Every timed remap launch at 4K, as the paths build it: key ->
    (label, source, group, store dtype, frames).  The groups are the
    Mapper's (its size group of the 6 cameras, Y at full and U|V at half
    resolution, RGB on the Y plans), one camera's (3b, and kernel 4's
    single-input launch), the band-sharded plans' (``host``, ``host_rgb``:
    band 1 as 3e and 3f check it, and each path's whole launch); the
    sources are random uint8 from seed 0 on the card (a launch's time
    does not depend on its pixel values).  Uses only the package's
    public plan API, so the rows of another checkout's package can be
    timed the same way (``--time-remap``)."""
    from octvr_tpu_torch.ops.remap import remap_group, remap_plan
    from octvr_tpu_torch.stitch.yuv_mode import half_maps

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def planes(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=gen)

    def flat(group, nc, frames=None):
        n = nc * group.src_rows * group.in_shape[1]
        return planes(n) if frames is None else planes(frames, n)

    half = CAM // 2
    full_plans = [remap_plan(i.map1, i.map2, CAM, CAM) for i in mt.inputs]
    half_plans = [remap_plan(*half_maps(i.map1, i.map2, i.roi)[:2], half, half) for i in mt.inputs]
    gy, guv = remap_group(full_plans, "cuda"), remap_group(half_plans, "cuda")
    g0, g0uv = remap_group(full_plans[:1], "cuda"), remap_group(half_plans[:1], "cuda")
    sm, _ = sharded_on_card(host)
    smr, _ = sharded_on_card(host_rgb)
    band = 1
    b1, b2 = (remap_group([p[band] for p in plans], "cuda", concat=True) for plans in (host.remap, host.remap_uv))
    b3 = remap_group([p[band] for p in host_rgb.remap], "cuda", concat=True)
    f32, bf16 = torch.float32, torch.bfloat16
    n = len(mt.inputs)
    rows = {}
    for tag, dt in (("f32", f32), ("bf16", bf16)):
        rows[f"cam0_nc1_{tag}"] = (f"3b camera 0, NC=1, {tag}", planes(1, 1, CAM, CAM), g0, dt, False)
        rows[f"cam0_nc2_{tag}"] = (f"3b camera 0, NC=2, {tag}", planes(1, 2, half, half), g0uv, dt, False)
        rows[f"single_nc3_{tag}"] = (f"3c camera 0 single-input launch (kernel 4), NC=3, {tag}",
                                     planes(1, 3, CAM, CAM), g0, dt, False)
        rows[f"band1_nc1_{tag}"] = (f"3e 4K band {band}, NC=1, {tag}", flat(b1, 1), b1, dt, False)
        rows[f"band1_nc2_{tag}"] = (f"3e 4K band {band}, NC=2, {tag}", flat(b2, 2), b2, dt, False)
        rows[f"rgb_band1_nc3_{tag}"] = (f"3f 4K rgb band {band}, NC=3, {tag}", flat(b3, 3), b3, dt, False)
    rows.update({
        "y_nc1_bf16": ("5 Y group launch (kernel 1), NC=1, bf16", planes(n, 1, CAM, CAM), gy, bf16, False),
        "uv_nc2_bf16": ("5 U|V group launch (kernel 2), NC=2, bf16", planes(n, 2, half, half), guv, bf16, False),
        "rgb_nc3_bf16": ("5b RGB group launch (kernel 3), NC=3, bf16", planes(n, 3, CAM, CAM), gy, bf16, False),
        "frames_y_nc1_bf16": (f"5c frames launch (kernel 5), Y, B={BATCH}, bf16",
                              planes(BATCH, n, 1, CAM, CAM), gy, bf16, True),
        "frames_uv_nc2_bf16": (f"5c frames launch (kernel 5), U|V, B={BATCH}, bf16",
                               planes(BATCH, n, 2, half, half), guv, bf16, True),
        "sharded_nc1_bf16": ("6 sharded launch (kernel 6), NC=1, bf16", flat(sm.plan.remap, 1), sm.plan.remap, bf16, False),
        "sharded_nc2_bf16": ("6 sharded launch (kernel 6), NC=2, bf16", flat(sm.plan.remap_uv, 2), sm.plan.remap_uv,
                             bf16, False),
        "sharded_nc3_bf16": ("6b sharded rgb launch (kernel 6), NC=3, bf16", flat(smr.plan.remap, 3), smr.plan.remap,
                             bf16, False),
    })
    return rows


def phase_remap_device_time(mt, host, host_rgb):
    """Every 4K remap row (``remap_rows``) timed as device time: the
    kernel, its eager call, its plain version, grid_sample, the bound.
    Returns {key: times}."""
    log("== 3h. device time of every 4K remap launch (CUDA graph of K launches, median of 5 replays)")
    t0 = time.time()
    rows = remap_rows(mt, host, host_rgb)
    times = {}
    for key, (label, src, group, dtype, frames) in rows.items():
        times[key] = _time_kernel(src, group, dtype, label, frames=frames)
    for keys, label in (
        (("y_nc1_bf16", "uv_nc2_bf16"), "Mapper launches (Y + U|V)"),
        (("frames_y_nc1_bf16", "frames_uv_nc2_bf16"), f"frames launches (Y + U|V, B={BATCH})"),
        (("sharded_nc1_bf16", "sharded_nc2_bf16"), "sharded launches (Y + U|V)"),
    ):
        _traffic([(rows[k][2], 2 if "nc2" in k else 1) for k in keys], _sum_times(*(times[k] for k in keys)), label)
    log(f"  phase 3h took {time.time() - t0:.1f} s")
    return times


def time_remap(root):
    """``--time-remap ROOT``: device and call ms of every ``remap_rows``
    launch of the package at ROOT, printed as one JSON line.  Two checkouts are compared by running this
    on each, in turns, in one call on one card."""
    sys.path.insert(0, os.path.abspath(root))
    import octvr_tpu_torch
    from octvr_tpu_torch.template import compile_rig

    log(f"== timing the remap rows of {os.path.dirname(octvr_tpu_torch.__file__)}")
    mt = compile_rig(six_cam_rig(), CANVAS_W, CANVAS_H)
    mt.create_masks()
    host, _ = build_sharded_4k(mt)
    host_rgb, _ = build_sharded_4k(mt, "rgb")
    rows = remap_rows(mt, host, host_rgb)
    result = {
        key: _time_kernel(src, group, dtype, label, frames=frames, full=False)
        for key, (label, src, group, dtype, frames) in rows.items()
    }
    print(json.dumps({"root": os.path.abspath(root), "rows": result}))


def _taps_bound(body, steps, g, lo, hi):
    """(bytes, flops, bound ms, "bytes" or "operations", floor ms) of one
    launch of kernel 8's ``body`` over ``steps`` x ``g`` tiles of 8x128
    pixels.  All three bodies compute the same bilinear sample, so they
    share the function's bound: per pixel 16 B of plan and a 4 B f32
    store, the visited window rows once (int32; the rows outside them are
    never needed), and 6 f32 FMAs.  ``floor`` is the body's own
    formulation's operation floor, logged beside the bound and never used
    as it, ``flops`` that formulation's count: A's 6 FMAs per pixel on
    the CUDA cores; B's three bf16 products (the f32 weights split into
    hi + mid + lo terms) and B2's two, each 128 x kb multiply-adds per
    pixel, against the tensor cores' bf16 peak."""
    from octvr_tpu_torch.ops.mxu_taps import TH, TW, visited_rows

    klo, khi = visited_rows(lo, hi)
    px = steps * g * TH * TW
    nbytes = 20 * px + steps * (khi - klo) * TW * 4
    flops = 12 * px
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    form_flops, peak = {
        "fan": (flops, F32_FLOP_PER_S),
        "mxu_folded": (6 * px * (khi - klo) * TW, BF16_FLOP_PER_S),
        "mxu_exact2": (4 * px * (khi - klo) * TW, BF16_FLOP_PER_S),
    }[body]
    floor = form_flops / peak * 1e3
    return nbytes, form_flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", floor


def time_taps(root):
    """``--time-taps ROOT``: device and call ms of kernel 8's three bodies
    of the package at ROOT at the probe's defaults, each held to A within
    1e-3, printed as one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import octvr_tpu_torch
    from octvr_tpu_torch.ops import mxu_taps
    from octvr_tpu_torch.tools import mxu_taps_probe

    log(f"== timing kernel 8 of {os.path.dirname(octvr_tpu_torch.__file__)}")
    lo, hi = TAPS["lo"], TAPS["hi"]
    arrays = mxu_taps_probe.make_probe_inputs(TAPS["steps"], TAPS["g"], TAPS["kh"], lo, hi)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    want = mxu_taps.fan(*t, lo, hi)
    rows = {}
    for k in ("fan", "mxu_folded", "mxu_exact2"):
        fn = getattr(mxu_taps, k)
        err = max((a - b).abs().max().item() for a, b in zip(fn(*t, lo, hi), want))
        if not err < 1e-3:
            raise AssertionError(f"{k} of {root} disagrees with A: {err}")
        ms = device_ms(lambda: fn(*t, lo, hi))
        rows[k] = {"ms": ms[0], "ms_min": ms[1], "ms_max": ms[2],
                   "call_ms": steady_ms(lambda: fn(*t, lo, hi))[0], "err_vs_fan": err}
    print(json.dumps({"root": os.path.abspath(root), "taps": rows}))


def _taps_grid_sample(oyl, fxy, win):
    """The library yardstick of kernel 8: device ms (``device_ms``) of one
    F.grid_sample(win f32 [N, 1, KH, 128], grid [N, G*8, 128, 2],
    bilinear, zeros, align_corners=True) with gx = 2 (l0 + fx) / 127 - 1,
    gy = 2 (oy0 + fy) / (KH - 1) - 1: the same function (taps never
    clamp: l0 <= 126, oy0 <= hi - 2), the grid and the cast made before
    the timing.  Returns (ms, its output as [G, N, 8, 128])."""
    import torch.nn.functional as F

    n, g = oyl.shape[:2]
    kh = win.shape[2]
    oy0 = (oyl[:, :, :8] & 0xFFFF).float()
    l0 = (oyl[:, :, 8:] & 0xFFFF).float()
    gx = 2 * (l0 + fxy[:, :, :8]) / 127 - 1
    gy = 2 * (oy0 + fxy[:, :, 8:]) / (kh - 1) - 1
    grid = torch.stack([gx, gy], dim=-1).reshape(n, g * 8, 128, 2)
    inp = win.float()

    def run():
        return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    ms = device_ms(run)[0]
    return ms, run()[:, 0].reshape(n, g, 8, 128).transpose(0, 1)


def phase_mxu_taps():
    """Kernel 8, the MXU-taps probe's three bodies (A: a gather from the
    step's window staged once in shared memory; B: the folded one-hot
    f32 weights as three bf16 products, B2: two exact bf16 selection
    products, both wgmma on the tensor cores, the taps read from the
    product staged in shared memory): each against its plain
    version and the three against each other at 64 steps x G=8 and at
    the probe's defaults (f32 max abs < 1e-3), timed at the defaults with
    its bound, its plain version and grid_sample on the same function;
    then the port's entry point, ``mxu_taps_probe.main([])``, with the
    counts set to 0 just before it and read just after.  Returns the
    kernels-line entry of each body."""
    from octvr_tpu_torch.ops import mxu_taps
    from octvr_tpu_torch.tools import mxu_taps_probe

    log("== 3g. kernel 8 (the MXU-taps probe): A fan (the step's window staged in shared memory, the plan "
        "in 16 B vectors), B folded f32 weights (three bf16 wgmma products), B2 exact bf16 selections "
        "(two wgmma products)")
    t_phase = time.time()
    lo, hi = TAPS["lo"], TAPS["hi"]
    names = ("fan", "mxu_folded", "mxu_exact2")
    bodies = {k: (getattr(mxu_taps, k), getattr(mxu_taps, f"{k}_reference")) for k in names}

    def inputs(steps):
        arrays = mxu_taps_probe.make_probe_inputs(steps, TAPS["g"], TAPS["kh"], lo, hi)
        return [torch.from_numpy(a).cuda() for a in arrays]

    def max_err(xs, ys):
        return max((a - b).abs().max().item() for a, b in zip(xs, ys))

    rows = {k: {"err": 0.0} for k in names}
    for steps in (TAPS_CHECK_STEPS, TAPS["steps"]):
        t = inputs(steps)
        got = {}
        for k, (fn, ref) in bodies.items():
            got[k] = fn(*t, lo, hi)
            err = max_err(got[k], ref(*t, lo, hi))
            torch.cuda.synchronize()
            log(f"  {steps} steps x G={TAPS['g']}, {k}: kernel vs plain f32 max abs err {err:.3g} (bar < 1e-3)")
            if not err < 1e-3:
                raise AssertionError(f"kernel 8 {k} disagrees with its plain version at {steps} steps")
            rows[k]["err"] = max(rows[k]["err"], err)
        cross = {f"{a} vs {b}": max_err(got[a], got[b]) for a, b in ((names[0], names[1]), (names[0], names[2]), (names[1], names[2]))}
        log(f"  {steps} steps: kernels against each other, max abs {cross} (bar < 1e-3)")
        if not max(cross.values()) < 1e-3:
            raise AssertionError(f"kernel 8's bodies disagree with each other at {steps} steps")
        for k in names:
            rows[k]["err"] = max(rows[k]["err"], *cross.values())

    # t, got: the probe's defaults
    lib, lib_out = _taps_grid_sample(*t)
    d = max_err(lib_out, got["fan"])
    log(f"  grid_sample on the same function: {lib:.4f} ms; max abs diff from A {d:.3g} (bar < 0.05: "
        f"f32 rounding of the normalised grid moves a tap by ~1e-5 px)")
    if not d < 0.05:
        raise AssertionError("grid_sample does not compute kernel 8's function: the yardstick is wrong")
    del got, lib_out
    for k, (fn, ref) in bodies.items():
        ms, ms_lo, ms_hi = device_ms(lambda: fn(*t, lo, hi))
        call = steady_ms(lambda: fn(*t, lo, hi))[0]
        plain = cuda_ms(lambda: ref(*t, lo, hi), iters=1, warmup=1)
        nbytes, flops, bound, by, floor = _taps_bound(k, TAPS["steps"], TAPS["g"], lo, hi)
        log(f"  {k}, {TAPS['steps']} steps x G={TAPS['g']}: kernel device {ms:.4f} ms (median; spread "
            f"{ms_lo:.4f}-{ms_hi:.4f}), call {call:.4f} ms, plain torch {plain:.4f} ms, grid_sample {lib:.4f} ms; "
            f"{nbytes / 1e6:.1f} MB ({nbytes / ms / 1e9:.3f} TB/s); bound of the function "
            f"{bound:.4f} ms ({by}), share {bound / ms:.3f}; this formulation's "
            f"{flops / 1e9:.1f} GFLOP ({flops / ms / 1e9:.1f} TFLOP/s), its operation floor {floor:.4f} ms, "
            f"share {floor / ms:.3f}")
        rows[k].update(ms=ms, call_ms=call, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib)
    del t

    log("  the entry point: octvr_tpu_torch.tools.mxu_taps_probe.main([])")
    mxu_taps.reset_counts()
    result = mxu_taps_probe.main([])
    counts = dict(mxu_taps.COUNTS)
    log(f"  entry point launches: {counts}")
    if counts != {f"taps_{k}": 21 for k in names}:  # one warm-up call and 20 timed ones each
        raise AssertionError(f"the probe's entry point took the wrong launches: {counts}")
    if result["fan_ms"] <= 0 or result["visited_rows"] != hi - lo:
        raise AssertionError(f"bad probe result {result}")
    for k in names:
        rows[k]["launches"] = counts[f"taps_{k}"]
    log(f"  phase 3g took {time.time() - t_phase:.1f} s")
    return rows


def phase_sharded_small_options():
    """Every option of the band-sharded stitcher (ROADMAP item 19b) on
    the small rig (two 1200^2 fisheyes -> 512x256, blend 16) at S=4:
    the port on CUDA in f32 against the port on the CPU, Y/UV (or RGB)
    mean < 0.2 and gains within 1e-3; each size group's plane takes one
    launch of the kernel, kernel 6 (concat) where source windows slice.
    The rgb pipeline's multiband cases here; 4d runs the yuv420 ones."""
    import dataclasses

    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
    from octvr_tpu_torch.template import compile_rig
    from rigs import two_fisheye_rig

    log(f"== 4e. small rig, every ShardedMapper option (S={SPACE}): CUDA f32 vs CPU f32")
    rig = two_fisheye_rig()
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [(1200, 1200)] * 2
    frames = _in_gamut_frames(np.random.default_rng(10), 2, 1200, [1.15, 0.85])
    ov = _in_gamut_frames(np.random.default_rng(11), 1, 1200, [1.0])
    mrig = two_fisheye_rig()
    mrig["inputs"][1]["options"]["width"] = mrig["inputs"][1]["options"]["height"] = 1000
    mmt = compile_rig(mrig, 512, 256)
    mmt.create_masks()
    rng = np.random.default_rng(12)
    mframes = [_in_gamut_frames(rng, 1, h, [g])[0] for h, g in ((1200, 1.15), (1000, 0.85))]
    rigs = {
        "equal": (mt, sizes, frames),
        "overlay": (dataclasses.replace(mt, overlay_inputs=[mt.inputs[0]]), sizes + sizes[:1], frames + ov),
        "mixed": (mmt, [(1200, 1200), (1000, 1000)], mframes),
    }
    both = [
        ("mixed sizes", "mixed", {}),
        ("feather", "equal", {"blend": -8}),
        ("paste", "equal", {"blend": 0}),
        ("blocks gains", "equal", {"enable_gain": "blocks"}),
        ("overlay input", "overlay", {}),
        ("scale_output=(256, 128)", "equal", {"scale_output": (256, 128)}),
        ("nv12", "equal", {"frame_format": "nv12"}),
    ]
    options = [
        ("rgb, split", "equal", {"pipeline": "rgb"}),
        ("rgb, no split", "equal", {"pipeline": "rgb", "coarse_split": 3}),
        ("rgb, source windows", "equal", {"pipeline": "rgb", "src_windows": True}),
        ("rgb, out_format rgb", "equal", {"pipeline": "rgb", "out_format": "rgb"}),
    ] + [(f"{p}, {label}", rig, {"pipeline": p, **kw}) for p in ("rgb", "yuv420") for label, rig, kw in both]
    for label, rig_name, kw in options:
        m, sz, fr = rigs[rig_name]
        if kw.get("frame_format") == "nv12":
            fr = [_nv12(f) for f in fr]
        kw = {"blend": 16, "enable_gain": True, "blend_dtype": "float32", **kw}
        batch = [torch.from_numpy(f[None]) for f in fr]
        out_cpu, g_cpu = ShardedMapper(m, sz, make_mesh(1, SPACE, device="cpu"), **kw).stitch_batch(batch)
        sm = ShardedMapper(m, sz, make_mesh(1, SPACE, device="cuda"), **kw)
        cuda_remap.reset_counts()
        out, g = sm.stitch_batch(batch)
        torch.cuda.synchronize()
        counts = dict(cuda_remap.COUNTS)
        want = {}
        for groups, nc in zip((sm.plan.remap_groups, sm.plan.remap_uv_groups), (3,) if kw["pipeline"] == "rgb" else (1, 2)):
            for grp in groups:
                key = f"{'concat_' if grp.concat else ''}nc{nc}_f32"
                want[key] = want.get(key, 0) + 1
        if kw.get("out_format") == "rgb":
            y_err = uv_err = (out[0].cpu() - out_cpu[0]).abs().mean().item()
        else:
            a, b = sm.assemble_yuv(out[0]).cpu().float(), sm.assemble_yuv(out_cpu[0]).float()
            oh = a.shape[0] * 2 // 3
            y_err, uv_err = (a - b)[:oh].abs().mean().item(), (a - b)[oh:].abs().mean().item()
        g_err = (g[0].cpu() - g_cpu[0]).abs().max().item()
        log(f"  {label:34s} out {tuple(out.shape[1:])}: Y {y_err:.4f}, UV {uv_err:.4f} (bar < 0.2), "
            f"gains {g_err:.3g} (bar < 1e-3); launches {counts}")
        if counts != want or (kw.get("src_windows") and not sm.plan.sliced):
            raise AssertionError(f"sharded option {label} took the wrong launches: {counts}, want {want}")
        if not (y_err < 0.2 and uv_err < 0.2 and g_err < 1e-3):
            raise AssertionError(f"sharded option {label}: CUDA vs CPU parity failed")


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
    from octvr_tpu_torch.template import compile_rig
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


def _nv12(buf):
    h, w = buf.shape[0] * 2 // 3, buf.shape[1]
    u, v = buf[h:, : w // 2], buf[h:, w // 2 :]
    return np.concatenate([buf[:h], np.stack([u, v], -1).reshape(h // 2, w)])


def _cuda_vs_cpu(label, make, frames):
    """Stitch ``frames`` with make("cpu") and make("cuda"); fails unless Y
    and UV mean abs err < 0.2 and gains within 1e-3.  Returns the CUDA
    mapper and its remap launch counts of that one stitch."""
    from octvr_tpu_torch.ops import cuda_remap

    out_cpu, g_cpu = make("cpu").stitch(frames)
    m = make("cuda")
    cuda_remap.reset_counts()
    out, g = m.stitch(frames)
    torch.cuda.synchronize()
    counts = dict(cuda_remap.COUNTS)
    h = out.shape[0] * 2 // 3
    d = (out.cpu().float() - out_cpu.float()).abs()
    y_err, uv_err = d[:h].mean().item(), d[h:].mean().item()
    g_err = (g.cpu() - g_cpu).abs().max().item()
    log(f"  {label:34s} {m.plan.pipeline:6s} out {tuple(out.shape)}: Y {y_err:.4f}, UV {uv_err:.4f} "
        f"(bar < 0.2), gains {g_err:.3g} (bar < 1e-3), launches {counts}")
    if not (y_err < 0.2 and uv_err < 0.2 and g_err < 1e-3):
        raise AssertionError(f"CUDA vs CPU parity failed: {label}, {m.plan.pipeline}")
    return m, counts


def phase_small_rig_options():
    """Every option on both pipelines, FastMapper and a mixed-size rig:
    the port on CUDA in f32 against the port on the CPU.  Returns the
    NC=3 launches of the mixed-size rgb stitch (single-input groups) and
    the kernel's max f32 error against its plain version at them."""
    import dataclasses

    from octvr_tpu_torch.template import compile_rig
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import remap_apply_reference
    from octvr_tpu_torch.stitch import FastMapper, Mapper
    from rigs import two_fisheye_rig

    log("== 4b. small rig, every option on both pipelines: CUDA f32 vs CPU f32")
    rig = two_fisheye_rig()
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [(s["options"]["height"], s["options"]["width"]) for s in rig["inputs"]]
    frames = _in_gamut_frames(np.random.default_rng(5), 2, sizes[0][0], [1.15, 0.85])
    mt_ov = dataclasses.replace(mt, overlay_inputs=[mt.inputs[0]])
    ov = _in_gamut_frames(np.random.default_rng(6), 1, 600, [1.0])
    options = (
        ("multiband + gains", {}),
        ("feather", {"blend": -8}),
        ("no blend", {"blend": 0}),
        ("blocks gains", {"enable_gain": "blocks"}),
        ("scale_output=(256, 128)", {"scale_output": (256, 128)}),
        ("nv12", {"frame_format": "nv12"}),
    )
    for pipeline in ("rgb", "yuv420"):
        base = dict(blend=16, enable_gain=True, pipeline=pipeline, blend_dtype="float32")
        for label, kw in options:
            fs = [_nv12(f) for f in frames] if kw.get("frame_format") == "nv12" else frames
            _cuda_vs_cpu(label, lambda d, kw=kw: Mapper(mt, sizes, device=d, **{**base, **kw}), fs)
        _cuda_vs_cpu(
            "overlay input (600^2, own group)",
            lambda d: Mapper(mt_ov, sizes + [(600, 600)], device=d, **base),
            frames + ov,
        )
        _cuda_vs_cpu(
            "FastMapper (nv12, feather 8)",
            lambda d: FastMapper(mt, sizes, device=d, pipeline=pipeline),
            [_nv12(f) for f in frames],
        )

    log("== 4b. mixed sizes: 1200^2 + 1000^2 fisheyes -> 512x256 (tests/test_yuv420_product.py)")
    mrig = two_fisheye_rig()
    mrig["inputs"][1]["options"]["width"] = mrig["inputs"][1]["options"]["height"] = 1000
    mmt = compile_rig(mrig, 512, 256)
    mmt.create_masks()
    msizes = [(s["options"]["height"], s["options"]["width"]) for s in mrig["inputs"]]
    rng = np.random.default_rng(8)
    mframes = [_in_gamut_frames(rng, 1, h, [g])[0] for (h, _), g in zip(msizes, (1.15, 0.85))]
    kw = dict(blend=16, enable_gain=True, blend_dtype="float32")
    _cuda_vs_cpu("mixed sizes", lambda d: Mapper(mmt, msizes, device=d, pipeline="yuv420", **kw), mframes)
    m, counts = _cuda_vs_cpu(
        "mixed sizes", lambda d: Mapper(mmt, msizes, device=d, pipeline="rgb", **kw), mframes
    )
    if counts != {"nc3_f32": 2}:
        raise AssertionError(f"mixed-size rgb stitch: want 2 single-input NC=3 launches, got {counts}")
    # the mixed-size rgb path with a bf16 blend stores f32 and applies the
    # gains (or the blocks gain maps) in f32, as the JAX Mapper does
    for gain in (True, "blocks"):
        kw16 = dict(blend=16, enable_gain=gain, blend_dtype="bfloat16")
        _, counts16 = _cuda_vs_cpu(f"mixed sizes, bf16 blend, gains {gain}",
                                   lambda d: Mapper(mmt, msizes, device=d, pipeline="rgb", **kw16), mframes)
        if counts16 != {"nc3_f32": 2}:
            raise AssertionError(f"mixed-size rgb bf16 stitch: want 2 f32-store NC=3 launches, got {counts16}")
    # kernel 4 at this path's own launches: each single-input group
    planes = m._prep_rgb(m._frames_to_device(mframes, batched=False))
    err = 0.0
    for idxs, g in zip(m.plan.group_idx, m.plan.remap_groups):
        stack = torch.stack([planes[i] for i in idxs])
        k = cuda_remap.remap_apply(stack, g, torch.float32)
        r = remap_apply_reference(stack, g, torch.float32)
        err = max(err, max((a - b).abs().max().item() for a, b in zip(k, r)))
    log(f"  mixed-size single-input NC=3 launches {m.plan.group_idx}, kernel vs plain f32: "
        f"max abs err {err:.3g} (bar < 1e-3)")
    if not err < 1e-3:
        raise AssertionError("NC=3 kernel disagrees at the mixed-size launches")
    return counts["nc3_f32"], err


def phase_default_path():
    """bench.py::default_path_regression on the card: the port's CUDA
    defaults (pipeline auto -> yuv420, blend_dtype -> bfloat16) against
    pipeline="rgb", blend_dtype="float32", on bench's 256x128 two 512^2
    lens rig with in-gamut frames."""
    import math

    from octvr_tpu_torch.template import compile_rig
    from octvr_tpu_torch.stitch import Mapper

    log("== 4c. default-path regression (bench.py:114-205): CUDA defaults vs rgb + f32")
    lens = {"width": 512, "height": 512, "hfov": math.pi * 1.15, "center_dx": 0.0,
            "center_dy": 0.0, "radial": [0.0, 0.0, 0.0]}
    rig = {
        "output": {"type": "equirectangular", "options": {}},
        "inputs": [
            {"type": "fullframe_fisheye", "options": dict(lens)},
            {"type": "fullframe_fisheye",
             "options": {**lens, "rotation": {"roll": 0.0, "yaw": math.pi, "pitch": 0.0}}},
        ],
    }
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(512, 512)] * 2
    m_def = Mapper(mt, sizes, blend=16, device="cuda")
    if m_def.plan.pipeline != "yuv420" or m_def.plan.blender.compute_dtype != "bfloat16":
        raise AssertionError(f"CUDA defaults are {m_def.plan.pipeline}, {m_def.plan.blender.compute_dtype}")
    m_ref = Mapper(mt, sizes, blend=16, pipeline="rgb", blend_dtype="float32", device="cuda")
    frames = _in_gamut_frames(np.random.default_rng(3), 2, 512, [1.0, 1.0])
    out_d, g_d = m_def.stitch(frames)
    out_r, g_r = m_ref.stitch(frames)
    y_err = (out_d[:128].float() - out_r[:128].float()).abs().mean().item()
    g_d, g_r = g_d.cpu().numpy(), g_r.cpu().numpy()
    log(f"  Y mean abs err {y_err:.4f} (bar < 1.5); gains {g_d.tolist()} vs {g_r.tolist()} "
        f"(rtol 0.05, atol 0.01)")
    if not y_err < 1.5:
        raise AssertionError(f"default-path regression: Y mean err {y_err:.3f}")
    np.testing.assert_allclose(g_d, g_r, rtol=0.05, atol=0.01)


def _sharded_vs(a, b, h, oh):
    """(Y mean, Y interior-row mean, UV mean) abs err of two packed
    canvases; the interior leaves out 8 rows at the top and bottom."""
    d = (a.cpu().float() - b.cpu().float()).abs()
    return d[:h].mean().item(), d[8 : oh - 8].mean().item(), d[h:].mean().item()


def phase_sharded_small():
    """The band-sharded stitcher on the small rig (two 1200^2 fisheyes
    -> 512x256, blend 16 so the two-level split engages at S=4; source
    windows slice each camera to 768 rows): CUDA f32 against the CPU,
    and against the CUDA Mapper at the JAX package's sharded bars
    (tests/test_sharded.py:178-185, tests/test_sharded_split.py:66-72)."""
    from octvr_tpu_torch.template import compile_rig
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
    from octvr_tpu_torch.stitch import Mapper
    from rigs import two_fisheye_rig

    log(f"== 4d. small rig, band-sharded (S={SPACE}): CUDA f32 vs CPU f32, and vs the CUDA Mapper")
    rig = two_fisheye_rig()
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [(s["options"]["height"], s["options"]["width"]) for s in rig["inputs"]]
    frames = _in_gamut_frames(np.random.default_rng(9), 2, sizes[0][0], [1.15, 0.85])
    batch = [torch.from_numpy(f[None]) for f in frames]
    base = dict(blend=16, enable_gain=True, blend_dtype="float32")
    ref, g_ref = Mapper(mt, sizes, pipeline="yuv420", device="cuda", **base).stitch(frames)
    h = 256
    for src_windows in (False, True):
        for split in (True, False):
            kw = dict(base, src_windows=src_windows, coarse_split=None if split else 3)
            out_cpu, g_cpu = ShardedMapper(mt, sizes, make_mesh(1, SPACE, device="cpu"), **kw).stitch_batch(batch)
            sm = ShardedMapper(mt, sizes, make_mesh(1, SPACE, device="cuda"), **kw)
            cuda_remap.reset_counts()
            out, g = sm.stitch_batch(batch)
            torch.cuda.synchronize()
            counts = dict(cuda_remap.COUNTS)
            yuv, yuv_cpu = sm.assemble_yuv(out[0]), sm.assemble_yuv(out_cpu[0])
            y_err, _, uv_err = _sharded_vs(yuv, yuv_cpu, h, h)
            g_err = (g[0].cpu() - g_cpu[0]).abs().max().item()
            my, mi, muv = _sharded_vs(yuv, ref, h, h)
            g_rel = ((g[0] - g_ref).abs() / g_ref.abs()).max().item()
            log(f"  src_windows={src_windows!s:5} split level {sm.plan.split_level:2d} "
                f"(src_h {sm.plan.src_h}): vs CPU Y {y_err:.4f}, UV {uv_err:.4f} (bar < 0.2), "
                f"gains {g_err:.3g} (bar < 1e-3); vs Mapper Y {my:.4f} (bar < 0.1), interior "
                f"{mi:.4f} (bar < 0.02), UV {muv:.4f} (bar < 0.2), gains rtol {g_rel:.3g} "
                f"(bar 5e-3); launches {counts}")
            # without the split the halo grows to 40 rows and the windows
            # then save too few camera rows to slice
            want = {f"{'concat_' if sm.plan.sliced else ''}nc{nc}_f32": 1 for nc in (1, 2)}
            if (split != (sm.plan.split_level >= 0) or sm.plan.sliced != (src_windows and split)
                    or counts != want):
                raise AssertionError(f"sharded small rig took the wrong path: {counts}")
            if not (y_err < 0.2 and uv_err < 0.2 and g_err < 1e-3):
                raise AssertionError("sharded CUDA vs CPU parity failed")
            if not (my < 0.1 and mi < 0.02 and muv < 0.2 and g_rel < 5e-3):
                raise AssertionError("sharded vs Mapper parity failed")


def make_frame_sets():
    """ITERS frame sets of the 4K rig on the card, from seed 0."""
    rng = np.random.default_rng(0)
    base = [rng.integers(0, 255, (CAM * 3 // 2, CAM), dtype=np.uint8) for _ in range(6)]
    base_t = torch.from_numpy(np.stack(base)).cuda().to(torch.int16)
    sets = [list((base_t + i).clamp(0, 255).to(torch.uint8).unbind(0)) for i in range(ITERS)]
    torch.cuda.synchronize()
    return sets


def phase_main_path(mt, t_template, frame_sets):
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

    # the main path's launch counts: reset just before, read just after
    cuda_remap.reset_counts()
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
    counts = dict(cuda_remap.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    log(f"  first call {t_first:.3f} s")
    log(f"  output checksum (frame 0): {checksum}")
    log(f"  steady {ms_frame:.3f} ms/frame over {ITERS} frames "
        f"({1e3 / ms_frame:.2f} frames/s), synchronised; the host enqueued "
        f"them at {ms_enqueue:.3f} ms/frame")
    log(f"  peak device memory in the steady loop {peak / 2**30:.3f} GiB")
    log(f"  remap kernel launches: {launches} over {ITERS + 1} frames: {counts}")
    if counts != {"nc1_bf16": ITERS + 1, "nc2_bf16": ITERS + 1}:
        raise AssertionError(f"expected {ITERS + 1} launches of each of nc1_bf16 and nc2_bf16")
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
                      pipeline="yuv420", device="cuda").stitch(frame_sets[0])
    y_err = (out32[:CANVAS_H].float() - y.float()).abs().mean().item()
    log(f"  bf16 vs f32 main path, frame 0: Y mean abs err {y_err:.4f} (bar < 1.5)")
    if not y_err < 1.5:
        raise AssertionError("bf16 main path drifts from f32")
    del out32

    # the kernel and its plain version at the main path's own launches
    from octvr_tpu_torch.ops.remap import remap_apply_reference

    ys, uvs = mapper._prep_yuv(frame_sets[0])
    planes_y = torch.stack(ys)
    planes_uv = torch.stack(uvs)
    gy, guv = mapper.plan.remap_groups[0], mapper.plan.remap_uv_groups[0]
    err = 0.0
    for planes, g, nc in ((planes_y, gy, 1), (planes_uv, guv, 2)):
        k = cuda_remap.remap_apply(planes, g, torch.float32)
        r = remap_apply_reference(planes, g, torch.float32)
        err = max(err, max((a - b).abs().max().item() for a, b in zip(k, r)))
    log(f"  6-camera group launches, kernel vs plain f32: max abs err {err:.3g}")
    if not err < 1e-3:
        raise AssertionError("remap kernel disagrees at the main path's shapes")
    del planes_y, planes_uv, ys, uvs

    profile(mapper.stitch, frame_sets, ms_frame)
    return {
        "mapper": mapper,
        "out0": out,
        "gains0": gains,
        "ms_frame": ms_frame,
        "ms_enqueue": ms_enqueue,
        "nc1": {"launches": counts["nc1_bf16"], "err": err},
        "nc2": {"launches": counts["nc2_bf16"], "err": err},
    }


def phase_rgb_path(mt, frame_sets):
    """The 4K rig on the rgb pipeline: one NC=3 launch per frame."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import remap_apply_reference
    from octvr_tpu_torch.stitch import Mapper

    log("== 5b. 4K rgb path: 6 x 1920^2 fisheyes -> 3840x1920, rgb + bf16 + gains, blend 128")
    t0 = time.time()
    mapper = Mapper(mt, [(CAM, CAM)] * 6, blend=128, enable_gain=True, pipeline="rgb", device="cuda")
    torch.cuda.synchronize()
    log(f"  plan built and moved to the card in {time.time() - t0:.1f} s "
        f"(blend_dtype={mapper.plan.blender.compute_dtype})")
    sets = frame_sets[:RGB_ITERS]
    cuda_remap.reset_counts()
    t0 = time.time()
    out, gains = mapper.stitch(sets[0])
    checksum = int(out[::101, ::103].to(torch.int64).sum().item())
    t_first = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    for fs in sets:
        mapper.stitch(fs)
    ms_enqueue = (time.time() - t0) / len(sets) * 1e3
    torch.cuda.synchronize()
    ms_frame = (time.time() - t0) / len(sets) * 1e3
    counts = dict(cuda_remap.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    log(f"  first call {t_first:.3f} s")
    log(f"  output checksum (frame 0): {checksum}")
    log(f"  steady {ms_frame:.3f} ms/frame over {len(sets)} frames "
        f"({1e3 / ms_frame:.2f} frames/s), synchronised; the host enqueued "
        f"them at {ms_enqueue:.3f} ms/frame")
    log(f"  peak device memory in the steady loop {peak / 2**30:.3f} GiB")
    log(f"  remap kernel launches over {len(sets) + 1} frames: {counts}")
    if counts != {"nc3_bf16": len(sets) + 1}:
        raise AssertionError(f"expected one NC=3 launch per frame, got {counts}")
    if out.dtype != torch.uint8 or tuple(out.shape) != (CANVAS_H * 3 // 2, CANVAS_W):
        raise AssertionError(f"bad output {out.dtype} {tuple(out.shape)}")
    if not torch.isfinite(gains).all() or int(out[:CANVAS_H].max()) == int(out[:CANVAS_H].min()):
        raise AssertionError("non-finite gains or a constant Y plane")
    log(f"  gains {[round(g, 5) for g in gains.tolist()]}")

    planes = torch.stack(mapper._prep_rgb(sets[0]))
    group = mapper.plan.remap_groups[0]
    k = cuda_remap.remap_apply(planes, group, torch.float32)
    r = remap_apply_reference(planes, group, torch.float32)
    err = max((a - b).abs().max().item() for a, b in zip(k, r))
    log(f"  6-camera NC=3 launch, kernel vs plain f32: max abs err {err:.3g}")
    if not err < 1e-3:
        raise AssertionError("NC=3 kernel disagrees at the rgb path's shapes")
    del planes, k, r
    profile(mapper.stitch, sets, ms_frame)
    return {"launches": counts["nc3_bf16"], "err": err, "out0": out, "gains0": gains}


def phase_stitch_batch(mapper, frame_sets, ms_stitch):
    """stitch_batch at B frames on the phase-5 mapper: two frames-axis
    launches per batch, each frame's output equal to stitch's."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import remap_apply_frames_reference

    nb = 3
    log(f"== 5c. stitch_batch at 4K, yuv420, B={BATCH}, {nb} batches (phase 5 stitch: "
        f"{ms_stitch:.3f} ms/frame)")
    sets = frame_sets[: nb * BATCH]
    batches = [
        [torch.stack(fs) for fs in zip(*sets[k * BATCH : (k + 1) * BATCH])] for k in range(nb)
    ]
    mapper.stitch_batch(batches[0])  # warm-up
    torch.cuda.synchronize()

    def run_batches():
        t0 = time.time()
        res = [mapper.stitch_batch(b) for b in batches]
        torch.cuda.synchronize()
        return res, (time.time() - t0) / len(sets) * 1e3

    def run_stitch():
        t0 = time.time()
        res = [mapper.stitch(fs) for fs in sets]
        torch.cuda.synchronize()
        return res, (time.time() - t0) / len(sets) * 1e3

    ref, ms_a = run_stitch()
    cuda_remap.reset_counts()
    res, ms_b = run_batches()
    counts = dict(cuda_remap.COUNTS)
    _, ms_c = run_batches()
    _, ms_d = run_stitch()
    log(f"  ms/frame in turns: stitch {ms_a:.3f}, stitch_batch {ms_b:.3f}, "
        f"stitch_batch {ms_c:.3f}, stitch {ms_d:.3f}")
    log(f"  remap launches over {nb} batches: {counts}")
    if counts != {"frames_nc1_bf16": nb, "frames_nc2_bf16": nb}:
        raise AssertionError(f"expected two frames-axis launches per batch, got {counts}")
    g_err = 0.0
    for k, (out, gains) in enumerate(res):
        for b in range(BATCH):
            o, g = ref[k * BATCH + b]
            if not torch.equal(out[b], o):
                raise AssertionError(f"stitch_batch frame {k * BATCH + b} differs from stitch")
            g_err = max(g_err, (gains[b] - g).abs().max().item())
    log(f"  every frame equal to stitch's; gains max err {g_err:.3g} (bar 1e-6)")
    if not g_err <= 1e-6:
        raise AssertionError("stitch_batch gains differ from stitch's")

    # the frames-axis launches against their plain version, at B frames
    preps = [mapper._prep_yuv(fs) for fs in sets[:BATCH]]
    err = 0.0
    for k, group in ((0, mapper.plan.remap_groups[0]), (1, mapper.plan.remap_uv_groups[0])):
        planes = torch.stack([torch.stack(p[k]) for p in preps])
        got = cuda_remap.remap_apply_frames(planes, group, torch.float32)
        want = remap_apply_frames_reference(planes, group, torch.float32)
        err = max(err, max((a - b).abs().max().item() for a, b in zip(got, want)))
    log(f"  frames-axis launches (Y + U|V, B={BATCH}), kernel vs plain f32: max abs err {err:.3g}")
    if not err < 1e-3:
        raise AssertionError("frames-axis kernel disagrees with its plain version")
    return {"launches": counts["frames_nc1_bf16"] + counts["frames_nc2_bf16"], "err": err}


def build_sharded_4k(mt, pipeline="yuv420"):
    """The 4K band-sharded host plan (S=4, source windows, blend 128,
    gains, bf16) on ``pipeline``, and its build time."""
    from octvr_tpu_torch.parallel import build_sharded_plan

    t0 = time.time()
    host = build_sharded_plan(mt, [(CAM, CAM)] * 6, SPACE, blend=128, enable_gain=True,
                              blend_dtype="bfloat16", pipeline=pipeline, src_windows=True)
    return host, time.time() - t0


def sharded_on_card(host):
    """A ShardedMapper over ``host`` moved to the card, and the move's
    time."""
    from octvr_tpu_torch.parallel import ShardedMapper, make_mesh

    mesh = make_mesh(1, SPACE, device="cuda")
    t0 = time.time()
    sm = ShardedMapper.from_plan(host.to(mesh.device), mesh)
    torch.cuda.synchronize()
    return sm, time.time() - t0


def _run_sharded(sm, batches):
    """Each batch through stitch_batch, synchronised at the end: (the
    last result, enqueue ms/frame, ms/frame)."""
    n = sum(b[0].shape[0] for b in batches)
    t0 = time.time()
    for b in batches:
        res = sm.stitch_batch(b)
    enqueue = (time.time() - t0) / n * 1e3
    torch.cuda.synchronize()
    return res, enqueue, (time.time() - t0) / n * 1e3


def phase_sharded(host, t_host, frame_sets, main_path):
    """The band-sharded 4K path at B=1 and at B=4 (frames axis), against
    phase 5's Mapper output; kernel 6 at the path's own launches."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import concat_source, remap_apply_reference

    sm, t_move = sharded_on_card(host)

    log(f"== 6. band-sharded 4K path: make_mesh(1, {SPACE}), source windows, blend 128, "
        f"gains, {host.compute_dtype}")
    log(f"  plan: built on the host in {t_host:.1f} s, moved to the card in {t_move:.1f} s; "
        f"band {host.bh} rows + halo {host.halo}, split level {host.split_level}/{host.split_level_uv}, "
        f"source heights {host.src_h} of {CAM}")
    if not host.sliced or not sm.plan.remap.concat:
        raise AssertionError("the 4K sharded plan slices no input: kernel 6 is not on the path")
    sets = frame_sets[:SHARD_ITERS]
    one = [[f[None] for f in fs] for fs in sets]
    cuda_remap.reset_counts()
    t0 = time.time()
    out, gains = sm.stitch_batch(one[0])
    yuv = sm.assemble_yuv(out[0])
    checksum = int(yuv[::101, ::103].to(torch.int64).sum().item())
    t_first = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _, enq1, ms1 = _run_sharded(sm, one)
    counts1 = dict(cuda_remap.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    n1 = len(one) + 1
    log(f"  first call {t_first:.3f} s; output checksum (frame 0): {checksum}")
    log(f"  B=1: steady {ms1:.3f} ms/frame over {len(one)} frames ({1e3 / ms1:.2f} frames/s), "
        f"synchronised; enqueue {enq1:.3f} ms/frame; peak device memory {peak / 2**30:.3f} GiB")
    log(f"  B=1 launches over {n1} frames: {counts1} "
        f"({sum(counts1.values()) / n1:.1f} per frame)")
    if counts1 != {"concat_nc1_bf16": n1, "concat_nc2_bf16": n1}:
        raise AssertionError(f"expected one kernel-6 launch per plane per frame, got {counts1}")

    batches = [[torch.stack(x) for x in zip(*sets[k : k + BATCH])] for k in range(0, len(sets), BATCH)]
    sm.stitch_batch(batches[0])  # warm-up
    torch.cuda.synchronize()
    cuda_remap.reset_counts()
    (out4, g4), enq4, ms4 = _run_sharded(sm, batches)
    counts4 = dict(cuda_remap.COUNTS)
    log(f"  B={BATCH}: steady {ms4:.3f} ms/frame over {len(batches)} batches, enqueue {enq4:.3f} "
        f"ms/frame; launches {counts4} ({sum(counts4.values()) / len(sets):.2f} per frame)")
    if counts4 != {"frames_concat_nc1_bf16": len(batches), "frames_concat_nc2_bf16": len(batches)}:
        raise AssertionError(f"expected one frames-axis kernel-6 launch per plane per batch, got {counts4}")
    ref_out, _ = sm.stitch_batch([f[None] for f in sets[-1]])
    if not torch.equal(out4[-1], ref_out[0]):
        raise AssertionError("stitch_batch at B=4 differs from B=1 on the last frame")

    if yuv.dtype != torch.uint8 or tuple(yuv.shape) != (CANVAS_H * 3 // 2, CANVAS_W):
        raise AssertionError(f"bad output {yuv.dtype} {tuple(yuv.shape)}")
    if not torch.isfinite(gains).all():
        raise AssertionError(f"non-finite gains {gains}")
    y_err = (yuv[:CANVAS_H].float() - main_path["out0"][:CANVAS_H].float()).abs().mean().item()
    g_ref = main_path["gains0"]
    g_rel = ((gains[0] - g_ref).abs() / g_ref.abs()).max().item()
    log(f"  vs phase 5's Mapper, frame 0: Y mean abs err {y_err:.4f} (bar < 1.0), gains rtol "
        f"{g_rel:.3g} (bar 5e-3); gains {[round(g, 5) for g in gains[0].tolist()]}")
    if not (y_err < 1.0 and g_rel < 5e-3):
        raise AssertionError("sharded 4K path disagrees with the Mapper")

    # kernel 6 at this path's own launches: every (input, band) pair
    bufs = sm._frames_to_device(one[0])
    ys, uvs = sm._prep_band_yuv(bufs)
    err = 0.0
    for parts, group in ((ys, sm.plan.remap), (uvs, sm.plan.remap_uv)):
        src = concat_source(parts, frames=True)[0]
        k = cuda_remap.remap_apply(src, group, torch.float32)
        r = remap_apply_reference(src, group, torch.float32)
        err = max(err, max((a - b).abs().max().item() for a, b in zip(k, r)))
    log(f"  sharded launches (Y + U|V), kernel vs plain f32: max abs err {err:.3g} (bar < 1e-3)")
    if not err < 1e-3:
        raise AssertionError("kernel 6 disagrees at the sharded path's launches")
    del ys, uvs, bufs
    profile(lambda fs: sm.stitch_batch([f[None] for f in fs]), sets, ms1)
    return {"launches": counts1["concat_nc1_bf16"] + counts1["concat_nc2_bf16"], "err": err, "sm": sm}


def phase_sharded_rgb(host, t_host, frame_sets, rgb_path):
    """The 4K rig through the rgb band path: ShardedMapper(pipeline=
    "rgb", make_mesh(1, 4), src_windows=True), blend 128, gains, bf16,
    one kernel-6 NC=3 launch per frame; against phase 5b's rgb Mapper
    output (Y mean < 1.0, gains rtol 5e-3); kernel 6 at NC=3 at the
    path's own launch."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.ops.remap import concat_source, remap_apply_reference

    sm, t_move = sharded_on_card(host)
    log(f"== 6b. band-sharded 4K rgb path: make_mesh(1, {SPACE}), source windows, blend 128, "
        f"gains, {host.compute_dtype}")
    log(f"  plan: built on the host in {t_host:.1f} s, moved to the card in {t_move:.1f} s; "
        f"band {host.bh} rows + halo {host.halo}, split level {host.split_level}, "
        f"source heights {host.src_h} of {CAM}")
    if sm.plan.pipeline != "rgb" or not sm.plan.remap.concat:
        raise AssertionError("the 4K rgb sharded plan does not take kernel 6 at NC=3")
    sets = frame_sets[:RGB_ITERS]
    one = [[f[None] for f in fs] for fs in sets]
    cuda_remap.reset_counts()
    t0 = time.time()
    out, gains = sm.stitch_batch(one[0])
    yuv = sm.assemble_yuv(out[0])
    checksum = int(yuv[::101, ::103].to(torch.int64).sum().item())
    t_first = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _, enq, ms = _run_sharded(sm, one)
    counts = dict(cuda_remap.COUNTS)
    peak = torch.cuda.max_memory_allocated()
    n = len(one) + 1
    log(f"  first call {t_first:.3f} s; output checksum (frame 0): {checksum}")
    log(f"  steady {ms:.3f} ms/frame over {len(one)} frames ({1e3 / ms:.2f} frames/s), synchronised; "
        f"enqueue {enq:.3f} ms/frame; peak device memory {peak / 2**30:.3f} GiB")
    log(f"  launches over {n} frames: {counts} ({sum(counts.values()) / n:.1f} per frame)")
    if counts != {"concat_nc3_bf16": n}:
        raise AssertionError(f"expected one kernel-6 NC=3 launch per frame, got {counts}")
    if yuv.dtype != torch.uint8 or tuple(yuv.shape) != (CANVAS_H * 3 // 2, CANVAS_W):
        raise AssertionError(f"bad output {yuv.dtype} {tuple(yuv.shape)}")
    if not torch.isfinite(gains).all():
        raise AssertionError(f"non-finite gains {gains}")
    y_err = (yuv[:CANVAS_H].float() - rgb_path["out0"][:CANVAS_H].float()).abs().mean().item()
    g_ref = rgb_path["gains0"]
    g_rel = ((gains[0] - g_ref).abs() / g_ref.abs()).max().item()
    log(f"  vs phase 5b's rgb Mapper, frame 0: Y mean abs err {y_err:.4f} (bar < 1.0), gains rtol "
        f"{g_rel:.3g} (bar 5e-3); gains {[round(g, 5) for g in gains[0].tolist()]}")
    if not (y_err < 1.0 and g_rel < 5e-3):
        raise AssertionError("sharded 4K rgb path disagrees with the rgb Mapper")

    # kernel 6 at NC=3 at this path's own launch: every (input, band) pair
    parts = sm._prep_band_rgb(sm._frames_to_device(one[0]))
    src = concat_source(parts, frames=True)[0]
    group = sm.plan.remap
    k = cuda_remap.remap_apply(src, group, torch.float32)
    r = remap_apply_reference(src, group, torch.float32)
    err = max((a - b).abs().max().item() for a, b in zip(k, r))
    log(f"  sharded NC=3 launch, kernel vs plain f32: max abs err {err:.3g} (bar < 1e-3)")
    if not err < 1e-3:
        raise AssertionError("kernel 6 at NC=3 disagrees at the rgb sharded path's launch")
    del k, r, parts, src
    profile(lambda fs: sm.stitch_batch([f[None] for f in fs]), sets, ms)
    return {"launches": counts["concat_nc3_bf16"], "err": err}


STREAM_FRAMES = 48  # 7a-7b: frame sets through the pipeline
SMALL_CAM = 512  # 7c-7f: two 512^2 fisheyes -> 512x256


def _run_stream(amm, sets):
    """Pushes every set, then the end of the stream, from a thread while
    popping here: (the outputs in pop order, wall seconds).  close()
    included; an extra pop must end the stream."""
    import threading

    def push_all():
        for fs in sets:
            amm.push(fs)
        amm.close_input()

    pusher = threading.Thread(target=push_all)
    got = []
    try:
        t0 = time.time()
        pusher.start()
        for _ in sets:
            got.append(amm.pop())
        wall = time.time() - t0
        pusher.join(timeout=60)
        if pusher.is_alive():
            raise AssertionError("the pusher did not finish")
        try:
            amm.pop()
            raise AssertionError("the pipeline gave more outputs than frame sets pushed")
        except StopIteration:
            pass
    finally:
        amm.close()
    return got, wall


def _stats_line(st, n, wall):
    gb = lambda v: "n/a" if v is None else f"{v:.2f}"  # noqa: E731
    return (f"{n} frames in {wall:.3f} s: {n / wall:.2f} frames/s host to host ({wall / n * 1e3:.3f} ms/frame); "
            f"[Timer stitch] upload {st['upload_ms']:.3f}, dispatch {st['dispatch_ms']:.3f}, drain "
            f"{st['drain_ms']:.3f} ms/frame; H2D {st['h2d_bytes'] / n / 1e6:.1f} MB/frame at {gb(st['h2d_GBps'])} "
            f"GB/s, D2H {st['d2h_bytes'] / n / 1e6:.1f} MB/frame at {gb(st['d2h_GBps'])} GB/s")


def phase_stream_4k(mapper, frame_sets, main_path):
    """7a-7b: the AsyncMultiMapper over phase 5's 4K yuv420 Mapper.  7a:
    host numpy frame sets through the pinned and device rings, host
    drain, every output bit-identical to Mapper.stitch of its own set,
    in order.  7b: the checksum drain, fed host frame sets and then the
    device-resident ones (no H2D), its fetched checksums those of 7a's
    reference frames.  Returns 7a's numbers and the reference."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.runtime import AsyncMultiMapper

    log(f"== 7a. AsyncMultiMapper over phase 5's 4K Mapper, {STREAM_FRAMES} host frame sets, drain host "
        f"(phase 5 Mapper.stitch: {main_path['ms_frame']:.3f} ms/frame, enqueue {main_path['ms_enqueue']:.3f})")
    t0 = time.time()
    host_sets = [[f.cpu().numpy() for f in fs] for fs in frame_sets]
    ref = [mapper.stitch(fs)[0].cpu().numpy() for fs in frame_sets]
    ref_chk = [int(r[::101, ::103].astype(np.int64).sum()) for r in ref]
    log(f"  {len(ref)} reference frames by Mapper.stitch in {time.time() - t0:.1f} s")
    sets = [host_sets[n % len(host_sets)] for n in range(STREAM_FRAMES)]
    amm = AsyncMultiMapper([mapper])
    cuda_remap.reset_counts()
    got, wall = _run_stream(amm, sets)
    counts = dict(cuda_remap.COUNTS)
    st = amm.stats()
    log(f"  {_stats_line(st, STREAM_FRAMES, wall)}")
    log(f"  remap launches: {counts}")
    if counts != {"nc1_bf16": STREAM_FRAMES, "nc2_bf16": STREAM_FRAMES}:
        raise AssertionError(f"expected {STREAM_FRAMES} launches of each of nc1_bf16 and nc2_bf16")
    bad = [n for n, outs in enumerate(got) if not np.array_equal(outs[0], ref[n % len(ref)])]
    log(f"  outputs bit-identical to Mapper.stitch, in order: {STREAM_FRAMES - len(bad)} of {STREAM_FRAMES}")
    if bad:
        raise AssertionError(f"pipeline frames {bad[:8]} differ from Mapper.stitch of their sets")
    del got
    a = {"fps": STREAM_FRAMES / wall, **st}

    log("== 7b. the same with drain=\"checksum\": host frame sets, then device-resident ones")
    res = {}
    for label, src in (("host frames", host_sets), ("device frames", frame_sets)):
        sets = [src[n % len(src)] for n in range(STREAM_FRAMES)]
        amm = AsyncMultiMapper([mapper], drain="checksum")
        cuda_remap.reset_counts()
        got, wall = _run_stream(amm, sets)
        counts = dict(cuda_remap.COUNTS)
        st = amm.stats()
        log(f"  {label}: {_stats_line(st, STREAM_FRAMES, wall)}; launches {counts}")
        want = [[float(ref_chk[n % len(ref_chk)]) if n % 8 == 7 else 0.0] for n in range(STREAM_FRAMES)]
        if got != want:
            raise AssertionError(f"checksum drain ({label}) disagrees with the reference frames")
        if counts != {"nc1_bf16": STREAM_FRAMES, "nc2_bf16": STREAM_FRAMES}:
            raise AssertionError(f"checksum drain ({label}) did not launch the kernels once per frame")
        res[label] = {"fps": STREAM_FRAMES / wall, **st}
    log(f"  fetched checksums equal the reference frames' ({STREAM_FRAMES // 8} fetches each)")
    log(f"  dispatch host ms/frame: 7a {a['dispatch_ms']:.3f}, 7b host {res['host frames']['dispatch_ms']:.3f}, "
        f"7b device {res['device frames']['dispatch_ms']:.3f}; phase 5 enqueue {main_path['ms_enqueue']:.3f}")
    res["rounds"] = _dispatch_rounds(mapper, frame_sets, host_sets)
    return {"7a": a, "7b": res}


DISPATCH_ROUNDS = 2


def _dispatch_rounds(mapper, frame_sets, host_sets):
    """How far the pipeline's side threads slow its dispatch thread, on a
    host whose pace drifts from one second to the next: rounds of four
    runs in turns over the 24 frame sets, each a host ms/frame of the
    stitch dispatch: Mapper.stitch alone on the main thread (the default
    stream; enqueue, synchronised before and after), alone in a thread
    of its own on a side stream, the pipeline from device-resident
    frames with the checksum drain (its side threads nearly idle), and
    the pipeline from host frames with the host drain (7a's).  Prints
    each round and the medians."""
    import threading

    from octvr_tpu_torch.runtime import AsyncMultiMapper

    def enqueue(stream):
        with torch.cuda.stream(stream):
            for fs in frame_sets[:2]:
                mapper.stitch(fs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for fs in frame_sets:
                mapper.stitch(fs)
            ms = (time.perf_counter() - t0) / len(frame_sets) * 1e3
        torch.cuda.synchronize()
        return ms

    def own_thread():
        box = {}
        t = threading.Thread(target=lambda: box.update(ms=enqueue(torch.cuda.Stream())))
        t.start()
        t.join()
        return box["ms"]

    def pipeline(sets, drain):
        amm = AsyncMultiMapper([mapper], drain=drain)
        _run_stream(amm, sets)
        return amm.stats()["dispatch_ms"]

    runs = {
        "alone, main thread": lambda: enqueue(torch.cuda.default_stream()),
        "alone, own thread": own_thread,
        "pipeline, device frames, checksum drain": lambda: pipeline(frame_sets, "checksum"),
        "pipeline, host frames, host drain": lambda: pipeline(host_sets, "host"),
    }
    got = {k: [] for k in runs}
    t0 = time.time()
    for r in range(DISPATCH_ROUNDS):
        for k, run in runs.items():
            got[k].append(run())
        log(f"  dispatch host ms/frame, round {r + 1}: " + "; ".join(f"{k} {v[-1]:.3f}" for k, v in got.items()))
    med = {k: float(np.median(v)) for k, v in got.items()}
    log("  medians: " + "; ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f" ({DISPATCH_ROUNDS} rounds in {time.time() - t0:.1f} s)")
    return med


def _small_stream_rig():
    """Two 512^2 fisheyes -> 512x256 (tests/rigs.py's lens)."""
    from octvr_tpu_torch.template import compile_rig
    from rigs import two_fisheye_rig

    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = spec["options"]["height"] = SMALL_CAM
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    return mt, [(SMALL_CAM, SMALL_CAM)] * 2


def _small_sets(n, seed):
    rng = np.random.default_rng(seed)
    return [_in_gamut_frames(rng, 2, SMALL_CAM, [1.15, 0.85]) for _ in range(n)]


def phase_stream_small(mt, sizes):
    """7c: two outputs with gain_modes [0, 0] on the small rig, each
    bit-identical to a direct stitch (the copier with the owner's
    gains).  7d (small): a ShardedMapper at make_mesh(2, 2) fed 5 frame
    sets: the last batch padded, its real frame out, no padding frame."""
    from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
    from octvr_tpu_torch.runtime import AsyncMultiMapper
    from octvr_tpu_torch.stitch import Mapper

    log("== 7c. small rig, two outputs, gain_modes [0, 0] (output 1 copies output 0's gains)")
    m0 = Mapper(mt, sizes, blend=16, device="cuda")
    m1 = Mapper(mt, sizes, blend=-8, device="cuda")
    sets = _small_sets(6, seed=70)
    got, _ = _run_stream(AsyncMultiMapper([m0, m1], gain_modes=[0, 0]), sets)
    for n, (outs, fs) in enumerate(zip(got, sets)):
        o0, g0 = m0.stitch(fs)
        o1, _ = m1.stitch(fs, gains=g0)
        if not (np.array_equal(outs[0], o0.cpu().numpy()) and np.array_equal(outs[1], o1.cpu().numpy())):
            raise AssertionError(f"gain-copy pipeline frame {n} differs from direct stitch")
    log(f"  {len(sets)} frame sets: both outputs bit-identical to stitch / stitch(gains=owner's), in order; "
        f"owner's gains frame 0 {[round(g, 5) for g in m0.stitch(sets[0])[1].tolist()]}")

    log("== 7d. small rig, ShardedMapper at make_mesh(2, 2), 5 frame sets (the last batch padded)")
    sm = ShardedMapper(mt, sizes, make_mesh(2, 2, device="cuda"), blend=16)
    sets = _small_sets(5, seed=71)
    got, _ = _run_stream(AsyncMultiMapper([sm]), sets)
    for b0 in range(0, len(sets), 2):
        batch = sets[b0 : b0 + 2]
        batch = batch + batch[-1:] * (2 - len(batch))
        out, _ = sm.stitch_batch([torch.from_numpy(np.stack(x)).cuda() for x in zip(*batch)])
        for b in range(min(2, len(sets) - b0)):
            if not np.array_equal(got[b0 + b][0], sm.assemble_yuv(out[b]).cpu().numpy()):
                raise AssertionError(f"sharded pipeline frame {b0 + b} differs from stitch_batch")
    log(f"  {len(got)} frames out of {len(sets)} pushed, each equal to stitch_batch's; no padding frame")


def phase_stream_sharded_4k(sm, host_sets):
    """7d (4K): the pipeline over phase 6's band-sharded yuv420
    ShardedMapper (make_mesh(1, 4), one frame set per batch), each output
    bit-identical to stitch_batch called directly."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.runtime import AsyncMultiMapper

    n = len(host_sets)
    log(f"== 7d. AsyncMultiMapper over phase 6's 4K band-sharded Mapper, {n} host frame sets")
    amm = AsyncMultiMapper([sm])
    cuda_remap.reset_counts()
    got, wall = _run_stream(amm, host_sets)
    counts = dict(cuda_remap.COUNTS)
    log(f"  {_stats_line(amm.stats(), n, wall)}; launches {counts}")
    if counts != {"concat_nc1_bf16": n, "concat_nc2_bf16": n}:
        raise AssertionError(f"expected {n} kernel-6 launches per plane, got {counts}")
    for k, fs in enumerate(host_sets):
        out, _ = sm.stitch_batch([torch.from_numpy(f[None]).cuda() for f in fs])
        if not np.array_equal(got[k][0], sm.assemble_yuv(out[0]).cpu().numpy()):
            raise AssertionError(f"sharded 4K pipeline frame {k} differs from stitch_batch")
    log(f"  {n} frames bit-identical to stitch_batch, in order")
    return {"fps": n / wall}


def _cli(args, timeout=300):
    """``python -m octvr_tpu_torch.cli.<args>`` from the root on the card
    (no OCTVR_PLATFORM): a started process."""
    env = {k: v for k, v in os.environ.items() if k != "OCTVR_PLATFORM"}
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc, label, timeout=300):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    tail = "\n".join(f"    | {line}" for line in err.strip().splitlines()[-6:])
    log(f"  {label}: exit {proc.returncode}\n{tail}")
    if proc.returncode != 0:
        raise AssertionError(f"{label} exited {proc.returncode}")
    return err


def phase_stream_cli(mt, sizes, mt4k):
    """7e: ``python -m octvr_tpu_torch.cli.stream`` on the card, on the
    small rig from raw files (against the port on the CPU, the Mapper
    bars) and at 4K from the synthetic source; ``map`` on the card on
    the small rig's PNGs, against the same steps by the port on the CPU
    (the map CLI's RGB bars).  7f: ``monkey`` on the small rig's NV12
    feeds to a raw file, each frame equal to FastMapper.stitch_nv12
    called directly."""
    import tempfile
    import threading

    from octvr_tpu_torch.ops.color import rgb_to_yuv420p, yuv420p_to_rgb
    from octvr_tpu_torch.stitch import FastMapper, Mapper
    from octvr_tpu_torch.template import save_npz
    from octvr_tpu_torch.utils.png import read_png, write_png

    log("== 7e-7f. the stream and monkey CLIs as processes on the card")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d:
        tmpl, tmpl4k = os.path.join(d, "small.npz"), os.path.join(d, "4k.npz")
        save_npz(mt, tmpl)
        saver = threading.Thread(target=save_npz, args=(mt4k, tmpl4k))  # zlib runs without the GIL
        saver.start()
        sets = _small_sets(6, seed=72)
        feeds, nv12 = [], []
        for cam in range(2):
            feeds.append(os.path.join(d, f"cam{cam}.yuv"))
            nv12.append(os.path.join(d, f"cam{cam}.nv12"))
            with open(feeds[-1], "wb") as fy, open(nv12[-1], "wb") as fn:
                for fs in sets:
                    fy.write(fs[cam].tobytes())
                    fn.write(_nv12(fs[cam]).tobytes())
        pngs = [os.path.join(d, f"cam{cam}.png") for cam in range(2)]
        for p, f in zip(pngs, sets[0]):
            write_png(p, np.clip(yuv420p_to_rgb(torch.from_numpy(f)).numpy(), 0, 255).astype(np.uint8))
        size = f"{SMALL_CAM}x{SMALL_CAM}"
        out, out_nv12, out_png = (os.path.join(d, n) for n in ("out.yuv", "out.nv12", "map.png"))
        p_stream = _cli(["octvr_tpu_torch.cli.stream", "--inputs", ",".join(feeds), "--in_size", size,
                         "--outputs", f"{tmpl}:16:0", "--out", out, "--pipeline", "yuv420",
                         "--blend_dtype", "float32"])
        p_monkey = _cli(["octvr_tpu_torch.cli.monkey", "-t", tmpl, "--inputs", ",".join(nv12),
                         "--in_size", size, "--out", out_nv12])
        # feather blend: f32 on both devices (the card's multiband
        # default is bf16, the CPU's f32), so the CPU port is like for like
        p_map = _cli(["octvr_tpu_torch.cli.map", "-t", tmpl, "-o", out_png, "--blend", "-8", "--gain", *pngs])
        _finish(p_stream, "stream, small rig from raw files")
        _finish(p_monkey, "monkey, small rig NV12 feeds")
        err_map = _finish(p_map, "map, small rig PNGs")

        m_cpu = Mapper(mt, sizes, blend=16, pipeline="yuv420", blend_dtype="float32", device="cpu")
        got = np.fromfile(out, np.uint8).reshape(-1, 384, 512)
        if len(got) != len(sets):
            raise AssertionError(f"stream CLI wrote {len(got)} frames of {len(sets)}")
        for n, fs in enumerate(sets):
            ref = m_cpu.stitch(fs)[0].numpy().astype(np.float32)
            d_y = np.abs(got[n][:256].astype(np.float32) - ref[:256])
            d_uv = np.abs(got[n][256:].astype(np.float32) - ref[256:])
            log(f"  stream frame {n} vs the port on the CPU: Y mean {d_y.mean():.4f} max {d_y.max():.0f}, "
                f"UV mean {d_uv.mean():.4f} max {d_uv.max():.0f} (bars: means < 0.2, maxima <= 2)")
            if not (d_y.mean() < 0.2 and d_uv.mean() < 0.2 and d_y.max() <= 2 and d_uv.max() <= 2):
                raise AssertionError("stream CLI on the card disagrees with the port on the CPU")

        imgs = [read_png(p) for p in pngs]
        m_map = Mapper(mt, sizes, blend=-8, enable_gain=True, pipeline="yuv420", device="cpu")
        o, g_cpu = m_map.stitch([rgb_to_yuv420p(torch.from_numpy(i.astype(np.float32))) for i in imgs])
        ref = np.clip(yuv420p_to_rgb(o).numpy(), 0, 255).astype(np.uint8)
        d_rgb = np.abs(read_png(out_png).astype(np.float32) - ref)
        line = [s for s in err_map.splitlines() if s.startswith("gains:")][0]
        g_card = np.array(line.split("[")[1].split("]")[0].split(), np.float32)
        g_err = float(np.abs(g_card - g_cpu.numpy()).max())
        ch_mean = d_rgb.reshape(-1, 3).mean(0).max()
        log(f"  map PNG vs the port on the CPU: worst channel mean {ch_mean:.4f} (bar < 0.2), max "
            f"{d_rgb.max():.0f} (bar <= 6); gains {g_card.tolist()}, max err {g_err:.3g} (bar < 1e-3)")
        if not (ch_mean < 0.2 and d_rgb.max() <= 6 and g_err < 1e-3):
            raise AssertionError("map CLI on the card disagrees with the port on the CPU")
        fm = FastMapper(mt, sizes, device="cuda")
        got = np.fromfile(out_nv12, np.uint8).reshape(-1, 384, 512)
        if len(got) != len(sets):
            raise AssertionError(f"monkey CLI wrote {len(got)} frames of {len(sets)}")
        for n, fs in enumerate(sets):
            if not np.array_equal(got[n], fm.stitch_nv12([_nv12(f) for f in fs]).cpu().numpy()):
                raise AssertionError(f"monkey frame {n} differs from FastMapper.stitch_nv12")
        log(f"  monkey: {len(got)} NV12 frames equal to FastMapper.stitch_nv12, bit for bit")

        saver.join()
        out4k = os.path.join(d, "4k.yuv")
        p = _cli(["octvr_tpu_torch.cli.stream", "--in_size", f"{CAM}x{CAM}", "--outputs", f"{tmpl4k}:128",
                  "--out", out4k, "--source", "synthetic", "--frames", str(STREAM_FRAMES), "--timers"])
        err = _finish(p, f"stream, 4K synthetic source, {STREAM_FRAMES} frames, --timers")
        done = [line for line in err.splitlines() if line.startswith("# done")]
        timers = [line for line in err.splitlines() if line.startswith("[Timer stitch]")]
        n_bytes = os.path.getsize(out4k)
        if not done or "fps" not in done[-1] or len(timers) != 3 * (STREAM_FRAMES // 10):
            raise AssertionError("the 4K stream CLI printed no '# done' fps or not every stage timer")
        if n_bytes != STREAM_FRAMES * CANVAS_H * 3 // 2 * CANVAS_W:
            raise AssertionError(f"the 4K stream CLI wrote {n_bytes} bytes")
        log(f"  4K CLI: {done[-1]}; last timers {timers[-3:]}")
    log(f"  phase 7e-7f took {time.time() - t0:.1f} s")
    return done[-1]


_KERNEL_CLASSES = (
    ("remap (csrc/remap.cu)", ("remap_kernel", "remap_frames_kernel")),
    ("matmul (pyramid, pooling)", ("gemm", "xmma", "cutlass")),
    ("dtype casts and copies", ("copy",)),
    ("reductions (gain sums)", ("reduce",)),
    ("indexing (band pastes, row gathers)", ("index",)),
)


def profile(stitch, frame_sets, ms_frame):
    """One torch.profiler pass over 3 frames, each ``stitch(frame_set)``:
    device time of the kernels, by class and by name, and the device's
    busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for fs in frame_sets[:2]:
        stitch(fs)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fs in frame_sets[:3]:
            stitch(fs)
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


def main(argv):
    t_start = time.time()
    smi = phase_env()
    if len(argv) == 2 and argv[0] == "--time-remap":
        return time_remap(argv[1])
    if len(argv) == 2 and argv[0] == "--time-taps":
        return time_taps(argv[1])
    if argv:
        raise SystemExit(f"usage: chip_smoke.py [--time-remap ROOT | --time-taps ROOT], got {argv}")
    phase_build()
    err_small = phase_kernel_small()

    from octvr_tpu_torch.template import compile_rig

    t0 = time.time()
    mt = compile_rig(six_cam_rig(), CANVAS_W, CANVAS_H)
    mt.create_masks()
    t_template = time.time() - t0
    err_cam = phase_kernel_4k_camera(mt)
    err_nc3 = phase_kernel_nc3(mt)
    phase_frames_axis()
    frame_sets = make_frame_sets()
    host, t_host = build_sharded_4k(mt)
    err_concat = phase_kernel_concat(host, frame_sets)
    host_rgb, t_host_rgb = build_sharded_4k(mt, "rgb")
    err_concat_nc3 = phase_kernel_concat_nc3(host_rgb, frame_sets)
    taps = phase_mxu_taps()
    times = phase_remap_device_time(mt, host, host_rgb)
    phase_small_rig()
    mixed_launches, err_mixed = phase_small_rig_options()
    phase_default_path()
    phase_sharded_small()
    phase_sharded_small_options()
    main_path = phase_main_path(mt, t_template, frame_sets)
    rgb = phase_rgb_path(mt, frame_sets)
    mapper = main_path.pop("mapper")
    batch = phase_stitch_batch(mapper, frame_sets, main_path["ms_frame"])
    sharded = phase_sharded(host, t_host, frame_sets, main_path)
    sharded_sm = sharded.pop("sm")
    del host
    sharded_rgb = phase_sharded_rgb(host_rgb, t_host_rgb, frame_sets, rgb)
    t7 = time.time()
    stream = phase_stream_4k(mapper, frame_sets, main_path)
    del mapper
    small_mt, small_sizes = _small_stream_rig()
    phase_stream_small(small_mt, small_sizes)
    stream["7d"] = phase_stream_sharded_4k(
        sharded_sm, [[f.cpu().numpy() for f in fs] for fs in frame_sets[:SHARD_ITERS]]
    )
    del sharded_sm
    stream["7e"] = phase_stream_cli(small_mt, small_sizes, mt)
    log(f"  phase 7 took {time.time() - t7:.1f} s")

    log("== summary")
    log(f"total run time {time.time() - t_start:.1f} s")
    log(f"card: {smi}")
    a, b = stream["7a"], stream["7b"]
    log(f"stream pipeline (7a, host frames in and out): {a['fps']:.2f} frames/s, stages upload "
        f"{a['upload_ms']:.3f} / dispatch {a['dispatch_ms']:.3f} / drain {a['drain_ms']:.3f} ms/frame, H2D "
        f"{a['h2d_GBps']:.2f} GB/s, D2H {a['d2h_GBps']:.2f} GB/s; checksum drain (7b) "
        f"{b['host frames']['fps']:.2f} frames/s from host frames, {b['device frames']['fps']:.2f} from "
        f"device frames; band-sharded (7d) {stream['7d']['fps']:.2f} frames/s; phase 5 Mapper.stitch "
        f"{main_path['ms_frame']:.3f} ms/frame ({1e3 / main_path['ms_frame']:.2f} frames/s)")
    log("stream dispatch host ms/frame, medians of 7b's rounds: "
        + "; ".join(f"{k} {v:.3f}" for k, v in b["rounds"].items()))
    log(f"4K stream CLI (7e): {stream['7e']}")
    log("4K remap launches: device ms (share of bound); call ms; grid_sample device ms")
    for key, t in times.items():
        log(f"  {key:22s} {t['ms']:.5f} ({t['bound_ms'] / t['ms']:.3f}); call {t['call_ms']:.5f}; "
            f"grid_sample {t['library_ms']:.5f}")
    src = "octvr_tpu_torch/csrc/remap.cu"
    taps_src = "octvr_tpu_torch/csrc/mxu_taps.cu"
    pr = "octvr_tpu/ops/pallas_remap.py"
    probe = "tools/mxu_taps_probe.py"
    def timed(r, *keys):
        return {**r, **_sum_times(*(times[k] for k in keys))}

    rows = [
        ("remap NC=1 (yuv420 Y), kernel 1", src, f"{pr}:661", timed(main_path["nc1"], "y_nc1_bf16"),
         max(err_small, err_cam)),
        ("remap NC=2 (yuv420 U|V), kernel 2", src, f"{pr}:661", timed(main_path["nc2"], "uv_nc2_bf16"),
         max(err_small, err_cam)),
        ("remap NC=3 (rgb, equal sizes), kernel 3", src, f"{pr}:661", timed(rgb, "rgb_nc3_bf16"), err_nc3),
        ("remap NC=3 single-input launch (rgb, mixed sizes), kernel 4", src, f"{pr}:352",
         timed({"launches": mixed_launches, "err": err_nc3}, "single_nc3_f32"), err_mixed),
        ("remap frames kernel (stitch_batch), kernel 5", src, f"{pr}:1242",
         timed(batch, "frames_y_nc1_bf16", "frames_uv_nc2_bf16"), 0.0),
        ("remap concat-source NC=1/2 (band-sharded yuv420, source windows), kernel 6", src, f"{pr}:1249",
         timed(sharded, "sharded_nc1_bf16", "sharded_nc2_bf16"), err_concat),
        ("remap concat-source NC=3 (band-sharded rgb, source windows), kernel 6", src, f"{pr}:1249",
         timed(sharded_rgb, "sharded_nc3_bf16"), err_concat_nc3),
        ("MXU-taps probe A, gather from the step's window staged in shared memory, plan in 16 B vectors "
         "(fan), kernel 8", taps_src, f"{probe}:100", taps["fan"], 0.0),
        ("MXU-taps probe B, folded f32 weights as three bf16 wgmma products, A from registers, kernel 8",
         taps_src, f"{probe}:140", taps["mxu_folded"], 0.0),
        ("MXU-taps probe B2, two exact bf16 selection wgmma products, A from registers, kernel 8", taps_src,
         f"{probe}:197", taps["mxu_exact2"], 0.0),
    ]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": r["launches"],
        "max_abs_err": max(r["err"], extra),
        "ms": r["ms"],
        "call_ms": r["call_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    } for name, source, replaces, r, extra in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
