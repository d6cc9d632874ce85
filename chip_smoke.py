#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (octvr_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each failing the run on any error:
  1. environment: torch, CUDA, triton, the card and its power limit;
  2. build of the two kernel libraries (utils/build.py: ``product``,
     csrc/remap.cu, csrc/pyramid.cu and csrc/prep.cu; ``tools``,
     csrc/mxu_taps.cu;
     nvcc, sm_90a), one nvcc
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
     first-call time, frame-0 checksum, peak memory, the remap and
     pyramid kernels' launch counts (each replayed set's), and one
     torch.profiler pass;
     b. the same rig on the rgb pipeline (blend 128, gains, bf16);
     c. stitch_batch at B=4 on the yuv420 pipeline against stitch;
     d. the pyramid kernels (csrc/pyramid.cu) of phase 5's two blends,
        through multiband_blend: device ms per blend, their byte bound
        (each byte read or written once, at 3.35 TB/s) and share, and the
        banded products with the eager ops on the card (the library
        yardstick); in bf16 and in f32 every launch against those
        products and ops on its own inputs;
     e. the prep kernel (csrc/prep.cu) on phase 5's six frames with the
        plan's vignettes: each frame's Y and U|V byte-equal to the eager
        ops, then device ms of the six launches in a CUDA graph beside
        their byte bound (each byte read or written once, at 3.35 TB/s)
        and the eager ops' device ms (15 launches a frame);
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
        feeds: every frame equal to FastMapper.stitch_nv12's;
  8. the registration path (octvr_tpu_torch.registration, no hand
     kernel: plain torch on the card) on the 8-camera ring of 1920x1080
     pinholes (f 1108, 45 degree yaw steps) rendered from the tests'
     synthetic world (its own copy of world_tex, render_view and
     yaw_cameras):
     a. detect_and_describe on the card against the port on the CPU on
        the same 0.6 MP grays: keypoints shared, angle error, descriptor
        bits differing; the process's TF32 flags unchanged by the call;
     b. match_images on the card against the CPU on the same features:
        the same pairs, inlier counts within 1;
     c. register_images on the card: all 8 kept, focals within 1% of
        1108, rms < 2, each neighbour's relative yaw within 1 degree of
        45; against the port on the CPU (the same indices, focals within
        0.5%); the stage times;
     d. bundle_adjust_ray_torch on the card against the f64 numpy
        bundle_adjust_ray: focals within 2%, its time and host syncs;
     e. Stitcher(conf_thresh=0.5).stitch to 3840x1920 on the card: remap
        kernels launched, the covered share, the mean error against the
        rendered world at the best yaw shift under 20;
     f. ``python -m octvr_tpu_torch.cli.register`` as a process on the
        card and with OCTVR_PLATFORM=cpu on PNGs of the tests' 5-camera
        ring: the same images, fx within 0.5%, rotations within 5e-3.
  9. the offline stage and the operator CLIs on the card, at the main
     path's full width (phase 5's rig, 6 x 1920^2 -> 3840x1920):
     a. ``python -m octvr_tpu_torch.cli.dump``, five processes at once:
        without images (the distance seam) and with six 1920^2 PNGs from
        seed 0 for each of graphcut, graphcut_grad, dp and dp_grad; each
        .dat loads and its seam masks partition the canvas (covered >
        0.98, overlap < 0.02); the distance .dat equals phase 5's
        in-process compile_rig + create_masks() byte for byte;
     b. ``python -m octvr_tpu_torch.cli.live`` on six raw feeds of 8
        frames (phase 5's frame sets), blend 128: exit 0, "stream
        finished cleanly", the template equal to phase 5's, every frame
        within the 7e bars of the port's Mapper on the card built with
        the stream CLI's options from that template, the stream child's
        remap launches and each stage's wall time; then live with and
        without --encrypt_args on the small rig: the same output bytes;
     c. ``python -m octvr_tpu_torch.cli.gain_and_remap`` on the card and
        with OCTVR_PLATFORM=cpu on phase 5's template, the six reverse
        (rmap) templates and the six PNGs (an exposure spread): the
        .gain.png files within 1 LSB, at least 99.9% of values equal;
     d. Stitcher(conf_thresh=0.5, seam="graphcut").stitch of 8c's images
        to 3840x1920 at 8e's bars, its seconds beside 8e's.
  10. the distributed path (runtime/distributed.py, the band group across
     ranks, DistributedBands): ranks that are fresh interpreters of this
     script (``--rank``), joined through a file:// rendezvous, sharing
     the one card; a rank that fails fails the run.  Each rank resets
     the remap counts before its timed run and reads them after it
     (kernel 6, one launch per plane per frame).  Their frame rates
     measure contention and gloo's host staging, not scaling:
     a. one NCCL rank, make_global_mesh(1, 4) on phase 6's host plan:
        its 12 frame sets and gains equal to phase 6's bit for bit;
        ms/frame, enqueue, the band group's synchronised ms, beside
        phase 6's;
     b. four gloo ranks, one band each, the same frame sets: the
        assembled output within Y and UV mean 0.02, max 2 and gains
        rtol 1e-5 of phase 6's; per rank ms/frame, enqueue, band group
        ms, peak memory and launches per frame;
     c. four gloo ranks as a (2, 2) grid, make_global_mesh(2, 4): two
        data rows of two ranks holding two bands each, each row its own
        6 frame sets, the local_output_shards indices checked, at 10b's
        bars;
     d. two gloo ranks on two 512^2 fisheyes -> 512x256 in f32: pairwise
        and blocks gains, split on and off, feather, rgb with
        out_format="rgb", source windows, each within max 1 and gains
        rtol 1e-6 of the CUDA make_mesh(1, 2) output;
     e. bundle_adjust_ray_torch(mesh=) on 2 and 4 gloo ranks on 8c's
        matches, held to 8d's one-rank result (focals rtol 1e-3,
        rotations 1e-3 rad, rms within 1%), its time and host syncs;
     f. ``python -m octvr_tpu_torch.tools.multihost_stitch --backend
        gloo`` at the JAX test's shape, --procs 2 --devices-per-proc 2
        and --procs 4 --devices-per-proc 1: parity_ok, frames/s.
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
    python3 chip_smoke.py --distributed

times only the 4K remap launches (phase 3h's rows, device and call ms),
or only kernel 8's three bodies at the probe's defaults (3g's timing,
each held to A), of the package in the checkout at ROOT and prints them
as one JSON line: run it on two checkouts in turns, in one call on one
card, to compare their kernels (an earlier commit's, or an edited copy
of a source).  ``--distributed`` runs phase 10 alone, with the inputs it
takes from phases 2, 6 and 8 made first.
"""

import ast
import contextlib
import importlib.util
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
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
    ys, uvs = sm._prep(bufs)
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
    parts = sm._prep(sm._frames_to_device([f[None] for f in frame_sets[0]]))
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


def _scene_rgb(rng, size, gain):
    """[size, size, 3] f64 RGB in [0, 255]: a smooth in-gamut scene scaled
    by its exposure gain, with noise (bench.py's default-path fixture)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rgb = np.stack(
        [
            127 + 90 * np.sin(6.3 * xx + 2 * yy + rng.uniform(0, 6)),
            127 + 90 * np.cos(4.1 * yy - 3 * xx + rng.uniform(0, 6)),
            127 + 90 * np.sin(2.7 * (xx + yy) + rng.uniform(0, 6)),
        ],
        axis=-1,
    ) * gain + rng.normal(0.0, 6.0, (size, size, 3))
    return np.clip(rgb, 0, 255)


def _in_gamut_frames(rng, n, size, gains):
    """Packed YUV420P frames of smooth in-gamut RGB scenes (bench.py's
    default-path fixture), each scaled by its exposure gain."""
    frames = []
    for k in range(n):
        rgb = _scene_rgb(rng, size, gains[k])
        r, g, b = (rgb[..., c] for c in range(3))
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
    planes = m._prep([f.to(m.device) for f in m._check_frames(mframes, batched=False)])
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


def make_frame_sets(n=ITERS):
    """``n`` frame sets of the 4K rig on the card, from seed 0."""
    rng = np.random.default_rng(0)
    base = [rng.integers(0, 255, (CAM * 3 // 2, CAM), dtype=np.uint8) for _ in range(6)]
    base_t = torch.from_numpy(np.stack(base)).cuda().to(torch.int16)
    sets = [list((base_t + i).clamp(0, 255).to(torch.uint8).unbind(0)) for i in range(n)]
    torch.cuda.synchronize()
    return sets


def _pyramid_counts(plan, dtype="bf16"):
    """{variant: launches} of the pyramid kernels in one stitch of a
    yuv420 Mapper's ``plan``: per multiband blend (Y at C=1, U|V at C=2)
    a grouped down per level and camera chunk, one gathering accumulate
    per chunk of its tables (``blenders.pyramid_groups``), and B collapse
    steps."""
    from octvr_tpu_torch.stitch.blenders import pyramid_groups

    counts = {}
    for bl, c in ((plan.blender, 1), (plan.blender_uv, 2)):
        groups, b = pyramid_groups(bl), bl.num_bands
        counts.update({f"down_group_c{c}_{dtype}": b * len(groups.cam_chunks),
                       f"lap_gather_c{c}_{dtype}": len(groups.lap), f"up_add_c{c}_{dtype}": b})
    return counts


def _cameras_a_grouped_launch(plan):
    """The cameras that a grouped pyramid launch of one stitch of a
    yuv420 Mapper's ``plan`` serves, on average over its two blends'
    grouped launches (from their tables)."""
    from octvr_tpu_torch.stitch.blenders import pyramid_groups

    served = []
    for bl in (plan.blender, plan.blender_uv):
        groups = pyramid_groups(bl)
        served += [len(ch) for ch in groups.cam_chunks] * bl.num_bands
        served += [len(cams) for _, cams, _ in groups.lap_chunks]
    return sum(served) / len(served)


def phase_main_path(mt, t_template, frame_sets):
    from octvr_tpu_torch.ops import cuda_prep, cuda_pyramid, cuda_remap
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
    cuda_pyramid.reset_counts()
    cuda_prep.reset_counts()
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
    pyr_counts = dict(cuda_pyramid.COUNTS)
    prep_counts = dict(cuda_prep.COUNTS)
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
    per_set = _pyramid_counts(mapper.plan)
    log(f"  pyramid kernel launches: {cuda_pyramid.LAUNCHES} over {ITERS + 1} frames: {pyr_counts} "
        f"(a set: {per_set}; {_cameras_a_grouped_launch(mapper.plan):.2f} cameras a grouped launch)")
    if pyr_counts != {k: (ITERS + 1) * v for k, v in per_set.items()}:
        raise AssertionError(f"expected {ITERS + 1} sets of the pyramid launches {per_set}")
    log(f"  prep kernel launches: {cuda_prep.LAUNCHES} over {ITERS + 1} frames: {prep_counts}")
    if prep_counts != {"yuv420p": 6 * (ITERS + 1)}:
        raise AssertionError(f"expected one prep launch per camera and set, {6 * (ITERS + 1)}")
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

    ys, uvs = mapper._prep(frame_sets[0])
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
        "pyramid_launches": sum(pyr_counts.values()),
        "prep_launches": sum(prep_counts.values()),
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

    planes = torch.stack(mapper._prep(sets[0]))
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
    preps = [mapper._prep(fs) for fs in sets[:BATCH]]
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


def _pyramid_bytes(plan, c, itemsize):
    """Bytes that the pyramid kernels of one multiband blend over
    ``plan`` on C-channel images must move, each read or written once:
    per image and level i < B a grouped down step (reads level i, writes
    i + 1); the gathering accumulate, which reads per image and level
    i < B its levels i + 1 and i and its weight level once for all
    channels, at level B its level B and weight level, and writes each
    band level once (never reads it); per canvas level i < B a collapse
    step (reads the coarser sum, the band level and its inverse weight
    once for all channels; writes the sum)."""
    B = plan.num_bands
    n = 0
    for _, _, aw, ah in plan.align_rois:
        for i in range(B):
            fine, coarse = (ah >> i) * (aw >> i), (ah >> (i + 1)) * (aw >> (i + 1))
            n += c * (fine + coarse)  # down
            n += c * coarse + c * fine + fine  # gather, level i
        n += (c + 1) * (ah >> B) * (aw >> B)  # gather, level B
    _, _, arw, arh = plan.align_result_roi
    n += sum(c * (arh >> i) * (arw >> i) for i in range(B + 1))  # the band levels, written once
    for i in range(B):
        fine, coarse = (arh >> i) * (arw >> i), (arh >> (i + 1)) * (arw >> (i + 1))
        n += c * coarse + 2 * c * fine + fine  # collapse
    return n * itemsize


@contextlib.contextmanager
def _pyramid_ops(**ops):
    """Inside, the entries of ``ops.cuda_pyramid`` named in ``ops`` are
    ``ops``' functions: ``down_group``, ``lap_gather`` and
    ``up_collapse``, which ``blenders.multiband_blend`` (the blend the
    Mapper runs) calls; ``down`` and ``up_laplacian``, which the
    stepwise compositions (``down_group_stepwise``,
    ``lap_gather_stepwise``) call."""
    from octvr_tpu_torch.ops import cuda_pyramid as cp

    real = {name: getattr(cp, name) for name in ops}
    for name, fn in ops.items():
        setattr(cp, name, fn)
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(cp, name, fn)


def _one_rounding(k, t32):
    """(share, err): the share of ``k`` (a kernel's store) that differs
    from the rounding of ``t32`` (the banded product's f32 sum) to k's
    dtype, and for f32 the max abs difference (0.0 for bf16).  Raises
    unless every f32 store is within 1e-4 of its sum and every bf16
    store a rounding of a value within a few f32 ulps of it (the twin's
    rounding, or its neighbour where the sum sits on an edge)."""
    if k.dtype == torch.float32:
        err = (k - t32).abs().max().item()
        if not err <= 1e-4:
            raise AssertionError(f"f32 pyramid step off its banded product by {err:.3g}")
        return 0.0, err
    half_ulp = torch.exp2(torch.frexp(t32.abs())[1].float() - 9)  # half a bf16 ulp of |t|
    if not ((k.float() - t32).abs() <= half_ulp + t32.abs() * 2**-18 + 1e-30).all():
        raise AssertionError("bf16 pyramid step is not a rounding of its banded product")
    return (k != t32.to(k.dtype)).float().mean().item(), 0.0


def _checked_pyramid_ops(checks):
    """The pyramid kernels of the blend, grouped and per step, each launch
    checked on its own inputs: a per-step down or up step's store is a
    rounding of the banded product's f32 sum (``_one_rounding``, whose
    result goes to ``checks``); the per-step Laplacian accumulate and the
    collapse equal, bit for bit, the eager ops on the card applied to the
    checked up step; each camera's level of a grouped down step equals
    the checked per-step ``down`` of its level, and the gathering
    accumulate's bands ``lap_gather_stepwise`` over the checked per-step
    ``up_laplacian``, byte for byte.  Returns the checked ``down_group``,
    ``lap_gather`` and ``up_collapse`` for ``_pyramid_ops``."""
    from octvr_tpu_torch.ops import cuda_pyramid as cp
    from octvr_tpu_torch.ops.pyramid import pyr_down_mm, pyr_up_mm

    names = ("down", "up", "up_laplacian", "up_collapse", "down_group", "lap_gather")
    real = {name: getattr(cp, name) for name in names}

    def down(x, mats):
        got = real["down"](x, mats)
        checks.append(_one_rounding(got, pyr_down_mm(x, mats[x.shape[-2]], mats[x.shape[-1]])))
        return got

    def up(x, mats):
        got = real["up"](x, mats)
        checks.append(_one_rounding(got, pyr_up_mm(x, mats[x.shape[-2]], mats[x.shape[-1]])))
        return got

    def up_laplacian(dst, g, x, w, mats):
        want = dst + (g - up(x, mats)) * w
        real["up_laplacian"](dst, g, x, w, mats)
        if not torch.equal(dst, want):
            raise AssertionError(f"Laplacian accumulate of {tuple(x.shape)} differs from the eager ops")
        return dst

    def up_collapse(x, d, s, mats):
        got = real["up_collapse"](x, d, s, mats)
        if not torch.equal(got, up(x, mats) + d * s):
            raise AssertionError(f"collapse step of {tuple(x.shape)} differs from the eager ops")
        return got

    def down_group(groups, i, x, mats):
        got = real["down_group"](groups, i, x, mats)
        for k in range(groups.cameras):
            if not torch.equal(groups.level(got, i + 1, k), down(groups.level(x, i, k), mats)):
                raise AssertionError(f"grouped down of level {i}, camera {k}, differs from the per-step down")
        return got

    def lap_gather(groups, gauss, mats):
        got = real["lap_gather"](groups, gauss, mats)
        with _pyramid_ops(up_laplacian=up_laplacian):
            want = cp.lap_gather_stepwise(groups, gauss, mats)
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"gathered band level {i} of {tuple(a.shape)} differs from the per-camera steps")
        return got

    return {"down_group": down_group, "lap_gather": lap_gather, "up_collapse": up_collapse}


def _profiled_ms(fn, words, calls=5):
    """Device ms per ``fn()`` from one torch.profiler pass over ``calls``
    eager calls: (every kernel's, the kernels' whose names hold one of
    ``words``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / calls / 1e3
    picked = sum(e.self_device_time_total for e in events if any(w in e.key for w in words)) / calls / 1e3
    return total, picked


def phase_pyramid_device_time(mapper):
    """5d: the pyramid kernels of the 4K Mapper's two blends (Y: 6 bands,
    C=1; U|V: 5 bands, C=2; bf16), run through ``multiband_blend``, the
    function the Mapper calls: the kernels' device time per blend
    (``ms``, torch.profiler), beside their byte bound (``_pyramid_bytes``
    at 3.35 TB/s), the per-step kernels of the same blend composed
    camera by camera (``step_ms``: ``down_group_stepwise`` and
    ``lap_gather_stepwise``, ``down`` and ``up_laplacian`` per camera and
    level and the eager level-B adds, the same collapse) and the plain
    steps on the card (the banded products and the eager ops, which
    cuBLAS and torch run, in the stepwise compositions: the library
    yardstick; the plain blend's device time less the blend's other
    ops); the launches against ``_pyramid_counts``; then, in bf16 and in
    f32 on the same plans and images, every grouped launch against the
    per-step kernels and every per-step launch against its plain version
    on its own inputs (``_checked_pyramid_ops``)."""
    import dataclasses

    from octvr_tpu_torch.ops import cuda_pyramid as cp
    from octvr_tpu_torch.stitch.blenders import multiband_blend

    log("== 5d. pyramid kernels at the 4K plan's shapes: device ms per blend, byte bound, banded products")
    stepwise = {"down_group": cp.down_group_stepwise, "lap_gather": cp.lap_gather_stepwise}
    plain = {**stepwise, "down": cp.down_reference, "up_laplacian": cp.up_laplacian_reference,
             "up_collapse": cp.up_collapse_reference}
    kernels = ("pyr_down_group_kernel", "pyr_lap_gather_kernel", "pyr_up_kernel")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for label, bl, c, canvas in (("Y", mapper.plan.blender, 1, (CANVAS_W, CANVAS_H)),
                                 ("U|V", mapper.plan.blender_uv, 2, (CANVAS_W // 2, CANVAS_H // 2))):
        dtype = getattr(torch, bl.compute_dtype)
        imgs = [(torch.rand((c, h, w), generator=gen, device="cuda") * 255).to(dtype) for _, _, w, h in bl.rois]

        def blend(plan=bl, imgs=imgs, canvas=canvas):
            return multiband_blend(plan, imgs, canvas)

        cp.reset_counts()
        blend()
        launches = cp.LAUNCHES
        blend_ms, ms = _profiled_ms(blend, kernels)
        with _pyramid_ops(**stepwise):
            step_ms = _profiled_ms(blend, ("pyr_down_kernel", "pyr_up_kernel"))[1]
        call_ms = steady_ms(blend)[0]
        with _pyramid_ops(**plain):
            plain_ms = _profiled_ms(blend, ())[0]
        lib_ms = plain_ms - (blend_ms - ms)
        nbytes = _pyramid_bytes(bl, c, imgs[0].element_size())
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        checks = []
        with _pyramid_ops(**_checked_pyramid_ops(checks)):
            blend()
            bl32 = dataclasses.replace(
                bl, weight_pyrs=[[w.float() for w in p] for p in bl.weight_pyrs],
                inv_band_weights=[v.float() for v in bl.inv_band_weights], compute_dtype="float32",
            )
            multiband_blend(bl32, [i.float() for i in imgs], canvas)
        torch.cuda.synchronize()
        share, err = (max(v) for v in zip(*checks))
        log(f"  {label}: {launches} launches, kernels {ms:.4f} ms of the blend's {blend_ms:.4f} device ms "
            f"(per-camera steps {step_ms:.4f} ms), "
            f"call {call_ms:.4f} ms; {nbytes / 1e6:.1f} MB, bound {bound_ms:.4f} ms, share {bound_ms / ms:.3f}; "
            f"banded products and eager ops {lib_ms:.4f} ms ({lib_ms / ms:.1f}x; the plain blend {plain_ms:.4f}); "
            f"{len(checks)} steps in bf16 and f32 each a rounding of its banded product: bf16 at most "
            f"{share:.2e} of a step's outputs off the twin's rounding (bar <= 1e-3), f32 max abs err {err:.3g} "
            f"(bar <= 1e-4); grouped downs and gathered bands equal to the per-step kernels, Laplacian steps "
            f"and collapse to the eager ops")
        if not share <= 1e-3:
            raise AssertionError(f"pyramid kernels round apart from the banded products at the 4K {label} plan")
        if not bound_ms < ms:
            raise AssertionError(f"the {label} pyramid kernels beat their byte bound: bytes or time miscounted")
        rows[label] = {"launches": launches, "err": err, "ms": ms, "step_ms": step_ms, "call_ms": call_ms,
                       "plain_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms}
        del imgs
    launches = rows["Y"]["launches"] + rows["U|V"]["launches"]
    if launches != sum(_pyramid_counts(mapper.plan).values()):
        raise AssertionError(f"{launches} pyramid launches in the two blends, expected {_pyramid_counts(mapper.plan)}")
    total = {k: rows["Y"][k] + rows["U|V"][k]
             for k in ("ms", "step_ms", "call_ms", "plain_ms", "bound_ms", "library_ms")}
    total.update(err=max(r["err"] for r in rows.values()), bound_by="bytes")
    log(f"  a set's two blends: kernels {total['ms']:.4f} device ms (per-camera steps {total['step_ms']:.4f}), "
        f"bound {total['bound_ms']:.4f} ms, share {total['bound_ms'] / total['ms']:.3f}; banded products and "
        f"eager ops {total['library_ms']:.4f} ms")
    return total


def _prep_bytes(h, w):
    """Bytes the prep of one packed frame [h*3/2, w] with its vignettes
    must move, each read or written once: the frame, the f32 vignette
    [h, w] and chroma vignette [h/2, w/2], the uint8 Y and U|V."""
    return h * 3 // 2 * w + 4 * h * w + 4 * (h // 2) * (w // 2) + h * w + h * w // 2


def phase_prep_device_time(mapper, frame_sets):
    """5e: the prep kernel on phase 5's six frames with the 4K plan's
    vignettes: every frame's Y and U|V byte-equal to the eager ops on
    the card; the six launches' device ms in a CUDA graph (``device_ms``,
    median of replays) beside their byte bound (``_prep_bytes`` at 3.35
    TB/s) and the eager ops' device ms (the plain version, 15 launches a
    frame, the parent's path); the eager call's ms."""
    from octvr_tpu_torch.ops import cuda_prep

    log("== 5e. prep kernel at the 4K main path's shapes: six 1920^2 frames, device ms, byte bound, eager ops")
    fmt = mapper.frame_format
    ips = mapper.plan.inputs
    frames = frame_sets[0]
    for f, ip in zip(frames, ips):
        got = cuda_prep.prep_yuv(f, fmt, ip.vignette, ip.vig_half)
        want = cuda_prep.prep_yuv_reference(f, fmt, ip.vignette, ip.vig_half)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("prep kernel differs from the eager ops at the 4K main path's shapes")

    def kernel():
        for f, ip in zip(frames, ips):
            cuda_prep.prep_yuv(f, fmt, ip.vignette, ip.vig_half)

    def plain():
        for f, ip in zip(frames, ips):
            cuda_prep.prep_yuv_reference(f, fmt, ip.vignette, ip.vig_half)

    ms = device_ms(kernel)[0]
    plain_ms = device_ms(plain)[0]
    call_ms = steady_ms(kernel)[0]
    nbytes = sum(_prep_bytes(f.shape[0] * 2 // 3, f.shape[1]) for f in frames)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  six frames: kernel {ms:.4f} device ms ({ms / len(frames) * 1e3:.2f} us a frame), call {call_ms:.4f} ms; "
        f"{nbytes / 1e6:.1f} MB, bound {bound_ms:.4f} ms, share {bound_ms / ms:.3f}; eager ops {plain_ms:.4f} "
        f"device ms ({plain_ms / ms:.1f}x); Y and U|V byte-equal to the eager ops on all six")
    if not bound_ms < ms:
        raise AssertionError("the prep kernel beats its byte bound: bytes or time miscounted")
    return {"err": 0.0, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


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
    ys, uvs = sm._prep(bufs)
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
    p6 = sharded_reference(sm, sets)
    p6.update(ms=ms1, enqueue=enq1)
    log(f"  band group (LocalBands): {p6['coll_calls']:.0f} calls, {p6['coll_ms']:.3f} ms/frame synchronised")
    profile(lambda fs: sm.stitch_batch([f[None] for f in fs]), sets, ms1)
    return {"launches": counts1["concat_nc1_bf16"] + counts1["concat_nc2_bf16"], "err": err, "sm": sm, "p6": p6}


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
    parts = sm._prep(sm._frames_to_device(one[0]))
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


def _card_env(**extra):
    """The environment of a CLI process on the card (no OCTVR_PLATFORM),
    plus ``extra``."""
    env = {k: v for k, v in os.environ.items() if k != "OCTVR_PLATFORM"}
    return {**env, **extra}


def _cli(args, timeout=300):
    """``python -m octvr_tpu_torch.cli.<args>`` from the root on the card
    (no OCTVR_PLATFORM): a started process."""
    return subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=_card_env(), text=True,
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


# ---------------------------------------------------------------- phase 8

REG_N, REG_STEP = 8, 45.0  # 8c: the 8-camera ring, 45 degree yaw steps
REG_W, REG_H, REG_F = 1920, 1080, 1108.0  # 1920x1080 pinholes, 82 degrees across
REG_FEATURES = 1500
SMALL_RING = (5, 30.0, 380.0, 400, 300)  # 8f: the tests' synthetic ring


def world_tex(d):
    """Busy, corner-rich color field over cv-convention ray directions
    [..., 3] -> [..., 3] uint8-range floats (the tests' synthetic world,
    tests/test_registration.py, its own copy)."""
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    # random per-cell brightness -> L/T junctions everywhere (FAST does
    # not fire on perfect checkerboard X-corners)
    a = np.floor((np.arctan2(x, z) + PI) * 64 / PI)
    b = np.floor((np.arcsin(np.clip(y, -1, 1)) + PI / 2) * 64 / PI)
    # per-cell pseudo-random brightness with large aperiodic variation so
    # corners are locally unique (repetitive textures defeat matching)
    check = ((a * 7919 + b * 104729 + a * b * 337) % 97) / 96.0 * 170 + 30
    r = check + 35 * np.sin(31 * x + 17 * y) + 30 * np.sin(3.1 * x - 1.7 * z)
    g = check + 35 * np.cos(23 * y + 11 * z) + 30 * np.cos(2.3 * y + 1.1 * x)
    bl = check + 35 * np.sin(27 * z + 19 * x) + 30 * np.sin(2.9 * z + 1.3 * y)
    return np.clip(np.stack([r, g, bl], axis=-1), 0, 255)


def render_view(R_cv, f, w, h):
    """Render a pinhole view (cv convention: ray_world = R @ K^-1 p)."""
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    d_cam = np.stack(
        [(u - w / 2) / f, (v - h / 2) / f, np.ones_like(u)], axis=-1
    )
    d_world = d_cam @ np.asarray(R_cv).T
    return world_tex(d_world).astype(np.float32)


def yaw_cameras(n, step_deg, f=400.0):
    """Cameras rotated about the world y axis."""
    cams = []
    for k in range(n):
        a = math.radians(step_deg * k)
        R = np.array(
            [
                [math.cos(a), 0, math.sin(a)],
                [0, 1, 0],
                [-math.sin(a), 0, math.cos(a)],
            ]
        )
        cams.append(R)
    return cams


def _render_ring(n, step, f, w, h):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda R: render_view(R, f, w, h), yaw_cameras(n, step)))


def _tf32_flags():
    return {
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def _rel_yaws(cams):
    """Each neighbour's relative rotation angle in degrees, around the ring."""
    out = []
    for a in range(len(cams)):
        R = cams[(a + 1) % len(cams)].R @ cams[a].R.T
        out.append(math.degrees(math.acos(np.clip((np.trace(R) - 1) / 2, -1, 1))))
    return out


def phase_features(images, smi):
    """8a: detect_and_describe on the card against the port on the CPU,
    on the same 0.6 MP grays of the 8-camera ring; the process's TF32
    flags before and after.  Returns the CPU features (8b's input)."""
    from octvr_tpu_torch.ops.resize import resize_bilinear_host
    from octvr_tpu_torch.registration import detect_and_describe, rgb_to_gray
    from octvr_tpu_torch.registration.stitcher import REGISTR_MEGAPIX
    from registration_fixtures import feature_parity

    scale = min(1.0, math.sqrt(REGISTR_MEGAPIX * 1e6 / (REG_W * REG_H)))
    sh, sw = int(REG_H * scale), int(REG_W * scale)
    grays = [rgb_to_gray(torch.from_numpy(resize_bilinear_host(im, sh, sw))) for im in images]
    log(f"== 8a. detect_and_describe on the card vs the CPU, {len(grays)} grays of {sw}x{sh} "
        f"(0.6 MP of the 8 x {REG_W}x{REG_H} ring), max_features {REG_FEATURES}")
    before = _tf32_flags()
    detect_and_describe(grays[0], max_features=REG_FEATURES, device="cuda")  # first call
    torch.cuda.synchronize()
    after = _tf32_flags()
    t0 = time.perf_counter()
    card = [detect_and_describe(g, max_features=REG_FEATURES, device="cuda") for g in grays]
    torch.cuda.synchronize()
    ms_card = (time.perf_counter() - t0) * 1e3 / len(grays)
    t0 = time.perf_counter()
    cpu = [detect_and_describe(g, max_features=REG_FEATURES, device="cpu") for g in grays]
    ms_cpu = (time.perf_counter() - t0) * 1e3 / len(grays)
    log(f"  TF32 flags before the first call {before}, after {after}")
    if before != after:
        raise AssertionError("detect_and_describe changed the process's TF32 flags")
    worst = None
    for k, (a, b) in enumerate(zip(card, cpu)):
        p = feature_parity(a, b)
        if k == 0:
            log(f"  image 0: valid {p['valid'][0]} on the card, {p['valid'][1]} on the CPU of "
                f"{a.valid.numel()} slots; shared {p['shared']} ({p['shared'] / max(p['valid']):.4f}); "
                f"angle error max {p['max_angle']:.3e} rad; descriptor bits differing "
                f"{1 - p['bits']:.3e}")
        if p["set_diff"] > 0.01 or p["max_angle"] > 1e-3 or p["bits"] < 0.995:
            raise AssertionError(f"image {k}: card features differ from the CPU's: {p}")
        worst = p if worst is None or p["set_diff"] > worst["set_diff"] else worst
    log(f"  all {len(grays)}: keypoint sets differ by at most {worst['set_diff']:.4f} of the valid "
        f"count (bar 0.01); features {ms_card:.2f} ms/image on the card, {ms_cpu:.1f} on the CPU ({smi})")
    return cpu


def phase_match(cpu_feats, smi):
    """8b: match_images on the card against the CPU, on the same
    features: the same pairs, inlier counts within +-1."""
    from octvr_tpu_torch.registration import match_images

    log(f"== 8b. match_images on the card vs the CPU, on 8a's CPU features ({len(cpu_feats)} images, "
        f"{len(cpu_feats) * (len(cpu_feats) - 1) // 2} pairs)")
    card_feats = [f.to("cuda") for f in cpu_feats]
    match_images(card_feats[:2], device="cuda")  # first call
    times = {}
    card = match_images(card_feats, device="cuda", times=times)
    cpu = match_images(cpu_feats, device="cpu")
    if card.keys() != cpu.keys():
        raise AssertionError("match_images: the pair keys differ")
    worst = 0
    for key in cpu:
        a, b = card[key], cpu[key]
        if not np.array_equal(a.pairs, b.pairs):
            raise AssertionError(f"pair {key}: the ratio-test pairs differ")
        worst = max(worst, abs(a.num_inliers - b.num_inliers))
    if worst > 1:
        raise AssertionError(f"inlier counts differ by {worst} (bar 1)")
    inl = {k: m.num_inliers for k, m in sorted(card.items()) if m.H is not None}
    log(f"  pairs equal; inlier counts within {worst} (bar 1); with a homography: {inl}")
    log(f"  card: 2-NN {times['two_nn'] * 1e3:.2f} ms, RANSAC {times['ransac'] * 1e3:.2f} ms, refit "
        f"{times['refit'] * 1e3:.2f} ms ({smi})")


def phase_register(images, smi):
    """8c: register_images on the card on the 8 x 1920x1080 ring, held to
    the ground truth and to the port on the CPU; stage times."""
    from octvr_tpu_torch.registration import register_images

    log(f"== 8c. register_images on the card: {REG_N} x {REG_W}x{REG_H} pinholes, f {REG_F:.0f}, "
        f"{REG_STEP:.0f} degree yaw steps, max_features {REG_FEATURES}, conf_thresh 0.5, ba ray")
    kw = dict(ba="ray", conf_thresh=0.5, max_features=REG_FEATURES)
    t0 = time.perf_counter()
    res = register_images(images, device="cuda", **kw)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = register_images(images, device="cpu", **kw)
    wall_cpu = time.perf_counter() - t0
    focals = np.array([c.focal for c in res.cameras])
    yaws = _rel_yaws(res.cameras)
    log(f"  kept {res.indices}; focals {np.round(focals, 2).tolist()}; rms {res.rms:.4f}; neighbour "
        f"yaws {np.round(yaws, 3).tolist()}")
    if res.indices != list(range(REG_N)):
        raise AssertionError(f"kept {res.indices}, not all {REG_N}")
    if np.abs(focals / REG_F - 1).max() > 0.01 or not res.rms < 2.0:
        raise AssertionError(f"focals {focals} (bar 1% of {REG_F}) or rms {res.rms} (bar 2)")
    if max(abs(y - REG_STEP) for y in yaws) > 1.0:
        raise AssertionError(f"neighbour yaws {yaws} (bar 1 degree of {REG_STEP})")
    f_cpu = np.array([c.focal for c in ref.cameras])
    if ref.indices != res.indices or np.abs(focals / f_cpu - 1).max() > 5e-3:
        raise AssertionError(f"card vs CPU: indices {res.indices} / {ref.indices}, focals {focals} / {f_cpu}")
    log(f"  vs the port on the CPU: the same indices, focals within {np.abs(focals / f_cpu - 1).max():.2e} "
        f"(bar 5e-3), rms {ref.rms:.4f}")
    stages = ("resize_gray", "features", "two_nn", "ransac", "refit", "rotations", "ba", "wave", "total")
    log("  stage seconds on the card (CPU): " + "; ".join(
        f"{k} {res.times[k]:.4f} ({ref.times[k]:.4f})" for k in stages))
    log(f"  features per image {res.times['features'] / REG_N * 1e3:.2f} ms; wall {wall:.3f} s on the card, "
        f"{wall_cpu:.3f} s on the CPU ({smi})")
    return res


def phase_bundle(res, smi):
    """8d: bundle_adjust_ray_torch on the card on 8c's matches, against
    the numpy f64 bundle_adjust_ray from the same cameras."""
    import copy

    from octvr_tpu_torch.registration import bundle_adjust_ray, estimate_rotations
    from octvr_tpu_torch.registration.bundle_torch import bundle_adjust_ray_torch

    log("== 8d. bundle_adjust_ray_torch on the card (f32 LM) vs the f64 numpy bundle_adjust_ray, "
        "8c's features and matches")
    cams, _ = estimate_rotations(res.features, res.matches)
    bundle_adjust_ray_torch(res.features, res.matches, copy.deepcopy(cams), 0.5, max_iter=2, device="cuda")
    stats = {}
    t0 = time.perf_counter()
    got, rms = bundle_adjust_ray_torch(res.features, res.matches, copy.deepcopy(cams), 0.5, device="cuda",
                                       stats=stats)
    ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want, rms_np = bundle_adjust_ray(res.features, res.matches, copy.deepcopy(cams), 0.5)
    ms_np = (time.perf_counter() - t0) * 1e3
    fg, fw = np.array([c.focal for c in got]), np.array([c.focal for c in want])
    rel = np.abs(fg / fw - 1).max()
    log(f"  focals within {rel:.2e} of numpy's (bar 0.02); rms {rms:.4f} vs {rms_np:.4f}; iterations "
        f"{stats['iters']}, host syncs {stats['syncs']}; {ms:.1f} ms on the card, numpy {ms_np:.1f} ms ({smi})")
    if rel > 0.02:
        raise AssertionError(f"card BA focals {fg} vs numpy {fw}")
    return {"focals": fg.tolist(), "R": [c.R for c in got], "rms": rms, "ms": ms, "syncs": stats["syncs"],
            "features": [f.to("cpu") for f in res.features], "matches": res.matches, "cams": cams}


def _world_error(pano, covered, step=8):
    """Mean abs error of the covered pixels against the rendered world at
    the best yaw shift (test_full_loop_ring_to_panorama's check): a coarse
    search on every step-th row and column, then each shift around the
    best on every step-th row."""
    from octvr_tpu_torch.cameras import new_camera
    from octvr_tpu_torch.geometry import lonlat_to_xyz
    from octvr_tpu_torch.registration.stitcher import _C

    H, W = pano.shape[:2]

    def truth(xs, ys):
        ll = new_camera("equirectangular", {}).image_to_obj(np.stack(np.meshgrid(xs / W, ys / H), -1))
        return world_tex(lonlat_to_xyz(ll) @ _C.T)

    ys = np.arange(0, H, step)
    coarse_t = truth(np.arange(0, W, step), ys)
    p, c = pano[::step, ::step].astype(float), covered[::step, ::step]
    errs = [np.abs(np.roll(p, s, 1) - coarse_t)[np.roll(c, s, 1)].mean() for s in range(W // step)]
    s0 = int(np.argmin(errs)) * step
    fine_t = truth(np.arange(W), ys)
    p, c = pano[::step].astype(float), covered[::step]
    return min(
        np.abs(np.roll(p, s, 1) - fine_t)[np.roll(c, s, 1)].mean() for s in range(s0 - step, s0 + step + 1)
    )


def phase_stitcher(images, smi, seam="distance", label="8e"):
    """8e (9d with ``seam="graphcut"``): Stitcher(conf_thresh=0.5,
    seam=seam).stitch of 8c's images to 3840x1920 on the card: the remap
    kernels launched, the covered share, the error against the rendered
    world at the best yaw shift.  Returns the StitchResult."""
    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.stitcher_facade import Stitcher

    log(f"== {label}. Stitcher(conf_thresh=0.5, seam={seam!r}).stitch of 8c's images to {CANVAS_W}x{CANVAS_H} "
        "on the card")
    cuda_remap.reset_counts()
    t0 = time.perf_counter()
    res = Stitcher(conf_thresh=0.5, seam=seam).stitch(images, out_width=CANVAS_W)
    t_stitch = time.perf_counter() - t0
    counts = dict(cuda_remap.COUNTS)
    if cuda_remap.LAUNCHES == 0:
        raise AssertionError("Stitcher.stitch launched no remap kernel")
    covered = np.zeros((CANVAS_H, CANVAS_W), bool)
    for inp, sm in zip(res.template.inputs, res.template.seam_masks):
        x, y, rw, rh = inp.roi
        covered[y : y + rh, x : x + rw] |= sm > 128
    err = _world_error(res.panorama, covered)
    log(f"  kept {res.indices}, rms {res.rms:.4f}; remap launches {counts}; covered share "
        f"{covered.mean():.4f} (bar 0.2-0.4); world error at the best yaw shift {err:.3f} (bar 20)")
    log(f"  stitch {t_stitch:.3f} s: registration {res.times['register']:.3f}, template (compile_rig + "
        f"create_masks, host) {res.times['template']:.3f}, Mapper build and one frame "
        f"{res.times['compose']:.3f} ({smi})")
    if res.panorama.shape != (CANVAS_H, CANVAS_W, 3) or res.indices != list(range(REG_N)):
        raise AssertionError(f"panorama {res.panorama.shape}, kept {res.indices}")
    if not (0.2 < covered.mean() < 0.4 and err < 20.0):
        raise AssertionError(f"covered {covered.mean()}, world error {err}")
    return res


def phase_register_cli(smi):
    """8f: ``python -m octvr_tpu_torch.cli.register`` as a process on the
    card on PNGs of the tests' 5-camera ring, against the same call with
    OCTVR_PLATFORM=cpu."""
    import tempfile

    from octvr_tpu_torch.utils.png import write_png

    n, step, f, w, h = SMALL_RING
    log(f"== 8f. the register CLI on the card vs OCTVR_PLATFORM=cpu, {n} PNGs of {w}x{h}")
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, img in enumerate(_render_ring(n, step, f, w, h)):
            paths.append(os.path.join(tmp, f"cam{k}.png"))
            write_png(paths[-1], img.astype(np.uint8))
        args = ["octvr_tpu_torch.cli.register", "--conf", "0.5", "--features", "1000"]
        t0 = time.perf_counter()
        card = _cli([*args, "-o", os.path.join(tmp, "card.json"), *paths])
        env = {**os.environ, "OCTVR_PLATFORM": "cpu"}
        cpu = subprocess.Popen([sys.executable, "-m", *args, "-o", os.path.join(tmp, "cpu.json"), *paths],
                               cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        _finish(card, "register CLI on the card")
        _finish(cpu, "register CLI, OCTVR_PLATFORM=cpu")
        took = time.perf_counter() - t0
        with open(os.path.join(tmp, "card.json")) as fh:
            got = json.load(fh)
        with open(os.path.join(tmp, "cpu.json")) as fh:
            want = json.load(fh)
    if got["source_images"] != want["source_images"] or len(got["inputs"]) != len(want["inputs"]):
        raise AssertionError(f"source_images {got['source_images']} vs {want['source_images']}")
    fx = max(abs(a["options"]["fx"] / b["options"]["fx"] - 1) for a, b in zip(got["inputs"], want["inputs"]))
    rot = max(
        np.abs(np.subtract(a["options"]["rotation_matrix"], b["options"]["rotation_matrix"])).max()
        for a, b in zip(got["inputs"], want["inputs"])
    )
    log(f"  {len(got['source_images'])} images in both; fx within {fx:.2e} (bar 5e-3), rotation entries "
        f"within {rot:.2e} (bar 5e-3); both processes {took:.1f} s")
    if fx > 5e-3 or rot > 5e-3:
        raise AssertionError("register CLI on the card differs from the CPU's")


def phase_registration(smi):
    """Phase 8, the registration path on the card (8a-8f).  Returns its
    time, 8c's stage times, the ring's images and 8e's StitchResult."""
    t0 = time.time()
    images = _render_ring(REG_N, REG_STEP, REG_F, REG_W, REG_H)
    log(f"== 8. registration: rendered {REG_N} x {REG_W}x{REG_H} views in {time.time() - t0:.1f} s")
    phase_match(phase_features(images, smi), smi)
    res = phase_register(images, smi)
    ba = phase_bundle(res, smi)
    stitched = phase_stitcher(images, smi)
    phase_register_cli(smi)
    took = time.time() - t0
    log(f"  phase 8 took {took:.1f} s")
    return {"seconds": took, "times": res.times, "images": images, "stitched": stitched, "ba": ba}


# ---------------------------------------------------------------- phase 9

SEAM_KINDS = ("graphcut", "graphcut_grad", "dp", "dp_grad")  # 9a: dump with images
EXPOSURES = (1.0, 0.8, 1.2, 0.9, 1.1, 0.85)  # 9a/9c: the six PNGs' exposure spread
LIVE_FRAMES = 8  # 9b
ARG_KEY = "0f" * 32  # 9b: the --encrypt_args key (hex)


def _timed_cli(args, env, timeout=600):
    """``python -m <args>`` from the root: (exit code, [(seconds since the
    start, stderr line), ...], seconds).  Lines are read as they come, so
    their times split the run into its stages."""
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    killer = threading.Timer(timeout, proc.kill)
    killer.start()
    lines = []
    try:
        for line in proc.stderr:
            lines.append((time.perf_counter() - t0, line.rstrip("\n")))
        proc.wait()
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, lines, time.perf_counter() - t0


def _run_together(jobs, label):
    """Runs {name: (args, env)} as processes at once (``_timed_cli``);
    fails unless each exits 0.  Returns {name: (lines, seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as pool:
        runs = dict(zip(jobs, pool.map(lambda job: _timed_cli(*job), jobs.values())))
    for name, (rc, lines, took) in runs.items():
        tail = "\n".join(f"    | {text}" for _, text in lines[-4:])
        log(f"  {label} {name}: exit {rc} after {took:.2f} s\n{tail}")
        if rc != 0:
            raise AssertionError(f"{label} {name} exited {rc}")
    return {name: (lines, took) for name, (rc, lines, took) in runs.items()}


def _dat_bytes(mt):
    import io

    from octvr_tpu_torch.template import dump_dat

    buf = io.BytesIO()
    dump_dat(mt, buf)
    return buf.getvalue()


def _partition(mt):
    """(covered, overlap) shares of the canvas under mt's seam masks
    (tests/test_template.py:68-78: > 0.98 and < 0.02)."""
    w, h = mt.out_size
    count = np.zeros((h, w), np.uint8)
    for inp, sm in zip(mt.inputs, mt.seam_masks):
        x, y, rw, rh = inp.roi
        count[y : y + rh, x : x + rw] += sm > 128
    return float((count >= 1).mean()), float((count > 1).mean())


def phase_dump_cli(want, d, smi):
    """9a: ``python -m octvr_tpu_torch.cli.dump`` at 4K on the six-camera
    rig, five processes at once: without images ("distance") and with the
    six PNGs for each image-driven seam kind.  Each .dat loads and its seam
    masks partition the canvas; the "distance" one equals phase 5's
    in-process compile_rig + create_masks() (``want``, its .dat bytes) byte
    for byte.  Returns the rig's path, the PNGs and each run's seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from octvr_tpu_torch.template import load_dat
    from octvr_tpu_torch.utils.png import write_png

    log(f"== 9a. the dump CLI at {CANVAS_W}x{CANVAS_H} on the card's host: 6 x {CAM}^2 PNGs from seed 0 "
        f"(exposures {list(EXPOSURES)}), seams distance and {', '.join(SEAM_KINDS)}")
    t0 = time.perf_counter()
    rig = os.path.join(d, "rig.json")
    with open(rig, "w") as f:
        json.dump(six_cam_rig(), f)
    rng = np.random.default_rng(0)
    scenes = [_scene_rgb(rng, CAM, g).astype(np.uint8) for g in EXPOSURES]
    pngs = [os.path.join(d, f"cam{k}.png") for k in range(len(scenes))]
    with ThreadPoolExecutor(len(pngs)) as pool:  # zlib runs without the GIL
        list(pool.map(write_png, pngs, scenes))
    log(f"  PNGs written in {time.perf_counter() - t0:.2f} s")
    size = ["-w", str(CANVAS_W), "-h", str(CANVAS_H)]
    jobs = {"distance": (["octvr_tpu_torch.cli.dump", *size, "-o", os.path.join(d, "distance.dat"), rig],
                         _card_env())}
    for kind in SEAM_KINDS:
        jobs[kind] = (["octvr_tpu_torch.cli.dump", *size, "--seam", kind, "-o", os.path.join(d, f"{kind}.dat"),
                       rig, *pngs], _card_env())
    runs = _run_together(jobs, "dump")
    for name in jobs:
        path = os.path.join(d, f"{name}.dat")
        with open(path, "rb") as f:
            got = load_dat(f)
        covered, overlap = _partition(got)
        log(f"  {name}: {os.path.getsize(path) / 2**20:.1f} MiB, loads; seam masks cover {covered:.5f} "
            f"(bar > 0.98), overlap {overlap:.5f} (bar < 0.02); {runs[name][1]:.2f} s")
        if not (covered > 0.98 and overlap < 0.02) or len(got.inputs) != 6:
            raise AssertionError(f"dump --seam {name}: {len(got.inputs)} inputs, covered {covered}, overlap {overlap}")
    with open(os.path.join(d, "distance.dat"), "rb") as f:
        if f.read() != want:
            raise AssertionError("dump's distance .dat differs from phase 5's compile_rig + create_masks()")
    log(f"  the distance .dat equals phase 5's template byte for byte ({len(want)} bytes); "
        f"9a took {time.perf_counter() - t0:.1f} s ({smi})")
    return rig, pngs, {name: took for name, (_, took) in runs.items()}


def _stage_times(lines):
    """live's stages from its stderr times: the dump child (up to the
    first "# starting stream") and the stream child (to "# stream
    finished cleanly")."""
    t_start = next(t for t, text in lines if text.startswith("# starting stream"))
    t_end = next(t for t, text in lines if "stream finished cleanly" in text)
    return {"dump": t_start, "stream": t_end - t_start}


def phase_live_cli(want, frame_sets, rig, d, smi):
    """9b: ``python -m octvr_tpu_torch.cli.live`` on the card at 4K: six
    raw files of LIVE_FRAMES frames (phase 5's first frame sets), blend
    128.  Its template equals phase 5's, and every output frame is within
    the 7e bars of the port's Mapper on the card built with the stream
    CLI's options from that template.  Then live plain and with
    --encrypt_args on the small rig: the same output bytes."""
    from octvr_tpu_torch.stitch import Mapper
    from octvr_tpu_torch.template import load_npz
    from rigs import two_fisheye_rig

    log(f"== 9b. the live CLI on the card: 6 x {CAM}^2 raw feeds of {LIVE_FRAMES} frames -> "
        f"{CANVAS_W}x{CANVAS_H}, blend 128")
    t0 = time.perf_counter()
    feeds = [os.path.join(d, f"cam{k}.yuv") for k in range(6)]
    for k, path in enumerate(feeds):
        with open(path, "wb") as f:
            for fs in frame_sets[:LIVE_FRAMES]:
                f.write(fs[k].cpu().numpy().tobytes())
    out, work = os.path.join(d, "live.yuv"), os.path.join(d, "live")
    args = ["octvr_tpu_torch.cli.live", "--rig", rig, "--inputs", ",".join(feeds), "--in_size", f"{CAM}x{CAM}",
            "--out_size", f"{CANVAS_W}x{CANVAS_H}", "--out", out, "--blend", "128", "--frames", str(LIVE_FRAMES),
            "--workdir", work]
    rc, lines, took = _timed_cli(args, _card_env())
    err = "\n".join(text for _, text in lines)
    log("\n".join(f"    | {text}" for _, text in lines if text.startswith(("#", "[Timer", "warning"))))
    if rc != 0 or "stream finished cleanly" not in err:
        raise AssertionError(f"live exited {rc}:\n{err[-3000:]}")
    stages = _stage_times(lines)
    done = [text for _, text in lines if text.startswith("# done")]
    launches = [text for _, text in lines if text.startswith("# remap launches")]
    counts = ast.literal_eval(launches[-1].split(" ", 4)[-1]) if launches else {}
    log(f"  live {took:.2f} s: dump child {stages['dump']:.2f} s, stream child {stages['stream']:.2f} s; "
        f"{done[-1] if done else 'no # done line'}; stream child's remap launches {counts} ({smi})")
    if counts.get("nc1_bf16", 0) < LIVE_FRAMES or counts.get("nc2_bf16", 0) < LIVE_FRAMES:
        raise AssertionError(f"the stream child launched the remap {counts}, not kernels 1-2 on every frame")
    tmpl = load_npz(os.path.join(work, "out0.npz"))
    if _dat_bytes(tmpl) != want:
        raise AssertionError("live's template differs from phase 5's")
    mapper = Mapper(tmpl, [(CAM, CAM)] * 6, blend=128, enable_gain=True, device="cuda")
    got = np.fromfile(out, np.uint8)
    if got.size != LIVE_FRAMES * CANVAS_H * 3 // 2 * CANVAS_W:
        raise AssertionError(f"live wrote {got.size} bytes for {LIVE_FRAMES} frames")
    worst = [0.0, 0.0, 0, 0]
    for n, frame in enumerate(got.reshape(LIVE_FRAMES, CANVAS_H * 3 // 2, CANVAS_W)):
        ref = mapper.stitch(frame_sets[n])[0].cpu().numpy().astype(np.float32)
        d_y = np.abs(frame[:CANVAS_H] - ref[:CANVAS_H])
        d_uv = np.abs(frame[CANVAS_H:] - ref[CANVAS_H:])
        worst = [max(worst[0], d_y.mean()), max(worst[1], d_uv.mean()), max(worst[2], d_y.max()),
                 max(worst[3], d_uv.max())]
    log(f"  {LIVE_FRAMES} frames vs the port's Mapper on the card from live's template (equal to phase 5's): "
        f"worst Y mean {worst[0]:.4f} max {worst[2]:.0f}, UV mean {worst[1]:.4f} max {worst[3]:.0f} "
        "(bars: means < 0.2, maxima <= 2)")
    if not (worst[0] < 0.2 and worst[1] < 0.2 and worst[2] <= 2 and worst[3] <= 2):
        raise AssertionError("live's output disagrees with the Mapper")
    del mapper, got

    small = two_fisheye_rig()
    for spec in small["inputs"]:
        spec["options"]["width"] = spec["options"]["height"] = SMALL_CAM
    small_rig = os.path.join(d, "small.json")
    with open(small_rig, "w") as f:
        json.dump(small, f)
    sets = _small_sets(4, seed=90)
    small_feeds = [os.path.join(d, f"small{k}.yuv") for k in range(2)]
    for k, path in enumerate(small_feeds):
        with open(path, "wb") as f:
            for fs in sets:
                f.write(fs[k].tobytes())
    jobs = {}
    for name, extra in (("plain", []), ("encrypt_args", ["--encrypt_args"])):
        jobs[name] = (["octvr_tpu_torch.cli.live", "--rig", small_rig, "--inputs", ",".join(small_feeds),
                       "--in_size", f"{SMALL_CAM}x{SMALL_CAM}", "--out_size", "512x256",
                       "--out", os.path.join(d, f"small_{name}.yuv"), "--blend", "16",
                       "--workdir", os.path.join(d, f"small_{name}"), *extra], _card_env(OCTVR_ARG_KEY=ARG_KEY))
    runs = _run_together(jobs, "live, small rig,")
    if not any("args encrypted" in text for _, text in runs["encrypt_args"][0]):
        raise AssertionError("live --encrypt_args did not encrypt the stream child's arguments")
    with open(os.path.join(d, "small_plain.yuv"), "rb") as fa, open(os.path.join(d, "small_encrypt_args.yuv"),
                                                                     "rb") as fb:
        a, b = fa.read(), fb.read()
    if len(a) != len(sets) * 384 * 512 or a != b:
        raise AssertionError(f"live --encrypt_args wrote {len(b)} bytes unlike plain live's {len(a)}")
    log(f"  small rig: live --encrypt_args wrote the same {len(a)} bytes as live; 9b took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"seconds": took, **stages, "done": done[-1] if done else "", "launches": counts}


def phase_gain_and_remap_cli(mt, pngs, d, smi):
    """9c: ``python -m octvr_tpu_torch.cli.gain_and_remap`` on the card and
    with OCTVR_PLATFORM=cpu, at once, on the 4K stitch template (phase
    5's), the six reverse (rmap) templates and the six PNGs: the two
    runs' .gain.png files within 1 LSB, at least 99.9% of values equal."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from octvr_tpu_torch.template import compile_rig, dump_dat
    from octvr_tpu_torch.utils.png import read_png

    log(f"== 9c. the gain_and_remap CLI at {CANVAS_W}x{CANVAS_H} on the card and on the CPU, 6 x {CAM}^2 PNGs")
    t0 = time.perf_counter()
    rig = six_cam_rig()

    def write_dat(args):
        path, tmpl = args
        with open(path, "wb") as f:
            dump_dat(tmpl, f)
        return path

    def rmap(i):
        rev = compile_rig({"output": rig["inputs"][i], "inputs": [rig["output"]]}, CAM, CAM)
        return write_dat((os.path.join(d, f"rmap{i}.dat"), rev))

    with ThreadPoolExecutor(6) as pool:
        rmaps = list(pool.map(rmap, range(6)))
    stitch = write_dat((os.path.join(d, "stitch.dat"), mt))
    imgs = {}
    for dev in ("card", "cpu"):
        os.makedirs(os.path.join(d, dev))
        imgs[dev] = [shutil.copy(p, os.path.join(d, dev)) for p in pngs]
    log(f"  templates written in {time.perf_counter() - t0:.2f} s")
    runs = _run_together({
        "card": (["octvr_tpu_torch.cli.gain_and_remap", stitch, *imgs["card"], *rmaps], _card_env()),
        "cpu": (["octvr_tpu_torch.cli.gain_and_remap", stitch, *imgs["cpu"], *rmaps],
                _card_env(OCTVR_PLATFORM="cpu")),
    }, "gain_and_remap")
    worst, equal, means = 0, 1.0, []
    for a, b, src in zip(imgs["card"], imgs["cpu"], pngs):
        ga, gb = read_png(a + ".gain.png").astype(np.int16), read_png(b + ".gain.png").astype(np.int16)
        worst, equal = max(worst, int(np.abs(ga - gb).max())), min(equal, float((ga == gb).mean()))
        means.append((float(read_png(src).mean()), float(ga.mean())))
    spread = [max(m[i] for m in means) - min(m[i] for m in means) for i in (0, 1)]
    log(f"  card vs CPU .gain.png: max diff {worst} (bar <= 1), equal share {equal:.6f} (bar >= 0.999); "
        f"mean spread over the six images {spread[0]:.2f} before, {spread[1]:.2f} after; card "
        f"{runs['card'][1]:.2f} s, CPU {runs['cpu'][1]:.2f} s; 9c took {time.perf_counter() - t0:.1f} s ({smi})")
    if worst > 1 or equal < 0.999:
        raise AssertionError("gain_and_remap on the card disagrees with the CPU")
    if not spread[1] < spread[0]:
        raise AssertionError("gain_and_remap did not pull the exposures together")
    return {"card": runs["card"][1], "cpu": runs["cpu"][1]}


def phase_offline_cli(mt, frame_sets, registration, smi):
    """Phase 9, the offline stage and the operator CLIs on the card
    (9a-9d)."""
    import tempfile

    t0 = time.time()
    want = _dat_bytes(mt)
    with tempfile.TemporaryDirectory() as d:
        rig, pngs, dumps = phase_dump_cli(want, d, smi)
        live = phase_live_cli(want, frame_sets, rig, d, smi)
        gains = phase_gain_and_remap_cli(mt, pngs, d, smi)
    res = phase_stitcher(registration["images"], smi, seam="graphcut", label="9d")
    before = registration["stitched"]
    log("  9d vs 8e (seam 'distance'), seconds: " + "; ".join(
        f"{k} {res.times[k]:.3f} ({before.times[k]:.3f})" for k in ("register", "template", "compose")))
    if [i.roi for i in res.template.inputs] == [i.roi for i in before.template.inputs]:
        moved = np.mean([((a > 128) != (b > 128)).mean()
                         for a, b in zip(res.template.seam_masks, before.template.seam_masks)])
        log(f"  graph-cut seam masks differ from 8e's distance masks on {moved:.4f} of their pixels")
    took = time.time() - t0
    log(f"  phase 9 took {took:.1f} s")
    return {"seconds": took, "dump": dumps, "live": live, "gain_and_remap": gains,
            "stitcher": {k: res.times[k] for k in ("register", "template", "compose")}}


# --------------------------------------------------------------- phase 10

DIST_LIMIT = 240  # seconds for one launch of ranks, and for a collective's wait
DIST_SMALL = 512  # 10d: two 512^2 fisheyes -> 512x256, mesh (1, 2)
DIST_SMALL_OPTIONS = (
    ("pairwise gains, split", {}),
    ("pairwise gains, no split", {"coarse_split": 3}),
    ("blocks gains", {"enable_gain": "blocks"}),
    ("feather", {"blend": -8}),
    ("rgb, out_format rgb", {"pipeline": "rgb", "out_format": "rgb"}),
    ("source windows", {"src_windows": True}),
)
DIST_TOOL = ((2, 2), (4, 1))  # 10f: (--procs, --devices-per-proc)


class _TimedGroup:
    """A band group whose collective calls are timed, each synchronised
    before and after: their count and wall ms.  A group of ranks meets
    at a barrier first, so a rank's time is the collective's own and not
    its wait for the slowest rank."""

    def __init__(self, group):
        from octvr_tpu_torch.parallel import DistributedBands

        self.group, self.size, self.calls, self.ms = group, group.size, 0, 0.0
        self.ranks = group.group if isinstance(group, DistributedBands) else None

    def _timed(self, fn, *args):
        torch.cuda.synchronize()
        if self.ranks is not None:
            torch.distributed.barrier(group=self.ranks)
        t0 = time.perf_counter()
        y = fn(*args)
        torch.cuda.synchronize()
        self.ms += (time.perf_counter() - t0) * 1e3
        self.calls += 1
        return y

    def sum(self, x):
        return self._timed(self.group.sum, x)

    def concat(self, x, dim):
        return self._timed(self.group.concat, x, dim)


def _collective_ms(sm, batches):
    """The band group's calls and their synchronised ms per frame over
    ``batches`` (one frame set each), in a pass of its own."""
    group = sm.group
    sm.group = timed = _TimedGroup(group)
    try:
        for b in batches:
            sm.stitch_batch(b)
        torch.cuda.synchronize()
    finally:
        sm.group = group
    return timed.calls / len(batches), timed.ms / len(batches)


def _timed_frames(sm, batches):
    """Each one-frame batch through stitch_batch, synchronised at the end:
    (enqueue ms/frame, ms/frame)."""
    t0 = time.time()
    for b in batches:
        sm.stitch_batch(b)
    enqueue = (time.time() - t0) / len(batches) * 1e3
    torch.cuda.synchronize()
    return enqueue, (time.time() - t0) / len(batches) * 1e3


def sharded_reference(sm, sets):
    """Phase 6's make_mesh(1, 4) stitcher on ``sets`` at B=1, for phase
    10: each frame's band stack and gains on the host, and the band
    group's (LocalBands) calls and ms per frame."""
    one = [[f[None] for f in fs] for fs in sets]
    calls, ms = _collective_ms(sm, one)
    outs, gains = [], []
    for b in one:
        out, g = sm.stitch_batch(b)
        outs.append(out[0].cpu().numpy())
        gains.append(g[0].cpu().numpy())
    return {"outs": outs, "gains": gains, "coll_calls": calls, "coll_ms": ms}


# ---- the ranks (``chip_smoke.py --rank JOB RANK``)


def _rank_stitch_4k(sub, ctx):
    """10a-10c on one rank: phase 6's host plan cut to this rank's bands,
    its data row's frame sets at B=1 through global_frame_batch: ms/frame,
    enqueue, the band group's calls and ms, peak memory and launches, then
    each frame's local_output_shards and gains."""
    import torch.distributed as dist

    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.parallel import ShardedMapper
    from octvr_tpu_torch.runtime.distributed import global_frame_batch, local_output_shards, make_global_mesh

    mesh = make_global_mesh(*sub["mesh"], device="cuda")
    sm = ShardedMapper.from_plan(ctx["plan"].bands(mesh.band_lo, mesh.band_hi).to(mesh.device), mesh)
    one = [global_frame_batch(torch.stack(ctx["sets"][i])[None], mesh) for i in sub["frames"][mesh.data_index]]
    n = len(one)
    sm.stitch_batch(one[0])
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    cuda_remap.reset_counts()
    enqueue, ms = _timed_frames(sm, one)
    counts = dict(cuda_remap.COUNTS)
    if counts != {"concat_nc1_bf16": n, "concat_nc2_bf16": n}:
        raise AssertionError(f"{sub['name']}: expected one kernel-6 launch per plane per frame, got {counts}")
    peak = torch.cuda.max_memory_allocated()
    dist.barrier()
    calls, coll_ms = _collective_ms(sm, one)
    shards, gains = [], []
    for b in one:
        out, g = sm.stitch_batch(b)
        shards.append(local_output_shards(out, mesh))
        gains.append(g[0].cpu().numpy())
    return dict(bands=(mesh.band_lo, mesh.band_hi), data_index=mesh.data_index, group=type(sm.group).__name__,
                backend=dist.get_backend(mesh.group), ms=ms, enqueue=enqueue, coll_calls=calls, coll_ms=coll_ms,
                peak=peak, launches={k: v / n for k, v in counts.items()}, shards=shards, gains=gains)


def _small_dist_rig():
    """10d's rig: two 512^2 fisheyes -> 512x256 and one frame set, stacked
    [1, 2, 768, 512] on the card."""
    from octvr_tpu_torch.template import compile_rig
    from rigs import two_fisheye_rig

    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"].update(width=DIST_SMALL, height=DIST_SMALL)
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    frames = _in_gamut_frames(np.random.default_rng(20), 2, DIST_SMALL, [1.15, 0.85])
    return mt, [(DIST_SMALL, DIST_SMALL)] * 2, torch.from_numpy(np.stack(frames)[None]).cuda()


def _small_dist_kw(kw):
    return {"blend": 16, "enable_gain": True, "blend_dtype": "float32", "pipeline": "yuv420", **kw}


def _rank_small(sub, ctx):
    """10d on one rank: each option on make_global_mesh(1, 2); its
    local_output_shards, gains and launches."""
    import torch.distributed as dist

    from octvr_tpu_torch.ops import cuda_remap
    from octvr_tpu_torch.parallel import ShardedMapper
    from octvr_tpu_torch.runtime.distributed import global_frame_batch, local_output_shards, make_global_mesh

    mt, sizes, frames = _small_dist_rig()
    res = {}
    for label, kw in DIST_SMALL_OPTIONS:
        mesh = make_global_mesh(1, 2, device="cuda")
        sm = ShardedMapper(mt, sizes, mesh, **_small_dist_kw(kw))
        cuda_remap.reset_counts()
        out, g = sm.stitch_batch(global_frame_batch(frames, mesh))
        torch.cuda.synchronize()
        counts = dict(cuda_remap.COUNTS)
        if not counts:
            raise AssertionError(f"10d {label}: no remap kernel launched")
        res[label] = dict(shards=local_output_shards(out, mesh), gains=g[0].cpu().numpy(), launches=counts,
                          sliced=sm.plan.sliced, split=sm.plan.split_level >= 0)
        dist.barrier()
    return res


def _rank_ba(sub, ctx):
    """10e on one rank: bundle_adjust_ray_torch(mesh=make_global_mesh())
    on phase 8's ring matches, after a two-iteration warm-up."""
    import copy

    from octvr_tpu_torch.registration.bundle_torch import bundle_adjust_ray_torch
    from octvr_tpu_torch.runtime.distributed import make_global_mesh

    ring = ctx["ring"]
    mesh = make_global_mesh(device="cuda")
    bundle_adjust_ray_torch(ring["features"], ring["matches"], copy.deepcopy(ring["cams"]), 0.5, max_iter=2,
                            mesh=mesh)
    stats = {}
    t0 = time.perf_counter()
    cams, rms = bundle_adjust_ray_torch(ring["features"], ring["matches"], copy.deepcopy(ring["cams"]), 0.5,
                                        mesh=mesh, stats=stats)
    ms = (time.perf_counter() - t0) * 1e3
    return dict(focals=[c.focal for c in cams], R=[c.R for c in cams], rms=rms, ms=ms, stats=stats)


_RANK_SUBS = {"stitch4k": _rank_stitch_4k, "small": _rank_small, "ba": _rank_ba}


def rank_main(job_path, rank):
    """``--rank JOB RANK``: one rank of a phase-10 launch.  Joins the
    group, runs the job's sub-phases and pickles their results to
    ``<out>/rank<RANK>.pkl``."""
    import datetime

    import torch.distributed as dist

    from octvr_tpu_torch.runtime.distributed import init_distributed

    with open(job_path, "rb") as f:
        job = pickle.load(f)
    if job["world"] == 1:
        # init_distributed leaves one process alone: a one-rank
        # communicator is joined directly
        torch.cuda.set_device(0)
        dist.init_process_group(job["backend"], init_method=job["init"], world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=DIST_LIMIT))
    else:
        init_distributed(job["init"], job["world"], rank, backend=job["backend"], timeout=DIST_LIMIT)
    ctx = {}
    if job.get("plan"):
        with open(job["plan"], "rb") as f:
            ctx["plan"] = pickle.load(f)
        ctx["sets"] = make_frame_sets(SHARD_ITERS)
    if job.get("ring"):
        with open(job["ring"], "rb") as f:
            ctx["ring"] = pickle.load(f)
    results = {sub["name"]: _RANK_SUBS[sub["kind"]](sub, ctx) for sub in job["subs"]}
    with open(os.path.join(job["out"], f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


# ---- the parent


def _launch(tmp, world, backend, subs, **paths):
    """Runs ``subs`` on ``world`` ranks of this script (fresh
    interpreters, joined through a file:// rendezvous), all killed if one
    fails or DIST_LIMIT passes.  Returns (per rank its results, seconds)."""
    from octvr_tpu_torch.tools.multihost_stitch import run_ranks

    d = tempfile.mkdtemp(dir=tmp)
    job = dict(world=world, backend=backend, init=f"file://{d}/rendezvous", out=d, subs=subs, **paths)
    path = _dump(d, "job.pkl", job)
    t0 = time.time()
    run_ranks([[sys.executable, os.path.abspath(__file__), "--rank", path, str(r)] for r in range(world)],
              DIST_LIMIT)
    took = time.time() - t0
    res = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res, took


def _assemble(shard_lists, shape, dtype, label):
    """The global output of one step from every rank's
    local_output_shards, each element written once."""
    full = np.zeros(shape, dtype)
    hits = np.zeros(shape, np.int32)
    for shards in shard_lists:
        for idx, arr in shards:
            full[idx] = arr
            hits[idx] += 1
    if not (hits == 1).all():
        raise AssertionError(f"{label}: the ranks' shards do not tile the output")
    return full


def _band_errors(got, want, obh):
    """(Y mean, UV mean, max) abs err of two band stacks [S*obh*3/2, oW]."""
    d = np.abs(got.astype(np.float32) - want.astype(np.float32)).reshape(-1, obh * 3 // 2, got.shape[-1])
    return float(d[:, :obh].mean()), float(d[:, obh:].mean()), float(d.max())


def _rank_lines(label, ranks, name, p6, smi):
    for i, r in enumerate(ranks):
        a = r[name]
        log(f"  {label} rank {i} bands [{a['bands'][0]}, {a['bands'][1]}) row {a['data_index']} "
            f"({a['backend']}): {a['ms']:.3f} ms/frame, enqueue {a['enqueue']:.3f} ms/frame, band group "
            f"{a['coll_calls']:.0f} calls {a['coll_ms']:.3f} ms/frame, peak device memory "
            f"{a['peak'] / 2**30:.3f} GiB, remap launches per frame {a['launches']}")
    log(f"  {label} beside phase 6 (make_mesh(1, {SPACE}), LocalBands): {p6['ms']:.3f} ms/frame, enqueue "
        f"{p6['enqueue']:.3f}, band group {p6['coll_calls']:.0f} calls {p6['coll_ms']:.3f} ms/frame ({smi})")


def _check_4k(label, ranks, name, p6, frames, obh, exact):
    """The ranks' 4K outputs against phase 6's: at step k data row d
    stitched frame set ``frames[d][k]``.  Bit for bit, or at 10b's bars;
    returns the worst (Y mean, UV mean, max, gains rtol)."""
    worst = [0.0, 0.0, 0.0, 0.0]
    rows, W = p6["outs"][0].shape
    nd = len(frames)
    for k in range(len(frames[0])):
        full = _assemble([r[name]["shards"][k] for r in ranks], (nd, rows, W), np.uint8, label)
        for d in range(nd):
            i = frames[d][k]
            want, g_want = p6["outs"][i], p6["gains"][i]
            for r in ranks:
                if r[name]["data_index"] == d:
                    g = r[name]["gains"][k]
                    worst[3] = max(worst[3], float(np.max(np.abs(g - g_want) / np.abs(g_want))))
                    if exact and not np.array_equal(g, g_want):
                        raise AssertionError(f"{label}: frame {i} gains differ from phase 6's")
            if exact:
                if not np.array_equal(full[d], want):
                    raise AssertionError(f"{label}: frame {i} differs from phase 6's output")
                continue
            worst[:3] = [max(x, y) for x, y in zip(worst[:3], _band_errors(full[d], want, obh))]
    if not exact and not (worst[0] < 0.02 and worst[1] < 0.02 and worst[2] <= 2 and worst[3] < 1e-5):
        raise AssertionError(f"{label}: vs phase 6 Y mean {worst[0]}, UV mean {worst[1]}, max {worst[2]}, "
                             f"gains rtol {worst[3]} (bars 0.02, 0.02, 2, 1e-5)")
    return worst


def _check_shard_indices(label, ranks, name, rows_per_band):
    """Each rank's local_output_shards indices: its data row on the batch
    axis (slice(None) for one row), its bands on the rows."""
    for i, r in enumerate(ranks):
        a = r[name]
        nd_many = any(x[name]["data_index"] for x in ranks)
        d = a["data_index"]
        want = [(slice(d, d + 1) if nd_many else slice(None), slice(s * rows_per_band, (s + 1) * rows_per_band),
                 slice(None)) for s in range(*a["bands"])]
        for shards in a["shards"]:
            if [idx for idx, _ in shards] != want:
                raise AssertionError(f"{label} rank {i}: shard indices {[idx for idx, _ in shards]}, want {want}")


def _check_ba(label, ranks, one):
    """10e: every rank the same result, held to 8d's one-rank result."""
    a = ranks[0]["ba"]
    for r in ranks[1:]:
        if r["ba"]["focals"] != a["focals"] or r["ba"]["rms"] != a["rms"]:
            raise AssertionError(f"{label}: the ranks disagree")
    f_rel = float(np.max(np.abs(np.array(a["focals"]) / np.array(one["focals"]) - 1)))
    rot = max(_rot_angle(x, y) for x, y in zip(a["R"], one["R"]))
    rms_rel = abs(a["rms"] / one["rms"] - 1)
    log(f"  {label}: focals rtol {f_rel:.2e} (bar 1e-3), rotations {rot:.2e} rad (bar 1e-3), rms {a['rms']:.5f} "
        f"vs {one['rms']:.5f} ({rms_rel:.2e}, bar 1%); {a['ms']:.1f} ms, iterations {a['stats']['iters']}, host "
        f"syncs {a['stats']['syncs']} (8d, one rank: {one['ms']:.1f} ms, {one['syncs']} syncs)")
    if not (f_rel < 1e-3 and rot < 1e-3 and rms_rel < 0.01):
        raise AssertionError(f"{label}: disagrees with 8d")


def _rot_angle(A, B):
    d = np.asarray(A) @ np.asarray(B).T
    return math.acos(np.clip((np.trace(d) - 1) / 2, -1, 1))


def _dump(tmp, name, obj):
    path = os.path.join(tmp, name)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def phase_distributed(host, p6, ba, smi):
    """Phase 10 (10a-10f), the distributed path on the card
    (runtime/distributed.py, DistributedBands, bundle_adjust_ray_torch
    (mesh=), tools/multihost_stitch): ranks of this script, started
    fresh, that share the card.  ``host``: phase 6's host plan; ``p6``:
    its outputs, gains, times and band-group times (sharded_reference);
    ``ba``: 8d's one-rank result and its inputs.  Returns its numbers."""
    t0 = time.time()
    log(f"== 10. the distributed path: torch.distributed ranks on the card ({smi}); ranks that share one card "
        f"measure contention and gloo's host staging, not scaling")
    sets = len(p6["outs"])
    obh = host.obh
    rows = obh * 3 // 2
    tmp = tempfile.mkdtemp(prefix="phase10-")
    summary = {}
    try:
        t = time.time()
        plan_path = _dump(tmp, "plan.pkl", host)
        ring_path = _dump(tmp, "ring.pkl", {k: ba[k] for k in ("features", "matches", "cams")})
        log(f"  host plan and ring written for the ranks in {time.time() - t:.1f} s")

        # 10a: one NCCL rank holding all four bands
        every = [list(range(sets))]
        (a,), took = _launch(tmp, 1, "nccl", [dict(kind="stitch4k", name="10a", mesh=(1, SPACE), frames=every)],
                             plan=plan_path)
        log(f"== 10a. one-rank NCCL group, make_global_mesh(1, {SPACE}), {sets} frame sets ({took:.1f} s)")
        if a["10a"]["backend"] != "nccl" or a["10a"]["group"] != "DistributedBands":
            raise AssertionError(f"10a ran {a['10a']['group']} on {a['10a']['backend']}")
        _rank_lines("10a", [a], "10a", p6, smi)
        _check_4k("10a", [a], "10a", p6, every, obh, exact=True)
        _check_shard_indices("10a", [a], "10a", rows)
        log(f"  10a: every frame and its gains equal to phase 6's bit for bit")
        summary["10a"] = a["10a"]["ms"]

        # 10b, 10c, 10e on four gloo ranks
        half = sets // 2
        rows_2x2 = [list(range(half)), list(range(half, 2 * half))]
        subs = [dict(kind="stitch4k", name="10b", mesh=(1, SPACE), frames=every),
                dict(kind="stitch4k", name="10c", mesh=(2, SPACE), frames=rows_2x2),
                dict(kind="ba", name="ba")]
        r4, took = _launch(tmp, 4, "gloo", subs, plan=plan_path, ring=ring_path)
        log(f"== 10b. four gloo ranks sharing the card, make_global_mesh(1, {SPACE}), one band each, {sets} "
            f"frame sets (launch with 10c and 10e: {took:.1f} s); the band group's ms timed after a barrier")
        _rank_lines("10b", r4, "10b", p6, smi)
        _check_shard_indices("10b", r4, "10b", rows)
        w = _check_4k("10b", r4, "10b", p6, every, obh, exact=False)
        log(f"  10b vs phase 6: Y mean abs {w[0]:.5f} (bar < 0.02), UV mean abs {w[1]:.5f} (bar < 0.02), max "
            f"{w[2]:.0f} (bar <= 2), gains rtol {w[3]:.3g} (bar 1e-5)")
        log(f"== 10c. four gloo ranks, make_global_mesh(2, {SPACE}): two data rows of two ranks, two bands "
            f"each; each row its own {half} frame sets")
        _rank_lines("10c", r4, "10c", p6, smi)
        _check_shard_indices("10c", r4, "10c", rows)
        w = _check_4k("10c", r4, "10c", p6, rows_2x2, obh, exact=False)
        log(f"  10c vs phase 6: Y mean abs {w[0]:.5f} (bar < 0.02), UV mean abs {w[1]:.5f} (bar < 0.02), max "
            f"{w[2]:.0f} (bar <= 2), gains rtol {w[3]:.3g} (bar 1e-5); shard indices checked")
        summary["10b"] = [r["10b"]["ms"] for r in r4]
        summary["10c"] = [r["10c"]["ms"] for r in r4]

        # 10d, 10e on two gloo ranks
        r2, took = _launch(tmp, 2, "gloo", [dict(kind="small", name="10d"), dict(kind="ba", name="ba")],
                           ring=ring_path)
        log(f"== 10d. two gloo ranks, make_global_mesh(1, 2), two {DIST_SMALL}^2 fisheyes -> 512x256, f32, each "
            f"option against the CUDA make_mesh(1, 2) output (launch with 10e: {took:.1f} s; {smi})")
        phase_small_distributed(r2)
        log(f"== 10e. bundle_adjust_ray_torch(mesh=make_global_mesh()) on 8c's ring matches, gloo ranks ({smi})")
        _check_ba("10e, 2 ranks", r2, ba)
        _check_ba("10e, 4 ranks", r4, ba)

        # 10f: the port's multihost tool as a process on the card
        log("== 10f. python -m octvr_tpu_torch.tools.multihost_stitch on the card, --backend gloo")
        summary["10f"] = [phase_multihost_tool(procs, dpp, smi) for procs, dpp in DIST_TOOL]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["seconds"] = time.time() - t0
    summary["p6_ms"] = p6["ms"]
    log(f"  phase 10 took {summary['seconds']:.1f} s")
    return summary


def phase_small_distributed(ranks):
    """10d: each option's two-rank output against the CUDA
    make_mesh(1, 2) ShardedMapper on the same frames: max <= 1, gains
    rtol 1e-6."""
    from octvr_tpu_torch.parallel import ShardedMapper, make_mesh

    mt, sizes, frames = _small_dist_rig()
    for label, kw in DIST_SMALL_OPTIONS:
        sm = ShardedMapper(mt, sizes, make_mesh(1, 2, device="cuda"), **_small_dist_kw(kw))
        out, g = sm.stitch_batch(frames)
        want = out.cpu().numpy()
        full = _assemble([r["10d"][label]["shards"] for r in ranks], want.shape, want.dtype, f"10d {label}")
        err = float(np.abs(full.astype(np.float32) - want.astype(np.float32)).max())
        g_want = g[0].cpu().numpy()
        g_rel = max(float(np.max(np.abs(r["10d"][label]["gains"] - g_want) / np.abs(g_want))) for r in ranks)
        a = ranks[0]["10d"][label]
        log(f"  {label:26s} max abs err {err:.4g} (bar <= 1), gains rtol {g_rel:.3g} (bar 1e-6); split "
            f"{a['split']}, sliced {a['sliced']}; rank 0 launches {a['launches']}")
        if not (err <= 1 and g_rel <= 1e-6):
            raise AssertionError(f"10d {label}: two ranks disagree with make_mesh(1, 2)")


def phase_multihost_tool(procs, dpp, smi):
    """10f: the port's multihost_stitch at the JAX test's shape, as a
    process on the card; parity_ok required.  Returns its frames/s."""
    args = ["--procs", str(procs), "--devices-per-proc", str(dpp), "--cam", "96", "--canvas", "192x96",
            "--blend", "32", "--iters", "3", "--backend", "gloo", "--timeout", str(DIST_LIMIT)]
    t0 = time.time()
    p = subprocess.run([sys.executable, "-m", "octvr_tpu_torch.tools.multihost_stitch", *args], capture_output=True,
                       text=True, timeout=DIST_LIMIT + 30, cwd=ROOT)
    took = time.time() - t0
    if p.returncode != 0:
        raise AssertionError(f"multihost_stitch {' '.join(args)} exited {p.returncode}:\n{p.stderr[-3000:]}")
    s = json.loads(p.stdout.strip().splitlines()[-1])
    log(f"  --procs {procs} --devices-per-proc {dpp}: parity_ok {s['parity_ok']}, parity {s['parity']}, "
        f"{s['frames_per_s']} frames/s ({s['ms_per_step']} ms/step, ranks sharing one card; {took:.1f} s; {smi})")
    if not (s["parity_ok"] and s["device"].startswith("cuda") and s["backend"] == "gloo"):
        raise AssertionError(f"multihost_stitch: {s}")
    return s["frames_per_s"]


def distributed_only(smi):
    """``--distributed``: phase 10 alone, with its inputs made here: the
    kernels built, phase 6's plan and reference outputs, 8c's ring and
    8d's one-rank result."""
    from octvr_tpu_torch.registration import register_images
    from octvr_tpu_torch.template import compile_rig

    phase_build()
    mt = compile_rig(six_cam_rig(), CANVAS_W, CANVAS_H)
    mt.create_masks()
    sets = make_frame_sets(SHARD_ITERS)
    host, _ = build_sharded_4k(mt)
    sm, _ = sharded_on_card(host)
    one = [[f[None] for f in fs] for fs in sets]
    sm.stitch_batch(one[0])  # timed after one call, as phase 6 and the ranks are
    enqueue, ms = _timed_frames(sm, one)
    p6 = sharded_reference(sm, sets)
    p6.update(ms=ms, enqueue=enqueue)
    del sm, sets, one
    images = _render_ring(REG_N, REG_STEP, REG_F, REG_W, REG_H)
    res = register_images(images, device="cuda", ba="ray", conf_thresh=0.5, max_features=REG_FEATURES)
    ba = phase_bundle(res, smi)
    dist = phase_distributed(host, p6, ba, smi)
    log(f"distributed (phase 10, {dist['seconds']:.1f} s): {json.dumps({k: v for k, v in dist.items()})}")


_KERNEL_CLASSES = (
    ("remap (csrc/remap.cu)", ("remap_kernel", "remap_frames_kernel")),
    ("pyramid (csrc/pyramid.cu)", ("pyr_down_kernel", "pyr_up_kernel", "pyr_down_group_kernel",
                                   "pyr_lap_gather_kernel")),
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
    if len(argv) == 3 and argv[0] == "--rank":
        return rank_main(argv[1], int(argv[2]))
    smi = phase_env()
    if len(argv) == 2 and argv[0] == "--time-remap":
        return time_remap(argv[1])
    if len(argv) == 2 and argv[0] == "--time-taps":
        return time_taps(argv[1])
    if argv == ["--distributed"]:
        return distributed_only(smi)
    if argv:
        raise SystemExit(f"usage: chip_smoke.py [--time-remap ROOT | --time-taps ROOT | --distributed], got {argv}")
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
    pyramid = phase_pyramid_device_time(mapper)
    prep = phase_prep_device_time(mapper, frame_sets)
    sharded = phase_sharded(host, t_host, frame_sets, main_path)
    sharded_sm = sharded.pop("sm")
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
    registration = phase_registration(smi)
    offline = phase_offline_cli(mt, frame_sets, registration, smi)
    distributed = phase_distributed(host, sharded.pop("p6"), registration["ba"], smi)
    del host

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
    log(f"registration (8c, 8 x 1920x1080 ring, card): " + "; ".join(
        f"{k} {v:.4f} s" for k, v in registration["times"].items()) + f"; phase 8 {registration['seconds']:.1f} s")
    live = offline["live"]
    log(f"offline stage and CLIs (phase 9, {offline['seconds']:.1f} s): dump at 4K "
        + ", ".join(f"{k} {v:.2f}" for k, v in offline["dump"].items())
        + f" s (five at once); live at 4K {live['seconds']:.2f} s (dump child {live['dump']:.2f}, stream child "
        f"{live['stream']:.2f}; {live['done']}); gain_and_remap at 4K card {offline['gain_and_remap']['card']:.2f} "
        f"s, CPU {offline['gain_and_remap']['cpu']:.2f} s (at once); Stitcher graphcut "
        + ", ".join(f"{k} {v:.3f}" for k, v in offline["stitcher"].items()) + " s")
    log(f"distributed path (phase 10, {distributed['seconds']:.1f} s, ranks sharing one card: contention, not "
        f"scaling): ms/frame 10a one NCCL rank {distributed['10a']:.3f}; 10b four gloo ranks "
        + ", ".join(f"{v:.3f}" for v in distributed["10b"]) + "; 10c (2, 2) grid "
        + ", ".join(f"{v:.3f}" for v in distributed["10c"]) + f"; 10f multihost_stitch frames/s "
        + ", ".join(f"{v}" for v in distributed["10f"]) + f"; phase 6 {distributed['p6_ms']:.3f}")
    log(f"4K pyramid kernels (5d), a set's two blends: device {pyramid['ms']:.4f} ms (share of bound "
        f"{pyramid['bound_ms'] / pyramid['ms']:.3f}; per-camera steps {pyramid['step_ms']:.4f}); call "
        f"{pyramid['call_ms']:.4f}; banded products "
        f"{pyramid['library_ms']:.4f}; {main_path['pyramid_launches'] // (ITERS + 1)} launches a set")
    log(f"4K prep kernel (5e), six frames: device {prep['ms']:.4f} ms (share of bound "
        f"{prep['bound_ms'] / prep['ms']:.3f}); call {prep['call_ms']:.4f}; eager ops {prep['plain_ms']:.4f}; "
        f"{main_path['prep_launches'] // (ITERS + 1)} launches a set")
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
        ("pyramid steps of the multiband blends (4K yuv420: Y 6 bands + U|V 5 bands, bf16), kernel 9",
         "octvr_tpu_torch/csrc/pyramid.cu", "octvr_tpu/ops/pyramid.py pyr_down_mm/pyr_up_mm (banded XLA products)",
         {**pyramid, "launches": main_path["pyramid_launches"]}, 0.0),
        ("prep, the yuv420 input stage with the vignette (4K: six 1920^2 frames), kernel 10",
         "octvr_tpu_torch/csrc/prep.cu", "none: octvr_tpu/stitch/mapper.py _prep_pack_yuv (plain XLA)",
         {**prep, "launches": main_path["prep_launches"]}, 0.0),
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
