"""Multi-process band-sharded stitch: the runtime/distributed.py path run
for real.  The port of tools/multihost_stitch.py.

One process per rank under ``torch.distributed``, the frames fanned out
on the 'data' axis (each rank feeds its own locally made frames: no
frame bytes cross ranks) and the canvas band-sharded inside each rank:

    init_distributed -> make_global_mesh -> ShardedMapper
    -> global_frame_batch -> stitch_batch -> local_output_shards

Launcher mode (the default) starts ``--procs`` workers of this module,
collects their PARITY and RESULT lines, and prints one summary JSON line:

    python -m octvr_tpu_torch.tools.multihost_stitch --procs 2 \\
        --devices-per-proc 2 --backend gloo

``--devices-per-proc`` is the bands each rank holds (the mesh is
(procs, devices-per-proc), one data row per rank, as in the JAX tool).
Each rank checks its output against the port's one-device ``Mapper`` on
its own frames (Y mean abs < 1.5, gains < 0.05).  The ranks run on the
card (``--device cuda``, the default; without a card it raises) or on
the CPU (``--device cpu``).  NCCL takes one card per rank: ranks that
share one card need ``--backend gloo``.  The workers meet through a
``file://`` rendezvous in a temporary directory of this run.
"""

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

__all__ = ["main", "rig", "local_frames", "assemble_from_local_shards", "run_ranks"]

PI = math.pi


def rig(cam):
    """Two back-to-back full-frame fisheyes of ``cam``^2 (the JAX tool's
    rig)."""
    lens = {
        "width": cam,
        "height": cam,
        "hfov": PI * 1.15,
        "center_dx": 0.0,
        "center_dy": 0.0,
        "radial": [0.0, 0.0, 0.0],
        "vignette": [1.0, -0.1, 0.0, 0.0],
    }
    return {
        "output": {"type": "equirectangular", "options": {}},
        "inputs": [
            {"type": "fullframe_fisheye", "options": dict(lens)},
            {
                "type": "fullframe_fisheye",
                "options": {**lens, "rotation": {"roll": 0.0, "yaw": PI, "pitch": 0.0}},
            },
        ],
    }


def local_frames(r, proc_id, batch_per_proc, step=0):
    """Each rank's own frames, distinct per rank and per step: the JAX
    tool's draws, so the frames are equal to its."""
    rng = np.random.default_rng(1000 * (proc_id + 1) + step)
    sets = []
    for _ in range(batch_per_proc):
        fs = []
        for spec in r["inputs"]:
            w = spec["options"]["width"]
            h = spec["options"]["height"]
            fs.append(rng.integers(0, 255, (h * 3 // 2, w), dtype=np.uint8))
        sets.append(np.stack(fs))
    return np.stack(sets)


def assemble_from_local_shards(sm, shards, batch_index):
    """One frame's [S*bh*3/2, Wp] band stack from this rank's output
    shards (local_output_shards), by their JAX shard indices (``sm``
    unused, as in the JAX tool)."""
    rows = []
    for index, arr in shards:
        if (index[0].start or 0) == batch_index:
            rows.append((index[1].start or 0, arr[0]))
    rows.sort(key=lambda t: t[0])
    return np.concatenate([a for _, a in rows], axis=0)


def run_ranks(cmds, timeout, env=None):
    """Run one process per command, together, each with its output in a
    file.  Waits at most ``timeout`` seconds for all of them; when one
    fails or the time is up, the others are killed and RuntimeError
    carries the failing rank's error output.  Returns each process's
    (stdout, stderr)."""
    tmp = tempfile.mkdtemp(prefix="ranks-")
    procs, files = [], []
    try:
        for i, cmd in enumerate(cmds):
            out = open(os.path.join(tmp, f"{i}.out"), "w+")
            err = open(os.path.join(tmp, f"{i}.err"), "w+")
            files.append((out, err))
            procs.append(subprocess.Popen(cmd, stdout=out, stderr=err, text=True, env=env))
        deadline = time.monotonic() + timeout
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((i for i, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = next(i for i, p in enumerate(procs) if p.poll() is None)
                break
            time.sleep(0.05)
        if failed is None:
            failed = next((i for i, p in enumerate(procs) if p.returncode != 0), None)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
        if failed is not None:
            rc = procs[failed].returncode
            why = f"timed out after {timeout} s" if rc == -9 else f"exited with {rc}"
            raise RuntimeError(f"rank {failed}/{len(cmds)} {why}:\n{texts[failed][1][-4000:]}")
        return texts
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def run_worker(args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from ..parallel.sharded import ShardedMapper
    from ..runtime.distributed import (
        global_frame_batch,
        init_distributed,
        local_output_shards,
        make_global_mesh,
    )
    from ..stitch import Mapper
    from ..template import compile_rig
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    init_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.procs,
        process_id=args.proc_id,
        local_device_ids=[0] if dev.type == "cuda" else None,
        backend=args.backend,
        timeout=args.timeout,
    )
    distributed = dist.is_initialized()
    if distributed and dist.get_world_size() != args.procs:
        raise RuntimeError(f"{dist.get_world_size()} ranks, want {args.procs}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if distributed:
            dist.barrier()

    W, H = (int(v) for v in args.canvas.split("x"))
    r = rig(args.cam)
    mt = compile_rig(r, W, H)
    mt.create_masks()
    sizes = [(args.cam, args.cam)] * len(r["inputs"])

    mesh = make_global_mesh(n_data=args.procs, n_space=args.devices_per_proc, device=dev)
    sm = ShardedMapper(mt, sizes, mesh, blend=args.blend, enable_gain=True, pipeline=args.pipeline)

    def log(msg):
        print(f"[proc {args.proc_id}] {msg}", file=sys.stderr, flush=True)

    # ---- one step + parity against the one-device Mapper on this
    # rank's frames
    mine = local_frames(r, args.proc_id, 1)
    out, gains = sm.stitch_batch(global_frame_batch(mine, mesh))
    shards = local_output_shards(out, mesh)
    # this rank holds exactly its own data row
    if not all((idx[0].start or 0) == args.proc_id for idx, _ in shards):
        raise RuntimeError(f"rank {args.proc_id} holds shards {[idx for idx, _ in shards]}")
    yuv = sm.assemble_yuv(assemble_from_local_shards(sm, shards, args.proc_id)).numpy()

    single = Mapper(mt, sizes, blend=args.blend, enable_gain=True, pipeline=args.pipeline, device=dev)
    ref, ref_gains = single.stitch([torch.from_numpy(f) for f in mine[0]])
    ref = ref.cpu().numpy()
    err = np.abs(yuv.astype(np.float32) - ref.astype(np.float32))
    h = ref.shape[0] * 2 // 3
    y_mean = float(err[4 : h - 4].mean())
    g_err = float((gains[0] - ref_gains).abs().max())
    ok = y_mean < 1.5 and g_err < 0.05
    print("PARITY " + json.dumps(
        {"proc": args.proc_id, "y_mean_err": round(y_mean, 4), "gain_err": round(g_err, 5), "ok": bool(ok)}
    ), flush=True)

    # ---- timed steps (distinct frames per step; each synchronised by
    # reading the local shards back, a barrier around the window)
    sync()
    t0 = time.time()
    for it in range(args.iters):
        mine = local_frames(r, args.proc_id, 1, step=1 + it)
        out, _ = sm.stitch_batch(global_frame_batch(mine, mesh))
        _ = [a.sum() for _, a in local_output_shards(out, mesh)]
    sync()
    dt = (time.time() - t0) / args.iters
    fps = args.procs / dt  # one frame per rank per step
    log(f"{dt * 1e3:.1f} ms/step, {fps:.2f} frames/s global")
    if args.proc_id == 0:
        print("RESULT " + json.dumps({
            "procs": args.procs,
            "devices_per_proc": args.devices_per_proc,
            "mesh": [args.procs, args.devices_per_proc],
            "pipeline": args.pipeline,
            "device": str(dev),
            "backend": dist.get_backend() if distributed else None,
            "ms_per_step": round(dt * 1e3, 1),
            "frames_per_s": round(fps, 3),
        }), flush=True)
    if distributed:
        dist.destroy_process_group()


def _worker_cmd(args, proc_id, procs, coordinator):
    cmd = [
        sys.executable, "-m", "octvr_tpu_torch.tools.multihost_stitch",
        "--proc-id", str(proc_id),
        "--coordinator", coordinator,
        "--procs", str(procs),
        "--devices-per-proc", str(args.devices_per_proc),
        "--cam", str(args.cam),
        "--canvas", args.canvas,
        "--blend", str(args.blend),
        "--iters", str(args.iters),
        "--pipeline", args.pipeline,
        "--device", args.device,
        "--timeout", str(args.timeout),
    ]
    return cmd + ([] if args.backend is None else ["--backend", args.backend])


def _lines(texts, tag):
    return [json.loads(line[len(tag):]) for out, _ in texts for line in out.splitlines() if line.startswith(tag)]


def _spawn(args, procs):
    rdv = tempfile.mkdtemp(prefix="rendezvous-")
    try:
        coordinator = f"file://{os.path.join(rdv, 'init')}"
        cmds = [_worker_cmd(args, i, procs, coordinator) for i in range(procs)]
        texts = run_ranks(cmds, args.timeout, env=_module_env())
    finally:
        shutil.rmtree(rdv, ignore_errors=True)
    for _, err in texts:
        for line in err.splitlines():
            if line.startswith("[proc"):
                print(line, file=sys.stderr)
    return texts


def _module_env():
    """The environment with this package's root on PYTHONPATH, so the
    workers import it from wherever the launcher was started."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    return env


def run_launcher(args):
    texts = _spawn(args, args.procs)
    parity, results = _lines(texts, "PARITY "), _lines(texts, "RESULT ")
    if len(results) != 1 or len(parity) != args.procs:
        raise RuntimeError(f"{len(parity)} PARITY and {len(results)} RESULT lines from {args.procs} ranks")
    summary = {
        "metric": "multihost_stitch",
        "parity_ok": all(p["ok"] for p in parity),
        "parity": parity,
        **results[0],
    }
    if args.baseline:
        # one rank with the same bands: the weak-scaling reference (ranks
        # that share a card measure contention, not scaling)
        base = _lines(_spawn(args, 1), "RESULT ")[0]
        summary["single_proc_frames_per_s"] = base["frames_per_s"]
        summary["weak_scaling_efficiency"] = round(
            results[0]["frames_per_s"] / (args.procs * base["frames_per_s"]), 3
        )
    print(json.dumps(summary))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4, help="bands per rank")
    ap.add_argument("--cam", type=int, default=192)
    ap.add_argument("--canvas", default="384x192")
    ap.add_argument("--blend", type=int, default=8)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--pipeline", default="yuv420", choices=["rgb", "yuv420"])
    ap.add_argument("--timeout", type=int, default=900, help="seconds for the ranks, and for a collective's wait")
    ap.add_argument("--baseline", action="store_true",
                    help="also run one rank and report weak-scaling efficiency")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="default: nccl on the card, gloo on the CPU")
    # worker-only
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args(argv)
    if args.proc_id is not None:
        run_worker(args)
    else:
        run_launcher(args)


if __name__ == "__main__":
    main()
