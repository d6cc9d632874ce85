"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``octvr_tpu_torch``).
The run loads its configuration's templates and Mappers, makes its
frame sets from the seed, warms its cell's shapes, measures for
``--seconds``, checks the window's outputs against the plain reference,
and prints one JSON line last on standard output: with ``--trace 0``
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(read from a traced segment after the window) and a breakdown.  It
exits non-zero with no result without a CUDA card, or with JAX loaded.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.time()
HERE = Path(__file__).resolve().parent

TRACE_SECONDS = 2.0  # the traced segment of a --trace 1 run (device activity)
HOST_TRACE_SECONDS = 0.5  # a resident run's second segment, with the host's ops
SAMPLE = 4  # sets drawn from the seed for the check, beside the window's last


def process_start():
    """Wall-clock time at which this process started (Linux), else the
    time this module was first executed."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_START


def set_cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = HERE / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_cell(spec, cell_name, seed, seconds, trace, device="cuda", t_start=None):
    """One run of a cell.  Returns the result dict (the last line) and
    the list of [name, value, limit] compared."""
    import torch

    from . import check, drive, frames
    from . import spec as specs
    from . import trace as tr
    from .deploy import System
    from .roofline import system_remap_bound

    t_start = time.time() if t_start is None else t_start
    cell = specs.cell(spec, cell_name)
    config = specs.config(spec, cell["config"])
    mix = specs.traffic(cell["traffic"])
    on_cuda = torch.device(device).type == "cuda"
    rec = {"cell": cell_name, "seed": seed, "trace": trace}

    t0 = time.time()
    if on_cuda:
        from octvr_tpu_torch.utils.build import load_library

        load_library("product")
    rec["library_s"] = time.time() - t0
    system = System(config, device)
    rec["template_s"], rec["plan_build_s"], rec["compiled"] = system.template_s, system.plan_build_s, system.compiled
    rec["outputs"] = len(system.mappers)
    t0 = time.time()
    pool = frames.make_pool(seed, mix["pool"], system.n_cams, system.cam_size, device)
    sample = drive.sample_indices(seed, seconds, SAMPLE)
    amm = None
    if mix["kind"] == "resident":
        drive.warm_resident(system, pool, mix)
    elif mix["kind"] == "live":
        from octvr_tpu_torch.runtime import AsyncMultiMapper

        hpool = drive.host_pool(pool)
        amm = AsyncMultiMapper(system.mappers, gain_modes=system.gain_modes)
        drive.warm_live(amm, hpool, mix)
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec["warmup_s"] = time.time() - t0
    rec["setup_s"] = time.time() - t_start

    if amm is None:
        win, kept = drive.resident(system, pool, seconds, sample, device)
    else:
        win, kept = drive.live(amm, hpool, mix, seconds, sample)
    rec.update(win)
    if trace:
        # device activity alone for the numbers; on a resident run, then a
        # short segment with the host's ops too, whose profiler overhead
        # leaves it only the names of what the host did in the idle gaps
        # (a live segment names its gaps by its own schedule)
        if amm is None:
            per_s = win["frames"] / win["window_s"]
            t = drive.trace_resident(system, pool, max(4, int(TRACE_SECONDS * per_s)), device)
            named = drive.trace_resident(system, pool, max(2, int(HOST_TRACE_SECONDS * per_s)), device, host=True)
        else:
            t = named = drive.trace_live(amm, hpool, mix, TRACE_SECONDS)
        rec["trace"] = {
            "frames": t["frames"],
            "window_s": t["window"][1],
            # the profiler slows the host: the traced segment's own rate,
            # beside the window's, shows how far idle_pct reads high
            "sets_per_s": t["frames"] / t["window"][1],
            "busy_s": tr.busy_s(t),
            "launches": tr.launches(t),
            "gemm_s": tr.class_seconds(t, "matmul (pyramid, pooling)"),
            "remap_s": tr.kernel_seconds(t, ("remap_kernel", "remap_frames_kernel")),
            "device_ops": tr.device_ops(t),
            "idle_gaps": tr.idle_gaps(named),
        }
        rec["remap_bound_s"] = system_remap_bound(system) if on_cuda else None
        del t, named
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    if amm is not None:
        amm.close()
    # the check runs on the host copies of the kept outputs; the program's
    # state is freed first, so that the reference never sets the peak
    kept = {i: (k, [o.cpu() if isinstance(o, torch.Tensor) else o for o in outs],
                None if g is None else [x.cpu() for x in g]) for i, (k, outs, g) in kept.items()}
    del system, amm
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    t0 = time.time()
    reference = check.Reference(config, device)
    found = check.numbers(reference, pool, kept)
    correct, compared = check.verdict(found, specs.limits(config["name"]))
    rec["check_s"] = time.time() - t0
    rec["max_diff"] = found["max_diff"]
    failed = rec["frames"] - rec.get("popped", rec["frames"])
    correct = correct and failed == 0 and not rec.get("errors")
    compared = compared + [["failed_sets", failed, 0]]

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in specs.metrics_for(spec, cell_name, kind):
        value = specs.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_cuda else "cpu",
        "kind": torch.cuda.get_device_name() if on_cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": rec["frames"], "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"], "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checked"] = compared  # last: each number compared beside its limit
    log(json.dumps({k: v for k, v in rec.items() if k not in ("latency_s", "late_s", "ends_s", "trace")}, default=str))
    per_s = [0] * (int(max(rec["ends_s"], default=0)) + 1)
    for t in rec["ends_s"]:
        per_s[int(t)] += 1
    log(f"# sets done in each second of the window: {per_s}")
    if "late_s" in rec:
        late = sorted(rec["late_s"])
        log(f"# generator lateness: max {late[-1] * 1e3:.3f} ms, p95 {late[int(0.95 * (len(late) - 1))] * 1e3:.3f} ms over {len(late)} pushes")
    if "remap_counts" in rec:
        log(f"# remap launches in the window: {rec['remap_launches']} {rec['remap_counts']} over {rec['frames']} sets")
    if trace:
        log("# trace: " + json.dumps({k: v for k, v in rec["trace"].items() if k not in ("device_ops", "idle_gaps")}))
    log(f"# setup: library {rec['library_s']:.3f} s, template {rec['template_s']:.3f} s, plan build "
        f"{rec['plan_build_s'] - rec['template_s']:.3f} s, pool and warm-up {rec['warmup_s']:.3f} s, "
        f"setup_s {rec['setup_s']:.3f} s; reference check {rec['check_s']:.3f} s")
    return result, compared


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    set_cache_dirs()

    from . import guard
    from . import spec as specs

    spec = specs.load()
    cell = specs.cell(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"no CUDA card, or fewer than the {cell['chips']} the cell asks for")
        return 2
    torch.set_float32_matmul_precision("highest")
    result, compared = run_cell(spec, args.workload, args.seed, args.seconds, args.trace, "cuda", t_start)
    found = guard.jax_modules()
    if found:
        log(f"JAX is loaded in the benchmark's process: {found}")
        return 3
    for name, value, limit in compared:
        log(f"check {name} {value} limit {limit}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
