"""Find the knee of a configuration's live path once, by a sweep.

    python3 -m benchmark.knee --config mono360_4k --seconds 8 [--fractions 0.6,0.8,...]

In one process: the closed-loop host-to-host rate (pushes as fast as
the pipeline takes them), then an open-loop window at each fraction of
that rate.  A rate is sustained when the backlog does not grow through
its window: the median latency of the window's last quarter is at most
1.25 times that of its first quarter, and the generator ends less than
one frame interval late.  The knee is the highest sustained rate; a live
cell offers 0.8 of it.  Prints one JSON line per rate, then the knee.
"""

import argparse
import json
import sys
import time

from .run import set_cache_dirs


def _quarter_medians(lat):
    from .stats import percentile

    q = max(1, len(lat) // 4)
    return percentile(lat[:q], 50), percentile(lat[-q:], 50)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--fractions", default="0.6,0.7,0.8,0.9,1.0,1.1")
    args = ap.parse_args(argv)
    set_cache_dirs()
    import threading

    import torch

    from octvr_tpu_torch.runtime import AsyncMultiMapper
    from octvr_tpu_torch.utils.build import load_library

    from . import drive, frames
    from . import spec as specs
    from .deploy import System
    from .stats import percentile

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    load_library("product")
    config = specs.config(specs.load(), args.config)
    system = System(config, "cuda")
    pool = drive.host_pool(frames.make_pool(args.seed, 4, system.n_cams, system.cam_size, "cuda"))
    amm = AsyncMultiMapper(system.mappers, gain_modes=system.gain_modes)
    mix = {"warmup": 6}
    drive.warm_live(amm, pool, mix)

    # closed loop: as fast as the pipeline takes them
    state = {"pushed": 0, "stopped": False}
    done = []

    def consume():
        while not (state["stopped"] and len(done) == state["pushed"]):
            amm.pop()
            done.append(time.perf_counter())

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + args.seconds:
        amm.push(pool[state["pushed"] % len(pool)])
        state["pushed"] += 1
    state["stopped"] = True
    consumer.join(timeout=60)
    closed = (len(done) - 1) / (done[-1] - done[0])
    print(json.dumps({"closed_loop_fps": closed, "sets": len(done), "wall_s": done[-1] - t0}), flush=True)

    knee = None
    for f in (float(x) for x in args.fractions.split(",")):
        rate = closed * f
        due, popped, late, _, errors = drive._open_loop(amm, pool, rate, args.seconds, 0, ())
        lat = [p - d for p, d in zip(popped, due) if p is not None]
        first, last = _quarter_medians(lat)
        ok = not errors and len(lat) == len(due) and last <= 1.25 * first and late[-1] < 1.0 / rate
        row = {
            "fraction": f, "rate_fps": rate, "sets": len(due), "popped": len(lat),
            "p50_ms": percentile(lat, 50) * 1e3, "p95_ms": percentile(lat, 95) * 1e3,
            "first_quarter_p50_ms": first * 1e3, "last_quarter_p50_ms": last * 1e3,
            "generator_late_end_ms": late[-1] * 1e3, "sustained": ok,
        }
        print(json.dumps(row), flush=True)
        if ok:
            knee = rate
        time.sleep(1.0)
    print(json.dumps({"config": args.config, "knee_fps": knee, "offer_fps": None if knee is None else 0.8 * knee,
                      "device": torch.cuda.get_device_name()}), flush=True)
    amm.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
