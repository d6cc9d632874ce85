"""The readings that a configuration's correctness limits are set from.

    python3 -m benchmark.control --config mono360_4k --seeds 12 [--control-seeds 3]

In one process, for each seed: the frame sets of a run (``--pool``
distinct sets made from the seed) are stitched by the timed path
(``deploy.System.stitch``, the entry the resident window drives) and
compared with the plain reference, as a run's check does: the lower
readings.  Then, on the first ``--control-seeds`` seeds, the control
takes the program's place: the reference computed in float8 (e4m3),
the precision below the configuration's bfloat16: the upper readings.
On those seeds the planted faults are read too: every set given the
outputs of the set before it (a stale state), and one 16x16 block of
each Y plane altered where it is produced.  The control's and each fault's
numbers go through the run's own ``check.verdict`` with the committed
``limits/<config>.json``, which has to call each of them not correct.
Prints one JSON line per seed and side, then the largest lower and the
smallest upper reading of each number and every verdict.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys

from .run import set_cache_dirs

CONTROL = "float8_e4m3fn"


def _stale(kept):
    """Every set given the outputs and gains of the set before it (the
    first set those of the last)."""
    order = sorted(kept)
    return {i: (kept[i][0], *kept[order[j - 1]][1:]) for j, i in enumerate(order)}


def _altered(kept):
    """One 16x16 block of each Y plane altered (as the CPU test's fault)."""

    def alter(o):
        o = o.clone()
        o[40:56, 100:116] ^= 0x55
        return o

    return {i: (k, [alter(o) for o in outs], g) for i, (k, outs, g) in kept.items()}


FAULTS = {"stale": _stale, "altered": _altered}


def readings(config, device, seeds, control_seeds, pool_size, limits, log=print):
    """({number: [lower readings]}, {number: [upper readings]},
    {side: [correct by the committed limits]}) over ``seeds``."""
    from . import check, frames
    from .deploy import System

    system = System(config, device)
    reference = check.Reference(config, device)
    lower, upper, verdicts = {}, {}, {}

    def read(side, seed, found, into):
        correct, _ = check.verdict(found, limits)
        verdicts.setdefault(side, []).append(correct)
        log(json.dumps({"seed": seed, "side": side, "correct": correct, **found}))
        for k, v in found.items():
            into.setdefault(k, []).append(v)

    for i, seed in enumerate(seeds):
        pool = frames.make_pool(seed, pool_size, system.n_cams, system.cam_size, device)
        kept = {k: (k, *system.stitch(pool[k])) for k in range(pool_size)}
        read("program", seed, check.numbers(reference, pool, kept), lower)
        if i < control_seeds:
            outputs_of = lambda k: reference.stitch(pool[k], quantize=CONTROL)  # noqa: E731
            read("control", seed, check.numbers(reference, pool, kept, outputs_of=outputs_of), upper)
            for name, fault in FAULTS.items():
                read(name, seed, check.numbers(reference, pool, fault(kept)), {})
    return lower, upper, verdicts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--pool", type=int, default=2)
    args = ap.parse_args(argv)
    set_cache_dirs()
    import torch

    from octvr_tpu_torch.utils.build import load_library

    from . import spec as specs

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    load_library("product")
    config = specs.config(specs.load(), args.config)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    limits = specs.limits(args.config)
    lower, upper, verdicts = readings(config, "cuda", seeds, args.control_seeds, args.pool, limits)
    summary = {
        "config": args.config,
        "device": torch.cuda.get_device_name(),
        "limits": limits,
        "lower_max": {k: max(v) for k, v in lower.items() if None not in v},
        "upper_min": {k: min(v) for k, v in upper.items() if None not in v},
        "correct": verdicts,
    }
    print(json.dumps(summary), flush=True)
    # the program is correct on every seed, the control and each fault on none
    ok = all(verdicts["program"]) and not any(c for side, v in verdicts.items() if side != "program" for c in v)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
