"""The MXU-taps probe on the card: can the remap's bilinear taps go
through the matrix unit instead of a gather?  The port of
tools/mxu_taps_probe.py (kernel 8 of the TPU table).

It runs the probe's synthetic workload (``make_probe_inputs``:
1,917 steps x G=8 tiles of 8x128 pixels at the defaults, about one 4K
luma plane, taps in window rows [16, 64) of 80) through three kernels:
A, the per-pixel gather (the fan's counterpart); B, the folded one-hot
f32 weights as three bf16 products (hi + mid + lo terms) and B2, two
exact bf16 selection products, both on the tensor cores (``wgmma``).  Each is timed with CUDA events over ``--iters``
calls after one warm-up call, B and B2 are held to A within 1e-3, and
the last line is the probe's JSON line with its keys.

    python -m octvr_tpu_torch.tools.mxu_taps_probe [--steps 1917] [--g 8]
        [--kh 80] [--lo 16] [--hi 64] [--iters 20] [--device cuda]

``--device cpu`` runs the plain torch versions on the host clock
(correctness only); without a card the default raises.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import mxu_taps
from ..ops.mxu_taps import TH, TW
from ..utils.device import resolve_device

__all__ = ["main", "make_probe_inputs"]


def make_probe_inputs(steps: int, g: int, kh: int, lo: int, hi: int):
    """The probe's workload (tools/mxu_taps_probe.py:79-96): the same
    draws from ``default_rng(0)`` in the same order, so the arrays are
    bit-equal to the JAX probe's.  Returns (oyl, fxy, win) numpy."""
    mxu_taps.check_range(kh, lo, hi)
    rng = np.random.default_rng(0)
    shape = (steps, g, TH, TW)
    oy0 = rng.integers(lo, hi - 1, shape).astype(np.int32)
    oy1 = oy0 + 1
    fy = rng.uniform(0, 1, shape).astype(np.float32)
    l0 = rng.integers(0, TW - 1, shape).astype(np.int32)
    l1 = np.minimum(l0 + 1, TW - 1)
    fx = rng.uniform(0, 1, shape).astype(np.float32)
    win = rng.integers(0, 255, (steps, 1, kh, TW)).astype(np.int32)
    oyp = (oy0 & 0xFFFF) | (oy1 << 16)
    lp = (l0 & 0xFFFF) | (l1 << 16)
    return np.concatenate([oyp, lp], axis=2), np.concatenate([fx, fy], axis=2), win


def _timed(fn, iters, device):
    """(the first call's outputs, ms per call over ``iters`` calls after
    it): CUDA events on the card, the host clock on the CPU."""
    t0 = time.time()
    outs = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        first = time.time() - t0
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / iters
    else:
        first = time.time() - t0
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) / iters * 1e3
    return outs, first, ms


def main(argv=None):
    """Runs the probe; prints its ``#`` lines and JSON line and returns
    the JSON object.  Raises if a body disagrees with A by 1e-3 or more."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1917)
    ap.add_argument("--g", type=int, default=8)
    ap.add_argument("--kh", type=int, default=80)
    ap.add_argument("--lo", type=int, default=16)
    ap.add_argument("--hi", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cpu":
        print("# device cpu: the plain torch versions (correctness only)", file=sys.stderr)
    lo, hi = args.lo, args.hi
    inputs = [
        torch.from_numpy(a).to(device)
        for a in make_probe_inputs(args.steps, args.g, args.kh, lo, hi)
    ]

    def run(body, name):
        outs, first, ms = _timed(lambda: body(*inputs, lo, hi), args.iters, device)
        print(f"# {name}: first call {first:.1f}s", file=sys.stderr)
        chk = float(outs[0][::7, :, ::11].sum())
        print(f"# {name}: {ms:.4f} ms  (checksum {chk:.1f})")
        return outs, ms

    outs_a, ms_a = run(mxu_taps.fan, "A fan (per-pixel gather)")
    outs_b, ms_b = run(mxu_taps.mxu_folded, "B folded f32 weights (three bf16 products)")
    outs_b2, ms_b2 = run(mxu_taps.mxu_exact2, "B2 exact bf16 selections x2")
    err = max((a - b).abs().max().item() for a, b in zip(outs_a, outs_b))
    err2 = max((a - b).abs().max().item() for a, b in zip(outs_a, outs_b2))
    print(f"# max |A-B| = {err:.2e}   max |A-B2| = {err2:.2e}")
    # the probe's bars are 2e-2 for B and 1e-3 for B2 (:284-285); the
    # port holds B to 1e-3 too: in f32 it adds exact zeros to two products
    if not err < 1e-3:
        raise AssertionError(f"B disagrees with A: {err:.3g}")
    if not err2 < 1e-3:
        raise AssertionError(f"B2 disagrees with A: {err2:.3g}")
    result = {
        "metric": "mxu_taps_probe",
        "steps": args.steps,
        "g": args.g,
        "kh": args.kh,
        "visited_rows": hi - lo,
        "fan_ms": ms_a,
        "mxu_folded_ms": ms_b,
        "mxu_exact2_ms": ms_b2,
        "speedup_folded": ms_a / ms_b,
        "speedup_exact2": ms_a / ms_b2,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
