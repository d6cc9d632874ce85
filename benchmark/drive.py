"""The one general traffic generator: it reads a traffic mix's parameters
(``traffic/<name>.json``) and drives a deploy.System with them.

Two kinds of mix:

- ``resident``: closed loop on device-resident frame sets.  A pool of
  ``pool`` distinct sets made on the card from the seed is stitched
  back to back in rotation with ``Mapper.stitch``; the window ends in a
  device synchronize, and every set enqueued in it counts.
- ``live``: open loop, host to host.  Pageable host frame sets (as a
  capture ring hands them over) are pushed into an ``AsyncMultiMapper``
  on a fixed schedule at ``rate_fps`` whether or not earlier sets have
  finished; a consumer thread pops them.  A set's latency runs from its
  due time to the pop that returns all its outputs.

Both keep the outputs of the sets named by ``sample`` (indices drawn
from the seed) for the correctness check, and return a record of plain
numbers for the metric readers.
"""

import math
import threading
import time

import numpy as np
import torch

from . import trace as tr

DEADLINE_S = 60.0  # how long past the window's close a live set may still arrive
FLOOR_FPS = 8.0  # fewer sets a second than any run of a cell reaches


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def sample_indices(seed, seconds, count):
    """``count`` distinct set indices drawn from the seed among the
    first ``seconds * FLOOR_FPS`` (the sets any run of the window
    reaches); the window's last set is compared besides."""
    n = max(count, int(seconds * FLOOR_FPS))
    rng = np.random.default_rng(int(seed))
    return sorted(int(i) for i in rng.choice(n, size=count, replace=False))


# ------------------------------------------------------------ resident


def warm_resident(system, pool, mix):
    for k in range(mix["warmup"]):
        system.stitch(pool[k % len(pool)])


def resident(system, pool, seconds, sample, device):
    """The closed-loop window.  Returns (record, kept) where ``kept``
    maps a set index to (its pool index, outputs, gains)."""
    from octvr_tpu_torch.ops import cuda_remap

    cuda_remap.reset_counts()
    want = set(sample)
    kept = {}
    ends = []  # when each call returned, from the window's start
    n = 0
    t0 = time.perf_counter()
    while True:
        k = n % len(pool)
        outs, gains = system.stitch(pool[k])
        if n in want:
            kept[n] = (k, outs, gains)
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    t_enq = time.perf_counter()
    _sync(device)
    t1 = time.perf_counter()
    kept[n - 1] = (k, outs, gains)
    return {
        "frames": n,
        "window_s": t1 - t0,
        "enqueue_s": t_enq - t0,
        "ends_s": ends,
        "remap_launches": cuda_remap.LAUNCHES,
        "remap_counts": dict(cuda_remap.COUNTS),
    }, kept


def trace_resident(system, pool, frames, device, host=False):
    """A traced segment of ``frames`` closed-loop sets."""

    def seg():
        for n in range(frames):
            system.stitch(pool[n % len(pool)])
        _sync(device)

    t = tr.traced(seg, host)
    t["frames"] = frames
    return t


# ---------------------------------------------------------------- live


def host_pool(pool):
    """The device pool as pageable host numpy arrays."""
    return [[f.cpu().numpy() for f in fs] for fs in pool]


def _open_loop(amm, pool, rate, seconds, first, sample):
    """Pushes ceil(seconds * rate) sets on the schedule t0 + i / rate and
    pops them on a consumer thread.  Returns (due, popped, late, kept)."""
    n = int(math.ceil(seconds * rate))
    popped = [None] * n
    kept = {}
    want = set(sample)

    def consume():
        for i in range(n):
            outs = amm.pop()
            popped[i] = time.perf_counter()
            if first + i in want or i == n - 1:
                kept[first + i] = ((first + i) % len(pool), outs, None)

    errors = []

    def guarded():
        try:
            consume()
        except BaseException as e:  # reported as failed sets by the caller
            errors.append(e)

    consumer = threading.Thread(target=guarded, daemon=True)
    consumer.start()
    t0 = time.perf_counter() + 0.01
    due = [t0 + i / rate for i in range(n)]
    late = []
    for i in range(n):
        wait = due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - due[i])
        try:
            amm.push(pool[(first + i) % len(pool)])
        except RuntimeError as e:  # the pipeline failed: the sets left never come
            errors.append(e)
            break
    consumer.join(timeout=max(0.0, due[-1] + DEADLINE_S - time.perf_counter()))
    return due, popped, late, kept, errors


def warm_live(amm, pool, mix):
    for k in range(mix["warmup"]):
        amm.push(pool[k % len(pool)])
    for _ in range(mix["warmup"]):
        amm.pop()


def _stage_totals(amm):
    s = amm.stats()
    return {k: s[f"{k}_ms"] * s["frames"] for k in ("upload", "dispatch", "drain")}, s["frames"]


def live(amm, pool, mix, seconds, sample):
    """The open-loop window.  Returns (record, kept)."""
    before, n0 = _stage_totals(amm)
    due, popped, late, kept, errors = _open_loop(amm, pool, mix["rate_fps"], seconds, 0, sample)
    after, n1 = _stage_totals(amm)
    frames = max(1, n1 - n0)
    lat = [p - d for p, d in zip(popped, due) if p is not None]
    return {
        "frames": len(due),
        "popped": len(lat),
        "latency_s": lat,
        "late_s": late,
        "ends_s": [p - due[0] for p in popped if p is not None],
        "window_s": due[-1] - due[0] + 1.0 / mix["rate_fps"],
        "stage_ms": {k: (after[k] - before[k]) / frames for k in before},
        "errors": [repr(e) for e in errors],
    }, kept


IN_FLIGHT = "a set in flight (upload, stitch or drain)"
BETWEEN = "no set in flight (waiting for the next arrival)"


def trace_live(amm, pool, mix, seconds):
    """A traced open-loop segment of ``seconds`` at the mix's rate,
    device activity only.  The profiler records no host op on the
    pipeline's threads, so the host's side of the trace is the
    segment's own schedule: each set in flight from its due time to
    its pop, and the stretches with none in flight between them."""
    out = {}

    def seg():
        # time.time_ns() - perf_counter(), to put the schedule on the trace's clock
        out["offset_ns"] = time.time_ns() - time.perf_counter() * 1e9
        out["due"], out["popped"], *_ = _open_loop(amm, pool, mix["rate_fps"], seconds, 0, ())

    t = tr.traced(seg)
    t["frames"] = sum(p is not None for p in out["popped"])
    shift = (out["offset_ns"] - t["t0_ns"]) * 1e-9
    flights = [(d + shift, p + shift) for d, p in zip(out["due"], out["popped"]) if p is not None]
    lo, hi = t["window"]
    t["host"] = [(IN_FLIGHT, s, e, 0) for s, e in flights] + [(BETWEEN, s, e, 0) for s, e in tr.gaps(flights, lo, hi)]
    return t
