"""Streaming multi-output stitch pipeline: the AsyncMultiMapper role
(octvr/src/async.{hpp,cpp}), the port of octvr_tpu/runtime/pipeline.py.

The reference runs 5 worker threads over blocking queues with triple
buffering (copy-in, H2D, stitch, D2H, copy-out; async.cpp:337-349,
BUF_SIZE=3 :261).  Here the same contract runs on three stages:

  upload:  a coordinator thread hands each host frame set, in push
           order, to a pool of UPLOAD_WORKERS.  A worker copies the set
           into a slot of a ring of BUF_SIZE pinned host buffers, then
           into that slot's device buffers with non_blocking copies on
           an H2D stream, and records an event after them.
  stitch:  one thread on its own compute stream waits on that event (a
           device-side wait: the host never blocks on it), runs the
           mappers, records a done event and frees the slot.
  drain:   one thread on a D2H stream waits on the done event, copies
           each output into pinned memory, synchronizes that copy and
           hands the caller a numpy array of its own.

Ring reuse is the counterpart of the JAX pipeline's buffer donation,
which has no meaning in eager torch: a slot's pinned buffers are
rewritten only after their H2D copy completed (the worker waits on its
event), and its device buffers only after the stitch that read them
completed (the H2D stream waits on that stitch's done event).  Frames
pushed as tensors on the mappers' device bypass both rings and are never
written: the stitch waits on an event recorded on the pushing thread's
stream, and marks them with ``record_stream``.  Mapper outputs, made on
the compute stream and read on the D2H stream, are marked the same way,
so the caching allocator never hands their memory out again while a copy
still reads it.  Each thread enters the device and its stream itself
(torch's current stream is per thread); the remap kernels launch on the
current stream, so they follow the stitch thread's.

On CPU mappers there are no streams, no pinned memory and no events:
the stages are the same threads over plain tensors.  That is the path a
caller asks for by building CPU mappers, never a fallback: CUDA mappers
without a card raise.

Multiple outputs (multi-region stereo layouts) are one mapper each with
gain sharing across outputs (gain_modes semantics, async.hpp:79:
-1 = off, k == own index -> solve, k != own -> copy output k's gains,
device to device).

Spans (``timer.RECORDER``): ``push()`` gives each set an id, in push
order, and opens its ``pipeline.set``, which the ``pop()`` returning
the set closes; the set's ``pipeline.upload``, ``pipeline.dispatch``
(with the mappers' ``mapper.*`` spans inside) and ``pipeline.drain``
are its children, so that its self time is its wait in the queues.  A
sharded batch's dispatch and drain are children of each of its sets.
The stage spans' totals are what ``stats()`` and the timers print.
"""

import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import ExitStack
from typing import List, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .timer import RECORDER, FpsMeter

BUF_SIZE = 3  # frame sets in flight, and slots in each ring (async.cpp:261)
UPLOAD_WORKERS = 2  # frame sets staged into pinned slots at once (async.cpp:263-309)
STAGES = ("upload", "dispatch", "drain")

__all__ = ["AsyncMultiMapper", "BUF_SIZE", "UPLOAD_WORKERS"]


class _Stop:
    pass


_STOP = _Stop()


class _Failure:
    """A stage's exception, passed downstream so that pop() raises it."""

    def __init__(self, exc):
        self.exc = exc


class _Slot:
    """One frame set's pinned host buffers and device buffers, with the
    events that guard their reuse."""

    def __init__(self):
        self.host = None  # pinned uint8 tensors, one per input
        self.dev = None  # device uint8 tensors, one per input
        self.start = torch.cuda.Event(enable_timing=True)
        self.copied = torch.cuda.Event(enable_timing=True)  # H2D done
        self.stitched = torch.cuda.Event()  # the stitch that read dev done
        self.pending_bytes = 0  # H2D bytes not yet counted in the stats


def _indexed(device):
    """``device`` resolved (CUDA without a card raises), with the current
    CUDA index where it names none, so that it compares equal to the
    device of a tensor on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _is_device_tensor(f, device):
    return isinstance(f, torch.Tensor) and f.device == device


class AsyncMultiMapper:
    """mappers: list of Mapper (one per output region) or of
    ShardedMapper, all on one device; gain_modes: per output, -1 = no
    compensation, own index = solve, other index = reuse that output's
    gains.  timers: print ``[Timer stitch] upload|dispatch|drain: X ms``
    every ``timer_interval`` frames.  drain: "host" hands each output
    frame to the caller; "checksum" fetches a strided scalar instead
    (see :meth:`pop`).  donate: accepted for the JAX signature and
    chooses nothing here: the device ring recycles the frame buffers
    (a frame set is never touched after its stitch completed)."""

    def __init__(
        self,
        mappers: List,
        gain_modes: Optional[List[int]] = None,
        timers: bool = False,
        timer_interval: int = 10,
        donate: bool = True,
        drain: str = "host",
    ):
        if drain not in ("host", "checksum"):
            raise ValueError(f"unknown drain {drain!r}")
        self.drain_mode = drain
        self.mappers = mappers
        self.device = _indexed(mappers[0].device)
        if any(_indexed(m.device) != self.device for m in mappers):
            raise ValueError("every output's mapper must be on one device")
        # sharded outputs (ShardedMapper): the stitch stage groups
        # mesh.n_data consecutive frame sets into one stitch_batch call;
        # the drain stage fans the batch back out per frame
        self._sharded = hasattr(mappers[0], "mesh")
        if any(hasattr(m, "mesh") != self._sharded for m in mappers):
            raise ValueError("mixing ShardedMapper and Mapper outputs is unsupported")
        if self._sharded:
            self._data_batch = mappers[0].mesh.n_data
        n_out = len(mappers)
        self.gain_modes = list(gain_modes) if gain_modes is not None else list(range(n_out))
        if len(self.gain_modes) != n_out:
            raise ValueError(f"{len(self.gain_modes)} gain modes for {n_out} outputs")
        # solve owners first, then gain copiers (async.cpp:75-91)
        self._order = sorted(range(n_out), key=lambda k: 0 if self.gain_modes[k] in (-1, k) else 1)

        self._cuda = self.device.type == "cuda"
        if self._cuda:
            with torch.cuda.device(self.device):
                self._h2d = torch.cuda.Stream()
                self._compute = torch.cuda.Stream()
                self._d2h = torch.cuda.Stream()
                self._d2h_start = torch.cuda.Event(enable_timing=True)
                self._d2h_end = torch.cuda.Event(enable_timing=True)
            self._slots = [_Slot() for _ in range(BUF_SIZE)]
            self._free = queue.Queue()
            for s in self._slots:
                self._free.put(s)
            self._h2d_lock = threading.Lock()
            self._pinned_out = [None] * n_out

        self._closed_input = False
        self._error = None
        self._last_chk = None
        self._in_q = queue.Queue(maxsize=BUF_SIZE)
        self._up_q = queue.Queue(maxsize=BUF_SIZE)
        self._flight_q = queue.Queue(maxsize=BUF_SIZE)
        self._out_q = queue.Queue(maxsize=BUF_SIZE)
        self.fps = FpsMeter()
        # per-stage phase timers, the mapper.cpp:206-318 / timer.cpp role:
        # host-side ms per stage (this pipeline's spans' totals), printed
        # every timer_interval frames
        self._scope = RECORDER.new_id()
        self._timers_on = timers
        self._timer_interval = max(1, timer_interval)
        self._timer_mark = self._stage_ns()
        self._stage_n = 0
        self._stats_lock = threading.Lock()
        self._totals = dict.fromkeys(("h2d_ms", "h2d_bytes", "d2h_ms", "d2h_bytes"), 0.0)
        self._pool = ThreadPoolExecutor(max_workers=UPLOAD_WORKERS, thread_name_prefix="octvr-upload")
        self._threads = [
            threading.Thread(target=self._guard, args=(self._run_upload, self._up_q), daemon=True),
            threading.Thread(target=self._guard, args=(self._run_stitch, self._flight_q), daemon=True),
            threading.Thread(target=self._guard, args=(self._run_drain, self._out_q), daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------ helpers

    def _on(self, stream):
        """Enter the device and ``stream`` on this thread (CUDA only)."""
        stack = ExitStack()
        if self._cuda:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _add(self, key, value):
        with self._stats_lock:
            self._totals[key] += value

    def _span(self, stage, parent):
        """The set ``parent``'s span of ``stage`` on this thread."""
        return RECORDER.span(f"pipeline.{stage}", parent=parent, scope=self._scope)

    def _also_under(self, stage, t0, t1, sets):
        """The stage's work of [t0, t1], done once for a batch, recorded
        again under each further set of it."""
        for sp in sets:
            RECORDER.record(f"pipeline.{stage}", t0, t1, sp)

    def _stage_ns(self):
        """This pipeline's host ns in each stage so far."""
        t = RECORDER.totals(self._scope)
        return {s: t.get(f"pipeline.{s}", (0, 0))[1] for s in STAGES}

    def _guard(self, run, downstream):
        """Runs a stage; on an exception, records it and passes it
        downstream so that pop() raises instead of waiting forever."""
        try:
            run()
        except BaseException as e:  # re-raised in the caller's thread by pop()
            self._error = e
            downstream.put(_Failure(e))

    def _forward(self, item, downstream):
        """Passes a _Failure on; True if ``item`` was one."""
        if isinstance(item, _Failure):
            downstream.put(item)
            return True
        return False

    # ------------------------------------------------------------ upload

    def _stage_set(self, slot, frames):
        """Host frames of one set -> the slot's device buffers: the
        pinned copy on this thread, the H2D copy on the H2D stream."""
        slot.copied.synchronize()  # the slot's last H2D copy has read its pinned buffers
        if slot.pending_bytes:
            self._add("h2d_ms", slot.start.elapsed_time(slot.copied))
            self._add("h2d_bytes", slot.pending_bytes)
            slot.pending_bytes = 0
        if slot.host is None:
            slot.host, slot.dev = [None] * len(frames), [None] * len(frames)
        nbytes = 0
        for i, f in enumerate(frames):
            if f is None:
                continue
            if slot.host[i] is None:  # first use: the stream's frame shapes are fixed from here
                slot.host[i] = torch.empty(f.shape, dtype=torch.uint8, pin_memory=True)
                slot.dev[i] = torch.empty(f.shape, dtype=torch.uint8, device=self.device)
            h = slot.host[i]
            if tuple(f.shape) != tuple(h.shape):
                raise ValueError(f"frame of shape {tuple(f.shape)} where the stream has {tuple(h.shape)}")
            if isinstance(f, torch.Tensor):
                h.copy_(f)
            else:
                np.copyto(h.numpy(), f, casting="no")
            nbytes += h.numel()
        with self._h2d_lock:  # one set's copies contiguous on the stream, so its events time them
            self._h2d.wait_event(slot.stitched)  # the stitch that read the device slot completed
            slot.start.record(self._h2d)
            for h, d, f in zip(slot.host, slot.dev, frames):
                if f is not None:
                    d.copy_(h, non_blocking=True)
            slot.copied.record(self._h2d)
        slot.pending_bytes = nbytes

    def _host_frames(self, frames):
        """``frames`` with None in place of those already on the device."""
        return [None if _is_device_tensor(f, self.device) else f for f in frames]

    def _upload_one(self, frames, ready, slot, set_span):
        with self._span("upload", set_span):
            if slot is not None:
                host = self._host_frames(frames)
                with self._on(self._h2d):
                    self._stage_set(slot, host)
                frames = [f if h is None else d for f, h, d in zip(frames, host, slot.dev)]
            elif not self._cuda:
                frames = [f if isinstance(f, torch.Tensor) else torch.from_numpy(np.array(f)) for f in frames]
        return frames, ready, slot, set_span

    def _get_slot(self):
        while True:
            if self._error is not None:
                raise RuntimeError("a later stage failed") from self._error
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue

    def _run_upload(self):
        """Coordinator: takes each set's slot in push order (slots free
        in that order, so no set waits on a later one), submits the
        uploads to the pool and queues the futures in arrival order, so
        frame order is kept downstream."""
        while True:
            item = self._in_q.get()
            if isinstance(item, _Stop):
                self._up_q.put(_STOP)
                return
            frames, ready, set_span = item
            use_slot = self._cuda and any(f is not None for f in self._host_frames(frames))
            slot = self._get_slot() if use_slot else None
            self._up_q.put(self._pool.submit(self._upload_one, frames, ready, slot, set_span))

    # ------------------------------------------------------------ stitch

    def _take(self, fut):
        """The uploaded set, ordered on the compute stream after its
        copies and after the pushing thread's work on device frames."""
        frames, ready, slot, set_span = fut.result()
        if self._cuda:
            if slot is not None:
                self._compute.wait_event(slot.copied)
            if ready is not None:
                self._compute.wait_event(ready)
                for f in frames:
                    if slot is None or all(f is not d for d in slot.dev):
                        f.record_stream(self._compute)
        return frames, slot, set_span

    def _release(self, slots):
        """A done event on the compute stream after the stitch: it guards
        the slots' device buffers and orders the drain."""
        if not self._cuda:
            return None
        done = torch.cuda.Event()
        done.record(self._compute)
        for s in slots:
            s.stitched = done
            self._free.put(s)
        return done

    def _stitch_outputs(self, stitch, frames):
        """Every output of one frame set (or batch), owners first."""
        outs = [None] * len(self.mappers)
        gains = [None] * len(self.mappers)
        for k in self._order:
            mode = self.gain_modes[k]
            if mode in (-1, k):
                outs[k], gains[k] = stitch(self.mappers[k], frames, None)
            else:
                outs[k], gains[k] = stitch(self.mappers[k], frames, gains[mode])
        return outs

    def _dispatch_sharded(self, batch, sets, timed=None):
        """One stitch_batch over ``batch`` (per input [B, ...]) for the
        sets ``sets``, the rows past theirs padded by repeating the last
        real set; the flight queue's item.  It runs inside the dispatch
        span of the set ``timed`` (of none at the end of the stream) and
        is recorded again under each other set."""
        t0 = time.perf_counter_ns()
        nreal = len(sets)
        for b in range(nreal, self._data_batch):
            for x in batch:
                x[b].copy_(x[nreal - 1])
        outs = self._stitch_outputs(lambda m, f, g: m.stitch_batch(f, gains=g), batch)
        item = (outs, sets, self._release([]))
        self._also_under("dispatch", t0, time.perf_counter_ns(), [sp for sp in sets if sp is not timed])
        return item

    def _run_stitch(self):
        with self._on(self._compute if self._cuda else None):
            if self._sharded:
                self._stitch_sharded()
            else:
                self._stitch_frames()

    def _stitch_frames(self):
        while True:
            fut = self._up_q.get()
            if isinstance(fut, _Stop):
                self._flight_q.put(_STOP)
                return
            if self._forward(fut, self._flight_q):
                return
            frames, slot, set_span = self._take(fut)
            with self._span("dispatch", set_span):
                outs = self._stitch_outputs(lambda m, f, g: m.stitch(f, gains=g), frames)
                done = self._release([] if slot is None else [slot])
            self._flight_q.put((outs, [set_span], done))

    def _stitch_sharded(self):
        B = self._data_batch
        batch, sets = None, []
        while True:
            fut = self._up_q.get()
            if isinstance(fut, _Stop):
                if sets:
                    self._flight_q.put(self._dispatch_sharded(batch, sets))
                self._flight_q.put(_STOP)
                return
            if self._forward(fut, self._flight_q):
                return
            frames, slot, set_span = self._take(fut)
            with self._span("dispatch", set_span):
                if not sets:
                    batch = [torch.empty((B,) + tuple(f.shape), dtype=f.dtype, device=f.device) for f in frames]
                for x, f in zip(batch, frames):
                    x[len(sets)].copy_(f)
                sets.append(set_span)
                if slot is not None:  # free the slot once copied: B may exceed the ring
                    self._release([slot])
                item = self._dispatch_sharded(batch, sets, timed=set_span) if len(sets) == B else None
            if item is not None:  # out of the span: the drain may start on it at once
                self._flight_q.put(item)
                batch, sets = None, []

    # ------------------------------------------------------------- drain

    def _to_host(self, outs, done):
        """Each output tensor (or batch) -> a host tensor: on CUDA a D2H
        copy into pinned memory on the D2H stream, then a synchronize."""
        if not self._cuda:
            return outs
        self._d2h.wait_event(done)
        self._d2h_start.record(self._d2h)
        for k, o in enumerate(outs):
            o.record_stream(self._d2h)
            p = self._pinned_out[k]
            if p is None or p.shape != o.shape:
                p = self._pinned_out[k] = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            p.copy_(o, non_blocking=True)
        self._d2h_end.record(self._d2h)
        self._d2h_end.synchronize()
        self._add("d2h_ms", self._d2h_start.elapsed_time(self._d2h_end))
        self._add("d2h_bytes", sum(o.numel() * o.element_size() for o in outs))
        return self._pinned_out

    def _checksums(self, outs, done):
        """One strided scalar per output (per batch when sharded): every
        frame's is computed, so the device runs every frame."""
        if self._cuda:
            self._d2h.wait_event(done)
            for o in outs:
                o.record_stream(self._d2h)
        idx = (slice(None),) * self._sharded + (slice(None, None, 101), slice(None, None, 103))
        return [o[idx].to(torch.int32).sum() for o in outs]

    def _run_drain(self):
        with self._on(self._d2h if self._cuda else None):
            self._drain()

    def _emit(self, host, set_span):
        self._stage_n += 1
        self.fps.tick()
        self._out_q.put((host, set_span))

    def _drain(self):
        while True:
            item = self._flight_q.get()
            if isinstance(item, _Stop):
                if self._last_chk is not None:
                    for s in self._last_chk:
                        s.item()  # final value-sync (checksum mode)
                self._out_q.put(_STOP)
                return
            if self._forward(item, self._out_q):
                return
            outs, sets, done = item
            nreal = len(sets)
            with self._span("drain", sets[0]) as drain:
                if self.drain_mode == "checksum":
                    scal = self._checksums(outs, done)
                    self._last_chk = scal
                    # the blocking fetch is amortized over 8 frames; a batch
                    # fetches when it holds a frame at 7 mod 8
                    fetch = self._stage_n % 8 >= 8 - nreal
                    vals = [float(s.item()) for s in scal] if fetch else [0.0] * len(scal)
                    frames = [list(vals) for _ in range(nreal)]
                else:
                    host = self._to_host(outs, done)
                    if self._sharded:
                        frames = [
                            [m.assemble_yuv(h[b]).numpy() for m, h in zip(self.mappers, host)]
                            for b in range(nreal)
                        ]
                    elif self._cuda:
                        frames = [[h.clone().numpy() for h in host]]  # the caller's own arrays
                    else:
                        frames = [[h.numpy() for h in host]]
            self._also_under("drain", drain.start_ns, drain.end_ns, sets[1:])
            if self._sharded:
                for f, sp in zip(frames, sets):
                    self._emit(f, sp)
                continue
            self._stage_n += 1
            if self._timers_on and self._stage_n % self._timer_interval == 0:
                k = self._timer_interval
                now = self._stage_ns()
                for stage in STAGES:
                    ms = (now[stage] - self._timer_mark[stage]) / 1e6
                    print(f"[Timer stitch] {stage}: {ms / k:.2f} ms", file=sys.stderr)
                self._timer_mark = now
            self.fps.tick()
            self._out_q.put((frames[0], sets[0]))

    # --------------------------------------------------------------- API

    def push(self, frames):
        """frames: one packed YUV420P uint8 [Hi*3/2, Wi] frame per input
        (numpy arrays, or tensors; tensors already on the mappers' device
        skip the rings).  Blocks when BUF_SIZE frame sets wait upstream."""
        set_span = RECORDER.span("pipeline.set", set_id=RECORDER.new_set(), stacked=False)
        frames = list(frames)
        ready = None
        if self._cuda and any(_is_device_tensor(f, self.device) for f in frames):
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        while True:
            if self._error is not None:
                raise RuntimeError("the stitch pipeline failed") from self._error
            try:
                self._in_q.put((frames, ready, set_span), timeout=0.1)
                return
            except queue.Full:
                continue

    def pop(self):
        """Returns the next frame set's outputs, in push order (blocks):
        one numpy uint8 YUV420P array per output, owned by the caller.
        Raises StopIteration at the end of the stream, and the stage's
        error if a stage failed.

        CONTRACT CHANGE in ``drain="checksum"`` mode: returns a list of
        per-output floats instead of frames (a strided checksum, 0.0 on
        the 7 of every 8 frames whose fetch is amortized).  That mode
        measures the device-bound pipeline rate without frame
        downloads: never feed its pop() results to a frame sink
        (cli/stream.py skips its writers in that mode)."""
        out = self._out_q.get()
        if isinstance(out, _Stop):
            raise StopIteration
        if isinstance(out, _Failure):
            raise RuntimeError("the stitch pipeline failed") from out.exc
        frames, set_span = out
        RECORDER.end(set_span)
        return frames

    def close_input(self):
        """Signal end-of-stream upstream: flushes any partial sharded
        batch so every pushed frame can still be pop()'d before
        close()."""
        if not self._closed_input:
            self._closed_input = True
            while True:
                try:
                    self._in_q.put(_STOP, timeout=0.1)
                    return
                except queue.Full:
                    if self._error is not None:  # the upload stage may never take it
                        return

    def close(self):
        self.close_input()
        for t in self._threads:
            t.join(timeout=30 if self._error is None else 1)
        self._pool.shutdown(wait=False)
        if self._cuda and not any(t.is_alive() for t in self._threads):
            for s in self._slots:
                s.copied.synchronize()
                if s.pending_bytes:
                    self._add("h2d_ms", s.start.elapsed_time(s.copied))
                    self._add("h2d_bytes", s.pending_bytes)
                    s.pending_bytes = 0
            torch.cuda.synchronize(self.device)

    def stats(self):
        """Totals so far: frames drained, each stage's host ms per frame
        (upload, dispatch, drain), and the H2D and D2H copies' device
        time and rate (CUDA only; ``None`` where nothing was copied)."""
        with self._stats_lock:
            t = dict(self._totals)
        stage = self._stage_ns()
        n = max(1, self._stage_n)

        def rate(key):
            return t[f"{key}_bytes"] / (t[f"{key}_ms"] * 1e6) if t[f"{key}_ms"] else None

        return {
            "frames": self._stage_n,
            **{f"{s}_ms": stage[s] / 1e6 / n for s in STAGES},
            "h2d_bytes": int(t["h2d_bytes"]),
            "h2d_ms": t["h2d_ms"],
            "h2d_GBps": rate("h2d"),
            "d2h_bytes": int(t["d2h_bytes"]),
            "d2h_ms": t["d2h_ms"],
            "d2h_GBps": rate("d2h"),
        }
