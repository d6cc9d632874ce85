"""Wrapper of the Hopper remap kernels (csrc/remap.cu).

``remap_apply`` (one frame: ``remap_kernel``, two pixels per thread)
and ``remap_apply_frames`` (B frames in one launch:
``remap_frames_kernel``, which reads the plan once per batch) take the
plain torch version for a CPU tensor and launch a CUDA kernel for a
CUDA tensor; there is no fallback from one to the other.  The source is
a plain stack of planes or a flat run of source blocks (ops/remap.py
``concat_source``).  The kernels are the ``product`` library
(utils/build.py).  ``LAUNCHES`` counts kernel launches in all, and
``COUNTS`` per variant (``"nc3_bf16"``, ``"frames_nc1_bf16"``,
``"concat_nc1_bf16"``, ``"frames_concat_nc2_bf16"``, ...; "concat" when
the inputs read camera-row slices), so a run can show that each of its
paths went through its kernel; a launch captured into a CUDA graph is
counted at each replay (``launch_counts``).
"""

import ctypes

import torch

from ..utils.build import load_library
from .launch_counts import Counter
from .remap import (
    RemapGroup,
    flat_source,
    remap_apply_frames_reference,
    remap_apply_reference,
    split_frame_outputs,
)

__all__ = [
    "COUNTS",
    "LAUNCHES",
    "launch_flat",
    "remap_apply",
    "remap_apply_frames",
    "reset_counts",
]

_COUNTER = Counter()
COUNTS = _COUNTER.counts
reset_counts = _COUNTER.reset  # set every count to 0
__getattr__ = _COUNTER.module_getattr(__name__)  # LAUNCHES: the launches in all


_OUT_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTRS = [ctypes.c_void_p] * 8
_ARGTYPES = {
    # (src, x0, y0, fx, fy, offsets, src_table, out, n_inputs, max_count,
    # total, src_rows, W, stream)
    False: _PTRS + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_void_p],
    # (..., out, n_frames, n_inputs, max_count, total, src_rows, W, stream)
    True: _PTRS + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
}
_ENTRIES = {}  # (nc, out dtype, frames) -> ctypes function
_INVALID_VALUE = 1  # cudaErrorInvalidValue: a shape the kernels refuse


def _entry(nc: int, out_dtype, frames: bool):
    key = (nc, out_dtype, frames)
    fn = _ENTRIES.get(key)
    if fn is None:
        name = f"octvr_remap_{'frames_' if frames else ''}nc{nc}_{_OUT_TAGS[out_dtype]}"
        fn = getattr(load_library("product"), name)
        fn.argtypes = _ARGTYPES[frames]
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def launch_flat(src, plan: RemapGroup, out_dtype=torch.float32, frames: bool = False):
    """One kernel launch on a CUDA uint8 source (ops/remap.py
    ``flat_source``; ``frames``: a leading frames axis, the frames
    kernel).  Returns (the flat output [B, C * total], C), which
    ``remap_apply`` and ``remap_apply_frames`` split into per-input
    views."""
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if not src.is_contiguous():
        raise ValueError("the source must be contiguous")
    flat, nc = flat_source(src, plan, frames)
    if out_dtype not in _OUT_TAGS:
        raise ValueError(f"out_dtype {out_dtype} not in (float32, bfloat16)")
    dev = flat.device
    for t in (plan.x0, plan.y0, plan.fx, plan.fy, plan.offsets, plan.src_table):
        if t.device != dev:
            raise ValueError(f"plan on {t.device}, source on {dev}")
    b = flat.shape[0]
    out = torch.empty((b, nc * plan.total), dtype=out_dtype, device=dev)
    if plan.max_count == 0 or b == 0:
        return out, nc
    fn = _entry(nc, out_dtype, frames)
    head = (
        flat.data_ptr(), plan.x0.data_ptr(), plan.y0.data_ptr(), plan.fx.data_ptr(),
        plan.fy.data_ptr(), plan.offsets.data_ptr(), plan.src_table.data_ptr(), out.data_ptr(),
    )
    shape = (len(plan.out_shapes), plan.max_count, plan.total, plan.src_rows, plan.in_shape[1])
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = _call(fn, head, shape, b, frames)
    else:
        err = _call(fn, head, shape, b, frames)
    if err == _INVALID_VALUE:
        raise RuntimeError(
            f"remap kernel refused the shape (inputs, max_count, total, src_rows, W) = {shape}: it takes "
            "1 to 65,535 inputs, at most 2^31 - 513 output pixels per input, and one channel of a "
            "frame's source under 2^31 bytes (src_rows * W)"
        )
    if err != 0:
        raise RuntimeError(f"remap kernel launch failed: CUDA error {err}")
    key = f"{'frames_' if frames else ''}{'concat_' if plan.concat else ''}nc{nc}_{_OUT_TAGS[out_dtype]}"
    _COUNTER.add({key: 1})
    return out, nc


def _call(fn, head, shape, b, frames):
    stream = torch.cuda.current_stream().cuda_stream
    if frames:
        return fn(*head, b, *shape, stream)
    return fn(*head, *shape, stream)


def remap_apply(src, plan: RemapGroup, out_dtype=torch.float32, run: int = 1):
    """src: uint8 [N, C, H, W], C in {1, 2, 3}, one plane stack per
    input of a stacked group, or a flat source [C*rows*W] of source
    blocks (ops/remap.py ``concat_source``).  Returns per input a
    [C, rh, rw] view of one output buffer, in ``out_dtype`` (float32 or
    bfloat16); with ``run`` > 1, per run of inputs a [run, C, rh, rw]
    view."""
    if src.device.type == "cpu":
        return remap_apply_reference(src, plan, out_dtype, run)
    out, nc = launch_flat(src, plan, out_dtype, frames=False)
    return [o[0] for o in split_frame_outputs(out, plan, nc, run)]


def remap_apply_frames(src, plan: RemapGroup, out_dtype=torch.float32, run: int = 1):
    """src: uint8 [B, N, C, H, W] or a flat [B, C*rows*W], B frames of
    the group's inputs, in one launch of the frames kernel.  Returns per
    input a [B, C, rh, rw] view of one output buffer (per run of inputs
    [B, run, C, rh, rw])."""
    if src.device.type == "cpu":
        return remap_apply_frames_reference(src, plan, out_dtype, run)
    out, nc = launch_flat(src, plan, out_dtype, frames=True)
    return split_frame_outputs(out, plan, nc, run)
