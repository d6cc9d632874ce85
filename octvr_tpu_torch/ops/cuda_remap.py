"""Wrapper of the Hopper remap kernel (csrc/remap.cu).

``remap_apply`` (one frame) and ``remap_apply_frames`` (B frames in one
launch) take the plain torch version for a CPU tensor and launch the
CUDA kernel for a CUDA tensor; there is no fallback from one to the
other.  The source is a plain stack of planes or a flat run of source
blocks (ops/remap.py ``concat_source``).  ``LAUNCHES`` counts kernel
launches in all, and ``COUNTS`` per variant (``"nc3_bf16"``,
``"frames_nc1_bf16"``, ``"concat_nc1_bf16"``, ``"frames_concat_nc2_bf16"``,
...; "concat" when the inputs read camera-row slices), so a
run can show that each of its paths went through its kernel.
"""

import ctypes

import torch

from ..utils.build import load_library
from .remap import (
    RemapGroup,
    flat_source,
    remap_apply_frames_reference,
    remap_apply_reference,
    split_frame_outputs,
)

__all__ = ["COUNTS", "LAUNCHES", "launch_flat", "remap_apply", "remap_apply_frames", "reset_counts"]

LAUNCHES = 0
COUNTS = {}

_OUT_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [
    ctypes.c_int,
    ctypes.c_int,
    ctypes.c_longlong,
    ctypes.c_longlong,
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_void_p,
]


def reset_counts():
    """Set ``LAUNCHES`` and every count in ``COUNTS`` to 0."""
    global LAUNCHES
    LAUNCHES = 0
    COUNTS.clear()


def _entry(nc: int, out_dtype):
    fn = getattr(load_library(), f"octvr_remap_nc{nc}_{_OUT_TAGS[out_dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def launch_flat(src, plan: RemapGroup, out_dtype=torch.float32, frames: bool = False):
    """One kernel launch on a CUDA uint8 source (ops/remap.py
    ``flat_source``; ``frames``: a leading frames axis).  Returns (the
    flat output [B, C * total], C), which ``remap_apply`` and
    ``remap_apply_frames`` split into per-input views."""
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if not src.is_contiguous():
        raise ValueError("the source must be contiguous")
    flat, nc = flat_source(src, plan, frames)
    if out_dtype not in _OUT_TAGS:
        raise ValueError(f"out_dtype {out_dtype} not in (float32, bfloat16)")
    for t in (plan.x0, plan.y0, plan.fx, plan.fy, plan.offsets, plan.src_table):
        if t.device != flat.device:
            raise ValueError(f"plan on {t.device}, source on {flat.device}")
    b = flat.shape[0]
    total = plan.starts[-1]
    out = torch.empty((b, nc * total), dtype=out_dtype, device=flat.device)
    max_count = max(e - s for s, e in zip(plan.starts[:-1], plan.starts[1:]))
    if max_count == 0 or b == 0:
        return out, nc
    with torch.cuda.device(flat.device):
        err = _entry(nc, out_dtype)(
            flat.data_ptr(),
            plan.x0.data_ptr(),
            plan.y0.data_ptr(),
            plan.fx.data_ptr(),
            plan.fy.data_ptr(),
            plan.offsets.data_ptr(),
            plan.src_table.data_ptr(),
            out.data_ptr(),
            b,
            len(plan.out_shapes),
            max_count,
            total,
            plan.src_rows,
            plan.in_shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"remap kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    key = f"{'frames_' if frames else ''}{'concat_' if plan.concat else ''}nc{nc}_{_OUT_TAGS[out_dtype]}"
    COUNTS[key] = COUNTS.get(key, 0) + 1
    return out, nc


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
    the group's inputs, in one launch.  Returns per input a
    [B, C, rh, rw] view of one output buffer (per run of inputs
    [B, run, C, rh, rw])."""
    if src.device.type == "cpu":
        return remap_apply_frames_reference(src, plan, out_dtype, run)
    out, nc = launch_flat(src, plan, out_dtype, frames=True)
    return split_frame_outputs(out, plan, nc, run)
