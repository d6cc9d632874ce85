"""Wrapper of the Hopper remap kernel (csrc/remap.cu).

``remap_apply`` (one frame) and ``remap_apply_frames`` (B frames in one
launch) take the plain torch version for a CPU tensor and launch the
CUDA kernel for a CUDA tensor; there is no fallback from one to the
other.  ``LAUNCHES`` counts kernel launches in all, and ``COUNTS`` per
variant (``"nc3_bf16"``, ``"frames_nc1_bf16"``, ...), so a run can show
that each of its paths went through its kernel.
"""

import ctypes

import torch

from ..utils.build import load_library
from .remap import (
    RemapGroup,
    remap_apply_frames_reference,
    remap_apply_reference,
    split_frame_outputs,
)

__all__ = ["COUNTS", "LAUNCHES", "remap_apply", "remap_apply_frames", "reset_counts"]

LAUNCHES = 0
COUNTS = {}

_OUT_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_int,
    ctypes.c_int,
    ctypes.c_longlong,
    ctypes.c_longlong,
    ctypes.c_int,
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


def _launch(planes_u8, plan: RemapGroup, out_dtype, variant: str):
    """planes_u8: CUDA uint8 [B, N, C, H, W]; returns the flat output
    [B, C * total] after one kernel launch."""
    if planes_u8.dtype != torch.uint8 or planes_u8.dim() != 5:
        raise ValueError(
            f"want uint8 [B, N, C, H, W], got {planes_u8.dtype} {tuple(planes_u8.shape)}"
        )
    b, n, nc = planes_u8.shape[:3]
    if nc not in (1, 2, 3):
        raise ValueError(f"channel count {nc} not in (1, 2, 3)")
    if n != len(plan.out_shapes) or tuple(planes_u8.shape[3:]) != plan.in_shape:
        raise ValueError(
            f"planes {tuple(planes_u8.shape)} do not match the plan: "
            f"{len(plan.out_shapes)} inputs of {plan.in_shape}"
        )
    if not planes_u8.is_contiguous():
        raise ValueError("planes must be contiguous")
    if out_dtype not in _OUT_TAGS:
        raise ValueError(f"out_dtype {out_dtype} not in (float32, bfloat16)")
    for t in (plan.x0, plan.y0, plan.fx, plan.fy, plan.offsets):
        if t.device != planes_u8.device:
            raise ValueError(f"plan on {t.device}, planes on {planes_u8.device}")
    total = plan.starts[-1]
    out = torch.empty((b, nc * total), dtype=out_dtype, device=planes_u8.device)
    max_count = max(e - s for s, e in zip(plan.starts[:-1], plan.starts[1:]))
    if max_count == 0 or b == 0:
        return out
    H, W = plan.in_shape
    with torch.cuda.device(planes_u8.device):
        err = _entry(nc, out_dtype)(
            planes_u8.data_ptr(),
            plan.x0.data_ptr(),
            plan.y0.data_ptr(),
            plan.fx.data_ptr(),
            plan.fy.data_ptr(),
            plan.offsets.data_ptr(),
            out.data_ptr(),
            b,
            n,
            max_count,
            total,
            H,
            W,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"remap kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    key = f"{variant}nc{nc}_{_OUT_TAGS[out_dtype]}"
    COUNTS[key] = COUNTS.get(key, 0) + 1
    return out


def _check_device(planes_u8):
    if planes_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {planes_u8.device}")


def remap_apply(planes_u8, plan: RemapGroup, out_dtype=torch.float32):
    """planes_u8: uint8 [N, C, H, W], C in {1, 2, 3}, one plane stack per
    input of the group.  Returns per input a [C, rh, rw] view of one
    output buffer, in ``out_dtype`` (float32 or bfloat16)."""
    if planes_u8.device.type == "cpu":
        return remap_apply_reference(planes_u8, plan, out_dtype)
    _check_device(planes_u8)
    if planes_u8.dim() != 4:
        raise ValueError(f"want [N, C, H, W], got {tuple(planes_u8.shape)}")
    out = _launch(planes_u8[None], plan, out_dtype, "")
    return [o[0] for o in split_frame_outputs(out, plan, planes_u8.shape[1])]


def remap_apply_frames(planes_u8, plan: RemapGroup, out_dtype=torch.float32):
    """planes_u8: uint8 [B, N, C, H, W], B frames of the group's N inputs,
    in one launch.  Returns per input a [B, C, rh, rw] view of one output
    buffer."""
    if planes_u8.device.type == "cpu":
        return remap_apply_frames_reference(planes_u8, plan, out_dtype)
    _check_device(planes_u8)
    out = _launch(planes_u8, plan, out_dtype, "frames_")
    return split_frame_outputs(out, plan, planes_u8.shape[2])
