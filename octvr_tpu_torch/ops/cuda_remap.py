"""Wrapper of the Hopper remap kernel (csrc/remap.cu).

``remap_apply`` takes the plain torch version for a CPU tensor and
launches the CUDA kernel for a CUDA tensor; there is no fallback from
one to the other.  ``LAUNCHES`` counts kernel launches, so a run can show
that its main path went through the kernel.
"""

import ctypes

import torch

from ..utils.build import load_library
from .remap import RemapGroup, remap_apply_reference, split_outputs

__all__ = ["LAUNCHES", "remap_apply"]

LAUNCHES = 0

_OUT_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [
    ctypes.c_int,
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_int,
    ctypes.c_void_p,
]


def _entry(nc: int, out_dtype):
    fn = getattr(load_library(), f"octvr_remap_nc{nc}_{_OUT_TAGS[out_dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def remap_apply(planes_u8, plan: RemapGroup, out_dtype=torch.float32):
    """planes_u8: uint8 [N, C, H, W], C in {1, 2}, one plane stack per
    input of the group.  Returns per input a [C, rh, rw] view of one
    output buffer, in ``out_dtype`` (float32 or bfloat16)."""
    if planes_u8.device.type == "cpu":
        return remap_apply_reference(planes_u8, plan, out_dtype)
    if planes_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {planes_u8.device}")
    if planes_u8.dtype != torch.uint8 or planes_u8.dim() != 4:
        raise ValueError(f"want uint8 [N, C, H, W], got {planes_u8.dtype} {tuple(planes_u8.shape)}")
    n, nc = planes_u8.shape[:2]
    if nc not in (1, 2):
        raise ValueError(f"channel count {nc} not in (1, 2)")
    if n != len(plan.out_shapes) or tuple(planes_u8.shape[2:]) != plan.in_shape:
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
    out = torch.empty(nc * total, dtype=out_dtype, device=planes_u8.device)
    max_count = max(e - s for s, e in zip(plan.starts[:-1], plan.starts[1:]))
    if max_count == 0:
        return split_outputs(out, plan, nc)
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
            n,
            max_count,
            H,
            W,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"remap kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return split_outputs(out, plan, nc)
