"""The remap gather: host plan and its plain torch version.

The maps are static per template, so all bilinear arithmetic is done
once on the host (``remap_plan``, the f64 arithmetic of
octvr_tpu/ops/remap.py).  The per-frame op gathers uint8 source planes
through the plan.  ``remap_apply_reference`` is the plain torch version:
the CPU path, and what the CUDA kernel (ops/cuda_remap.py) is held
against on the card.

Planes flow planar [C, H, W]; a size group of N same-size inputs stacks
them [N, C, H, W].
"""

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "RemapGroup",
    "RemapPlan",
    "remap_apply_reference",
    "remap_group",
    "remap_plan",
    "remap_taps",
    "split_outputs",
]


@dataclass(frozen=True)
class RemapPlan:
    """Host gather plan for one (map, input-size) pair.

    idx:  int32 [4, rh*rw]  flat tap indices y*W + x (0 where invalid)
    w:    f32   [4, rh*rw]  bilinear weights (0 where invalid)
    x0, y0: int32 [rh*rw]   clipped top-left tap, -1 where invalid
    fx, fy: f32   [rh*rw]   fractional offsets (before the clip)
    """

    idx: np.ndarray
    w: np.ndarray
    x0: np.ndarray
    y0: np.ndarray
    fx: np.ndarray
    fy: np.ndarray
    out_shape: tuple
    in_shape: tuple


def remap_plan(map1: np.ndarray, map2: np.ndarray, in_h: int, in_w: int) -> RemapPlan:
    """Build the gather plan from normalized maps (f32 [rh, rw], -1 where
    invalid): px = map1 * W - 0.5 with clamp-to-edge, the arithmetic of
    octvr_tpu/ops/remap.py::remap_plan."""
    rh, rw = map1.shape
    px = map1.astype(np.float64) * in_w - 0.5
    py = map2.astype(np.float64) * in_h - 0.5
    invalid = (map1 < 0).reshape(-1)

    x0 = np.floor(px)
    y0 = np.floor(py)
    fx = (px - x0).astype(np.float32)
    fy = (py - y0).astype(np.float32)
    x0 = np.clip(x0, 0, in_w - 1).astype(np.int32)
    y0 = np.clip(y0, 0, in_h - 1).astype(np.int32)
    x1 = np.minimum(x0 + 1, in_w - 1)
    y1 = np.minimum(y0 + 1, in_h - 1)

    idx = np.stack(
        [y0 * in_w + x0, y0 * in_w + x1, y1 * in_w + x0, y1 * in_w + x1]
    ).reshape(4, -1)
    w = np.stack(
        [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    ).reshape(4, -1)
    w[:, invalid] = 0.0
    idx[:, invalid] = 0
    x0 = x0.reshape(-1)
    y0 = y0.reshape(-1)
    x0[invalid] = -1
    y0[invalid] = -1
    return RemapPlan(
        idx=idx,
        w=w.astype(np.float32),
        x0=x0,
        y0=y0,
        fx=fx.reshape(-1),
        fy=fy.reshape(-1),
        out_shape=(rh, rw),
        in_shape=(in_h, in_w),
    )


@dataclass(frozen=True)
class RemapGroup:
    """Device plan of one size group: N inputs' per-pixel taps
    concatenated.  Input i owns entries [starts[i], starts[i+1]) and the
    output block [NC*starts[i], NC*starts[i+1]), laid out [NC, rh, rw]."""

    x0: torch.Tensor  # int32 [total], -1 where invalid
    y0: torch.Tensor  # int32 [total]
    fx: torch.Tensor  # f32 [total]
    fy: torch.Tensor  # f32 [total]
    offsets: torch.Tensor  # int64 [N+1], on the plan's device
    starts: tuple  # host copy of offsets
    out_shapes: tuple  # per input (rh, rw)
    in_shape: tuple  # (H, W) shared by the group


def remap_group(plans, device) -> RemapGroup:
    """Concatenate same-source-size RemapPlans into one device plan."""
    in_shape = plans[0].in_shape
    assert all(p.in_shape == in_shape for p in plans), "mixed source sizes"
    starts = np.concatenate(
        [[0], np.cumsum([p.x0.size for p in plans])]
    ).astype(np.int64)

    def cat(field):
        return torch.from_numpy(
            np.concatenate([getattr(p, field) for p in plans])
        ).to(device)

    return RemapGroup(
        x0=cat("x0"),
        y0=cat("y0"),
        fx=cat("fx"),
        fy=cat("fy"),
        offsets=torch.from_numpy(starts).to(device),
        starts=tuple(int(s) for s in starts),
        out_shapes=tuple(p.out_shape for p in plans),
        in_shape=tuple(in_shape),
    )


def remap_taps(plan: RemapGroup):
    """(idx int64 [4, total], w f32 [4, total]) flat taps and weights,
    derived from the per-pixel plan exactly as remap_plan derives its
    ``idx``/``w`` (same f32 formulas; 0 index and weight where invalid)."""
    H, W = plan.in_shape
    valid = plan.x0 >= 0
    x0 = plan.x0.clamp(min=0).long()
    y0 = plan.y0.clamp(min=0).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
    fx, fy = plan.fx, plan.fy
    w = torch.stack(
        [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    )
    return idx * valid, w * valid


def split_outputs(out: torch.Tensor, plan: RemapGroup, nc: int):
    """Flat group output -> per-input [nc, rh, rw] views."""
    return [
        out[nc * s : nc * e].view(nc, rh, rw)
        for s, e, (rh, rw) in zip(
            plan.starts[:-1], plan.starts[1:], plan.out_shapes
        )
    ]


def remap_apply_reference(planes_u8, plan: RemapGroup, out_dtype=torch.float32):
    """planes_u8: uint8 [N, C, H, W], C in {1, 2}.  Returns per input a
    [C, rh, rw] tensor in ``out_dtype``: four flat gathers per pixel,
    accumulated in f32, cast at the store; invalid pixels are exactly 0."""
    n, c = planes_u8.shape[:2]
    idx, w = remap_taps(plan)
    flat = planes_u8.reshape(n, c, -1)
    out = torch.empty(c * plan.starts[-1], dtype=out_dtype, device=planes_u8.device)
    for i, (s, e) in enumerate(zip(plan.starts[:-1], plan.starts[1:])):
        acc = torch.zeros((c, e - s), dtype=torch.float32, device=planes_u8.device)
        for k in range(4):
            acc = acc + flat[i][:, idx[k, s:e]].float() * w[k, s:e]
        out[c * s : c * e] = acc.reshape(-1).to(out_dtype)
    return split_outputs(out, plan, c)
