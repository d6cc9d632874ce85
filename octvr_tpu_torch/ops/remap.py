"""The remap gather: host plan and its plain torch version.

The maps are static per template, so all bilinear arithmetic is done
once on the host (``remap_plan``, the f64 arithmetic of
octvr_tpu/ops/remap.py).  The per-frame op gathers uint8 source planes
through the plan.  ``remap_apply_reference`` is the plain torch version:
the CPU path, and what the CUDA kernel (ops/cuda_remap.py) is held
against on the card.

Planes flow planar [C, H, W], C in {1, 2, 3} (Y, U|V, RGB); a size
group of N same-size inputs stacks them [N, C, H, W], and B frames of a
group [B, N, C, H, W] (``remap_apply_frames_reference``).

Source blocks (the concat-source layout of
octvr_tpu/ops/pallas_remap.py, ``merge_remap_plans`` with a list of
heights): each input may read a source of its own height, e.g. a slice
of camera rows.  One frame's source is then the blocks [C, h_b, W]
flattened and concatenated in block order (``concat_source``), and
input i reads block ``blocks[i]``; several inputs may read one block.
The plain stack [N, C, H, W] is the case where input i reads block i
and every height is H.
"""

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "RemapGroup",
    "RemapPlan",
    "concat_source",
    "flat_source",
    "remap_apply_frames_reference",
    "remap_apply_reference",
    "remap_group",
    "remap_plan",
    "remap_taps",
    "split_frame_outputs",
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
    """Device plan of one launch: N inputs' per-pixel taps concatenated.
    Input i owns entries [starts[i], starts[i+1]) and the output block
    [NC*starts[i], NC*starts[i+1]), laid out [NC, rh, rw].  It reads the
    source block whose first row (counted in rows of one channel) is
    ``src_row0[i]`` and whose height is ``src_h[i]``."""

    x0: torch.Tensor  # int32 [total], -1 where invalid
    y0: torch.Tensor  # int32 [total]
    fx: torch.Tensor  # f32 [total]
    fy: torch.Tensor  # f32 [total]
    offsets: torch.Tensor  # int64 [N+1], on the plan's device
    src_table: torch.Tensor  # int64 [2N]: src_row0, then src_h
    starts: tuple  # host copy of offsets
    total: int  # starts[-1]: output pixels of one channel of a frame
    max_count: int  # the most output pixels of one input
    out_shapes: tuple  # per input (rh, rw)
    in_shape: tuple  # (H, W); H is None when the heights differ
    src_row0: tuple  # per input, its block's first row
    src_h: tuple  # per input, its block's height
    src_rows: int  # rows of one channel of a frame's source
    concat: bool  # the blocks are camera-row slices (TPU kernel 6)

    @property
    def stacked(self) -> bool:
        """Input i reads block i and all heights are equal: the source
        may be given as a plain [N, C, H, W] stack."""
        h = self.in_shape[0]
        return h is not None and self.src_row0 == tuple(range(0, h * len(self.src_h), h))



def remap_group(plans, device, blocks=None, concat=None) -> RemapGroup:
    """Concatenate RemapPlans into one device plan.  ``blocks`` gives
    per plan the source block it reads (default: plan i reads block i);
    a block's height is its plans' source height, and the blocks stack
    in index order.  All plans share one source width.  ``concat``: the
    blocks are slices of camera rows (TPU kernel 6's concat-source
    mode); None means "the heights differ"."""
    blocks = list(range(len(plans))) if blocks is None else list(blocks)
    width = plans[0].in_shape[1]
    assert all(p.in_shape[1] == width for p in plans), "mixed source widths"
    heights = {}
    for b, p in zip(blocks, plans):
        assert heights.setdefault(b, p.in_shape[0]) == p.in_shape[0], f"block {b}: mixed heights"
    assert sorted(heights) == list(range(len(heights))), f"blocks {sorted(heights)} not 0..n-1"
    block_row0 = np.concatenate([[0], np.cumsum([heights[b] for b in range(len(heights))])])
    src_row0 = tuple(int(block_row0[b]) for b in blocks)
    src_h = tuple(p.in_shape[0] for p in plans)
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
        src_table=torch.tensor(src_row0 + src_h, dtype=torch.int64, device=device),
        starts=tuple(int(s) for s in starts),
        total=int(starts[-1]),
        max_count=int(np.diff(starts).max()),
        out_shapes=tuple(p.out_shape for p in plans),
        in_shape=(src_h[0] if len(set(src_h)) == 1 else None, width),
        src_row0=src_row0,
        src_h=src_h,
        src_rows=int(block_row0[-1]),
        concat=len(set(src_h)) > 1 if concat is None else bool(concat),
    )


def _per_pixel(plan: RemapGroup, per_input):
    """A per-input value repeated over each input's output pixels."""
    counts = plan.offsets[1:] - plan.offsets[:-1]
    return torch.repeat_interleave(per_input, counts, output_size=plan.starts[-1])


def remap_taps(plan: RemapGroup):
    """(idx int64 [4, total], w f32 [4, total]) flat taps and weights
    within each input's [h, W] source plane, derived from the per-pixel
    plan exactly as remap_plan derives its ``idx``/``w`` (same f32
    formulas; 0 index and weight where invalid).  The bottom clamp is at
    the input's own source height."""
    W = plan.in_shape[1]
    valid = plan.x0 >= 0
    x0 = plan.x0.clamp(min=0).long()
    y0 = plan.y0.clamp(min=0).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = torch.minimum(y0 + 1, _per_pixel(plan, plan.src_table[len(plan.src_h) :]) - 1)
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
    fx, fy = plan.fx, plan.fy
    w = torch.stack(
        [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    )
    return idx * valid, w * valid


def concat_source(parts, frames: bool = False):
    """One launch's flat source from its blocks in block order: each
    part a uint8 [C, h, W] block or a [k, C, h, W] run of k blocks (with
    ``frames``, a leading B axis on every part).  Returns [C*rows*W], or
    [B, C*rows*W] with ``frames``."""
    if frames:
        return torch.cat([p.reshape(p.shape[0], -1) for p in parts], dim=1)
    return torch.cat([p.reshape(-1) for p in parts])


def flat_source(src, plan: RemapGroup, frames: bool):
    """(flat uint8 [B, C*rows*W], C) from a plain stack [N, C, H, W]
    ([B, N, C, H, W] with ``frames``; stacked plans only) or a flat
    source [C*rows*W] ([B, C*rows*W]) built by ``concat_source``."""
    if src.dtype != torch.uint8:
        raise ValueError(f"want a uint8 source, got {src.dtype}")
    lead = 1 if frames else 0
    if src.dim() == 4 + lead:
        n, c = src.shape[lead : lead + 2]
        if not plan.stacked or n != len(plan.out_shapes) or tuple(src.shape[lead + 2 :]) != plan.in_shape:
            raise ValueError(
                f"planes {tuple(src.shape)} do not match the plan: "
                f"{len(plan.out_shapes)} inputs of {plan.in_shape}"
                + ("" if plan.stacked else " in source blocks (pass a flat source)")
            )
        if c not in (1, 2, 3):
            raise ValueError(f"channel count {c} not in (1, 2, 3)")
        return src.reshape(src.shape[0] if frames else 1, -1), int(c)
    if src.dim() != 1 + lead:
        raise ValueError(
            f"want {4 + lead}-d planes or a {1 + lead}-d flat source, got {tuple(src.shape)}"
        )
    plane = plan.src_rows * plan.in_shape[1]
    n = src.shape[-1]
    if n % plane or n // plane not in (1, 2, 3):
        raise ValueError(f"flat source of {n} bytes is not 1, 2 or 3 channels of {plane}")
    return src.reshape(src.shape[0] if frames else 1, -1), n // plane


def split_frame_outputs(out: torch.Tensor, plan: RemapGroup, nc: int, run: int = 1):
    """Flat B-frame output [B, nc * total] -> per input [B, nc, rh, rw]
    views; with ``run`` > 1, per run of ``run`` consecutive inputs of one
    output shape a [B, run, nc, rh, rw] view."""
    b = out.shape[0]
    views = []
    for k in range(0, len(plan.out_shapes), run):
        (rh, rw), s, e = plan.out_shapes[k], plan.starts[k], plan.starts[k + run]
        if e - s != run * rh * rw:
            raise ValueError(f"inputs {k}..{k + run - 1} differ in output shape")
        v = out[:, nc * s : nc * e].view(b, run, nc, rh, rw)
        views.append(v if run > 1 else v[:, 0])
    return views


def _gather(flat, plan: RemapGroup, c: int, out_dtype):
    """One frame: flat uint8 [C*rows*W] -> flat output [c * total]: four
    flat gathers per pixel, accumulated in f32, cast at the store;
    invalid pixels are exactly 0."""
    n = len(plan.src_h)
    W = plan.in_shape[1]
    idx, w = remap_taps(plan)
    row0 = _per_pixel(plan, plan.src_table[:n])
    height = _per_pixel(plan, plan.src_table[n:])
    acc = []
    for ch in range(c):
        base = (c * row0 + ch * height) * W
        a = torch.zeros(plan.starts[-1], dtype=torch.float32, device=flat.device)
        for k in range(4):
            a = a + flat[base + idx[k]].float() * w[k]
        acc.append(a)
    acc = torch.stack(acc)
    return torch.cat(
        [acc[:, s:e].reshape(-1) for s, e in zip(plan.starts[:-1], plan.starts[1:])]
    ).to(out_dtype)


def remap_apply_reference(src, plan: RemapGroup, out_dtype=torch.float32, run: int = 1):
    """src: uint8 planes [N, C, H, W], C in {1, 2, 3}, or a flat source
    (``concat_source``).  Returns per input a [C, rh, rw] tensor in
    ``out_dtype`` (per run of inputs [run, C, rh, rw], see
    ``split_frame_outputs``)."""
    flat, c = flat_source(src, plan, frames=False)
    out = _gather(flat[0], plan, c, out_dtype)
    return [o[0] for o in split_frame_outputs(out[None], plan, c, run)]


def remap_apply_frames_reference(src, plan: RemapGroup, out_dtype=torch.float32, run: int = 1):
    """src: uint8 [B, N, C, H, W] or a flat [B, C*rows*W].  Returns per
    input a [B, C, rh, rw] tensor: ``remap_apply_reference`` frame by
    frame."""
    flat, c = flat_source(src, plan, frames=True)
    out = torch.stack([_gather(f, plan, c, out_dtype) for f in flat])
    return split_frame_outputs(out, plan, c, run)
