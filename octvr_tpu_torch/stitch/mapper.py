"""The online Mapper, yuv420 path (octvr_tpu/stitch/mapper.py).

Per frame (packed YUV420P in and out):

    split planes -> vignette -> quantize to uint8 -> remap Y (full res)
    and U|V (half res) with the CUDA kernel, one launch per plane per
    size group -> centre chroma -> working-grid norms -> gain solve and
    apply -> multiband blend of Y and of UV -> round -> YUV420P

The plan is built once on the host in numpy (the JAX package's own
arithmetic) and moved to the device as tensors; the frame path is eager
torch plus the remap kernel, with no host round trip.

This port carries the yuv420 pipeline with multiband blending and global
gains, for one or more equal-size camera groups.  Everything else the
JAX Mapper does raises NotImplementedError naming its ROADMAP.md item.
"""

import math
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from octvr_tpu.ops.resize import resize_bilinear
from octvr_tpu.template.compiler import MapperTemplate

from ..ops.color import merge_yuv420p, split_yuv420p
from ..ops.cuda_remap import remap_apply
from ..ops.remap import remap_group, remap_plan
from ..utils.device import resolve_device, tree_to
from .blenders import build_multiband_plan, multiband_blend
from .gain import build_gain_plan, solve_gains
from .yuv_mode import half_mask, half_maps, half_roi, yuv_rgb_norm

WORKING_MEGAPIX = 0.1  # mapper.cpp:43

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1, item 10)"

__all__ = ["Mapper", "StitchPlan", "build_plan"]


def _pool_pow2(x, s, col_mat=None):
    """[C, H, W] -> [C, H/s, W/s] box mean, s a power of two: rows by
    log2(s) pairwise halvings, columns by ``col_mat`` ([W, W/s]) when
    given, else by halvings too (octvr_tpu's order of operations)."""
    if col_mat is not None:
        s0 = s
        while s0 > 1:
            x = (x[:, 0::2, :] + x[:, 1::2, :]) * 0.5
            s0 >>= 1
        return x @ col_mat
    while s > 1:
        x = (x[:, 0::2, :] + x[:, 1::2, :]) * 0.5
        x = (x[:, :, 0::2] + x[:, :, 1::2]) * 0.5
        s >>= 1
    return x


def _pool_cols_matrix(w, s):
    """[w, w/s] box-mean pooling matrix for _pool_pow2's column step."""
    M = np.zeros((w, w // s), dtype=np.float32)
    cols = np.arange((w // s) * s)
    M[cols, cols // s] = 1.0 / s
    return M


@dataclass
class _InputPlan:
    # working-scale image spec: (oy, ox, stride, wh, ww) -- stride x
    # stride box means over canvas-aligned blocks of the warped ROI
    work_sub: tuple
    vignette: object  # f32 [H_in, W_in] or None
    vig_half: object  # f32 [H_in/2, W_in/2] chroma-grid vignette or None
    pool_cols: object = None  # [ww*s, ww] box-mean matrix (stride > 1)
    # chroma sampled onto the luma working grid: stride >= 2 pools the
    # chroma plane at stride/2; stride == 1 gathers nearest rows/cols
    work_sub_uv: Optional[tuple] = None  # (oy, ox, stride/2, wh, ww)
    pool_cols_uv: object = None  # [ww*su, ww] box-mean matrix (su > 1)
    uv_rows: object = None  # i32 [wh] chroma row gather (stride == 1)
    uv_cols: object = None  # i32 [ww] chroma col gather (stride == 1)


@dataclass
class StitchPlan:
    """The yuv420 stitch plan.  Built on the host by :func:`build_plan`
    (numpy arrays; remap groups as tuples of per-input RemapPlans) and
    moved to a device by :meth:`to` (tensors; remap groups as
    RemapGroups)."""

    canvas_size: tuple  # (W, H)
    inputs: List[_InputPlan]
    gain: object  # GainPlan or None
    blender: object  # MultiBandPlan, luma grid
    blender_uv: object  # MultiBandPlan, chroma grid
    remap_y_groups: tuple  # per size group: full-res Y plans
    remap_uv_groups: tuple  # per size group: half-res U|V plans
    group_idx: tuple  # per size group: input indices

    def to(self, device):
        return replace(
            self,
            inputs=tree_to(self.inputs, device),
            gain=tree_to(self.gain, device),
            blender=self.blender.to(device),
            blender_uv=self.blender_uv.to(device),
            remap_y_groups=tuple(
                remap_group(g, device) for g in self.remap_y_groups
            ),
            remap_uv_groups=tuple(
                remap_group(g, device) for g in self.remap_uv_groups
            ),
        )


def _working_stride(W, H):
    """Integer canvas stride of the 0.1 MP working scale, rounded to a
    power of two (mapper.py of the JAX package)."""
    working_scale = min(1.0, math.sqrt(WORKING_MEGAPIX * 1e6 / (W * H)))
    stride = max(1, int(round(1.0 / working_scale)))
    return 1 << max(0, int(round(math.log2(stride))))


def _input_plan(inp, in_h, in_w, stride):
    """Per-input geometry, vignettes and working-grid sampling, plus the
    input's working mask and working roi for the gain plan."""
    rx, ry, rw, rh = inp.roi
    gx = -(-rx // stride)  # first full block inside the roi
    gy = -(-ry // stride)
    ox, oy = gx * stride - rx, gy * stride - ry
    ww = (rw - ox) // stride
    wh = (rh - oy) // stride
    work_sub = (oy, ox, stride, wh, ww)
    wroi = (gx, gy, ww, wh)
    mb = (inp.mask > 0).astype(np.float32)[
        oy : oy + wh * stride, ox : ox + ww * stride
    ]
    pooled = mb.reshape(wh, stride, ww, stride).mean(axis=(1, 3))
    # a block counts only when fully covered by the mask
    work_mask = (pooled > 0.999).astype(np.uint8) * 255

    vig = vig_half = None
    if inp.vignette is not None:
        vig = np.asarray(resize_bilinear(inp.vignette, in_h, in_w)).astype(
            np.float32
        )
        vig_half = (
            vig.reshape(in_h // 2, 2, in_w // 2, 2)
            .mean(axis=(1, 3))
            .astype(np.float32)
        )

    ip = _InputPlan(
        work_sub=work_sub,
        vignette=vig,
        vig_half=vig_half,
        pool_cols=_pool_cols_matrix(ww * stride, stride) if stride > 1 else None,
    )
    cx0, cy0 = half_roi(inp.roi)[:2]
    if stride >= 2:
        su = stride // 2
        ip.work_sub_uv = ((ry + oy) // 2 - cy0, (rx + ox) // 2 - cx0, su, wh, ww)
        if su > 1:
            ip.pool_cols_uv = _pool_cols_matrix(ww * su, su)
    else:
        ip.uv_rows = ((ry + oy + np.arange(wh)) // 2 - cy0).astype(np.int32)
        ip.uv_cols = ((rx + ox + np.arange(ww)) // 2 - cx0).astype(np.int32)
    return ip, work_mask, wroi


def build_plan(
    mt: MapperTemplate, in_sizes, blend: int, enable_gain: bool, blend_dtype: str
) -> StitchPlan:
    """Host (numpy) plan of the yuv420 pipeline with multiband blending
    (``blend`` > 0) and optional global gains."""
    W, H = mt.out_size
    stride = _working_stride(W, H)
    inputs, work_masks, work_rois = [], [], []
    for inp, (in_h, in_w) in zip(mt.inputs, in_sizes):
        ip, wm, wroi = _input_plan(inp, in_h, in_w, stride)
        inputs.append(ip)
        work_masks.append(wm)
        work_rois.append(wroi)

    rois = [inp.roi for inp in mt.inputs]
    num_bands = int(math.ceil(math.log(blend) / math.log(2.0)) - 1.0)
    seams_uv = [half_mask(sm, i.roi) for sm, i in zip(mt.seam_masks, mt.inputs)]

    # equal-size cameras share one kernel launch per plane (size groups)
    by_size = {}
    for idx, hw in enumerate(map(tuple, in_sizes)):
        by_size.setdefault(hw, []).append(idx)
    group_idx = tuple(tuple(v) for v in by_size.values())
    remap_y_groups, remap_uv_groups = remap_groups(mt, in_sizes, group_idx)
    return StitchPlan(
        canvas_size=(W, H),
        inputs=inputs,
        gain=build_gain_plan(work_masks, work_rois) if enable_gain else None,
        blender=build_multiband_plan(
            mt.seam_masks, rois, num_bands, (W, H), dtype=blend_dtype
        ),
        blender_uv=build_multiband_plan(
            seams_uv,
            [half_roi(r) for r in rois],
            max(1, num_bands - 1),
            (W // 2, H // 2),
            dtype=blend_dtype,
        ),
        remap_y_groups=remap_y_groups,
        remap_uv_groups=remap_uv_groups,
        group_idx=group_idx,
    )


def remap_groups(mt, in_sizes, group_idx):
    """Per size group, the full-res Y RemapPlans and the half-res U|V
    RemapPlans (through the inputs' half_maps) of its inputs."""
    hm = [half_maps(i.map1, i.map2, i.roi) for i in mt.inputs]
    y_groups = tuple(
        tuple(
            remap_plan(mt.inputs[i].map1, mt.inputs[i].map2, *in_sizes[i])
            for i in idxs
        )
        for idxs in group_idx
    )
    uv_groups = tuple(
        tuple(
            remap_plan(hm[i][0], hm[i][1], in_sizes[i][0] // 2, in_sizes[i][1] // 2)
            for i in idxs
        )
        for idxs in group_idx
    )
    return y_groups, uv_groups


def _quantize(x):
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


class Mapper:
    """yuv420 Mapper on a torch device.

    ``device`` is required ("cuda", "cuda:N" or "cpu"); "cuda" without a
    card raises.  blend: > 0 multiband blend width.  enable_gain: global
    pairwise gains.  blend_dtype: multiband pyramid precision, "float32"
    or "bfloat16"; None picks bfloat16 on CUDA and float32 on the CPU.
    pipeline: "yuv420", or "auto", which picks yuv420 on CUDA when the
    geometry is even and rgb otherwise."""

    def __init__(
        self,
        mt: MapperTemplate,
        in_sizes,
        blend: int = 128,
        enable_gain: bool = True,
        scale_output=None,
        frame_format: str = "yuv420p",
        blend_dtype: str = None,
        pipeline: str = "auto",
        *,
        device,
    ):
        dev = resolve_device(device)
        on_cuda = dev.type == "cuda"
        if frame_format != "yuv420p":
            raise NotImplementedError(f"frame_format={frame_format!r} {_NOT_PORTED}")
        if pipeline not in ("auto", "rgb", "yuv420"):
            raise ValueError(f"unknown pipeline {pipeline!r}")
        W, H = mt.out_size
        if scale_output is not None and tuple(scale_output) != (W, H):
            raise NotImplementedError(f"scale_output {_NOT_PORTED}")
        if mt.overlay_inputs:
            raise NotImplementedError(f"overlay inputs {_NOT_PORTED}")
        even = (
            W % 2 == 0
            and H % 2 == 0
            and all(h % 2 == 0 and w % 2 == 0 for h, w in in_sizes)
        )
        if pipeline == "auto":
            pipeline = "yuv420" if (on_cuda and even) else "rgb"
        if pipeline == "rgb":
            raise NotImplementedError(f"the rgb pipeline {_NOT_PORTED}")
        if not even:
            raise ValueError("yuv420 pipeline needs even frame geometry")
        if len(mt.inputs) == 1:
            blend, enable_gain = 0, False
        if blend == 0:
            raise NotImplementedError(f"no-blend paste {_NOT_PORTED}")
        if blend < 0:
            raise NotImplementedError(f"feather blending {_NOT_PORTED}")
        if enable_gain == "blocks":
            raise NotImplementedError(f"blocks gains {_NOT_PORTED}")
        if blend_dtype is None:
            blend_dtype = "bfloat16" if on_cuda else "float32"
        if len(in_sizes) != len(mt.inputs):
            raise ValueError(f"{len(in_sizes)} sizes for {len(mt.inputs)} inputs")
        host = build_plan(mt, in_sizes, blend, bool(enable_gain), blend_dtype)
        self._bind(host.to(dev), dev)

    @classmethod
    def from_plan(cls, plan: StitchPlan, device):
        """Mapper over a plan already on ``device`` (StitchPlan.to, or
        stitch.convert.plan_from_jax)."""
        self = cls.__new__(cls)
        self._bind(plan, resolve_device(device))
        return self

    def _bind(self, plan, device):
        self.plan = plan
        self.device = device
        self.num_inputs = len(plan.inputs)
        self.in_sizes = [None] * self.num_inputs
        for idxs, g in zip(plan.group_idx, plan.remap_y_groups):
            for i in idxs:
                self.in_sizes[i] = g.in_shape

    # ------------------------------------------------------------ forward

    def _prep_yuv(self, frames):
        """Split, vignette, round and clip to uint8: per input a Y plane
        [H, W] and a U|V stack [2, H/2, W/2]."""
        ys, uvs = [], []
        for buf, ip in zip(frames, self.plan.inputs):
            y, u, v = split_yuv420p(buf)
            if ip.vignette is None:
                ys.append(y)
                uvs.append(torch.stack([u, v]))
                continue
            ys.append(_quantize(torch.clamp(y.float() * ip.vignette, 0.0, 255.0)))
            uv = torch.stack([u, v]).float()
            uvs.append(
                _quantize(torch.clamp((uv - 128.0) * ip.vig_half + 128.0, 0.0, 255.0))
            )
        return ys, uvs

    def _forward_yuv(self, frames, ext_gains):
        plan = self.plan
        remap_dtype = getattr(torch, plan.blender.compute_dtype)
        ys, uvs = self._prep_yuv(frames)
        warped_y = [None] * self.num_inputs
        warped_uv = [None] * self.num_inputs
        for idxs, rp_y, rp_uv in zip(
            plan.group_idx, plan.remap_y_groups, plan.remap_uv_groups
        ):
            outs_y = remap_apply(
                torch.stack([ys[i][None] for i in idxs]), rp_y, remap_dtype
            )
            outs_uv = remap_apply(
                torch.stack([uvs[i] for i in idxs]), rp_uv, remap_dtype
            )
            for i, wy, wuv in zip(idxs, outs_y, outs_uv):
                warped_y[i] = wy
                warped_uv[i] = wuv
        return self._postwarp_yuv(warped_y, warped_uv, ext_gains)

    def _postwarp_yuv(self, warped_y, warped_uv, ext_gains):
        """Chroma centring, gains, the two blends, packed output.  Chroma
        rides centred (U-128, V-128) through gains and blend; uncovered
        pixels stay 0 and become neutral 128 at the output."""
        plan = self.plan
        W, H = plan.canvas_size
        warped_uv = [wuv - 128.0 for wuv in warped_uv]

        gains = None
        if plan.gain is not None:
            work_norms = []
            for wy, wuv, ip in zip(warped_y, warped_uv, plan.inputs):
                oy, ox, s, wh, ww = ip.work_sub
                yimg = wy[:, oy : oy + wh * s, ox : ox + ww * s].float()
                yimg = _pool_pow2(yimg, s, col_mat=ip.pool_cols)
                if ip.work_sub_uv is not None:
                    oyu, oxu, su, _, _ = ip.work_sub_uv
                    uvimg = wuv[:, oyu : oyu + wh * su, oxu : oxu + ww * su].float()
                    uvimg = _pool_pow2(uvimg, su, col_mat=ip.pool_cols_uv)
                else:  # stride 1: nearest chroma gather
                    uvimg = wuv.float()[:, ip.uv_rows][:, :, ip.uv_cols]
                work_norms.append(yuv_rgb_norm(yimg[0], uvimg[0], uvimg[1]))
            gains = solve_gains(plan.gain, work_norms) if ext_gains is None else ext_gains
            # cast the scalar, not the image: f32 * bf16 would promote
            warped_y = [w * gains[i].to(w.dtype) for i, w in enumerate(warped_y)]
            warped_uv = [w * gains[i].to(w.dtype) for i, w in enumerate(warped_uv)]

        y_canvas = multiband_blend(plan.blender, warped_y, (W, H))
        uv_canvas = multiband_blend(plan.blender_uv, warped_uv, (W // 2, H // 2))
        y8 = _quantize(y_canvas[0])
        uv8 = _quantize(uv_canvas + 128.0)
        out = merge_yuv420p(y8, uv8[0], uv8[1])
        if gains is None:
            gains = torch.ones(self.num_inputs, dtype=torch.float32, device=self.device)
        return out, gains

    # ------------------------------------------------------------- public

    def stitch(self, frames, gains=None):
        """frames: per input a packed YUV420P uint8 [Hi*3/2, Wi] tensor or
        array.  Returns (out uint8 [H*3/2, W], gains f32 [n]) on the
        Mapper's device.  ``gains`` ([n]) replaces the solved exposure
        gains (gain sharing between outputs, async.cpp:75-91)."""
        if len(frames) != self.num_inputs:
            raise ValueError(f"{len(frames)} frames for {self.num_inputs} inputs")
        bufs = []
        for f, (h, w) in zip(frames, self.in_sizes):
            if not isinstance(f, torch.Tensor):
                f = torch.from_numpy(np.array(f))  # a writable copy
            f = f.to(self.device)
            if f.dtype != torch.uint8 or tuple(f.shape) != (h * 3 // 2, w):
                raise ValueError(
                    f"want uint8 [{h * 3 // 2}, {w}], got {f.dtype} {tuple(f.shape)}"
                )
            bufs.append(f)
        if gains is not None:
            gains = torch.as_tensor(gains, dtype=torch.float32, device=self.device)
        return self._forward_yuv(bufs, gains)

    def stitch_batch(self, frames, gains=None):
        raise NotImplementedError(
            "stitch_batch is not ported yet (ROADMAP.md, queue 1, item 11)"
        )
