"""The online Mapper (octvr_tpu/stitch/mapper.py) and FastMapper.

Two pipelines, per frame (packed YUV420P or NV12 in and out):

    rgb:    planes -> planar RGB -> vignette -> quantize to uint8 ->
            remap (CUDA kernel, NC=3, one launch per size group) ->
            working-grid norms -> gains -> blend -> overlays -> clip ->
            (resize) -> YUV420P
    yuv420: planes -> vignette -> quantize to uint8 -> remap Y (full
            res, NC=1) and U|V (half res, NC=2), one launch per plane
            per size group -> centre chroma -> working-grid norms ->
            gains -> blend Y and UV -> overlays -> (resize) -> YUV420P

Blending is multiband (blend > 0), feather (blend < 0) or a paste in
which later inputs overwrite earlier ones (blend == 0); gains are off,
global (pairwise) or "blocks" (per-block gain maps).  The plan is built
once on the host in numpy (the JAX package's own arithmetic) and moved
to the device as tensors; the frame path is eager torch plus the remap
kernel, with no host round trip.  On a CUDA device ``Mapper.stitch``
records that path once as a CUDA graph and replays it on every later
call, so a frame costs the host a copy in, one graph launch and a copy
out instead of some 1,700 launches issued from Python.

A template may hold empty inputs (``template.compiler.empty_input``: a
camera that covers no pixel of the output, as the camera facing one
pole under the other pole's cap).  The plan is then built over the
covering inputs alone, exactly as over the rig without the empty
cameras, and keeps the map back to the rig: a call still takes one
frame per camera of the rig and checks it, but an empty camera's frame
is never copied, prepped, remapped, pooled or blended, and the gains
stay one per camera of the rig, 1.0 at an empty camera (a given gain
there is ignored).
"""

import math
import threading
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np
import torch


from ..ops import launch_counts
from ..ops.color import _quantize, merge_frame, rgb_planar_to_planes
from ..ops.cuda_remap import remap_apply, remap_apply_frames
from ..ops.pyramid import require_full_f32
from ..ops.remap import remap_group, remap_plan
from ..ops.resize import resize_apply, resize_plan
from ..runtime.timer import RECORDER
from ..template.compiler import MapperTemplate, is_empty
from ..utils.device import resolve_device, tree_to
from .blenders import (
    build_feather_plan,
    build_multiband_plan,
    feather_blend,
    multiband_blend,
)
from .frames import check_frames, prep_rgb, prep_yuv, vignette_maps
from .gain import build_gain_plan, solve_gains
from .gain_blocks import (
    build_blocks_gain_plan,
    sample_block_lattice,
    solve_block_gains,
    solve_block_lattice,
)
from .yuv_mode import half_mask, half_maps, half_roi, yuv_rgb_norm

WORKING_MEGAPIX = 0.1  # mapper.cpp:43

__all__ = ["FastMapper", "Mapper", "PLANS", "StitchPlan", "build_plan", "plan_shape"]

# The shape of every plan that build_plan builds, summed (``plan_shape``'s
# keys), so that a run can read what its remap grids and pyramid boxes
# sweep; PLANS.reset() sets it to 0.
PLANS = launch_counts.Counter()


def _pool_pow2(x, s, col_mat=None):
    """[C, H, W] -> [C, H/s, W/s] box mean, s a power of two: rows by
    log2(s) pairwise halvings, columns by ``col_mat`` ([W, W/s]) when
    given, else by halvings too (octvr_tpu's order of operations)."""
    if col_mat is not None:
        s0 = s
        while s0 > 1:
            x = (x[:, 0::2, :] + x[:, 1::2, :]) * 0.5
            s0 >>= 1
        require_full_f32()
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
    roi: tuple  # canvas (x, y, w, h)
    # working-scale image spec: (oy, ox, stride, wh, ww) -- stride x
    # stride box means over canvas-aligned blocks of the warped ROI;
    # None for overlays, which take no part in the gains
    work_sub: Optional[tuple]
    vignette: object  # f32 [H_in, W_in] or None
    mask: object  # u8 roi-sized (paste and overlay masks)
    pool_cols: object = None  # [ww*s, ww] box-mean matrix (stride > 1)
    # yuv420 pipeline extras
    vig_half: object = None  # f32 [H_in/2, W_in/2] chroma-grid vignette
    roi_uv: Optional[tuple] = None  # chroma-grid roi
    mask_half: object = None  # u8 chroma-grid mask
    # chroma sampled onto the luma working grid: stride >= 2 pools the
    # chroma plane at stride/2; stride == 1 gathers nearest rows/cols
    work_sub_uv: Optional[tuple] = None  # (oy, ox, stride/2, wh, ww)
    pool_cols_uv: object = None  # [ww*su, ww] box-mean matrix (su > 1)
    uv_rows: object = None  # i32 [wh] chroma row gather (stride == 1)
    uv_cols: object = None  # i32 [ww] chroma col gather (stride == 1)


@dataclass
class StitchPlan:
    """The stitch plan.  Built on the host by :func:`build_plan` (numpy
    arrays; remap groups as tuples of per-input RemapPlans) and moved to
    a device by :meth:`to` (tensors; remap groups as RemapGroups)."""

    canvas_size: tuple  # (W, H)
    out_size: tuple  # (W, H) after the optional output scaling
    pipeline: str  # "rgb" | "yuv420"
    blend_kind: str  # "multiband" | "feather" | "none"
    working_scale: float
    inputs: List[_InputPlan]
    overlays: List[_InputPlan] = field(default_factory=list)
    gain: object = None  # GainPlan (also built for "blocks": the sums)
    gain_blocks: object = None  # BlocksGainPlan
    blender: object = None  # MultiBandPlan | FeatherPlan, luma/RGB grid
    blender_uv: object = None  # the same on the chroma grid (yuv420)
    # per size group over inputs + overlays: full-res plans (Y in
    # yuv420, RGB in rgb) and half-res U|V plans (yuv420 only)
    remap_groups: tuple = ()
    remap_uv_groups: tuple = ()
    group_idx: tuple = ()  # per size group: indices into inputs + overlays
    resize: object = None  # ResizePlan canvas -> out_size (Y or RGB)
    resize_uv: object = None  # ResizePlan of the chroma planes (yuv420)
    # a template with empty inputs: per frame of a call (cameras of the
    # rig, then overlay inputs) its (H, W), and per input then overlay of
    # the plan the index of its frame; both empty when every camera covers
    frame_sizes: tuple = ()
    frame_idx: tuple = ()

    def to(self, device):
        def blender(b):
            return None if b is None else b.to(device)

        return replace(
            self,
            inputs=tree_to(self.inputs, device),
            overlays=tree_to(self.overlays, device),
            gain=tree_to(self.gain, device),
            gain_blocks=tree_to(self.gain_blocks, device),
            blender=blender(self.blender),
            blender_uv=blender(self.blender_uv),
            remap_groups=tuple(remap_group(g, device) for g in self.remap_groups),
            remap_uv_groups=tuple(
                remap_group(g, device) for g in self.remap_uv_groups
            ),
            resize=tree_to(self.resize, device),
            resize_uv=tree_to(self.resize_uv, device),
        )


def _working_stride(W, H):
    """Integer canvas stride of the 0.1 MP working scale, rounded to a
    power of two (mapper.py of the JAX package)."""
    working_scale = min(1.0, math.sqrt(WORKING_MEGAPIX * 1e6 / (W * H)))
    stride = max(1, int(round(1.0 / working_scale)))
    return 1 << max(0, int(round(math.log2(stride))))


def _input_plan(inp, in_h, in_w, stride, yuv, is_overlay):
    """Per-input geometry, vignettes and working-grid sampling, plus the
    input's working mask and working roi for the gain plans (None for an
    overlay)."""
    rx, ry, rw, rh = inp.roi
    work_sub = work_mask = wroi = None
    if not is_overlay:
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

    vig, vig_half = vignette_maps(inp.vignette, in_h, in_w, yuv)
    ip = _InputPlan(
        roi=inp.roi,
        work_sub=work_sub,
        vignette=vig,
        mask=inp.mask,
        pool_cols=(
            _pool_cols_matrix(work_sub[4] * stride, stride)
            if work_sub is not None and stride > 1
            else None
        ),
        vig_half=vig_half,
    )
    if yuv:
        ip.roi_uv = half_roi(inp.roi)
        cx0, cy0 = ip.roi_uv[:2]
        if work_sub is not None:
            oy, ox, s, wh, ww = work_sub
            if s >= 2:
                su = s // 2
                ip.work_sub_uv = ((ry + oy) // 2 - cy0, (rx + ox) // 2 - cx0, su, wh, ww)
                if su > 1:
                    ip.pool_cols_uv = _pool_cols_matrix(ww * su, su)
            else:
                ip.uv_rows = ((ry + oy + np.arange(wh)) // 2 - cy0).astype(np.int32)
                ip.uv_cols = ((rx + ox + np.arange(ww)) // 2 - cx0).astype(np.int32)
        ip.mask_half = (half_mask(inp.mask, inp.roi) > 0).astype(np.uint8) * 255
    return ip, work_mask, wroi


def size_groups(in_sizes):
    """Input indices grouped by source size, in first-seen order: equal-
    size inputs share one kernel launch per plane."""
    by_size = {}
    for idx, hw in enumerate(map(tuple, in_sizes)):
        by_size.setdefault(hw, []).append(idx)
    return tuple(tuple(v) for v in by_size.values())


def group_remap_plans(mt, in_sizes, group_idx, yuv):
    """Per size group, the full-res RemapPlans of its inputs (inputs then
    overlays) and, for yuv420, the half-res U|V RemapPlans (through the
    inputs' half_maps)."""
    all_inputs = mt.inputs + mt.overlay_inputs
    full = tuple(
        tuple(
            remap_plan(all_inputs[i].map1, all_inputs[i].map2, *in_sizes[i])
            for i in idxs
        )
        for idxs in group_idx
    )
    if not yuv:
        return full, ()
    hm = [half_maps(i.map1, i.map2, i.roi) for i in all_inputs]
    uv = tuple(
        tuple(
            remap_plan(hm[i][0], hm[i][1], in_sizes[i][0] // 2, in_sizes[i][1] // 2)
            for i in idxs
        )
        for idxs in group_idx
    )
    return full, uv


def resize_plans(canvas_size, out_size, yuv):
    """(full-grid, chroma-grid) ResizePlans, None when not scaling."""
    if tuple(out_size) == tuple(canvas_size):
        return None, None
    (W, H), (ow, oh) = canvas_size, out_size
    full = resize_plan(H, W, oh, ow)
    return full, (resize_plan(H // 2, W // 2, oh // 2, ow // 2) if yuv else None)


def plan_shape(mt: MapperTemplate):
    """The shape of a template's plan on the Y plane: ``plans`` 1, the
    ``inputs`` of the rig and the ``empty_inputs`` among them, the
    ``canvas_px``, and over the covering inputs the summed ROI box pixels
    (``roi_px``), their valid pixels (``valid_px``), and the ``wrapped``
    ROIs: those that span the canvas's width with valid pixels in both its
    first and its last column (on an equirect canvas, a camera that sees
    across +-180 degrees)."""
    W, H = mt.out_size
    live = [inp for inp in mt.inputs if not is_empty(inp)]
    return {
        "plans": 1,
        "inputs": len(mt.inputs),
        "empty_inputs": len(mt.inputs) - len(live),
        "canvas_px": W * H,
        "roi_px": sum(inp.roi[2] * inp.roi[3] for inp in live),
        "valid_px": sum(int(np.count_nonzero(inp.mask)) for inp in live),
        "wrapped": sum(
            inp.roi[2] == W and bool(inp.mask[:, 0].any()) and bool(inp.mask[:, -1].any())
            for inp in live
        ),
    }


def build_plan(
    mt: MapperTemplate,
    in_sizes,
    blend: int,
    enable_gain,
    blend_dtype: str,
    pipeline: str = "yuv420",
    out_size=None,
) -> StitchPlan:
    """Host (numpy) plan.  in_sizes: (H, W) per input, then per overlay
    input.  enable_gain: False, True or "blocks".  Over a template with
    empty inputs, the plan of the covering ones (see the module's
    docstring); without a covering input it raises.  Adds the plan's
    ``plan_shape`` to ``PLANS``."""
    live = [k for k, inp in enumerate(mt.inputs) if not is_empty(inp)]
    if not live:
        raise ValueError("no input covers any output pixel")
    PLANS.add(plan_shape(mt))
    if len(live) < len(mt.inputs):
        n = len(mt.inputs)
        idx = tuple(live) + tuple(range(n, n + len(mt.overlay_inputs)))
        covering = MapperTemplate(
            out_size=mt.out_size,
            inputs=[mt.inputs[k] for k in live],
            overlay_inputs=list(mt.overlay_inputs),
            seam_masks=[mt.seam_masks[k] for k in live],
        )
        plan = _covering_plan(
            covering, [in_sizes[i] for i in idx], blend, enable_gain, blend_dtype, pipeline, out_size
        )
        return replace(plan, frame_sizes=tuple(tuple(hw) for hw in in_sizes), frame_idx=idx)
    return _covering_plan(mt, in_sizes, blend, enable_gain, blend_dtype, pipeline, out_size)


def _covering_plan(mt, in_sizes, blend, enable_gain, blend_dtype, pipeline, out_size):
    """:func:`build_plan` over a template whose every input covers."""
    W, H = mt.out_size
    out_size = tuple(out_size) if out_size else (W, H)
    yuv = pipeline == "yuv420"
    n = len(mt.inputs)
    stride = _working_stride(W, H)
    inputs, overlays, work_masks, work_rois = [], [], [], []
    for idx, inp in enumerate(mt.inputs + mt.overlay_inputs):
        ip, wm, wroi = _input_plan(inp, *in_sizes[idx], stride, yuv, idx >= n)
        if idx >= n:
            overlays.append(ip)
            continue
        inputs.append(ip)
        work_masks.append(wm)
        work_rois.append(wroi)

    gain = gain_blocks = None
    if enable_gain:
        gain = build_gain_plan(work_masks, work_rois)
    if enable_gain == "blocks":
        gain_blocks = build_blocks_gain_plan(
            work_masks, work_rois, (-(-W // stride), -(-H // stride))
        )

    rois = [inp.roi for inp in mt.inputs]
    rois_uv = [half_roi(r) for r in rois]
    blend_kind, blender, blender_uv = "none", None, None
    if blend > 0:
        blend_kind = "multiband"
        num_bands = int(math.ceil(math.log(blend) / math.log(2.0)) - 1.0)
        blender = build_multiband_plan(
            mt.seam_masks, rois, num_bands, (W, H), dtype=blend_dtype
        )
        if yuv:
            blender_uv = build_multiband_plan(
                [half_mask(sm, i.roi) for sm, i in zip(mt.seam_masks, mt.inputs)],
                rois_uv,
                max(1, num_bands - 1),
                (W // 2, H // 2),
                dtype=blend_dtype,
            )
    elif blend < 0:
        blend_kind = "feather"
        blender = build_feather_plan([i.mask for i in mt.inputs], rois, -blend)
        if yuv:
            blender_uv = build_feather_plan(
                [ip.mask_half for ip in inputs], rois_uv, max(1, (-blend) // 2)
            )

    group_idx = size_groups(in_sizes)
    full, uv = group_remap_plans(mt, in_sizes, group_idx, yuv)
    rs, rs_uv = resize_plans((W, H), out_size, yuv)
    return StitchPlan(
        canvas_size=(W, H),
        out_size=out_size,
        pipeline=pipeline,
        blend_kind=blend_kind,
        working_scale=1.0 / stride,
        inputs=inputs,
        overlays=overlays,
        gain=gain,
        gain_blocks=gain_blocks,
        blender=blender,
        blender_uv=blender_uv,
        remap_groups=full,
        remap_uv_groups=uv,
        group_idx=group_idx,
        resize=rs,
        resize_uv=rs_uv,
    )


def _paste(canvas, img, roi, mask):
    """canvas[:, roi] = img where mask > 0 (mapper.cpp:279-282)."""
    x, y, rw, rh = roi
    region = canvas[:, y : y + rh, x : x + rw]
    canvas[:, y : y + rh, x : x + rw] = torch.where(
        (mask > 0)[None], img.to(canvas.dtype), region
    )


class _StitchGraph:
    """One CUDA graph of ``Mapper._stitch_eager`` for one call signature
    (gains solved, or given): the static inputs it reads, the outputs it
    writes, the kernel launches it holds, and an event after its last
    replay, which a replay on another stream waits for before it rewrites
    the inputs."""

    def __init__(self, mapper, bufs, gains, stream):
        """Captures the path on ``stream`` over static inputs shaped as
        ``bufs`` (the plan's frames, ``Mapper._check_frames``) and
        ``gains``.  Work of other threads goes on meanwhile
        (``capture_error_mode="thread_local"``); a failed capture
        raises."""
        dev = mapper.device
        self.inputs = [torch.empty(tuple(b.shape), dtype=torch.uint8, device=dev) for b in bufs]
        self.gains = None if gains is None else torch.empty_like(gains)
        self.graph = torch.cuda.CUDAGraph()
        with launch_counts.deferred() as self.launches:
            with torch.cuda.graph(self.graph, stream=stream, capture_error_mode="thread_local"):
                self.out, self.out_gains = mapper._stitch_planned(self.inputs, self.gains)
        self.done = torch.cuda.Event()
        self.stream = None  # the stream of the last replay

    def replay(self, mapper, frames, gains):
        """Checks ``mapper``'s call's frames and copies them (an empty
        camera's left out) and its gains in, replays the graph and
        returns fresh copies of its outputs, all on the calling stream,
        under the spans ``mapper.copy_in``, ``mapper.launch`` and
        ``mapper.copy_out``."""
        stream = torch.cuda.current_stream(self.out.device)
        with RECORDER.span("mapper.copy_in"):
            bufs = mapper._check_frames(frames, batched=False)
            if self.stream is not None and self.stream != stream:
                stream.wait_event(self.done)
            for dst, src in zip(self.inputs, bufs):
                dst.copy_(src)
            if gains is not None:
                self.gains.copy_(gains)
        with RECORDER.span("mapper.launch"):
            self.graph.replay()
        with RECORDER.span("mapper.copy_out"):
            out = self.out.clone(), self.out_gains.clone()
            self.done.record(stream)
            self.stream = stream
            launch_counts.replay(self.launches)
        return out


class Mapper:
    """The stitcher on a torch device.

    ``device``: "cuda" (the default), "cuda:N" or "cpu"; "cuda" without a
    card raises.  blend: > 0 multiband blend width, 0 none (a paste), < 0
    feather border.  enable_gain: False, True (global pairwise gains) or
    "blocks" (per-block gain maps).  scale_output: output (W, H), or None
    for the canvas size.  frame_format: "yuv420p" or "nv12", in and out.
    blend_dtype: multiband pyramid precision, "float32" or "bfloat16";
    None picks bfloat16 on CUDA and float32 on the CPU.  pipeline: "rgb",
    "yuv420", or "auto", which picks yuv420 on CUDA when the geometry is
    even and rgb otherwise.  in_sizes: (H, W) per input, then per overlay
    input of the template, empty inputs included."""

    def __init__(
        self,
        mt: MapperTemplate,
        in_sizes,
        blend: int = 128,
        enable_gain=True,
        scale_output=None,
        frame_format: str = "yuv420p",
        blend_dtype: str = None,
        pipeline: str = "auto",
        *,
        device="cuda",
    ):
        dev = resolve_device(device)
        on_cuda = dev.type == "cuda"
        if frame_format not in ("yuv420p", "nv12"):
            raise ValueError(f"unknown frame_format {frame_format!r}")
        if pipeline not in ("auto", "rgb", "yuv420"):
            raise ValueError(f"unknown pipeline {pipeline!r}")
        if enable_gain not in (False, True, "blocks"):
            raise ValueError(f"unknown enable_gain {enable_gain!r}")
        n_all = len(mt.inputs) + len(mt.overlay_inputs)
        if len(in_sizes) != n_all:
            raise ValueError(
                f"{len(in_sizes)} sizes for {n_all} inputs and overlay inputs"
            )
        W, H = mt.out_size
        out_size = tuple(scale_output) if scale_output else (W, H)
        even = (
            W % 2 == 0
            and H % 2 == 0
            and out_size[0] % 2 == 0
            and out_size[1] % 2 == 0
            and all(h % 2 == 0 and w % 2 == 0 for h, w in in_sizes)
        )
        if pipeline == "auto":
            pipeline = "yuv420" if (on_cuda and even) else "rgb"
        if pipeline == "yuv420" and not even:
            raise ValueError("yuv420 pipeline needs even frame geometry")
        if sum(not is_empty(inp) for inp in mt.inputs) == 1:
            blend, enable_gain = 0, False
        if blend_dtype is None:
            blend_dtype = "bfloat16" if on_cuda else "float32"
        host = build_plan(
            mt, in_sizes, blend, enable_gain, blend_dtype, pipeline, out_size
        )
        self._bind(host.to(dev), dev, frame_format)

    @classmethod
    def from_plan(cls, plan: StitchPlan, device="cuda", frame_format: str = "yuv420p"):
        """Mapper over a plan already on ``device`` (StitchPlan.to, or
        stitch.convert.plan_from_jax)."""
        self = cls.__new__(cls)
        self._bind(plan, resolve_device(device), frame_format)
        return self

    def _bind(self, plan, device, frame_format):
        self.plan = plan
        self.device = device
        self.frame_format = frame_format
        self.num_inputs = len(plan.inputs)  # the inputs the plan blends
        n_all = self.num_inputs + len(plan.overlays)
        self._frame_idx = plan.frame_idx or tuple(range(n_all))
        self._live = None  # the covering cameras, where some camera is empty
        if plan.frame_idx:
            self.in_sizes = list(plan.frame_sizes)  # per frame of a call
            self._live = torch.tensor(plan.frame_idx[: self.num_inputs], device=device)
        else:
            self.in_sizes = [None] * n_all
            for idxs, g in zip(plan.group_idx, plan.remap_groups):
                for i in idxs:
                    self.in_sizes[i] = g.in_shape
        self.cameras = len(self.in_sizes) - len(plan.overlays)  # one gain each
        self._graphed = device.type == "cuda"  # stitch replays a CUDA graph
        self._graphs = {}  # gains given: _StitchGraph (CUDA only)
        self._graph_lock = threading.Lock()

    def _remap_dtype(self):
        """The kernel's store dtype, the JAX Mapper's: multiband takes
        its compute dtype straight out of the kernel where the JAX
        package batches the remap (every yuv420 size group; an rgb rig of
        one size).  An rgb rig of mixed sizes stores f32, as the JAX
        package's single-input kernel does (octvr_tpu/stitch/mapper.py:
        498-502): its gains, gain maps and overlay pastes then apply in
        f32, and multiband_blend casts to the compute dtype.  The other
        blends take f32."""
        plan = self.plan
        if plan.blend_kind != "multiband" or (plan.pipeline == "rgb" and len(plan.group_idx) > 1):
            return torch.float32
        return getattr(torch, plan.blender.compute_dtype)

    def _work_norms_rgb(self, warped):
        norms = []
        for w, ip in zip(warped, self.plan.inputs):
            oy, ox, s, wh, ww = ip.work_sub
            wimg = w[:, oy : oy + wh * s, ox : ox + ww * s].float()
            wimg = _pool_pow2(wimg, s, col_mat=ip.pool_cols)
            norms.append(torch.sqrt(torch.sum(wimg * wimg, dim=0)))
        return norms

    def _work_norms_yuv(self, warped_y, warped_uv):
        norms = []
        for wy, wuv, ip in zip(warped_y, warped_uv, self.plan.inputs):
            oy, ox, s, wh, ww = ip.work_sub
            yimg = wy[:, oy : oy + wh * s, ox : ox + ww * s].float()
            yimg = _pool_pow2(yimg, s, col_mat=ip.pool_cols)
            if ip.work_sub_uv is not None:
                oyu, oxu, su, _, _ = ip.work_sub_uv
                uvimg = wuv[:, oyu : oyu + wh * su, oxu : oxu + ww * su].float()
                uvimg = _pool_pow2(uvimg, su, col_mat=ip.pool_cols_uv)
            else:  # stride 1: nearest chroma gather
                uvimg = wuv.float()[:, ip.uv_rows][:, :, ip.uv_cols]
            norms.append(yuv_rgb_norm(yimg[0], uvimg[0], uvimg[1]))
        return norms

    def _plan_gains(self, gains):
        """Given gains, one per camera of the rig, as the plan's: those of
        the covering cameras."""
        return gains if gains is None or self._live is None else gains[self._live]

    def _rig_gains(self, gains):
        """The plan's gains as one per camera of the rig, 1.0 at an empty
        camera."""
        if self._live is None:
            return gains
        rig = torch.ones(self.cameras, dtype=gains.dtype, device=gains.device)
        return rig.index_copy_(0, self._live, gains)

    def _prep(self, bufs):
        """The input stage of the plan's frames (``stitch.frames``): per
        input (then overlay) Y [1, H, W] and U|V [2, H/2, W/2] as two
        tuples on the yuv420 pipeline, a list of planar RGB [3, H, W] on
        the rgb one, uint8."""
        ips = self.plan.inputs + self.plan.overlays
        if self.plan.pipeline == "yuv420":
            return tuple(
                zip(*(prep_yuv(b, self.frame_format, ip.vignette, ip.vig_half) for b, ip in zip(bufs, ips)))
            )
        return [prep_rgb(b, self.frame_format, ip.vignette) for b, ip in zip(bufs, ips)]

    def _forward(self, prepped, gains):
        """Everything after the prep (``_prep``'s planes), gains in and
        out one per camera of the rig."""
        gains = self._plan_gains(gains)
        if self.plan.pipeline == "yuv420":
            out, gains = self._postwarp_yuv(*self._remap_yuv(*prepped), gains)
        else:
            out, gains = self._forward_rgb(prepped, gains)
        return out, self._rig_gains(gains)

    @staticmethod
    def _scale(imgs, factors):
        """imgs[i] * factors[i] for the blended inputs; the factor is cast
        to the image's dtype, since f32 * bf16 would promote."""
        return [w * f.to(w.dtype) for w, f in zip(imgs, factors)] + imgs[len(factors) :]

    def _blend(self, blender, imgs, size, rois, masks):
        kind = self.plan.blend_kind
        if kind == "multiband":
            return multiband_blend(blender, imgs, size)
        if kind == "feather":
            return feather_blend(blender, imgs, size)
        cw, ch = size
        canvas = torch.zeros(
            (imgs[0].shape[0], ch, cw), dtype=torch.float32, device=imgs[0].device
        )
        for img, roi, m in zip(imgs, rois, masks):
            _paste(canvas, img, roi, m)
        return canvas

    # ---------------------------------------------------------- rgb path

    def _remap(self, planes, groups, dtype, frames=False):
        """One kernel launch per size group.  planes: per input (then
        overlay) a uint8 [C, H, W] stack, or with ``frames`` a
        [B, C, H, W] stack of B frames, which the kernel's frames axis
        remaps in the same one launch.  For equal sizes this is the JAX
        package's batched kernel; for mixed sizes the JAX package
        launches its single-input kernel per input, where the port
        launches once per size group, and a group of one input is that
        launch's shape.  ``dtype`` is the store dtype the JAX package
        uses on the same path (``_remap_dtype``)."""
        apply = remap_apply_frames if frames else remap_apply
        warped = [None] * len(planes)
        for idxs, g in zip(self.plan.group_idx, groups):
            stack = torch.stack([planes[i] for i in idxs], dim=int(frames))
            for i, w in zip(idxs, apply(stack, g, dtype)):
                warped[i] = w
        return warped

    def _forward_rgb(self, planes, ext_gains):
        """Everything after the prep (``_prep``'s planes): remap, gains,
        blend, pack."""
        plan = self.plan
        n = self.num_inputs
        W, H = plan.canvas_size
        with RECORDER.span("mapper.remap"):
            warped = self._remap(planes, plan.remap_groups, self._remap_dtype())

        gains = None
        if plan.gain is not None:
            with RECORDER.span("mapper.gain_pool"):
                norms = self._work_norms_rgb(warped)
            with RECORDER.span("mapper.gain_solve"):
                if plan.gain_blocks is not None:
                    gmaps = solve_block_gains(
                        plan.gain_blocks, norms,
                        out_rois=[ip.roi for ip in plan.inputs],
                        scale=plan.working_scale,
                    )
                    warped = self._scale(warped, [g[None] for g in gmaps])
                else:
                    gains = solve_gains(plan.gain, norms) if ext_gains is None else ext_gains
                    warped = self._scale(warped, list(gains.unbind(0)))

        with RECORDER.span("mapper.blend"):
            canvas = self._blend(
                plan.blender, warped[:n], (W, H),
                [ip.roi for ip in plan.inputs], [ip.mask for ip in plan.inputs],
            )
        with RECORDER.span("mapper.pack"):
            if canvas.dtype != torch.float32:
                canvas = canvas.float()
            for img, ip in zip(warped[n:], plan.overlays):
                _paste(canvas, img, ip.roi, ip.mask)
            canvas = torch.clamp(canvas, 0.0, 255.0)
            if plan.resize is not None:
                canvas = resize_apply(canvas, plan.resize)
            out = merge_frame(*rgb_planar_to_planes(canvas), self.frame_format)
            if gains is None:
                gains = torch.ones(n, dtype=torch.float32, device=self.device)
        return out, gains

    # ------------------------------------------------------- yuv420 path

    def _remap_yuv(self, ys, uvs, frames=False):
        """The Y and U|V remaps, then chroma centring: chroma rides
        centred (U-128, V-128) through gains and blend; uncovered pixels
        stay 0 and become neutral 128 at the output."""
        dtype = self._remap_dtype()
        with RECORDER.span("mapper.remap"):
            warped_y = self._remap(ys, self.plan.remap_groups, dtype, frames)
            warped_uv = self._remap(uvs, self.plan.remap_uv_groups, dtype, frames)
            return warped_y, [wuv - 128.0 for wuv in warped_uv]

    def _postwarp_yuv(self, warped_y, warped_uv, ext_gains):
        """Gains, the two blends, overlays, resize, packed output, from
        the remapped planes with chroma centred (``_remap_yuv``)."""
        plan = self.plan
        n = self.num_inputs
        W, H = plan.canvas_size

        gains = None
        if plan.gain is not None:
            with RECORDER.span("mapper.gain_pool"):
                norms = self._work_norms_yuv(warped_y, warped_uv)
            with RECORDER.span("mapper.gain_solve"):
                if plan.gain_blocks is not None:
                    # one lattice solve, two sample grids: a chroma pixel is
                    # two luma pixels, so the lattice scale doubles
                    lattice = solve_block_lattice(plan.gain_blocks, norms)
                    gy = sample_block_lattice(
                        plan.gain_blocks, lattice, [ip.roi for ip in plan.inputs],
                        scale=plan.working_scale,
                    )
                    guv = sample_block_lattice(
                        plan.gain_blocks, lattice, [ip.roi_uv for ip in plan.inputs],
                        scale=plan.working_scale * 2.0,
                    )
                    warped_y = self._scale(warped_y, [g[None] for g in gy])
                    warped_uv = self._scale(warped_uv, [g[None] for g in guv])
                else:
                    gains = solve_gains(plan.gain, norms) if ext_gains is None else ext_gains
                    factors = list(gains.unbind(0))
                    warped_y = self._scale(warped_y, factors)
                    warped_uv = self._scale(warped_uv, factors)

        ins = plan.inputs
        with RECORDER.span("mapper.blend"):
            y_canvas = self._blend(
                plan.blender, warped_y[:n], (W, H),
                [ip.roi for ip in ins], [ip.mask for ip in ins],
            )
            uv_canvas = self._blend(
                plan.blender_uv, warped_uv[:n], (W // 2, H // 2),
                [ip.roi_uv for ip in ins], [ip.mask_half for ip in ins],
            )
        with RECORDER.span("mapper.pack"):
            for wy, wuv, ip in zip(warped_y[n:], warped_uv[n:], plan.overlays):
                _paste(y_canvas, wy, ip.roi, ip.mask)
                _paste(uv_canvas, wuv, ip.roi_uv, ip.mask_half)

            yf = y_canvas[0].float()
            uvf = uv_canvas.float() + 128.0
            if plan.resize is not None:
                # output resize in the native planes: Y at full resolution,
                # chroma at half resolution
                yf = resize_apply(yf, plan.resize)
                uvf = resize_apply(uvf, plan.resize_uv)
            out = merge_frame(_quantize(yf), _quantize(uvf[0]), _quantize(uvf[1]), self.frame_format)
            if gains is None:
                gains = torch.ones(n, dtype=torch.float32, device=self.device)
        return out, gains

    def _forward_yuv_batch(self, frames, ext_gains):
        """B frames: per-frame prep, one frames-axis kernel launch per
        plane per size group for all B frames, per-frame post-warp."""
        B = frames[0].shape[0]
        preps = []
        for b in range(B):
            with RECORDER.span("mapper.prep"):
                preps.append(self._prep([f[b] for f in frames]))
        # per input, its B frames: Y [B, 1, H, W] and U|V [B, 2, H/2, W/2]
        ys, uvs = (
            [torch.stack(per_input) for per_input in zip(*(p[k] for p in preps))]
            for k in (0, 1)
        )
        warped_y, warped_uv = self._remap_yuv(ys, uvs, frames=True)
        outs, gains = [], []
        for b in range(B):
            o, g = self._postwarp_yuv(
                [w[b] for w in warped_y],
                [w[b] for w in warped_uv],
                self._plan_gains(None if ext_gains is None else ext_gains[b]),
            )
            outs.append(o)
            gains.append(self._rig_gains(g))
        return torch.stack(outs), torch.stack(gains)

    # ------------------------------------------------------------- public

    def _check_frames(self, frames, batched):
        """The frames checked (``stitch.frames.check_frames`` against
        ``in_sizes``), where they are (host or device), in the plan's
        order: an empty camera's frame is checked and left out."""
        bufs = check_frames(frames, self.in_sizes, batched)
        return [bufs[i] for i in self._frame_idx]

    def stitch(self, frames, gains=None):
        """frames: per input (then per overlay input) a packed YUV420P or
        NV12 uint8 [Hi*3/2, Wi] tensor or array, empty inputs included.
        Returns (out uint8 [Ho*3/2, Wo], gains f32 [n]) on the Mapper's
        device, n the cameras of the rig (``cameras``).  ``gains`` ([n])
        replaces the solved global gains (gain sharing between outputs,
        async.cpp:75-91).

        On the CPU this is ``_stitch_eager``.  On a CUDA device the first
        call of each signature (``gains`` given or not) runs it eagerly
        and captures it as a CUDA graph; every later call copies its
        frames (and gains) into the graph's inputs, replays the graph
        and returns copies of its outputs (so an output kept across
        calls stays as it was), on the calling thread's current stream,
        one call at a time.  Its spans
        (``runtime.timer.RECORDER``): ``mapper.stitch``, and under it the
        stage spans of ``_stitch_eager`` on the CPU, ``mapper.capture``
        around those of the eager run and of the capture, or
        ``mapper.replay`` around ``mapper.copy_in``, ``mapper.launch``
        and ``mapper.copy_out``."""
        with RECORDER.span("mapper.stitch"):
            if not self._graphed:
                return self._stitch_eager(frames, gains)
            # the graph holds the GEMMs cuBLAS chose at capture: a TF32
            # setting made since then must still raise
            require_full_f32()
            if gains is not None:
                gains = torch.as_tensor(gains, dtype=torch.float32, device=self.device)
            with self._graph_lock:
                graph = self._graphs.get(gains is not None)
                if graph is None:
                    with RECORDER.span("mapper.capture"):
                        return self._capture(self._check_frames(frames, batched=False), gains)
                with RECORDER.span("mapper.replay"):
                    return graph.replay(self, frames, gains)

    def _capture(self, bufs, gains):
        """The first call of a signature: the eager stitch on a side
        stream (its outputs are the call's result), then the capture of
        the same path on that stream (PyTorch's recipe for a graph)."""
        caller = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(caller)
        with torch.cuda.stream(side):
            first = self._stitch_planned(bufs, gains)
        caller.wait_stream(side)
        for t in first:  # made on the side stream, used on the caller's
            t.record_stream(caller)
        self._graphs[gains is not None] = _StitchGraph(self, bufs, gains, side)
        return first

    def _stitch_eager(self, frames, gains=None):
        """The stitch as eager torch ops and the remap kernel (arguments
        and result as :meth:`stitch`), with its stage spans in call
        order: ``mapper.prep``, ``.remap``, ``.gain_pool``,
        ``.gain_solve``, ``.blend``, ``.pack``."""
        return self._stitch_planned(self._check_frames(frames, batched=False), gains)

    def _stitch_planned(self, bufs, gains):
        """:meth:`_stitch_eager` over the plan's frames (``_check_frames``),
        the path that the CUDA graph captures."""
        with RECORDER.span("mapper.prep"):
            bufs = [f.to(self.device) for f in bufs]
            if gains is not None:
                gains = torch.as_tensor(gains, dtype=torch.float32, device=self.device)
            prepped = self._prep(bufs)
        return self._forward(prepped, gains)

    def stitch_batch(self, frames, gains=None):
        """frames: per input (then per overlay input) a uint8
        [B, Hi*3/2, Wi] stack of B frames, empty inputs included.  Returns
        (out uint8 [B, Ho*3/2, Wo], gains f32 [B, n]); ``gains`` ([B, n]) as in
        :meth:`stitch`.  The yuv420 pipeline remaps all B frames of a
        plane and size group in one kernel launch; the rgb pipeline
        stitches frame by frame.  The JAX package's ``donate`` (buffer
        reuse inside one jitted program) has no meaning in eager torch
        and is not taken.  Its spans: the stage spans of :meth:`stitch`
        per frame (one ``mapper.remap`` for all B frames on the yuv420
        pipeline), under the caller's open span."""
        with RECORDER.span("mapper.prep"):
            bufs = [f.to(self.device) for f in self._check_frames(frames, batched=True)]
            if gains is not None:
                gains = torch.as_tensor(gains, dtype=torch.float32, device=self.device)
        if self.plan.pipeline == "yuv420":
            return self._forward_yuv_batch(bufs, gains)
        outs, gs = [], []
        for b in range(bufs[0].shape[0]):
            with RECORDER.span("mapper.prep"):
                planes = self._prep([f[b] for f in bufs])
            o, g = self._forward(planes, None if gains is None else gains[b])
            outs.append(o)
            gs.append(g)
        return torch.stack(outs), torch.stack(gs)


class FastMapper(Mapper):
    """The mobile profile of the reference (vr::FastMapper,
    mapper_fast.cpp): NV12 frames in and out, feather blending with
    ``border``, no exposure compensation.  On CUDA with even geometry it
    takes the yuv420 pipeline, on the CPU the rgb one."""

    def __init__(self, mt, in_sizes, border: int = 8, **kw):
        super().__init__(
            mt,
            in_sizes,
            blend=-abs(border),
            enable_gain=False,
            frame_format="nv12",
            **kw,
        )

    def stitch_nv12(self, nv12_inputs):
        out, _ = self.stitch(nv12_inputs)
        return out
