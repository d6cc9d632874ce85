"""Carry a JAX Mapper's plan across to the port.

``plan_from_jax`` reads the numpy fields of an ``octvr_tpu`` Mapper's
``plan`` (its host StitchPlan) and returns the port's StitchPlan on a
torch device, for every plan kind the JAX Mapper builds: either
pipeline, multiband, feather or no blend, global or blocks gains,
overlays and output scaling.  It duck-types the JAX plan and imports no
JAX.  bf16 fields arrive as ``ml_dtypes`` arrays and are read
bit-for-bit through a uint16 view (utils/device.to_device).  The
per-pixel remap taps are rebuilt from the template, because the JAX
plan holds only TPU tile plans (or, for the rgb pipeline off the TPU,
XLA gather plans).
"""

from .blenders import FeatherPlan, MultiBandPlan
from .gain import GainPlan, finish_gain_plan
from .gain_blocks import BlocksGainPlan
from .mapper import (
    StitchPlan,
    _InputPlan,
    group_remap_plans,
    resize_plans,
    size_groups,
)

__all__ = ["plan_from_jax"]

_INPUT_FIELDS = (
    "roi",
    "work_sub",
    "vignette",
    "mask",
    "pool_cols",
    "vig_half",
    "roi_uv",
    "mask_half",
    "work_sub_uv",
    "pool_cols_uv",
    "uv_rows",
    "uv_cols",
)
_BLEND_FIELDS = {
    "multiband": (
        MultiBandPlan,
        (
            "num_bands",
            "rois",
            "align_rois",
            "align_result_roi",
            "weight_pyrs",
            "inv_band_weights",
            "down_mats",
            "up_mats",
            "compute_dtype",
        ),
    ),
    "feather": (FeatherPlan, ("rois", "result_roi", "weights")),
}
_BLOCKS_FIELDS = (
    "num_images",
    "block",
    "nby",
    "nbx",
    "canvas",
    "rois",
    "cover",
    "N",
    "A_static",
    "b",
)


def _copy(cls, obj, fields):
    return cls(**{f: getattr(obj, f) for f in fields})


def _blender(kind, jb):
    if jb is None or kind == "none":
        return None
    cls, fields = _BLEND_FIELDS[kind]
    return _copy(cls, jb, fields)


def _in_sizes(jax_plan):
    """(H, W) per input and overlay input, read from the JAX plan's remap
    plans: the yuv420 size groups, the rgb batched plan (equal sizes), or
    each input's own plan (rgb, mixed sizes or off the TPU)."""
    ips = jax_plan.inputs + jax_plan.overlays
    if jax_plan.pipeline == "yuv420":
        sizes = [None] * len(ips)
        for idxs, g in zip(jax_plan.group_idx, jax_plan.remap_y_groups):
            for i in idxs:
                sizes[i] = tuple(g.in_shape)
        return sizes
    if jax_plan.batched_remap is not None:
        return [tuple(jax_plan.batched_remap.in_shape)] * len(ips)
    return [tuple(ip.remap.in_shape) for ip in ips]


def plan_from_jax(jax_plan, mt, device) -> StitchPlan:
    """jax_plan: ``octvr_tpu.stitch.Mapper(...).plan`` over ``mt`` (the
    same MapperTemplate).  The input sizes are those its remap plans were
    built for."""
    yuv = jax_plan.pipeline == "yuv420"
    sizes = _in_sizes(jax_plan)
    gain = None
    if jax_plan.gain is not None:
        g = jax_plan.gain
        gain = finish_gain_plan(
            GainPlan(
                num_images=g.num_images,
                N=g.N,
                b=g.b,
                A_static=g.A_static,
                pairs=tuple(g.pairs),
                masks_i=list(g.masks_i),
                masks_j=list(g.masks_j),
            )
        )
    gain_blocks = None
    if jax_plan.gain_blocks is not None:
        gain_blocks = _copy(BlocksGainPlan, jax_plan.gain_blocks, _BLOCKS_FIELDS)
    group_idx = size_groups(sizes)  # the JAX package's grouping rule
    full, uv = group_remap_plans(mt, sizes, group_idx, yuv)
    rs, rs_uv = resize_plans(jax_plan.canvas_size, jax_plan.out_size, yuv)
    host = StitchPlan(
        canvas_size=tuple(jax_plan.canvas_size),
        out_size=tuple(jax_plan.out_size),
        pipeline=jax_plan.pipeline,
        blend_kind=jax_plan.blend_kind,
        working_scale=jax_plan.working_scale,
        inputs=[_copy(_InputPlan, ip, _INPUT_FIELDS) for ip in jax_plan.inputs],
        overlays=[_copy(_InputPlan, ip, _INPUT_FIELDS) for ip in jax_plan.overlays],
        gain=gain,
        gain_blocks=gain_blocks,
        blender=_blender(jax_plan.blend_kind, jax_plan.blender),
        blender_uv=_blender(jax_plan.blend_kind, jax_plan.blender_uv),
        remap_groups=full,
        remap_uv_groups=uv,
        group_idx=group_idx,
        resize=rs,
        resize_uv=rs_uv,
    )
    return host.to(device)
