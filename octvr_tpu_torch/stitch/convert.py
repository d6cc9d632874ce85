"""Carry a JAX Mapper's plan across to the port.

``plan_from_jax`` reads the numpy fields of an ``octvr_tpu`` Mapper's
``plan`` (its host StitchPlan) and returns the port's StitchPlan on a
torch device.  It duck-types the JAX plan and imports no JAX.  bf16
fields arrive as ``ml_dtypes`` arrays and are read bit-for-bit through a
uint16 view (utils/device.to_device).  The per-pixel remap taps are
rebuilt from the template, because the JAX plan holds only TPU tile
plans.
"""

from .blenders import MultiBandPlan
from .gain import GainPlan, finish_gain_plan
from .mapper import StitchPlan, _InputPlan, remap_groups

__all__ = ["plan_from_jax"]

_INPUT_FIELDS = (
    "work_sub",
    "vignette",
    "vig_half",
    "pool_cols",
    "work_sub_uv",
    "pool_cols_uv",
    "uv_rows",
    "uv_cols",
)
_BLEND_FIELDS = (
    "num_bands",
    "rois",
    "align_rois",
    "align_result_roi",
    "weight_pyrs",
    "inv_band_weights",
    "down_mats",
    "up_mats",
    "compute_dtype",
)


def _blender(jb):
    return MultiBandPlan(**{f: getattr(jb, f) for f in _BLEND_FIELDS})


def plan_from_jax(jax_plan, mt, device) -> StitchPlan:
    """jax_plan: ``octvr_tpu.stitch.Mapper(...).plan`` of a yuv420,
    multiband Mapper over ``mt`` (the same MapperTemplate)."""
    if (
        jax_plan.pipeline != "yuv420"
        or jax_plan.blend_kind != "multiband"
        or jax_plan.overlays
        or jax_plan.gain_blocks is not None
        or tuple(jax_plan.out_size) != tuple(jax_plan.canvas_size)
    ):
        raise NotImplementedError(
            "only yuv420 multiband plans without overlays, blocks gains or "
            "output scaling are ported (ROADMAP.md, queue 1, item 10)"
        )
    in_sizes = [None] * len(jax_plan.inputs)
    for idxs, g in zip(jax_plan.group_idx, jax_plan.remap_y_groups):
        for i in idxs:
            in_sizes[i] = tuple(g.in_shape)
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
    y_groups, uv_groups = remap_groups(mt, in_sizes, jax_plan.group_idx)
    host = StitchPlan(
        canvas_size=tuple(jax_plan.canvas_size),
        inputs=[
            _InputPlan(**{f: getattr(ip, f) for f in _INPUT_FIELDS})
            for ip in jax_plan.inputs
        ],
        gain=gain,
        blender=_blender(jax_plan.blender),
        blender_uv=_blender(jax_plan.blender_uv),
        remap_y_groups=y_groups,
        remap_uv_groups=uv_groups,
        group_idx=tuple(tuple(g) for g in jax_plan.group_idx),
    )
    return host.to(device)
