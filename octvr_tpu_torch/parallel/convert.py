"""Carry a JAX ShardedMapper's plan across to the port.

``sharded_plan_from_jax`` reads the numpy leaves of an ``octvr_tpu``
``ShardedPlan`` (the host plan of ``octvr_tpu.parallel.ShardedMapper``)
and returns the port's ShardedPlan on a torch device.  It duck-types the
JAX plan and imports no JAX.  bf16 leaves arrive as ``ml_dtypes`` arrays
and are read bit-for-bit through a uint16 view (utils/device.to_device).
The per-pixel remap taps are rebuilt from the template at the plan's
geometry, because the JAX plan's remap leaves are TPU tile plans.
"""

import numpy as np

from ..stitch.gain import GainPlan, finish_gain_plan
from .sharded import (
    ShardedPlan,
    _band_remap_plans,
    _check_slice,
    _Geom,
    _union_box,
    _window_maps,
)

__all__ = ["sharded_plan_from_jax"]

_STATIC = (
    "num_inputs", "S", "bh", "halo", "ext", "Hp", "Wp", "num_bands",
    "num_bands_uv", "stride", "ralign", "ghalo", "compute_dtype",
    "split_level", "split_level_uv",
)
_LEAVES = (
    "wp_coarse", "inv_bw_coarse", "wp_coarse_uv", "inv_bw_coarse_uv",
    "coarse_row_idx", "coarse_row_idx_uv", "union_row_mask",
    "union_row_mask_uv", "union_col_mask", "union_col_mask_uv",
    "weight_pyrs", "inv_band_weights", "weight_pyrs_uv",
    "inv_band_weights_uv", "gm_i", "pool_cols_roi", "pool_cols_roi_uv",
    "down_mats", "up_mats",
)


def sharded_plan_from_jax(jax_plan, mt, in_sizes, device) -> ShardedPlan:
    """jax_plan: ``octvr_tpu.parallel.ShardedMapper(...).plan`` (or
    ``build_sharded_plan``) of the yuv420 pipeline over ``mt`` (the same
    MapperTemplate) and ``in_sizes``, within this slice's options."""
    if jax_plan.pipeline != "yuv420" or jax_plan.blend_kind != "multiband":
        raise NotImplementedError(
            f"{jax_plan.pipeline} pipeline, {jax_plan.blend_kind} blend: not ported yet "
            "(ROADMAP queue 1 item 19b)"
        )
    _check_slice(mt, in_sizes, 2, True if jax_plan.gain_blocks is None else "blocks")
    if jax_plan.num_overlays or jax_plan.resize_v is not None or jax_plan.frame_format != "yuv420p":
        raise NotImplementedError("overlays, scale_output or nv12: not ported yet (ROADMAP queue 1 item 19b)")
    in_size = tuple(in_sizes[0])
    gain = None
    if jax_plan.gain_b is not None:
        gain = finish_gain_plan(
            GainPlan(
                num_images=jax_plan.num_inputs,
                N=tuple(tuple(int(v) for v in row) for row in jax_plan.N),
                b=np.asarray(jax_plan.gain_b),
                A_static=np.asarray(jax_plan.gain_A_static),
                pairs=tuple(tuple(p) for p in jax_plan.pairs),
            )
        )
    # the JAX plan keeps ones where a camera has no vignette; the port
    # keeps None and skips the multiply, which changes no byte
    vig = [None if inp.vignette is None else v for inp, v in zip(mt.inputs, jax_plan.vignette)]
    host = ShardedPlan(
        **{f: getattr(jax_plan, f) for f in _STATIC},
        **{f: getattr(jax_plan, f) for f in _LEAVES},
        canvas_size=tuple(jax_plan.canvas_size),
        in_size=in_size,
        rois=tuple(tuple(r) for r in jax_plan.rois),
        roi_oy_static=tuple(jax_plan.roi_oy_static),
        roi_oy=np.asarray(jax_plan.roi_oy),
        src_h=tuple(jax_plan.src_h),
        src_row0_static=tuple(jax_plan.src_row0_static),
        src_row0=np.asarray(jax_plan.src_row0),
        gain=gain,
        vignette=vig,
        vignette_half=[None if v is None else vh for v, vh in zip(vig, jax_plan.vignette_half)],
    )
    g = _Geom(host.S, host.bh, host.halo, host.rois, host.roi_oy, _union_box(mt, 1 << host.num_bands))
    host.remap, host.remap_uv = (
        _band_remap_plans(
            _window_maps(mt, g, host.Hp, host.Wp, div), host.src_h, host.src_row0, in_size, div
        )
        for div in (1, 2)
    )
    return host.to(device)
