"""Carry a JAX ShardedMapper's plan across to the port.

``sharded_plan_from_jax`` reads the numpy leaves of an ``octvr_tpu``
``ShardedPlan`` (the host plan of ``octvr_tpu.parallel.ShardedMapper``)
and returns the port's ShardedPlan on a torch device, for every plan
kind the JAX package builds: either pipeline, multiband (single level
or split), feather or paste, pairwise or blocks gains, overlays,
``scale_output``, NV12 and mixed camera sizes.  It duck-types the JAX
plan and imports no JAX.  bf16 leaves arrive as ``ml_dtypes`` arrays
and are read bit-for-bit through a uint16 view (utils/device.to_device).
The per-pixel remap taps are rebuilt from the template at the plan's
geometry, because the JAX plan's remap leaves are TPU tile plans.
"""

import numpy as np

from ..stitch.gain import GainPlan, finish_gain_plan
from ..stitch.gain_blocks import BlocksGainPlan
from .sharded import ShardedPlan, _check_options, _Geom, _plane_remaps, _union_box

__all__ = ["sharded_plan_from_jax"]

_STATIC = (
    "num_inputs", "num_overlays", "S", "bh", "halo", "ext", "Hp", "Wp",
    "num_bands", "num_bands_uv", "stride", "ralign", "ghalo", "compute_dtype",
    "split_level", "split_level_uv", "blend_kind", "pipeline", "frame_format",
    "obh", "oW",
)
_TUPLES = ("canvas_size", "out_size", "rois", "roi_oy_static", "src_h", "src_row0_static")
_LEAVES = (
    "wp_coarse", "inv_bw_coarse", "wp_coarse_uv", "inv_bw_coarse_uv",
    "coarse_row_idx", "coarse_row_idx_uv", "union_row_mask",
    "union_row_mask_uv", "union_col_mask", "union_col_mask_uv",
    "feather_w", "feather_w_uv", "weight_pyrs", "inv_band_weights",
    "weight_pyrs_uv", "inv_band_weights_uv", "gm_i", "overlay_masks",
    "overlay_masks_uv", "resize_v", "resize_h", "resize_v_uv", "resize_h_uv",
    "pool_cols_roi", "pool_cols_roi_uv", "down_mats", "up_mats",
)
_BLOCKS_FIELDS = ("num_images", "block", "nby", "nbx", "canvas", "rois", "cover", "N", "A_static", "b")


def _nested_tuple(v):
    return tuple(_nested_tuple(x) for x in v) if isinstance(v, (list, tuple)) else v


def sharded_plan_from_jax(jax_plan, mt, in_sizes, device) -> ShardedPlan:
    """jax_plan: ``octvr_tpu.parallel.ShardedMapper(...).plan`` (or
    ``build_sharded_plan``) over ``mt`` (the same MapperTemplate) and
    ``in_sizes`` ((H, W) per camera, then per overlay input, or per
    camera only)."""
    gains = "blocks" if jax_plan.gain_blocks is not None else jax_plan.gain_b is not None
    sizes = _check_options(mt, in_sizes, jax_plan.pipeline, gains, jax_plan.frame_format, tuple(jax_plan.out_size))
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
    gain_blocks = None
    if jax_plan.gain_blocks is not None:
        gain_blocks = BlocksGainPlan(**{f: getattr(jax_plan.gain_blocks, f) for f in _BLOCKS_FIELDS})
    # the JAX plan keeps ones where an input has no vignette; the port
    # keeps None and skips the multiply, which changes no byte
    inputs = mt.inputs + mt.overlay_inputs
    vig = [None if inp.vignette is None else v for inp, v in zip(inputs, jax_plan.vignette)]
    vig_half = None
    if jax_plan.vignette_half is not None:
        vig_half = [None if v is None else vh for v, vh in zip(vig, jax_plan.vignette_half)]
    host = ShardedPlan(
        **{f: getattr(jax_plan, f) for f in _STATIC},
        **{f: _nested_tuple(getattr(jax_plan, f)) for f in _TUPLES},
        **{f: getattr(jax_plan, f) for f in _LEAVES},
        in_sizes=sizes,
        group_idx=_nested_tuple(jax_plan.group_idx),
        roi_oy=np.asarray(jax_plan.roi_oy),
        src_row0=np.asarray(jax_plan.src_row0),
        gain=gain,
        gain_blocks=gain_blocks,
        vignette=vig,
        vignette_half=vig_half,
    )
    multiband = host.blend_kind == "multiband"
    union = _union_box(mt, 1 << host.num_bands) if multiband else (0, 0, host.Wp, host.Hp)
    g = _Geom(host.S, host.bh, host.halo, host.rois, host.roi_oy, union)
    host.remap, host.remap_uv = _plane_remaps(mt, g, host, host.pipeline == "yuv420", multiband)
    return host.to(device)
