"""The port's band-sharded plan (octvr_tpu_torch/parallel/sharded.py)
against the JAX package's ``build_sharded_plan``, field by field, and
the per-shard remap taps against the JAX plain gather; also
``sharded_plan_from_jax``, the options that still raise, and the
port's freedom from JAX.

The plan builders are the same numpy arithmetic, so every field is held
with ``np.array_equal``; no JIT runs here."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu.ops.remap import remap_apply as jax_remap_apply
from octvr_tpu.ops.remap import remap_plan as jax_remap_plan
from octvr_tpu.parallel.sharded import build_sharded_plan as jax_build_sharded_plan
from octvr_tpu_torch.ops.remap import remap_apply_reference, remap_group
from octvr_tpu_torch.parallel import ShardedMapper, build_sharded_plan, make_mesh
from octvr_tpu_torch.parallel.convert import sharded_plan_from_jax
from octvr_tpu_torch.parallel.sharded import _Geom, _union_box, _window_maps
from sharded_fixtures import fisheye_rig, six_cam_small

torch.set_num_threads(2)

# (rig, S, options): the split on (blend 32 -> 4 bands, split level 2),
# the split off (coarse_split = the band count), S=1 (halo 0), and the
# six-camera rig with source windows (kernel 6's concat layout)
CONFIGS = {
    "fisheye_s4_split": ("fisheye", 4, {}),
    "fisheye_s4_nosplit": ("fisheye", 4, {"coarse_split": 4}),
    "fisheye_s1": ("fisheye", 1, {}),
    "sixcam_s4_srcwin": ("sixcam", 4, {"src_windows": True}),
}

_SAME = (
    "S", "bh", "halo", "ext", "Hp", "Wp", "num_bands", "num_bands_uv",
    "stride", "ralign", "ghalo", "rois", "roi_oy_static", "roi_oy", "src_h",
    "src_row0_static", "src_row0", "split_level", "split_level_uv",
    "coarse_row_idx", "coarse_row_idx_uv", "weight_pyrs", "inv_band_weights",
    "weight_pyrs_uv", "inv_band_weights_uv", "wp_coarse", "inv_bw_coarse",
    "wp_coarse_uv", "inv_bw_coarse_uv", "gm_i", "union_row_mask",
    "union_row_mask_uv", "union_col_mask", "union_col_mask_uv",
    "pool_cols_roi", "pool_cols_roi_uv", "down_mats",
    "up_mats",
)


@pytest.fixture(scope="module")
def rigs():
    return {"fisheye": fisheye_rig(), "sixcam": six_cam_small()}


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def _plans(rigs, name):
    rig, S, kw = CONFIGS[name]
    mt, sizes, _ = rigs[rig]
    port = build_sharded_plan(mt, sizes, S, blend=32, **kw)
    ref = jax_build_sharded_plan(mt, sizes, S, blend=32, pipeline="yuv420", **kw)
    return mt, sizes, port, ref


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_fields_equal_jax(rigs, name):
    mt, sizes, port, ref = _plans(rigs, name)
    for f in _SAME:
        assert _equal(getattr(port, f), getattr(ref, f)), f
    assert port.gain.N == ref.N and port.gain.pairs == ref.pairs
    assert np.array_equal(port.gain.b, ref.gain_b)
    assert np.array_equal(port.gain.A_static, ref.gain_A_static)
    # the JAX plan keeps ones where a camera has no vignette
    for v, rv in zip(port.vignette + port.vignette_half, ref.vignette + ref.vignette_half):
        assert np.array_equal(rv, np.ones_like(rv) if v is None else v)
    concat = any(rp.concat_heights for rp in ref.remap_groups)
    assert port.sliced == concat
    assert port.to("cpu").remap.concat == concat
    if name == "sixcam_s4_srcwin":
        # side cameras sliced, poles whole: kernel 6 takes the launch
        assert concat and any(h < 240 for h in port.src_h), port.src_h
    if name == "fisheye_s4_split":
        assert port.split_level == 2 and port.split_level_uv == 1
    if name == "fisheye_s4_nosplit":
        assert port.split_level == -1 and port.halo >= 5 * (1 << port.num_bands)
    if name == "fisheye_s1":
        assert port.halo == 0 and port.split_level == -1


def test_sliced_taps_equal_jax_gather_on_unsliced_source(rigs):
    """The contract kernel 6 keeps: each (input, band) window remap
    through the port's taps on the sliced source equals the JAX plain
    gather on the unsliced source through the un-rebased window maps.
    The rebased map is rounded to f32, which moves a tap by ~1e-5 px and
    so a weight by a few 1e-5: under 0.01 between neighbours 255 apart,
    hence the bar of 0.02."""
    mt, sizes, _ = rigs["sixcam"]
    plan = build_sharded_plan(mt, sizes, 4, blend=32, src_windows=True)
    g = _Geom(plan.S, plan.bh, plan.halo, plan.rois, plan.roi_oy, _union_box(mt, 1 << plan.num_bands))
    rng = np.random.default_rng(5)
    worst, sliced = 0.0, 0
    for div, plans in ((1, plan.remap), (2, plan.remap_uv)):
        band_maps = _window_maps(mt, g, plan.Hp, plan.Wp, div)
        H, W = plan.in_size[0] // div, plan.in_size[1] // div
        for i in range(plan.num_inputs):
            img = rng.integers(0, 256, (1, H, W), dtype=np.uint8)
            h = plan.src_h[i] // div
            for s in range(plan.S):
                r0 = int(plan.src_row0[s, i]) // div
                got = remap_apply_reference(
                    torch.from_numpy(img[None, :, r0 : r0 + h].copy()), remap_group([plans[i][s]], "cpu")
                )[0]
                want = jax_remap_apply(
                    jnp.asarray(img, jnp.float32), jax_remap_plan(*band_maps[s][i], H, W)
                )
                worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
                sliced += h < H
    print(f"sliced taps vs JAX gather on the unsliced source: max abs {worst:.3g}")
    assert sliced > 0 and worst < 0.02


@pytest.mark.parametrize(
    "name,dtype",
    [("fisheye_s4_split", "float32"), ("fisheye_s4_split", "bfloat16"), ("sixcam_s4_srcwin", "float32")],
)
def test_plan_from_jax_stitches_like_port_plan(rigs, name, dtype):
    """A plan carried across from the JAX package stitches bit for bit
    like the port's own; bf16 leaves (ml_dtypes arrays) arrive bit for
    bit."""
    rig, S, kw = CONFIGS[name]
    mt, sizes, frames = rigs[rig]
    port = build_sharded_plan(mt, sizes, S, blend=32, blend_dtype=dtype, **kw).to("cpu")
    ref = jax_build_sharded_plan(mt, sizes, S, blend=32, pipeline="yuv420", blend_dtype=dtype, **kw)
    carried = sharded_plan_from_jax(ref, mt, sizes, "cpu")
    assert carried.weight_pyrs[0][0].dtype == getattr(torch, dtype)
    assert _equal_tensors(carried.weight_pyrs, port.weight_pyrs)
    assert _equal_tensors(carried.inv_bw_coarse_uv, port.inv_bw_coarse_uv)
    frames = [torch.from_numpy(f[None].copy()) for f in frames]
    mesh = make_mesh(1, S, device="cpu")
    a = ShardedMapper.from_plan(port, mesh).stitch_batch(frames)
    b = ShardedMapper.from_plan(carried, mesh).stitch_batch(frames)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _equal_tensors(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_tensors(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or torch.equal(a, b)


def test_unported_options_raise(rigs):
    mt, sizes, _ = rigs["fisheye"]
    mesh = make_mesh(1, 2, device="cpu")
    for kw in (
        {"pipeline": "rgb"},
        {"out_format": "rgb"},
        {"blend": 0},
        {"blend": -8},
        {"enable_gain": "blocks"},
        {"scale_output": (128, 64)},
        {"frame_format": "nv12"},
    ):
        with pytest.raises(NotImplementedError, match="19b"):
            ShardedMapper(mt, sizes, mesh, **kw)
    with pytest.raises(NotImplementedError, match="mixed camera sizes"):
        ShardedMapper(mt, [(256, 256), (240, 240)], mesh)
    import dataclasses

    with pytest.raises(NotImplementedError, match="overlay"):
        ShardedMapper(dataclasses.replace(mt, overlay_inputs=[mt.inputs[0]]), sizes, mesh)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        make_mesh(1, 4, device="cuda")


def test_port_imports_no_jax():
    code = "import sys, octvr_tpu_torch.parallel.convert; assert 'jax' not in sys.modules, 'jax imported'"
    subprocess.run([sys.executable, "-c", code], check=True)
