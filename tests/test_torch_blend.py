"""Port multiband blender (octvr_tpu_torch.stitch.blenders) against the
JAX package's: the host plan bit for bit, the f32 blend to 1e-3, and the
bf16 blend against the port's f32 at the JAX package's bf16 bars
(tests/test_blend_real.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu.stitch import blenders as jb
from octvr_tpu_torch.stitch import blenders as tb
from octvr_tpu_torch.utils.device import tree_to

torch.set_num_threads(2)

CANVAS = (160, 96)  # (W, H)


def _scene(seed, c=1, n=3, bands=3):
    """n overlapping ROIs on the canvas with random seam masks and
    smooth-plus-noise images in [0, 255]."""
    rng = np.random.default_rng(seed)
    W, H = CANVAS
    rois, masks, imgs = [], [], []
    for _ in range(n):
        w = int(rng.integers(40, 90))
        h = int(rng.integers(30, 70))
        x = int(rng.integers(0, W - w))
        y = int(rng.integers(0, H - h))
        rois.append((x, y, w, h))
        masks.append((rng.uniform(size=(h, w)) > 0.3).astype(np.uint8) * 255)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        base = 127 + 100 * np.sin(xx / (5 + 10 * rng.uniform()) + yy / 9.0)
        imgs.append(
            np.clip(base[None] + rng.normal(0, 8, (c, h, w)), 0, 255).astype(
                np.float32
            )
        )
    return masks, rois, imgs, bands


@pytest.mark.parametrize("seed", [0, 1])
def test_multiband_plan_bit_equal(seed):
    masks, rois, _, bands = _scene(seed)
    ref = jb.build_multiband_plan(masks, rois, bands, CANVAS)
    got = tb.build_multiband_plan(masks, rois, bands, CANVAS)
    assert got.align_rois == ref.align_rois
    assert got.align_result_roi == ref.align_result_roi
    for pg, pr in zip(got.weight_pyrs, ref.weight_pyrs):
        for a, b in zip(pg, pr):
            assert np.array_equal(a, b)
    for a, b in zip(got.inv_band_weights, ref.inv_band_weights):
        assert np.array_equal(a, b)
    for mg, mr in ((got.down_mats, ref.down_mats), (got.up_mats, ref.up_mats)):
        assert sorted(mg) == sorted(mr)
        assert all(np.array_equal(mg[k], mr[k]) for k in mr)


def test_multiband_bf16_plan_matches_ml_dtypes():
    """The port's device bf16 plan equals the JAX package's ml_dtypes bf16
    plan bit for bit, whichever side built it."""
    masks, rois, _, bands = _scene(2)
    ref = tree_to(
        jb.build_multiband_plan(masks, rois, bands, CANVAS, dtype="bfloat16"),
        "cpu",
    )
    got = tb.build_multiband_plan(masks, rois, bands, CANVAS, dtype="bfloat16").to("cpu")
    pairs = list(zip(sum(got.weight_pyrs, []), sum(ref.weight_pyrs, [])))
    pairs += list(zip(got.inv_band_weights, ref.inv_band_weights))
    pairs += [(got.down_mats[k], ref.down_mats[k]) for k in ref.down_mats]
    for a, b in pairs:
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)


@pytest.mark.parametrize("seed,c", [(0, 1), (1, 2), (3, 1)])
def test_multiband_blend_matches_jax_f32(seed, c):
    masks, rois, imgs, bands = _scene(seed, c=c)
    ref = np.asarray(
        jb.multiband_blend(
            jb.build_multiband_plan(masks, rois, bands, CANVAS),
            [jnp.asarray(i) for i in imgs],
            CANVAS,
        )
    )
    plan = tb.build_multiband_plan(masks, rois, bands, CANVAS).to("cpu")
    got = tb.multiband_blend(plan, [torch.from_numpy(i) for i in imgs], CANVAS)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() < 1e-3


def test_multiband_bf16_tracks_f32():
    masks, rois, imgs, bands = _scene(4, c=2)
    ts = [torch.from_numpy(i) for i in imgs]
    outs = {}
    for dt in ("float32", "bfloat16"):
        plan = tb.build_multiband_plan(masks, rois, bands, CANVAS, dtype=dt).to("cpu")
        outs[dt] = tb.multiband_blend(plan, ts, CANVAS).numpy()
    d = np.abs(outs["bfloat16"] - outs["float32"])
    assert d.mean() < 1.5, d.mean()
    assert np.percentile(d, 99) < 6.0, np.percentile(d, 99)


@pytest.mark.parametrize("seed,border", [(0, 4), (1, 1), (5, 12)])
def test_feather_plan_bit_equal_and_blend_matches_jax(seed, border):
    """The feather weights, normalized by the canvas total including
    WEIGHT_EPS, np.array_equal to the JAX package's; the blend within
    1e-5 (relative to 255) of JAX's."""
    masks, rois, imgs, _ = _scene(seed, c=3)
    ref = jb.build_feather_plan(masks, rois, border)
    got = tb.build_feather_plan(masks, rois, border)
    assert got.rois == ref.rois and got.result_roi == ref.result_roi
    assert all(np.array_equal(a, b) for a, b in zip(got.weights, ref.weights))
    out_ref = np.asarray(jb.feather_blend(ref, [jnp.asarray(i) for i in imgs], CANVAS))
    out = tb.feather_blend(got.to("cpu"), [torch.from_numpy(i) for i in imgs], CANVAS)
    assert out.dtype == torch.float32 and out.shape == out_ref.shape
    assert np.abs(out.numpy() - out_ref).max() < 1e-5 * 255
