"""Port gain solve and yuv420 helpers (octvr_tpu_torch.stitch.gain,
.yuv_mode, mapper._pool_pow2) against the JAX package's: host plans bit
for bit, per-frame math at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu.stitch import gain as jg
from octvr_tpu.stitch import mapper as jm
from octvr_tpu.stitch import yuv_mode as jy
from octvr_tpu_torch.stitch import gain as tg
from octvr_tpu_torch.stitch import mapper as tm
from octvr_tpu_torch.stitch import yuv_mode as ty
from octvr_tpu_torch.utils.device import tree_to

torch.set_num_threads(2)


def _gain_scene(seed, n=4):
    """n working-scale masks on a 64x32 working canvas, with overlaps."""
    rng = np.random.default_rng(seed)
    masks, rois = [], []
    for k in range(n):
        w, h = int(rng.integers(20, 36)), int(rng.integers(14, 28))
        x, y = int(rng.integers(0, 64 - w)), int(rng.integers(0, 32 - h))
        rois.append((x, y, w, h))
        masks.append((rng.uniform(size=(h, w)) > 0.2).astype(np.uint8) * 255)
    norms = [
        rng.uniform(50, 400, (r[3], r[2])).astype(np.float32) for r in rois
    ]
    return masks, rois, norms


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gain_plan_bit_equal_and_solve_matches_jax(seed):
    masks, rois, norms = _gain_scene(seed)
    ref = jg.build_gain_plan(masks, rois)
    got = tg.build_gain_plan(masks, rois)
    assert got.N == ref.N and got.pairs == ref.pairs and got.pairs
    assert np.array_equal(got.A_static, ref.A_static)
    assert np.array_equal(got.b, ref.b)
    for a, b in zip(got.masks_i + got.masks_j, ref.masks_i + ref.masks_j):
        assert np.array_equal(a, b)
    g_ref = np.asarray(jg.solve_gains(ref, [jnp.asarray(x) for x in norms]))
    g_got = tg.solve_gains(tree_to(got, "cpu"), [torch.from_numpy(x) for x in norms])
    np.testing.assert_allclose(g_got.numpy(), g_ref, rtol=1e-5)


def test_yuv_rgb_norm_matches_jax():
    rng = np.random.default_rng(3)
    y = rng.uniform(0, 255, (17, 23)).astype(np.float32)
    u, v = (rng.uniform(-128, 127, (17, 23)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jy.yuv_rgb_norm(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))
    got = ty.yuv_rgb_norm(*(torch.from_numpy(a) for a in (y, u, v)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


@pytest.mark.parametrize("roi", [(0, 0, 40, 30), (3, 5, 37, 29), (6, 1, 21, 40)])
def test_half_maps_mask_roi_bit_equal(roi):
    rng = np.random.default_rng(roi[0] + roi[1])
    w, h = roi[2], roi[3]
    m1 = rng.uniform(0, 1, (h, w)).astype(np.float32)
    m2 = rng.uniform(0, 1, (h, w)).astype(np.float32)
    hole = rng.uniform(size=(h, w)) < 0.2
    m1[hole] = m2[hole] = -1
    mask = np.where(hole, 0, 255).astype(np.uint8)
    assert ty.half_roi(roi) == jy.half_roi(roi)
    for a, b in zip(ty.half_maps(m1, m2, roi), jy.half_maps(m1, m2, roi)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(ty.half_mask(mask, roi), jy.half_mask(mask, roi))


@pytest.mark.parametrize("s,cols", [(1, False), (2, False), (4, True), (8, True)])
def test_pool_pow2_matches_jax(s, cols):
    rng = np.random.default_rng(s)
    x = rng.uniform(0, 255, (2, 8 * s, 5 * s)).astype(np.float32)
    cm = tm._pool_cols_matrix(5 * s, s) if cols else None
    assert cm is None or np.array_equal(cm, jm._pool_cols_matrix(5 * s, s))
    ref = np.asarray(jm._pool_pow2(jnp.asarray(x), s, col_mat=None if cm is None else jnp.asarray(cm)))
    got = tm._pool_pow2(torch.from_numpy(x), s, col_mat=None if cm is None else torch.from_numpy(cm))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
