"""Port gain solves and yuv420 helpers (octvr_tpu_torch.stitch.gain,
.gain_blocks, .yuv_mode, mapper._pool_pow2) against the JAX package's:
host plans bit for bit, per-frame math at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu.stitch import gain as jg
from octvr_tpu.stitch import gain_blocks as jgb
from octvr_tpu.stitch import mapper as jm
from octvr_tpu.stitch import yuv_mode as jy
from octvr_tpu_torch.stitch import gain as tg
from octvr_tpu_torch.stitch import gain_blocks as tgb
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


def _blocks_scene(seed, n=3):
    """n working-scale masks on a 70x45 working canvas (not a multiple
    of the 16-px block), with overlaps, and their luminance norms."""
    rng = np.random.default_rng(seed)
    masks, rois, norms = [], [], []
    for _ in range(n):
        w, h = int(rng.integers(30, 50)), int(rng.integers(20, 40))
        x, y = int(rng.integers(0, 70 - w)), int(rng.integers(0, 45 - h))
        rois.append((x, y, w, h))
        masks.append((rng.uniform(size=(h, w)) > 0.15).astype(np.uint8) * 255)
        norms.append(rng.uniform(50, 400, (h, w)).astype(np.float32))
    return masks, rois, norms


@pytest.mark.parametrize("seed", [0, 1])
def test_blocks_gain_plan_bit_equal_and_solve_matches_jax(seed):
    """build_blocks_gain_plan np.array_equal to the JAX package's; the
    lattice solve and its samples on the luma grid and on the chroma
    grid (scale x 2, the yuv420 pipeline's use) within 1e-5."""
    masks, rois, norms = _blocks_scene(seed)
    ref = jgb.build_blocks_gain_plan(masks, rois, (70, 45), block=16)
    got = tgb.build_blocks_gain_plan(masks, rois, (70, 45), block=16)
    for f in ("num_images", "block", "nby", "nbx", "canvas", "rois"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("cover", "N", "A_static", "b"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f

    dev = tree_to(got, "cpu")
    lat_ref = np.asarray(jgb.solve_block_lattice(ref, [jnp.asarray(x) for x in norms]))
    lat = tgb.solve_block_lattice(dev, [torch.from_numpy(x) for x in norms])
    assert lat.shape == lat_ref.shape == (3, 5, 3)
    np.testing.assert_allclose(lat.numpy(), lat_ref, rtol=1e-5, atol=1e-5)
    out_rois = [(2 * x, 2 * y, 2 * w, 2 * h) for x, y, w, h in rois]
    for rs, scale in ((out_rois, 0.5), ([(x // 2, y // 2, w // 2, h // 2) for x, y, w, h in out_rois], 1.0)):
        m_ref = jgb.sample_block_lattice(ref, jnp.asarray(lat_ref), rs, scale=scale)
        m_got = tgb.sample_block_lattice(dev, torch.from_numpy(np.array(lat_ref)), rs, scale=scale)
        for a, b in zip(m_got, m_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    g_ref = jgb.solve_block_gains(ref, [jnp.asarray(x) for x in norms], out_rois, 0.5)
    g_got = tgb.solve_block_gains(dev, [torch.from_numpy(x) for x in norms], out_rois, 0.5)
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
