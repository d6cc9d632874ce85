"""Port ops of the rgb pipeline and of stitch_batch against the JAX
package: the three-channel remap (the plain version of kernels 3 and 4)
and the frames-axis remap (kernel 5) against the Pallas kernels in
interpret mode, the colour conversions, and the output resize.  Inputs
come from numpy seeds; tensors cross between the frameworks as numpy
arrays.

Bars: remap max abs < 1e-3 (the JAX package's own Pallas-vs-XLA bar);
uint8 colour outputs bit-equal, f32 RGB max abs < 1e-4; resize max abs
< 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu.ops import color as jcolor
from octvr_tpu.ops.pallas_remap import (
    merge_remap_plans,
    pack_pairs,
    pallas_remap_apply,
    pallas_remap_apply_batched,
    pallas_remap_plan,
)
from octvr_tpu.ops.remap import pack_rgb
from octvr_tpu.ops.resize import resize_bilinear
from octvr_tpu_torch.ops import color, cuda_remap
from octvr_tpu_torch.ops.remap import (
    remap_apply_frames_reference,
    remap_apply_reference,
    remap_group,
    remap_plan,
)
from octvr_tpu_torch.ops.resize import resize_apply, resize_plan
from octvr_tpu_torch.stitch.frames import rgb_prep
from octvr_tpu_torch.utils.device import tree_to
from remap_fixtures import IN_H, IN_W, edge_maps
from test_pallas_remap import _arc_maps

torch.set_num_threads(2)


def _rgb_planes(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 3, IN_H, IN_W), dtype=np.uint8)


def _packed(planes):
    """JAX pack_rgb bytes of uint8 [3, H, W] planes, as int32 [H, W]."""
    return pack_rgb(jnp.asarray(planes.astype(np.float32))).reshape(IN_H, IN_W)


def test_nc3_matches_batched_pallas_kernel():
    """Kernel 3: the batched Pallas kernel, nc=3 unpaired, on pack_rgb
    bytes of two inputs with the arc maps (invalid hole and band, empty
    tiles), at 48x128 to keep interpret mode short."""
    m1, m2 = _arc_maps(48, 128)
    maps = [(m1, m2), (m2, m1)]
    planes = _rgb_planes(40, 2)
    bp = merge_remap_plans(maps, IN_H, IN_W)
    ref = pallas_remap_apply_batched(
        jnp.stack([_packed(p) for p in planes]), bp, interpret=True
    )
    group = remap_group([remap_plan(*m, IN_H, IN_W) for m in maps], "cpu")
    got = remap_apply_reference(torch.from_numpy(planes), group)
    for r, g in zip(ref, got):
        assert g.shape == (3, 48, 128)
        assert np.abs(np.asarray(r) - g.numpy()).max() < 1e-3


@pytest.mark.parametrize("maps", ["arc", "edge"])
def test_nc3_matches_single_input_pallas_kernel(maps):
    """Kernel 4: pallas_remap_apply (one input, with its XLA residual
    pass) against a size group of one input, the port's launch shape
    for mixed camera sizes."""
    m1, m2 = _arc_maps(64, 256) if maps == "arc" else edge_maps()
    planes = _rgb_planes(41, 1)
    pp = pallas_remap_plan(m1, m2, IN_H, IN_W)
    ref = np.asarray(pallas_remap_apply(_packed(planes[0]), pp, interpret=True))
    (got,) = remap_apply_reference(
        torch.from_numpy(planes), remap_group([remap_plan(m1, m2, IN_H, IN_W)], "cpu")
    )
    assert ref.shape == tuple(got.shape) == (3, *m1.shape)
    assert np.abs(ref - got.numpy()).max() < 1e-3


def test_frames_axis_matches_pallas_frames_axis():
    """Kernel 5: pallas_remap_apply_batched(frames_axis=True), nc=1
    paired, two frames in one launch (48x128 arc maps)."""
    m1, m2 = _arc_maps(48, 128)
    rng = np.random.default_rng(11)
    B = 2
    planes = rng.integers(0, 256, (B, 1, 1, IN_H, IN_W), dtype=np.uint8)
    bp = merge_remap_plans([(m1, m2)], IN_H, IN_W, paired=True)
    packs = [pack_pairs([jnp.asarray(p[0, 0].astype(np.int32))]) for p in planes]
    (ref,) = pallas_remap_apply_batched(
        jnp.stack([p[None] for p in packs]), bp, interpret=True, nc=1,
        paired=True, frames_axis=True,
    )
    group = remap_group([remap_plan(m1, m2, IN_H, IN_W)], "cpu")
    (got,) = remap_apply_frames_reference(torch.from_numpy(planes), group)
    assert got.shape == (B, 1, 48, 128) == ref.shape
    assert np.abs(np.asarray(ref) - got.numpy()).max() < 1e-3


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_frames_reference_equals_frame_by_frame(nc):
    """The frames-axis plain version gives each frame what a one-frame
    call gives, through the CPU wrapper, which launches nothing."""
    maps = [_arc_maps(64, 256), edge_maps()]
    group = remap_group([remap_plan(*m, IN_H, IN_W) for m in maps], "cpu")
    rng = np.random.default_rng(50 + nc)
    planes = torch.from_numpy(rng.integers(0, 256, (3, 2, nc, IN_H, IN_W), dtype=np.uint8))
    before = cuda_remap.LAUNCHES
    got = cuda_remap.remap_apply_frames(planes, group, torch.bfloat16)
    assert cuda_remap.LAUNCHES == before
    for b in range(3):
        one = cuda_remap.remap_apply(planes[b], group, torch.bfloat16)
        for i in range(2):
            assert torch.equal(got[i][b], one[i])


def test_remap_reference_refuses_four_channels():
    group = remap_group([remap_plan(*edge_maps(), IN_H, IN_W)], "cpu")
    with pytest.raises(ValueError):
        remap_apply_reference(torch.zeros((1, 4, IN_H, IN_W), dtype=torch.uint8), group)


@pytest.mark.parametrize("up_cols", [False, True])
def test_yuv420p_to_rgb_matches_jax(up_cols):
    """f32 RGB within 1e-4, and the Mapper's rgb prep (vignette, clip,
    8-bit quantization) bit-equal to the JAX pack_rgb bytes, with and
    without the TPU's matmul upsample."""
    rng = np.random.default_rng(60)
    buf = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    up = jcolor.up_cols_matrix(64) if up_cols else None
    ref = np.asarray(jcolor.yuv420p_to_rgb_planar(jnp.asarray(buf), up_cols=up))
    got = color.yuv420p_to_rgb_planar(torch.from_numpy(buf))
    assert np.abs(got.numpy() - ref).max() < 1e-4
    vig = rng.uniform(0.6, 1.4, (64, 128)).astype(np.float32)
    ref_q = np.asarray(pack_rgb(jnp.clip(jnp.asarray(ref) * vig[None], 0.0, 255.0)))
    got_q = rgb_prep(*color.split_yuv420p(torch.from_numpy(buf)), torch.from_numpy(vig))
    assert np.array_equal(ref_q & 0xFF, got_q[0].reshape(-1).numpy())
    assert np.array_equal((ref_q >> 8) & 0xFF, got_q[1].reshape(-1).numpy())
    assert np.array_equal((ref_q >> 16) & 0xFF, got_q[2].reshape(-1).numpy())


@pytest.mark.parametrize("down_cols", [False, True])
def test_rgb_to_yuv420p_matches_jax(down_cols):
    """Bit-equal uint8, including values that round at .5."""
    rng = np.random.default_rng(61)
    rgb = rng.uniform(0, 255, (3, 64, 128)).astype(np.float32)
    rgb[:, :8] = np.round(rgb[:, :8])  # integer RGB: sums land on .5 often
    dn = jcolor.down_cols_matrix(128) if down_cols else None
    ref = np.asarray(jcolor.rgb_planar_to_yuv420p(jnp.asarray(rgb), down_cols=dn))
    got = color.rgb_planar_to_yuv420p(torch.from_numpy(rgb))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), ref)


def test_nv12_split_merge_match_jax():
    rng = np.random.default_rng(62)
    nv = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    ref = jcolor.split_nv12(jnp.asarray(nv))
    got = color.split_nv12(torch.from_numpy(nv))
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
    assert np.array_equal(color.merge_nv12(*got).numpy(), nv)
    assert np.array_equal(
        color.merge_nv12(*color.split_yuv420p(torch.from_numpy(nv))).numpy(),
        np.asarray(jcolor.merge_nv12(*jcolor.split_yuv420p(jnp.asarray(nv)))),
    )


@pytest.mark.parametrize("shape", [(64, 96, 32, 48), (60, 90, 97, 131), (40, 40, 40, 40)])
def test_resize_matches_jax(shape):
    """cv::resize INTER_LINEAR, down, up and identity, on a [3, H, W]
    stack against the JAX package's resize_bilinear per channel."""
    h, w, oh, ow = shape
    rng = np.random.default_rng(63)
    img = rng.uniform(0, 255, (3, h, w)).astype(np.float32)
    ref = np.stack([np.asarray(resize_bilinear(jnp.asarray(c), oh, ow, xp=jnp)) for c in img])
    plan = tree_to(resize_plan(h, w, oh, ow), "cpu")
    got = resize_apply(torch.from_numpy(img), plan)
    assert got.shape == (3, oh, ow)
    assert np.abs(got.numpy() - ref).max() < 1e-4
