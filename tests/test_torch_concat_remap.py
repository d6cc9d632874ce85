"""The port's remap over source blocks of their own heights (the
concat-source mode of the JAX package's Pallas remap, TPU kernel 6)
against the JAX package: the 96x256 fixture of
tests/test_pallas_remap.py::test_pallas_remap_concat_source, with input B
sliced to source rows [36, 76) and its map rebased.  The Pallas kernel
runs in interpret mode; the port runs its plain version, which is what
the CUDA kernel is held against on the card.

Bars: the JAX test's own 1e-3 max abs; the frames axis and shared
blocks bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu.ops.pallas_remap import merge_remap_plans, pack_pairs, pallas_remap_apply_batched
from octvr_tpu.ops.remap import pack_rgb
from octvr_tpu_torch.ops import cuda_remap
from octvr_tpu_torch.ops.remap import (
    concat_source,
    remap_apply_frames_reference,
    remap_apply_reference,
    remap_group,
    remap_plan,
)
from remap_fixtures import H_B, IN_H, IN_W, LO, concat_maps

torch.set_num_threads(2)


def _concat_group(device="cpu"):
    a, _, b_s = concat_maps()
    return remap_group([remap_plan(*a, IN_H, IN_W), remap_plan(*b_s, H_B, IN_W)], device)


def _planes(seed, nc, b=None):
    rng = np.random.default_rng(seed)
    shape = (nc, IN_H, IN_W) if b is None else (b, nc, IN_H, IN_W)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


def _slice(planes):
    """Input A's whole source and input B's rows [LO, LO+H_B) as source
    blocks."""
    return [planes, planes[..., LO : LO + H_B, :]]


@pytest.mark.parametrize("paired,nc", [(False, 1), (True, 1), (True, 2), (False, 3)])
def test_concat_matches_pallas_concat_mode(paired, nc):
    """The plain concat gather against the Pallas kernel's concat-source
    launch (interpret mode): unpaired nc=1 as in the JAX test, the paired
    nc=1 (Y) and nc=2 (U|V) launches of the sharded yuv420 path, and the
    nc=3 launch of its rgb path, each block packed by ``pack_rgb`` as
    the JAX band stitch packs it (parallel/sharded.py:1873)."""
    a, _, b_s = concat_maps()
    planes = _planes(9 + nc, nc)
    q = jnp.asarray(planes.numpy().astype(np.int32))
    bp = merge_remap_plans([a, b_s], [IN_H, H_B], IN_W, paired=paired)
    assert bp.concat_heights and bp.concat_heights[1][2] == H_B
    srcs = [q, q[:, LO : LO + H_B]]
    if paired:
        srcs = [pack_pairs(list(s)) for s in srcs]
    elif nc == 3:
        srcs = [pack_rgb(s.astype(jnp.float32)).reshape(s.shape[1:]) for s in srcs]
    else:
        srcs = [s[0] for s in srcs]
    ref = pallas_remap_apply_batched(srcs, bp, interpret=True, nc=nc, paired=paired)
    group = _concat_group()
    assert group.concat and group.src_h == (IN_H, H_B) and group.src_row0 == (0, IN_H)
    got = remap_apply_reference(concat_source(_slice(planes)), group)
    for r, g in zip(ref, got):
        assert g.shape == (nc,) + r.shape[1:]
        assert np.abs(np.asarray(r) - g.numpy()).max() < 1e-3


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_concat_matches_stacked_launch(nc):
    """The same gather through the sliced source and rebased map as
    through the unsliced source and map (the port's stacked launch)."""
    a, b, _ = concat_maps()
    planes = _planes(20 + nc, nc)
    stacked = remap_group([remap_plan(*a, IN_H, IN_W), remap_plan(*b, IN_H, IN_W)], "cpu")
    assert stacked.stacked and not stacked.concat
    ref = remap_apply_reference(torch.stack([planes, planes]), stacked)
    got = remap_apply_reference(concat_source(_slice(planes)), _concat_group())
    for r, g in zip(ref, got):
        assert (r - g).abs().max().item() < 1e-3


def test_concat_frames_axis_equals_one_frame():
    """B=3 frames of a concat source through the frames-axis version give,
    bit for bit, what three one-frame calls give, in f32 and bf16."""
    group = _concat_group()
    planes = _planes(30, 2, b=3)
    src = concat_source(_slice(planes), frames=True)
    assert src.shape == (3, 2 * (IN_H + H_B) * IN_W)
    for dtype in (torch.float32, torch.bfloat16):
        got = remap_apply_frames_reference(src, group, dtype)
        for b in range(3):
            for g, one in zip(got, remap_apply_reference(src[b], group, dtype)):
                assert torch.equal(g[b], one)


def test_shared_source_blocks_and_runs():
    """Inputs that read one source block (the bands of an unsliced camera)
    give what separate copies of the block give; ``run`` views a run of
    equal-shape inputs as one [run, C, rh, rw] tensor."""
    a, _, b_s = concat_maps()
    pa, pb = remap_plan(*a, IN_H, IN_W), remap_plan(*b_s, H_B, IN_W)
    planes = _planes(40, 1)
    shared = remap_group([pa, pa, pb, pb], "cpu", blocks=[0, 0, 1, 1])
    assert shared.src_row0 == (0, 0, IN_H, IN_H) and shared.src_rows == IN_H + H_B
    separate = remap_group([pa, pa, pb, pb], "cpu")
    blocks = _slice(planes)
    got = remap_apply_reference(concat_source(blocks), shared, run=2)
    ref = remap_apply_reference(concat_source([blocks[0], blocks[0], blocks[1], blocks[1]]), separate)
    assert [tuple(g.shape) for g in got] == [(2, 1, 64, 256), (2, 1, 64, 256)]
    for k, g in enumerate(got):
        assert torch.equal(g[0], ref[2 * k]) and torch.equal(g[1], ref[2 * k + 1])


def test_concat_wrapper_takes_plain_version_on_cpu_and_checks_sources():
    group = _concat_group()
    src = concat_source(_slice(_planes(50, 2)))
    before = cuda_remap.LAUNCHES
    got = cuda_remap.remap_apply(src, group, torch.bfloat16)
    for g, r in zip(got, remap_apply_reference(src, group, torch.bfloat16)):
        assert torch.equal(g, r)
    assert cuda_remap.LAUNCHES == before  # no kernel ran
    with pytest.raises(ValueError, match="flat source"):
        remap_apply_reference(src[:-1], group)
    with pytest.raises(ValueError, match="source blocks"):
        remap_apply_reference(torch.stack([_planes(51, 1)] * 2), group)
