"""TPU kernel 7, the rowpack layout of the paired nc=1 Pallas remap
(octvr_tpu/ops/pallas_remap.py ``pack_pair_rows`` and ``body_rp``: two
source rows per int32, one gather per two rows), computes kernel 1's
output, so the port runs it as kernel 1.  Held here: the JAX rowpack
launch (interpret mode, ``kh_multiple=16``, as in
tests/test_pallas_remap.py::test_pallas_remap_rowpack, here on a 48x128
source with one 32x128 window of the arc maps to keep interpret mode
short) against the port's plain version of kernel 1 on the same maps
and source, max abs < 1e-3 (the JAX remap tests' bar)."""

import jax.numpy as jnp
import numpy as np
import torch

from octvr_tpu.ops.pallas_remap import merge_remap_plans, pack_pair_rows, pallas_remap_apply_batched
from octvr_tpu_torch.ops.remap import remap_apply_reference, remap_group, remap_plan
from remap_fixtures import arc_maps

IN_H, IN_W = 48, 128

torch.set_num_threads(2)


def test_rowpack_launch_matches_kernel_1_plain_version():
    rng = np.random.default_rng(7)
    y = np.round(rng.uniform(0, 255, (IN_H, IN_W))).astype(np.int32)
    maps = [arc_maps(32, 128)]
    bp = merge_remap_plans(maps, IN_H, IN_W, paired=True, kh_multiple=16)
    assert bp.KH % 16 == 0
    src = pack_pair_rows(jnp.asarray(y))
    ref = pallas_remap_apply_batched(
        src[None], bp, interpret=True, nc=1, paired=True, rowpack=True
    )
    group = remap_group([remap_plan(*m, IN_H, IN_W) for m in maps], "cpu")
    planes = torch.from_numpy(y.astype(np.uint8))[None, None]
    got = remap_apply_reference(planes, group)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        err = np.abs(np.asarray(r) - g.numpy()).max()
        assert err < 1e-3, err
