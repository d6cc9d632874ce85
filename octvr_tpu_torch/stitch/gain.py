"""Exposure gain compensation, pairwise least squares
(octvr_tpu/stitch/gain.py; the reference's GainCompensatorGPU,
stitching/src/exposure_compensate.cpp:174-313).

Pairwise intersections and counts N(i, j) are fixed at plan time on the
host; per frame the device takes one masked sum per image and pair and
solves the small dense n x n system with ``torch.linalg.solve_ex``, which
does not wait on the host for an error check.
"""

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

ALPHA = 0.01
BETA = 100.0

__all__ = ["GainPlan", "build_gain_plan", "finish_gain_plan", "solve_gains"]


@dataclass
class GainPlan:
    num_images: int
    N: tuple  # [n][n] int, static pair pixel counts (nested tuple)
    b: object  # [n] f32, static rhs
    A_static: object  # [n, n] f32, static part of the normal matrix
    # per pair (i, j), i<j with overlap: intersection masks restricted to
    # each image's working roi
    pairs: Tuple[Tuple[int, int], ...] = ()
    masks_i: List = field(default_factory=list)  # f32 [rh_i, rw_i]
    masks_j: List = field(default_factory=list)
    # derived from N and pairs by finish_gain_plan, so that the per-frame
    # solve makes no host-to-device copy
    Nf: object = None  # f32 [n, n]
    pair_idx: object = None  # int64 [2P]: i*n+j of each pair, then j*n+i


def finish_gain_plan(plan: GainPlan) -> GainPlan:
    """Fill the fields derived from ``N`` and ``pairs``."""
    n = plan.num_images
    plan.Nf = np.array(plan.N, dtype=np.float32).reshape(n, n)
    plan.pair_idx = np.array(
        [i * n + j for i, j in plan.pairs] + [j * n + i for i, j in plan.pairs],
        dtype=np.int64,
    )
    return plan


def _overlap(roi_a, roi_b):
    ax, ay, aw, ah = roi_a
    bx, by, bw, bh = roi_b
    x0 = max(ax, bx)
    y0 = max(ay, by)
    x1 = min(ax + aw, bx + bw)
    y1 = min(ay + ah, by + bh)
    if x1 <= x0 or y1 <= y0:
        return None
    return (x0, y0, x1 - x0, y1 - y0)


def build_gain_plan(masks: List[np.ndarray], rois: List[tuple]) -> GainPlan:
    """masks: working-scale uint8 masks, one per image, each sized to its
    working roi; rois: working-scale canvas rects (x, y, w, h)."""
    n = len(masks)
    N = np.zeros((n, n), dtype=np.int64)
    plan = GainPlan(num_images=n, N=N, b=None, A_static=None, pairs=[])

    for i in range(n):
        N[i, i] = max(1, int(np.count_nonzero(masks[i])))
        for j in range(i + 1, n):
            ov = _overlap(rois[i], rois[j])
            if ov is None:
                N[i, j] = N[j, i] = 1
                continue
            ox, oy, ow, oh = ov
            ix, iy = ox - rois[i][0], oy - rois[i][1]
            jx, jy = ox - rois[j][0], oy - rois[j][1]
            sub_i = masks[i][iy : iy + oh, ix : ix + ow] > 0
            sub_j = masks[j][jy : jy + oh, jx : jx + ow] > 0
            inter = sub_i & sub_j
            N[i, j] = N[j, i] = max(1, int(inter.sum()))
            if not inter.any():
                continue
            mi = np.zeros(masks[i].shape, dtype=np.float32)
            mi[iy : iy + oh, ix : ix + ow] = inter
            mj = np.zeros(masks[j].shape, dtype=np.float32)
            mj[jy : jy + oh, jx : jx + ow] = inter
            plan.pairs.append((i, j))
            plan.masks_i.append(mi)
            plan.masks_j.append(mj)

    plan.b = (BETA * N.sum(axis=1)).astype(np.float32)
    plan.A_static = np.diag(BETA * N.sum(axis=1)).astype(np.float32)
    plan.N = tuple(tuple(int(v) for v in row) for row in N)
    plan.pairs = tuple(plan.pairs)
    return finish_gain_plan(plan)


def solve_gains(plan: GainPlan, norm_images):
    """norm_images: list of f32 [rh_i, rw_i] per-pixel luminance norms of
    the working-scale warped images.  ``plan`` is a device plan
    (utils/device.tree_to).  Returns gains f32 [n] on the same device."""
    n = plan.num_images
    I = plan.Nf.new_zeros(n * n)
    if plan.pairs:
        cnt = [float(plan.N[i][j]) for i, j in plan.pairs]
        vals = [torch.sum(norm_images[i] * m) / c
                for (i, _), m, c in zip(plan.pairs, plan.masks_i, cnt)]
        vals += [torch.sum(norm_images[j] * m) / c
                 for (_, j), m, c in zip(plan.pairs, plan.masks_j, cnt)]
        I = I.index_put((plan.pair_idx,), torch.stack(vals))
    I = I.view(n, n)
    off = 1.0 - torch.eye(n, dtype=torch.float32, device=I.device)
    diag_dyn = torch.sum(2.0 * ALPHA * I * I * plan.Nf * off, dim=1)
    A = plan.A_static + torch.diag(diag_dyn) - 2.0 * ALPHA * I * I.T * plan.Nf * off
    gains, _ = torch.linalg.solve_ex(A, plan.b)
    return gains
