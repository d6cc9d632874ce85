"""Block-wise exposure compensation, the BlocksGainCompensator role
(octvr_tpu/stitch/gain_blocks.py; stitching/src/exposure_compensate.cpp:
330-438 of the reference): gains are solved per canvas block and
bilinearly interpolated into smooth per-pixel gain maps.

The per-block pairwise systems are assembled from block-reduced masked
sums and solved as one batched ``torch.linalg.solve_ex`` over all
blocks, which does not wait on the host for an error check; the gain
maps are a bilinear upsample of the [nby, nbx] gain lattice.
"""

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .gain import ALPHA, BETA

__all__ = [
    "BlocksGainPlan",
    "assemble_and_solve_lattice",
    "build_blocks_gain_plan",
    "sample_block_lattice",
    "solve_block_gains",
    "solve_block_lattice",
]


@dataclass
class BlocksGainPlan:
    num_images: int
    block: int  # block size in working-scale pixels
    nby: int
    nbx: int
    canvas: tuple  # working-scale canvas (Hc, Wc), padded to the block grid
    rois: tuple  # per image working-scale roi (x, y, w, h)
    cover: object  # f32 [n, Hc, Wc] mask per image (canvas frame)
    N: object  # f32 [B, n, n] per-block pair counts (>= 1)
    A_static: object  # f32 [B, n, n]
    b: object  # f32 [B, n]


def build_blocks_gain_plan(masks: List[np.ndarray], rois, canvas_size, block=32):
    """masks: working-scale uint8 per image (roi-sized); rois: working
    scale (x, y, w, h); canvas_size: working scale (W, H)."""
    W, H = canvas_size
    n = len(masks)
    nby = -(-H // block)
    nbx = -(-W // block)
    Hc, Wc = nby * block, nbx * block

    cover = np.zeros((n, Hc, Wc), dtype=np.float32)
    for i, (m, (x, y, w, h)) in enumerate(zip(masks, rois)):
        cover[i, y : y + h, x : x + w] = (np.asarray(m) > 0).astype(np.float32)

    def block_sum(a):
        return a.reshape(*a.shape[:-2], nby, block, nbx, block).sum(axis=(-3, -1))

    B = nby * nbx
    N = np.ones((B, n, n), dtype=np.float32)
    for i in range(n):
        N[:, i, i] = np.maximum(block_sum(cover[i]).reshape(B), 1.0)
        for j in range(i + 1, n):
            Nij = block_sum(cover[i] * cover[j]).reshape(B)
            N[:, i, j] = N[:, j, i] = np.maximum(Nij, 1.0)

    # diagonal: beta * sum_j N(i, j)
    A_static = np.zeros((B, n, n), dtype=np.float32)
    for i in range(n):
        A_static[:, i, i] = BETA * N[:, i].sum(axis=1)

    return BlocksGainPlan(
        num_images=n,
        block=block,
        nby=nby,
        nbx=nbx,
        canvas=(Hc, Wc),
        rois=tuple(tuple(r) for r in rois),
        cover=cover,
        N=N,
        A_static=A_static,
        b=BETA * N.sum(axis=2),
    )


def solve_block_gains(plan: BlocksGainPlan, norm_images, out_rois=None, scale=1.0):
    """norm_images: per image f32 [rh_i, rw_i] working-scale luminance
    norms (roi frame).  Returns per-image gain maps sampled at
    ``out_rois`` (default: the working rois); full-res px * ``scale`` =
    working px."""
    lattice = solve_block_lattice(plan, norm_images)
    rois_out = plan.rois if out_rois is None else out_rois
    return sample_block_lattice(plan, lattice, rois_out, scale)


def solve_block_lattice(plan: BlocksGainPlan, norm_images):
    """Assemble and solve the per-block pairwise systems; returns the
    gain lattice [nby, nbx, n].  One solve can feed several sample grids
    (the yuv420 pipeline's luma and chroma planes)."""
    n = plan.num_images
    Hc, Wc = plan.canvas
    block, nby, nbx = plan.block, plan.nby, plan.nbx
    canvas_norm = plan.cover.new_zeros((n, Hc, Wc))
    for i, (nm, (x, y, w, h)) in enumerate(zip(norm_images, plan.rois)):
        canvas_norm[i, y : y + h, x : x + w] = nm
    canvas_norm = canvas_norm * plan.cover

    # sums[i, j, b] = sum over block b of norm_i on the (i, j) overlap
    prod = canvas_norm[:, None] * plan.cover[None]
    sums = prod.reshape(n, n, nby, block, nbx, block).sum(dim=(-3, -1))
    # I[b, i, j] = their mean; the diagonal stays 0
    off = 1.0 - torch.eye(n, dtype=torch.float32, device=sums.device)
    I = sums.reshape(n, n, nby * nbx).permute(2, 0, 1) / plan.N * off
    return assemble_and_solve_lattice(plan, I)


def assemble_and_solve_lattice(plan: BlocksGainPlan, I):
    """Per-block system assembly and one batched solve from the overlap
    means I [B, n, n]."""
    n = plan.num_images
    off = 1.0 - torch.eye(n, dtype=torch.float32, device=I.device)[None]
    diag_dyn = torch.sum(2.0 * ALPHA * I * I * plan.N * off, dim=2)
    A = plan.A_static + torch.diag_embed(diag_dyn) - (
        2.0 * ALPHA * I * I.transpose(1, 2) * plan.N * off
    )
    gains, _ = torch.linalg.solve_ex(A, plan.b[..., None])
    return gains[..., 0].reshape(plan.nby, plan.nbx, n)


def sample_block_lattice(plan: BlocksGainPlan, lattice, rois_out, scale=1.0):
    """Bilinear upsample of the gain lattice to per-pixel maps at the
    given rois; roi px * ``scale`` = working px."""
    block, nby, nbx = plan.block, plan.nby, plan.nbx
    dev = lattice.device
    maps = []
    for i, (x, y, w, h) in enumerate(rois_out):
        ys = ((torch.arange(y, y + h, device=dev) + 0.5) * scale) / block - 0.5
        xs = ((torch.arange(x, x + w, device=dev) + 0.5) * scale) / block - 0.5
        y0 = torch.floor(ys).long().clamp(0, nby - 1)
        x0 = torch.floor(xs).long().clamp(0, nbx - 1)
        y1 = (y0 + 1).clamp(max=nby - 1)
        x1 = (x0 + 1).clamp(max=nbx - 1)
        fy = torch.clamp(ys - y0, 0.0, 1.0)[:, None]
        fx = torch.clamp(xs - x0, 0.0, 1.0)[None, :]
        g = lattice[..., i]
        top = g[y0][:, x0] * (1 - fx) + g[y0][:, x1] * fx
        bot = g[y1][:, x0] * (1 - fx) + g[y1][:, x1] * fx
        maps.append(top * (1 - fy) + bot * fy)
    return maps
