"""Bundle adjustment on a torch device: the counterpart of
octvr_tpu/registration/bundle_jax.py (``bundle_adjust_ray_jax``).

The ray cost of BundleAdjusterRay (motion_estimators.cpp:505-578) with
analytic per-match Jacobian blocks and camera-block normal equations:

* each match's residual (the unit-ray difference scaled by
  sqrt(f_i f_j), 3 values) and its Jacobians with respect to its two
  cameras' 4-parameter blocks (f, rvec) come from ``torch.func.jacfwd``
  vmapped over the matches: O(m) block work instead of a dense
  [3m, 4n] Jacobian (a rotation-only panorama BA has no landmarks, so
  the camera blocks are the whole reduced system);
* the [4n, 4n] normal matrix and the [4n] gradient are scatter-added
  from the 4x4 blocks (``index_add_``);
* the LM damping loop (solve, trial step, accept or reject, lambda
  update) runs on the device, in f32 as the JAX function does, with the
  JAX loop's two phases (focals locked first, then all parameters).

Host syncs: one per LM iteration, which reads the loop's condition
(the stall count and lambda) as ``lax.while_loop`` evaluates it on the
device (and one more read when the condition ends a phase), plus two per
phase for the result (x, the cost).  ``stats``, when given,
receives {"iters": [phase 1, phase 2], "syncs": total}.

``mesh=`` (a mesh of runtime.distributed.make_global_mesh) shards the
matches over the mesh's ranks, as the JAX function's ``mesh=`` shards
them over devices: the matches are padded to the rank count with rows
whose two ends are the same camera and pixel (zero residual, Jacobian
blocks that cancel), each rank takes a contiguous share, and JtJ, Jtr
and the cost are summed over the ranks (``all_reduce``) before any use.
Every LM decision is read from those sums, so every rank takes the same
branch; the host syncs stay one per iteration.  A one-process mesh
(``make_mesh``) computes what ``mesh=None`` computes.

No TF32: every product is written as multiply-adds, and the one solve
per iteration is an LU solve of a [4n, 4n] system.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.func import jacfwd, vmap

from ..utils.device import resolve_device
from .bundle import BundleData, _center_normalize, inv_rodrigues, rodrigues

__all__ = ["bundle_adjust_ray_torch"]

_EYE3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def _rodrigues(rvec):
    """[3] -> [3, 3], as the JAX function's ``_rodrigues_jnp``."""
    theta = torch.sqrt(torch.sum(rvec * rvec) + 1e-12)
    k = rvec / theta
    kx, ky, kz = k[0], k[1], k[2]
    z = torch.zeros_like(kx)
    K = torch.stack(
        [torch.stack([z, -kz, ky]), torch.stack([kz, z, -kx]), torch.stack([-ky, kx, z])]
    )
    KK = (K[:, :, None] * K[None, :, :]).sum(1)  # K @ K
    eye = torch.tensor(_EYE3, dtype=rvec.dtype, device=rvec.device)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * KK


def _pair_residual(pi, pj, pt1, pt2, sz1, sz2):
    """One match: 4-param camera blocks (f, rvec) x2 -> residual [3]."""

    def ray(p, pt, sz):
        f = p[0]
        R = _rodrigues(p[1:4])
        v = torch.stack(
            [(pt[0] - sz[0] * 0.5) / f, (pt[1] - sz[1] * 0.5) / f, torch.ones_like(f)]
        )
        w = (R * v[None, :]).sum(-1)  # R @ v
        return w / torch.sqrt(torch.sum(w * w))

    r = ray(pi, pt1, sz1) - ray(pj, pt2, sz2)
    return r * torch.sqrt(torch.abs(pi[0] * pj[0]))


_v_res = vmap(_pair_residual)
_v_jac = vmap(jacfwd(_pair_residual, argnums=(0, 1)))


def _norm_eqs(x, cam_i, cam_j, p1, p2, sizes, n):
    """Camera-block JtJ [4n, 4n] and Jtr [4n], scatter-added 4x4 blocks."""
    P = x.reshape(n, 4)
    args = (P[cam_i], P[cam_j], p1, p2, sizes[cam_i], sizes[cam_j])
    r = _v_res(*args)  # [m, 3]
    Ji, Jj = _v_jac(*args)  # [m, 3, 4] x2

    def blk(a, b):  # [m, 4, 4] = a^T b per match
        return (a[:, :, :, None] * b[:, :, None, :]).sum(1)

    JtJ = torch.zeros((n * n, 4, 4), dtype=x.dtype, device=x.device)
    JtJ.index_add_(0, cam_i * n + cam_i, blk(Ji, Ji))
    JtJ.index_add_(0, cam_j * n + cam_j, blk(Jj, Jj))
    JtJ.index_add_(0, cam_i * n + cam_j, blk(Ji, Jj))
    JtJ.index_add_(0, cam_j * n + cam_i, blk(Jj, Ji))
    Jtr = torch.zeros((n, 4), dtype=x.dtype, device=x.device)
    Jtr.index_add_(0, cam_i, (Ji * r[:, :, None]).sum(1))
    Jtr.index_add_(0, cam_j, (Jj * r[:, :, None]).sum(1))
    JtJ = JtJ.reshape(n, n, 4, 4).permute(0, 2, 1, 3).reshape(4 * n, 4 * n)
    return JtJ, Jtr.reshape(4 * n)


def _cost(x, cam_i, cam_j, p1, p2, sizes, n):
    P = x.reshape(n, 4)
    r = _v_res(P[cam_i], P[cam_j], p1, p2, sizes[cam_i], sizes[cam_j])
    return torch.sum(r * r)


def _levmar(x, free, args, n, max_iter, total):
    """The JAX function's LM loop: (x, cost, iterations, host reads of
    the loop condition).  ``total`` sums a tensor over the ranks that
    share the matches (in place)."""

    def norm_eqs(x):
        JtJ, Jtr = _norm_eqs(x, *args, n)
        both = total(torch.cat([JtJ.reshape(-1), Jtr]))  # one collective
        return both[: JtJ.numel()].view_as(JtJ), both[JtJ.numel() :]

    def cost_of(x):
        return total(_cost(x, *args, n))

    cost = cost_of(x)
    lam = torch.tensor(1e-3, dtype=x.dtype, device=x.device)
    stall = torch.zeros((), dtype=torch.int64, device=x.device)
    fm = free.to(x.dtype)
    lock = torch.diag(1.0 - fm)
    it = reads = 0
    while it < max_iter:
        go_stall, go_lam = torch.stack([stall.to(x.dtype), lam]).tolist()
        reads += 1
        if not (go_stall < 8 and go_lam < 1e12):
            break
        JtJ, Jtr = norm_eqs(x)
        # lock params outside the free set: unit diagonal, zero gradient
        A = JtJ * fm[:, None] * fm[None, :] + lock
        g = Jtr * fm
        damped = A + lam * torch.diag(torch.diagonal(A) + 1e-9)
        delta = torch.linalg.solve_ex(damped, -g[:, None])[0][:, 0]
        xn = x + delta * fm
        cn = cost_of(xn)
        accept = cn < cost
        x = torch.where(accept, xn, x)
        cost = torch.where(accept, cn, cost)
        lam = torch.where(accept, torch.clamp_min(lam * 0.1, 1e-10), lam * 10.0)
        stall = torch.where(accept, 0, stall + 1)
        it += 1
    return x, cost, it, reads


def _rank_share(data, mesh):
    """(cam_i, cam_j, p1, p2) of this rank's share of the matches padded
    to the mesh's rank count (bundle_jax.py:153-169), and the function
    that sums a tensor over the mesh's ranks in place."""
    m = len(data.cam_i)
    cols = (data.cam_i, data.cam_j, data.p1.astype(np.float32), data.p2.astype(np.float32))
    if mesh is None or mesh.mesh_group is None:
        return cols, lambda x: x
    ranks = [r for row in mesh.ranks for r in row]
    share = -(-m // len(ranks))
    pad = share * len(ranks)
    cam_i, cam_j = np.zeros(pad, np.int64), np.zeros(pad, np.int64)
    p1, p2 = np.zeros((pad, 2), np.float32), np.zeros((pad, 2), np.float32)
    cam_i[:m], cam_j[:m], p1[:m], p2[:m] = cols
    # padding rows: both ends the same camera and pixel
    cam_j[m:], p2[m:] = cam_i[m:], p1[m:]
    lo = ranks.index(dist.get_rank()) * share

    def total(x):
        dist.all_reduce(x, group=mesh.mesh_group)
        return x

    return tuple(a[lo : lo + share] for a in (cam_i, cam_j, p1, p2)), total


def bundle_adjust_ray_torch(
    features, matches, cameras, conf_thresh=1.0, max_iter=60, mesh=None, *, device="cuda", stats=None
):
    """Drop-in alternative to bundle_adjust_ray (the numpy f64 path): the
    camera-block LM on ``device`` ("cuda" without a card raises), in f32;
    with ``mesh`` on ``mesh.device``, the matches sharded over its ranks.
    Returns (cameras, rms)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    n = len(cameras)
    data = BundleData.from_matches(features, matches, conf_thresh)
    m = len(data.cam_i)
    if m == 0:
        return cameras, float("nan")

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    (cam_i, cam_j, p1, p2), total = _rank_share(data, mesh)
    args = (
        t(cam_i, torch.int64),
        t(cam_j, torch.int64),
        t(p1),
        t(p2),
        t(data.sizes.astype(np.float32)),
    )
    x = np.zeros(n * 4, dtype=np.float32)
    for c, cam in enumerate(cameras):
        x[c * 4] = cam.focal
        x[c * 4 + 1 : c * 4 + 4] = inv_rodrigues(cam.R)

    # phase 1 locks focals (see bundle.py on the ray-cost collapse)
    free_masks = [np.ones(n * 4, bool), np.ones(n * 4, bool)]
    free_masks[0][0::4] = False
    cost, iters, syncs = None, [], 0
    for free in free_masks:
        xt, ct, it, reads = _levmar(t(x), t(free, torch.bool), args, n, max_iter, total)
        x = xt.cpu().numpy().astype(np.float64)
        cost = float(ct)
        iters.append(it)
        syncs += reads + 2  # the condition's reads, then x and the cost
    if stats is not None:
        stats["iters"] = iters
        stats["syncs"] = syncs

    for c, cam in enumerate(cameras):
        cam.focal = float(x[c * 4])
        cam.R = rodrigues(x[c * 4 + 1 : c * 4 + 4])
    _center_normalize(cameras, matches, n)
    return cameras, float(np.sqrt(cost / m))
