"""Multi-process runtime: the counterpart of octvr_tpu/runtime/distributed.py
on ``torch.distributed``.

Every process runs the same program after :func:`init_distributed`, as
one rank of a process group.  :func:`make_global_mesh` lays the ranks out
as a ('data', 'space') grid: each data row stitches its own frame sets,
and its ranks share the row's bands, so that only the band group's gain
sums and level-L row gathers cross ranks (parallel/sharded.py,
``DistributedBands``).  Each rank feeds only its row's frames
(:func:`global_frame_batch`: no frame bytes cross ranks) and gets back
only its own output shards (:func:`local_output_shards`).

One process: every function below works without a process group, on
the process's own device, so the same program runs on one card or on
many.  NCCL takes one card per rank; ranks that share a card are started
with ``backend="gloo"``, which takes CUDA tensors too.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.sharded import BandMesh, make_mesh
from ..utils.device import resolve_device

__all__ = [
    "init_distributed",
    "make_global_mesh",
    "global_frame_batch",
    "local_output_shards",
]


def init_distributed(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    local_device_ids=None,
    *,
    backend=None,
    timeout=None,
):
    """Join the process group.  ``coordinator_address``: "host:port"
    (TCP), a URL such as "file:///path" used as it is, or None for the
    ``env://`` variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    ``local_device_ids[0]`` is this rank's card.  ``backend``: "nccl" or
    "gloo"; None picks "nccl" when a card is present and "gloo" on the
    CPU.  ``timeout``: seconds a collective may wait for the other ranks.
    Returns False, and initialises nothing, for one process or a group
    that is already up; True once the group is joined."""
    if num_processes == 1 or dist.is_initialized():
        return False
    if local_device_ids:
        resolve_device("cuda")
        torch.cuda.set_device(int(local_device_ids[0]))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        **kw,
    )
    return True


def make_global_mesh(n_data=None, n_space=1, devices=None, *, device="cuda"):
    """('data', 'space') mesh over the ranks ``devices`` (default: every
    rank of the group).  The ranks are laid out [n_data, R] row by row,
    R = len(ranks) // n_data (n_data defaults to len(ranks) // n_space):
    rank (d, p) serves data row d and bands [p*k, (p+1)*k), k = n_space
    // R.  This is the JAX mesh's device grid with one device per rank;
    at R = 1 a rank holds every band of its row, as a JAX process with
    several devices does.  Every rank must call this with the same
    arguments: each data row gets a process group of its ranks.  Without
    a process group: ``make_mesh(n_data, n_space)`` on ``device``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return make_mesh(1 if n_data is None else n_data, n_space, device=dev)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if n_data is None:
        n_data = max(1, len(ranks) // n_space)
    R = len(ranks) // n_data
    if R < 1 or n_space % R:
        raise ValueError(f"{len(ranks)} ranks in {n_data} data rows cannot share {n_space} bands evenly")
    grid = [tuple(ranks[d * R : (d + 1) * R]) for d in range(n_data)]
    groups = [dist.new_group(list(row)) for row in grid]
    mesh_ranks = [r for row in grid for r in row]
    mesh_group = dist.new_group(mesh_ranks)
    me = dist.get_rank()
    if me not in mesh_ranks:
        raise ValueError(f"rank {me} is not in the mesh's ranks {mesh_ranks}")
    d, p = divmod(mesh_ranks.index(me), R)
    k = n_space // R
    return BandMesh(
        n_data, n_space, dev, band_lo=p * k, band_hi=(p + 1) * k, data_index=d,
        group=groups[d], ranks=tuple(grid), mesh_group=mesh_group,
    )


def global_frame_batch(local_frames, mesh: BandMesh):
    """This process's frame sets, uint8 [B_local, ncam, Hf*3/2, Wf], as a
    tensor on ``mesh.device``.  Every rank of a data row passes that
    row's frame sets; no frame bytes cross ranks."""
    f = local_frames if isinstance(local_frames, torch.Tensor) else torch.from_numpy(np.asarray(local_frames))
    if f.dtype != torch.uint8 or f.dim() != 4 or f.shape[2] % 3 or f.shape[3] % 2:
        raise ValueError(f"want uint8 frames [B, ncam, Hf*3/2, Wf], got {f.dtype} {tuple(f.shape)}")
    if f.shape[0] % mesh.local_data:
        raise ValueError(f"{f.shape[0]} frame sets for {mesh.local_data} data rows")
    return f.to(mesh.device)


def local_output_shards(out, mesh: BandMesh):
    """The output shards this process holds, as (index, ndarray) pairs,
    each index the JAX shard index into the global output: (batch rows,
    band rows, :) for yuv420 output [B, k*obh*3/2, oW], (batch rows, :,
    band rows, :) for rgb output [B, 3, k*obh, oW]; an axis of size 1
    takes slice(None).  A torch tensor carries no sharding, so this
    takes the mesh (the one difference from the JAX signature)."""
    host = out.detach().cpu().numpy()
    rgb = host.ndim == 4
    k = mesh.band_hi - mesh.band_lo
    rows = (host.shape[2] if rgb else host.shape[1]) // k
    held = range(mesh.n_data) if mesh.group is None else [mesh.data_index]
    nb = host.shape[0] // len(held)
    shards = []
    for i, d in enumerate(held):
        b_idx = slice(None) if mesh.n_data == 1 else slice(d * nb, (d + 1) * nb)
        for j in range(k):
            s = mesh.band_lo + j
            s_idx = slice(None) if mesh.n_space == 1 else slice(s * rows, (s + 1) * rows)
            b, r = slice(i * nb, (i + 1) * nb), slice(j * rows, (j + 1) * rows)
            if rgb:
                shards.append(((b_idx, slice(None), s_idx, slice(None)), host[b, :, r]))
            else:
                shards.append(((b_idx, s_idx, slice(None)), host[b, r]))
    return shards
