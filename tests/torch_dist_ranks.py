"""One rank of the port's distributed tests (tests/test_torch_distributed*.py
and the two-rank case of tests/test_torch_on_card.py).  Imports no JAX.

    python tests/torch_dist_ranks.py JOB RANK

JOB is a pickle the test wrote: the world size, the rendezvous URL, the
backend, the device, an output directory and a list of cases.  The rank
joins the group (with a timeout), runs every case and pickles each
case's result to ``<out>/<case>-<rank>.pkl``.  Cases:

* ``stitch``: a rig (a dict for the port's compile_rig) stitched by a
  ShardedMapper on make_global_mesh(n_data, n_space), this rank's data
  row's frame sets in; the result holds the mesh's fields, the output,
  the gains and local_output_shards;
* ``meshes``: the mesh fields of make_global_mesh at each (n_data,
  n_space) given;
* ``ba``: bundle_adjust_ray_torch(mesh=make_global_mesh()) on the
  features, matches and cameras given;
* ``bands``: DistributedBands.sum and .concat of per-band tensors;
* ``raise``: raises on the rank given, before any collective.
"""

import datetime
import os
import pickle
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from octvr_tpu_torch.parallel import DistributedBands, ShardedMapper  # noqa: E402
from octvr_tpu_torch.runtime.distributed import (  # noqa: E402
    global_frame_batch,
    init_distributed,
    local_output_shards,
    make_global_mesh,
)


def mesh_fields(mesh):
    return dict(n_data=mesh.n_data, n_space=mesh.n_space, band_lo=mesh.band_lo, band_hi=mesh.band_hi,
                data_index=mesh.data_index, ranks=mesh.ranks,
                row=dist.get_process_group_ranks(mesh.group))


def case_stitch(c, dev):
    from octvr_tpu_torch.template import compile_rig

    mt = compile_rig(c["rig"], *c["canvas"])
    mt.create_masks()
    mesh = make_global_mesh(*c["mesh"], device=dev)
    sm = ShardedMapper(mt, c["sizes"], mesh, **c["kw"])
    frames = global_frame_batch(c["frames"][mesh.data_index], mesh)
    out, gains = sm.stitch_batch(frames)
    return dict(mesh=mesh_fields(mesh), out=out.cpu().numpy(), gains=gains.cpu().numpy(),
                shards=local_output_shards(out, mesh), group=type(sm.group).__name__)


def case_meshes(c, dev):
    return [mesh_fields(make_global_mesh(nd, ns, device=dev)) for nd, ns in c["meshes"]]


def case_ba(c, dev):
    from octvr_tpu_torch.registration.bundle_torch import bundle_adjust_ray_torch

    mesh = make_global_mesh(device=dev)
    stats = {}
    cams, rms = bundle_adjust_ray_torch(c["features"], c["matches"], c["cameras"], 0.5, mesh=mesh, stats=stats)
    return dict(focals=[cam.focal for cam in cams], R=[cam.R for cam in cams], rms=rms, stats=stats)


def case_bands(c, dev):
    mesh = make_global_mesh(1, c["S"], device=dev)
    group = DistributedBands(mesh.group, mesh.band_lo, mesh.band_hi, c["S"])
    x = torch.from_numpy(c["x"][mesh.band_lo : mesh.band_hi]).to(dev)
    return dict(sum=group.sum(x).cpu().numpy(), concat=group.concat(x, c["dim"]).cpu().numpy(),
                on=str(x.device))


def case_raise(c, dev):
    if dist.get_rank() == c["rank"]:
        raise RuntimeError("this rank fails before its first collective")
    dist.barrier()
    return {}


CASES = {"stitch": case_stitch, "meshes": case_meshes, "ba": case_ba, "bands": case_bands, "raise": case_raise}


def main(job_path, rank):
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)
    dev = torch.device(job["device"])
    if job["world"] == 1:
        # init_distributed leaves one process alone, so a one-rank group
        # is joined directly
        dist.init_process_group(job["backend"], init_method=job["init"], world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=job["timeout"]))
    elif not init_distributed(job["init"], job["world"], rank, backend=job["backend"], timeout=job["timeout"]):
        raise RuntimeError("init_distributed joined no group")
    for c in job["cases"]:
        res = CASES[c["kind"]](c, dev)
        with open(os.path.join(job["out"], f"{c['name']}-{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
