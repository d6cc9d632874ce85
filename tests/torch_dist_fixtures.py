"""Launching the ranks of the port's distributed tests: each case runs in
real processes of tests/torch_dist_ranks.py, joined by a gloo group
through a ``file://`` rendezvous in the test's temporary directory (no
TCP port, so pytest-xdist workers cannot collide), under a wall-clock
limit after which every rank is killed and the test fails."""

import os
import pickle
import sys

from octvr_tpu_torch.tools.multihost_stitch import run_ranks

RANKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_ranks.py")
LIMIT = 60  # seconds for a launch, and for a collective's wait


def launch(tmp, world, cases, device="cpu", backend="gloo", limit=LIMIT):
    """Run ``cases`` on ``world`` ranks; returns {case name: [result of
    rank 0, rank 1, ...]}.  Raises RuntimeError when a rank fails or the
    launch outlasts ``limit`` seconds."""
    job = dict(world=world, init=f"file://{tmp}/rendezvous", backend=backend, device=device, out=str(tmp),
               cases=cases, timeout=limit)
    path = os.path.join(tmp, "job.pkl")
    with open(path, "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run_ranks([[sys.executable, RANKS, path, str(r)] for r in range(world)], limit, env=env)
    out = {}
    for c in cases:
        out[c["name"]] = []
        for r in range(world):
            with open(os.path.join(tmp, f"{c['name']}-{r}.pkl"), "rb") as f:
                out[c["name"]].append(pickle.load(f))
    return out
