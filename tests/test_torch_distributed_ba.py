"""``bundle_adjust_ray_torch(mesh=)`` on the CPU: the 5-camera ring's
matches (tests/test_torch_registration.py's ring, registered by the JAX
package and carried across) sharded over 2, 3 and 4 real gloo ranks
(tests/torch_dist_ranks.py, each launch under a 60 s limit), against
the one-process port at rtol 1e-4 and against the JAX
``bundle_adjust_ray_jax(mesh=)`` on an 8-device CPU mesh at
tests/test_registration.py's bars (focals rtol 0.01, rms within 0.1).
The ring has 266 matches, so 3 and 4 ranks take padding rows."""

import copy
import math

import numpy as np
import pytest
import torch

from octvr_tpu.registration import register_images as jax_register_images
from octvr_tpu.registration.bundle_jax import bundle_adjust_ray_jax
from octvr_tpu_torch.parallel import make_mesh
from octvr_tpu_torch.registration.bundle import BundleData
from octvr_tpu_torch.registration.bundle_torch import bundle_adjust_ray_torch
from octvr_tpu_torch.registration.convert import cameras_from_jax, features_from_jax, matches_from_jax
from test_registration import render_view, yaw_cameras
from torch_dist_fixtures import launch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ring():
    """The JAX package's registration of the ring before its BA, and the
    port's copies of its features, matches and cameras."""
    images = [render_view(R, 380.0, 400, 300) for R in yaw_cameras(5, 30.0)]
    res = jax_register_images(images, ba=None, wave_kind=None, conf_thresh=0.5)
    port = ([features_from_jax(f, "cpu") for f in res.features], matches_from_jax(res.matches),
            cameras_from_jax(res.cameras))
    return res, port


@pytest.fixture(scope="module")
def one_process(ring):
    feats, matches, cams = ring[1]
    stats = {}
    got, rms = bundle_adjust_ray_torch(feats, matches, copy.deepcopy(cams), 0.5, device="cpu", stats=stats)
    return got, rms, stats


@pytest.fixture(scope="module")
def jax_mesh(ring):
    """bundle_adjust_ray_jax(mesh=) on an 8-device CPU mesh: (cameras, rms)."""
    import jax
    from jax.sharding import Mesh

    res = ring[0]
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), axis_names=("data",))
    return bundle_adjust_ray_jax(res.features, res.matches, copy.deepcopy(res.cameras), 0.5, mesh=mesh)


def _rot_angle(A, B):
    d = np.asarray(A) @ np.asarray(B).T
    return math.acos(np.clip((np.trace(d) - 1) / 2, -1, 1))


def test_one_process_mesh_computes_what_no_mesh_computes(ring, one_process):
    feats, matches, cams = ring[1]
    got, rms = bundle_adjust_ray_torch(feats, matches, copy.deepcopy(cams), 0.5, mesh=make_mesh(1, 1, device="cpu"))
    want, want_rms, _ = one_process
    assert rms == want_rms
    for a, b in zip(got, want, strict=True):
        assert a.focal == b.focal and np.array_equal(a.R, b.R)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_ranks_match_one_process_and_jax_mesh(ring, one_process, jax_mesh, world, tmp_path):
    feats, matches, cams = ring[1]
    m = len(BundleData.from_matches(feats, matches, 0.5).cam_i)
    assert (m % world != 0) == (world != 2)  # 3 and 4 ranks pad
    ranks = launch(tmp_path, world, [dict(kind="ba", name="ba", features=feats, matches=matches, cameras=cams)])["ba"]
    # every rank took the same branches to the same result
    for r in ranks[1:]:
        assert r["focals"] == ranks[0]["focals"] and r["rms"] == ranks[0]["rms"]
        assert all(np.array_equal(a, b) for a, b in zip(r["R"], ranks[0]["R"]))
        assert r["stats"] == ranks[0]["stats"]
    got = ranks[0]
    want, want_rms, want_stats = one_process
    rot = max(_rot_angle(a, b.R) for a, b in zip(got["R"], want))
    print(f"{world} ranks: focals {got['focals']}, rms {got['rms']} vs one process {want_rms}, rotations "
          f"{rot:.2e} rad, stats {got['stats']} vs {want_stats}")
    np.testing.assert_allclose(got["focals"], [c.focal for c in want], rtol=1e-4)
    assert abs(got["rms"] - want_rms) <= 1e-4 * want_rms
    assert rot < 1e-4
    # one host sync per iteration: the loop condition, once more where it
    # ends a phase, and x and the cost of each of the two phases
    assert 4 <= got["stats"]["syncs"] - sum(got["stats"]["iters"]) <= 6

    jcams, jrms = jax_mesh
    np.testing.assert_allclose(got["focals"], [c.focal for c in jcams], rtol=0.01)
    assert abs(got["rms"] - jrms) < 0.1
