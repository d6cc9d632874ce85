"""The port's distributed runtime (runtime/distributed.py) and the band
group across ranks (parallel/sharded.py, DistributedBands) on the CPU:
real gloo ranks (tests/torch_dist_ranks.py), each launch under a 60 s
wall-clock limit, held to the port's one-process ShardedMapper
(LocalBands) on the same frames at gains rtol 1e-6 and Y and UV max
<= 1 (bit-equal for a one-rank group), and in one case to the JAX
ShardedMapper at the JAX package's Mapper bars (Y and UV mean < 0.2,
max <= 2, gains 1e-3).  JAX runs in the pytest process only."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
from octvr_tpu_torch.runtime import distributed as port_dist
from octvr_tpu_torch.template import compile_rig
from rigs import two_fisheye_rig
from sharded_fixtures import mapper_bar_errors
from test_stitch import render_camera_frames
from torch_dist_fixtures import LIMIT, launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM, CANVAS = 96, (192, 96)
EXPOSURES = ((1.15, 0.85), (0.9, 1.1), (1.0, 1.0), (1.2, 0.8))
# (n_data, n_space) meshes each world size lays out
MESHES = {1: [(1, 1), (1, 4), (None, 1)], 2: [(2, 1), (1, 2), (1, 4), (2, 2), (None, 1)],
          4: [(4, 1), (2, 2), (1, 4), (1, 8), (2, 4), (None, 2)]}

torch.set_num_threads(2)


def fisheye(n_sets):
    """The two-fisheye rig at 96^2 -> 192x96 and ``n_sets`` frame sets of
    the rendered world, each at its own exposure pair (per input a
    uint8 [n_sets, 144, 96])."""
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"].update(width=CAM, height=CAM)
    sets = [render_camera_frames(rig, exposure_gains=EXPOSURES[b % 4]) for b in range(n_sets)]
    return rig, [np.stack(f) for f in zip(*sets)]


def six_cam():
    """tests/sharded_fixtures.six_cam_small's rig and frames, the rig as
    a dict for the ranks' compile_rig."""
    from bench import six_cam_rig

    from sharded_fixtures import six_cam_small

    rig = six_cam_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = spec["options"]["height"] = 240
    _, _, frames = six_cam_small()
    return rig, [f[None] for f in frames]


def stitch_case(name, rig, frames, mesh, canvas=CANVAS, **kw):
    """A ``stitch`` case: frames per input [n_data * B, ...], split by
    data row for the ranks."""
    nd = mesh[0]
    B = frames[0].shape[0] // nd
    rows = [np.stack([f[d * B : (d + 1) * B] for f in frames], axis=1) for d in range(nd)]
    sizes = [(f.shape[1] * 2 // 3, f.shape[2]) for f in frames]
    return dict(kind="stitch", name=name, rig=rig, canvas=canvas, sizes=sizes, mesh=mesh, kw=kw,
                frames=rows, all_frames=frames)


def reference(case):
    """The port's one-process ShardedMapper (LocalBands) on the CPU over
    every data row's frames: (mapper, out, gains)."""
    mt = compile_rig(case["rig"], *case["canvas"])
    mt.create_masks()
    sm = ShardedMapper(mt, case["sizes"], make_mesh(case["mesh"][0], case["mesh"][1], device="cpu"), **case["kw"])
    out, gains = sm.stitch_batch([torch.from_numpy(f) for f in case["all_frames"]])
    return sm, out.numpy(), gains.numpy()


def assemble(results, shape, dtype):
    """The global output from every rank's local_output_shards, each
    element written exactly once."""
    full = np.zeros(shape, dtype)
    hits = np.zeros(shape, np.int32)
    for r in results:
        for idx, arr in r["shards"]:
            full[idx] = arr
            hits[idx] += 1
    assert (hits == 1).all(), "the ranks' shards do not tile the output"
    return full


def check_against_local(case, results, exact=False):
    """The ranks' output and gains against the one-process ShardedMapper:
    Y and UV (or RGB) max <= 1 and gains rtol 1e-6, or bit-equal."""
    sm, ref, g_ref = reference(case)
    got = assemble(results, ref.shape, ref.dtype)
    B = g_ref.shape[0] // case["mesh"][0]
    for r in results:
        d = r["mesh"]["data_index"]
        g = r["gains"]
        if exact:
            assert np.array_equal(g, g_ref[d * B : (d + 1) * B])
        np.testing.assert_allclose(g, g_ref[d * B : (d + 1) * B], rtol=1e-6, atol=0)
    if exact:
        assert np.array_equal(got, ref)
        return 0.0
    if sm.out_format == "rgb":
        err = float(np.abs(got - ref).max())
        assert err <= 1.0
        return err
    oh = sm.plan.out_size[1]
    errs = []
    for b in range(ref.shape[0]):
        _, y_max, _, uv_max = mapper_bar_errors(
            sm.assemble_yuv(got[b]).numpy(), sm.assemble_yuv(ref[b]).numpy(), oh
        )
        errs.append(max(y_max, uv_max))
    assert max(errs) <= 1
    return max(errs)


def expected_layout(world, n_data, n_space):
    """Per rank (band_lo, band_hi, data_index) from the JAX
    make_global_mesh device grid over 8 forced CPU devices: with R ranks
    per data row and k = n_space // R bands each, JAX process p holds k
    devices, so device id // k is the rank that holds that band."""
    import jax

    from octvr_tpu.runtime.distributed import make_global_mesh as jax_global_mesh

    nd = n_data if n_data is not None else max(1, world // n_space)
    R = world // nd
    k = n_space // R
    grid = np.array([[d.id for d in row] for row in jax_global_mesh(nd, n_space, jax.devices()[: nd * n_space]).devices])
    want = {}
    for d in range(nd):
        for s in range(n_space):
            rank = int(grid[d, s]) // k
            lo, hi, dd = want.get(rank, (s, s + 1, d))
            assert dd == d
            want[rank] = (min(lo, s), max(hi, s + 1), d)
    return want


# ------------------------------------------------------------ launches


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    rig, frames = fisheye(1)
    cases = [stitch_case("b32", rig, frames, (1, 2), blend=32, enable_gain=True, blend_dtype="float32"),
             dict(kind="meshes", name="meshes", meshes=MESHES[1])]
    return cases, launch(tmp_path_factory.mktemp("one"), 1, cases)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    rig, frames = fisheye(1)
    f32 = dict(enable_gain=True, blend_dtype="float32")
    cases = [
        stitch_case("b8", rig, frames, (1, 2), blend=8, **f32),
        stitch_case("b32", rig, frames, (1, 2), blend=32, **f32),
        stitch_case("b32_nosplit", rig, frames, (1, 2), blend=32, coarse_split=4, **f32),
        stitch_case("blocks", rig, frames, (1, 2), blend=32, enable_gain="blocks", blend_dtype="float32"),
        stitch_case("rgb", rig, frames, (1, 2), blend=32, pipeline="rgb", out_format="rgb", **f32),
        stitch_case("feather", rig, frames, (1, 2), blend=-8, **f32),
        stitch_case("four_bands", rig, frames, (1, 4), blend=32, **f32),
        dict(kind="meshes", name="meshes", meshes=MESHES[2]),
    ]
    rig6, frames6 = six_cam()
    cases.append(stitch_case("srcwin", rig6, frames6, (1, 4), canvas=(480, 240), blend=32, src_windows=True, **f32))
    t0 = time.time()
    res = launch(tmp_path_factory.mktemp("two"), 2, cases)
    print(f"two ranks, {len(cases)} cases: {time.time() - t0:.1f} s")
    return {c["name"]: c for c in cases}, res


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rig, frames = fisheye(4)
    f32 = dict(enable_gain=True, blend_dtype="float32")
    cases = [
        stitch_case("grid", rig, frames, (2, 2), blend=32, **f32),
        stitch_case("one_band_each", rig, [f[:1] for f in frames], (1, 4), blend=32, enable_gain="blocks",
                    blend_dtype="float32"),
        dict(kind="meshes", name="meshes", meshes=MESHES[4]),
    ]
    return {c["name"]: c for c in cases}, launch(tmp_path_factory.mktemp("four"), 4, cases)


# --------------------------------------------------------------- tests


def test_init_distributed_leaves_one_process_alone():
    assert port_dist.init_distributed(num_processes=1) is False
    assert not torch.distributed.is_initialized()
    mesh = port_dist.make_global_mesh(1, 2, device="cpu")
    assert mesh.group is None and (mesh.band_lo, mesh.band_hi, mesh.local_data) == (0, 2, 1)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_mesh_layout_matches_jax_device_grid(world, one_rank, two_ranks, four_ranks):
    """Each rank's bands and data row, at every mesh each world lays
    out, against the JAX make_global_mesh device grid."""
    res = {1: one_rank, 2: two_ranks, 4: four_ranks}[world][1]["meshes"]
    for m, (nd, ns) in enumerate(MESHES[world]):
        want = expected_layout(world, nd, ns)
        for rank, r in enumerate(res):
            got = r[m]
            assert (got["band_lo"], got["band_hi"], got["data_index"]) == want[rank], (nd, ns, rank)
            assert rank in got["row"] and got["row"] == list(got["ranks"][got["data_index"]])


def test_one_rank_group_is_bit_equal(one_rank):
    cases, res = one_rank
    assert res["b32"][0]["group"] == "DistributedBands"
    check_against_local(cases[0], res["b32"], exact=True)


@pytest.mark.parametrize("name", ["b8", "b32", "b32_nosplit", "blocks", "rgb", "feather", "four_bands", "srcwin"])
def test_two_ranks_match_local_bands(two_ranks, name):
    cases, res = two_ranks
    ranks = res[name]
    assert [r["group"] for r in ranks] == ["DistributedBands"] * 2
    k = 2 if cases[name]["mesh"][1] == 4 else 1
    assert [(r["mesh"]["band_lo"], r["mesh"]["band_hi"]) for r in ranks] == [(0, k), (k, 2 * k)]
    # every rank of the row solved the same gains
    assert np.array_equal(ranks[0]["gains"], ranks[1]["gains"])
    err = check_against_local(cases[name], ranks)
    print(f"{name}: max abs err vs LocalBands {err}")


def test_split_is_on_where_asked(two_ranks):
    cases, _ = two_ranks
    sm_b32, _, _ = reference(cases["b32"])
    sm_off, _, _ = reference(cases["b32_nosplit"])
    sm_src, _, _ = reference(cases["srcwin"])
    assert sm_b32.plan.split_level >= 0 and sm_off.plan.split_level < 0
    assert sm_src.plan.sliced and sm_src.plan.remap.concat


def test_four_ranks_data_rows_and_bands(four_ranks):
    """Mesh (2, 2): each data row stitches its own two frame sets; the
    local_output_shards indices are JAX's for the same global output."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from octvr_tpu.runtime.distributed import make_global_mesh as jax_global_mesh

    cases, res = four_ranks
    ranks = res["grid"]
    assert [(r["mesh"]["data_index"], r["mesh"]["band_lo"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    out_shape = (4,) + (ranks[0]["out"].shape[1] * 2, ranks[0]["out"].shape[2])
    jmesh = jax_global_mesh(2, 2, jax.devices()[:4])
    jidx = NamedSharding(jmesh, P("data", "space", None)).devices_indices_map(out_shape)
    by_id = {d.id: idx for d, idx in jidx.items()}
    for rank, r in enumerate(ranks):
        assert [idx for idx, _ in r["shards"]] == [by_id[rank]]
        assert r["shards"][0][1].shape == (2,) + r["out"].shape[1:]
    err = check_against_local(cases["grid"], ranks)
    print(f"mesh (2, 2): max abs err vs LocalBands {err}")


def test_four_ranks_one_band_each_blocks_gains(four_ranks):
    cases, res = four_ranks
    ranks = res["one_band_each"]
    assert [(r["mesh"]["band_lo"], r["mesh"]["band_hi"]) for r in ranks] == [(s, s + 1) for s in range(4)]
    err = check_against_local(cases["one_band_each"], ranks)
    print(f"mesh (1, 4), one band each, blocks gains: max abs err vs LocalBands {err}")


def test_two_ranks_match_jax_sharded_mapper(two_ranks):
    """The two ranks' canvas (blend 32, split on) against the JAX
    ShardedMapper on make_mesh(1, 2) at the Mapper bars."""
    from octvr_tpu.parallel.sharded import ShardedMapper as JaxShardedMapper
    from octvr_tpu.parallel.sharded import make_mesh as jax_make_mesh
    from octvr_tpu.template import compile_rig as jax_compile_rig

    cases, res = two_ranks
    case = cases["b32"]
    mt = jax_compile_rig(case["rig"], *case["canvas"])
    mt.create_masks()
    jsm = JaxShardedMapper(mt, case["sizes"], jax_make_mesh(1, 2), blend=32, enable_gain=True,
                           blend_dtype="float32", pipeline="yuv420")
    jout, jg = jsm.stitch_batch([np.asarray(f) for f in case["all_frames"]])
    ref = jsm.assemble_yuv(np.asarray(jout)[0])
    sm, local, _ = reference(case)
    got = sm.assemble_yuv(assemble(res["b32"], local.shape, local.dtype)[0]).numpy()
    y_mean, y_max, uv_mean, uv_max = mapper_bar_errors(got, ref, CANVAS[1])
    g_err = np.abs(res["b32"][0]["gains"][0] - np.asarray(jg)[0]).max()
    print(f"two ranks vs JAX: Y mean {y_mean:.4f} max {y_max}, UV mean {uv_mean:.4f} max {uv_max}, gains {g_err:.2e}")
    assert y_mean < 0.2 and uv_mean < 0.2 and y_max <= 2 and uv_max <= 2
    assert g_err < 1e-3


def test_a_failing_rank_fails_the_launch(tmp_path):
    """A rank that raises before a collective fails the launch at once:
    its peer, waiting in a barrier, is killed, nothing hangs."""
    t0 = time.time()
    with pytest.raises(RuntimeError, match="rank 1/2 exited"):
        launch(tmp_path, 2, [dict(kind="raise", name="raise", rank=1)])
    assert time.time() - t0 < LIMIT


@pytest.mark.parametrize("blend", [8, 32])
def test_port_multihost_stitch_tool(blend):
    """The port's tools/multihost_stitch at the JAX test's flags on the
    CPU: both ranks' PARITY lines under the JAX tool's bars."""
    p = subprocess.run(
        [sys.executable, "-m", "octvr_tpu_torch.tools.multihost_stitch", "--procs", "2", "--devices-per-proc", "2",
         "--cam", "96", "--canvas", "192x96", "--blend", str(blend), "--iters", "1", "--pipeline", "yuv420",
         "--device", "cpu", "--timeout", str(LIMIT)],
        capture_output=True, text=True, timeout=LIMIT + 10, cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert p.returncode == 0, p.stderr[-4000:]
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    assert summary["procs"] == 2 and summary["backend"] == "gloo" and summary["device"] == "cpu"
    assert summary["parity_ok"], summary
    assert sorted(par["proc"] for par in summary["parity"]) == [0, 1]
    for par in summary["parity"]:
        assert par["y_mean_err"] < 1.5 and par["gain_err"] < 0.05
    assert summary["frames_per_s"] > 0
