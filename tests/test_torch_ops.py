"""Port ops (octvr_tpu_torch.ops, .utils) against the JAX package: remap
plan and gather, the paired Pallas remap kernel (interpret mode),
pyramid matrices and products, YUV420P split/merge, device transfer.
Inputs come from numpy seeds; tensors cross between the two frameworks
as numpy arrays."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from octvr_tpu.ops import color as jcolor
from octvr_tpu.ops import pyramid as jpyr
from octvr_tpu.ops import remap as jremap
from octvr_tpu_torch.ops import color, cuda_remap, pyramid
from octvr_tpu_torch.ops.remap import (
    remap_apply_reference,
    remap_group,
    remap_plan,
    remap_taps,
)
from octvr_tpu_torch.utils.device import resolve_device, to_device
from remap_fixtures import IN_H, IN_W, arc_maps, edge_maps
from test_pallas_remap import _arc_maps

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

MAPS = {"arc": lambda: _arc_maps(64, 256), "edge": edge_maps}


def _planes(seed, n, nc):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, nc, IN_H, IN_W), dtype=np.uint8)


@pytest.mark.parametrize("maps", sorted(MAPS))
def test_remap_plan_bit_equal(maps):
    m1, m2 = MAPS[maps]()
    ref = jremap.remap_plan(m1, m2, IN_H, IN_W)
    got = remap_plan(m1, m2, IN_H, IN_W)
    assert np.array_equal(got.idx, ref.idx)
    assert np.array_equal(got.w, ref.w)
    assert got.out_shape == ref.out_shape and got.in_shape == ref.in_shape
    # the kernel's per-pixel taps give back the same idx / w, bit for bit
    idx, w = remap_taps(remap_group([got], "cpu"))
    assert np.array_equal(idx.numpy(), ref.idx)
    assert np.array_equal(w.numpy(), ref.w)
    # F1: the first half-pixel blends pixels 0 and 1 (0.34 / 0.66 at W=8)
    p = remap_plan(np.full((1, 1), 0.02, np.float32), np.full((1, 1), 0.5, np.float32), 8, 8)
    assert p.x0[0] == 0 and abs(p.fx[0] - 0.66) < 1e-6


@pytest.mark.parametrize("maps", sorted(MAPS))
@pytest.mark.parametrize("nc", [1, 2])
def test_remap_reference_matches_xla_gather(maps, nc):
    """Plain torch gather vs the JAX XLA gather (remap_apply) in f32;
    bf16 output within 1.0 of the f32 output."""
    m1, m2 = MAPS[maps]()
    planes = _planes(10 + nc, 1, nc)
    ref = np.asarray(
        jremap.remap_apply(
            jnp.asarray(planes[0].astype(np.float32)),
            jremap.remap_plan(m1, m2, IN_H, IN_W),
        )
    )
    group = remap_group([remap_plan(m1, m2, IN_H, IN_W)], "cpu")
    (got,) = remap_apply_reference(torch.from_numpy(planes), group)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() < 1e-3
    (got16,) = remap_apply_reference(
        torch.from_numpy(planes), group, torch.bfloat16
    )
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - got).abs().max() <= 1.0


def test_remap_group_layout():
    """A group of inputs with different ROI shapes gives each input the
    same output as its own one-input group; invalid pixels are exactly 0."""
    ma, mb = _arc_maps(64, 256), edge_maps()
    # the JAX-free copy of the fixture (on-card tests, chip_smoke.py)
    assert all(np.array_equal(a, b) for a, b in zip(arc_maps(64, 256), ma))
    pa = remap_plan(*ma, IN_H, IN_W)
    pb = remap_plan(*mb, IN_H, IN_W)
    planes = torch.from_numpy(_planes(3, 2, 2))
    outs = remap_apply_reference(planes, remap_group([pa, pb], "cpu"))
    (ra,) = remap_apply_reference(planes[:1], remap_group([pa], "cpu"))
    (rb,) = remap_apply_reference(planes[1:], remap_group([pb], "cpu"))
    assert outs[0].shape == (2, 64, 256) and outs[1].shape == (2, 32, 256)
    assert torch.equal(outs[0], ra) and torch.equal(outs[1], rb)
    assert (outs[0][:, ma[0] < 0] == 0).all()


@pytest.mark.parametrize("nc", [1, 2])
def test_remap_matches_paired_pallas_kernel(nc):
    """The plain torch gather against the product's paired Pallas kernel
    (pallas_remap_apply_batched, interpret mode) on pair-packed uint8
    planes: nc=1 is the Y launch, nc=2 the U|V launch."""
    from octvr_tpu.ops.pallas_remap import (
        merge_remap_plans,
        pack_pairs,
        pallas_remap_apply_batched,
    )

    m1, m2 = _arc_maps(64, 256)
    planes = _planes(21, 1, 2)[:, :nc]
    bp = merge_remap_plans([(m1, m2)], IN_H, IN_W, paired=True)
    group = remap_group([remap_plan(m1, m2, IN_H, IN_W)], "cpu")
    q = jnp.asarray(planes[0].astype(np.int32))
    (ref,) = pallas_remap_apply_batched(
        pack_pairs(list(q))[None], bp, interpret=True, nc=nc, paired=True
    )
    (got,) = remap_apply_reference(torch.from_numpy(np.ascontiguousarray(planes)), group)
    assert np.abs(np.asarray(ref) - got.numpy()).max() < 1e-3


def test_remap_group_precomputes_launch_shape():
    """The launch's pixel counts are host ints of the group, computed
    once: ``total`` output pixels of a channel, ``max_count`` of the
    largest input."""
    pa = remap_plan(*_arc_maps(64, 256), IN_H, IN_W)
    pb = remap_plan(*edge_maps(), IN_H, IN_W)
    one = np.zeros((1, 1), np.float32)
    pc = remap_plan(one + 0.5, one + 0.5, IN_H, IN_W)
    group = remap_group([pa, pb, pc], "cpu")
    counts = [pa.x0.size, pb.x0.size, 1]
    assert group.total == sum(counts) == group.starts[-1] == int(group.offsets[-1])
    assert group.max_count == max(counts) and isinstance(group.max_count, int)


def test_remap_wrapper_takes_plain_version_on_cpu():
    m1, m2 = _arc_maps(64, 256)
    group = remap_group([remap_plan(m1, m2, IN_H, IN_W)], "cpu")
    planes = torch.from_numpy(_planes(5, 1, 2))
    before = cuda_remap.LAUNCHES
    (got,) = cuda_remap.remap_apply(planes, group, torch.bfloat16)
    (ref,) = remap_apply_reference(planes, group, torch.bfloat16)
    assert torch.equal(got, ref)
    assert cuda_remap.LAUNCHES == before  # no kernel ran


def test_deferred_counts_hold_a_capture_apart():
    """Launches counted inside ``launch_counts.deferred`` go to its dict,
    for every kernel family and on its thread alone; ``replay`` of that
    dict counts them again at each replay of the graph that holds them."""
    import threading

    from octvr_tpu_torch.ops import cuda_pyramid, launch_counts

    before, counts = cuda_remap.LAUNCHES, dict(cuda_remap.COUNTS)
    pyr_before = cuda_pyramid.LAUNCHES
    with launch_counts.deferred() as held:
        cuda_remap._COUNTER.add({"nc1_bf16": 1})
        cuda_remap._COUNTER.add({"nc1_bf16": 1, "nc2_bf16": 1})
        cuda_pyramid._COUNTER.add({"down_c1_bf16": 1})
        other = threading.Thread(target=cuda_remap._COUNTER.add, args=({"nc3_f32": 1},))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    assert held == {cuda_remap._COUNTER: {"nc1_bf16": 2, "nc2_bf16": 1},
                    cuda_pyramid._COUNTER: {"down_c1_bf16": 1}}
    assert cuda_remap.LAUNCHES == before + 1 and cuda_remap.COUNTS.get("nc3_f32", 0) == counts.get("nc3_f32", 0) + 1
    assert cuda_pyramid.LAUNCHES == pyr_before
    for _ in range(2):
        launch_counts.replay(held)
    assert cuda_remap.LAUNCHES == before + 7
    assert cuda_remap.COUNTS["nc1_bf16"] == counts.get("nc1_bf16", 0) + 4
    assert cuda_pyramid.LAUNCHES == pyr_before + 2


def test_pyramid_matrices_bit_equal():
    for n in (2, 6, 16, 40, 97):
        assert np.array_equal(pyramid.down_matrix(n), jpyr.down_matrix(n))
        assert np.array_equal(pyramid.up_matrix(n), jpyr.up_matrix(n))


def test_pyramid_products_match_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, (2, 32, 48)).astype(np.float32)
    kv, kh = jpyr.down_matrix(32), jpyr.down_matrix(48)
    ref = np.asarray(jpyr.pyr_down_mm(jnp.asarray(x), kv, kh))
    got = pyramid.pyr_down_mm(torch.from_numpy(x), torch.from_numpy(kv), torch.from_numpy(kh))
    assert np.abs(got.numpy() - ref).max() < 1e-3
    uv, uh = jpyr.up_matrix(16), jpyr.up_matrix(24)
    ref = np.asarray(jpyr.pyr_up_mm(jnp.asarray(ref), uv, uh))
    got = pyramid.pyr_up_mm(got, torch.from_numpy(uv), torch.from_numpy(uh))
    assert np.abs(got.numpy() - ref).max() < 1e-3
    # importing the port leaves the process's TF32 settings as it set them
    code = (
        "import torch; torch.set_float32_matmul_precision('high'); "
        "import octvr_tpu_torch.parallel, octvr_tpu_torch.ops.mxu_taps, octvr_tpu_torch.tools.mxu_taps_probe; "
        "assert torch.get_float32_matmul_precision() == 'high' and torch.backends.cuda.matmul.allow_tf32"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
    # under TF32 the products raise instead of running, and leave the setting alone
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="highest"):
            pyramid.pyr_down_mm(torch.from_numpy(x), torch.from_numpy(kv), torch.from_numpy(kh))
        assert torch.get_float32_matmul_precision() == "high" and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before)
    assert not torch.backends.cuda.matmul.allow_tf32


def test_yuv420p_split_merge_match_jax():
    rng = np.random.default_rng(4)
    buf = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    ref = jcolor.split_yuv420p(jnp.asarray(buf))
    got = color.split_yuv420p(torch.from_numpy(buf))
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())
    assert np.array_equal(color.merge_yuv420p(*got).numpy(), buf)


def test_resolve_device_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_to_device_bf16_matches_ml_dtypes():
    rng = np.random.default_rng(6)
    x = rng.normal(0, 300, (64, 33)).astype(np.float32)
    # torch's f32 -> bf16 cast rounds as ml_dtypes does (nearest even)
    bf = to_device(x, "cpu", torch.bfloat16)
    ref = x.astype(ml_dtypes.bfloat16)
    assert np.array_equal(bf.view(torch.int16).numpy().view(np.uint16), ref.view(np.uint16))
    # ml_dtypes bf16 arrays are read bit for bit
    assert torch.equal(to_device(ref, "cpu"), bf)


def test_port_imports_no_jax():
    code = (
        "import sys, octvr_tpu_torch.stitch, octvr_tpu_torch.stitch.convert, "
        "octvr_tpu_torch.ops.cuda_remap, octvr_tpu_torch.runtime, octvr_tpu_torch.presets, "
        "octvr_tpu_torch.cli.stream, octvr_tpu_torch.cli.map, octvr_tpu_torch.cli.monkey, "
        "octvr_tpu_torch.cli.monkey_gen; "
        "assert 'jax' not in sys.modules and 'ml_dtypes' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
    for f in (ROOT / "octvr_tpu_torch").rglob("*.py"):
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert not words[1].startswith(("jax", "ml_dtypes")), (f, line)
