"""Port tests that need an NVIDIA card: the CUDA remap kernels (NC=1, 2
and 3; the one-frame kernel on ragged inputs and on a shape it refuses;
the frames kernel against one-frame launches; stacked or concat
sources; a CUDA-graph replay), the Mapper's graph against its eager
stitch (every option group, fresh outputs, two streams, the pipeline,
TF32 set after the capture, a polar cap with an empty input), and the
three kernels of the MXU-taps probe (kernel 8) against their plain
torch versions, the prep kernel against the eager prep byte for byte
(the bench rig's frames, odd geometries, block stacks, strided views,
the rounding edges, the 16-frame ring stack in a graph, the benchmark
configurations' stitch), the 16-camera ring's graph against its eager
stitch, and the
port's Mapper and ShardedMapper (every option group) on the card
against the port on the CPU, and the band group
across two gloo ranks that share the card.  They carry the
``cuda`` marker and skip without a card.
This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py -q
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from octvr_tpu_torch.ops import color, cuda_prep, cuda_pyramid, cuda_remap, mxu_taps
from octvr_tpu_torch.ops.pyramid import down_matrix, pyr_down_mm, pyr_up_mm, up_matrix
from octvr_tpu_torch.ops.remap import (
    concat_source,
    remap_apply_reference,
    remap_group,
    remap_plan,
    split_frame_outputs,
)
from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
from octvr_tpu_torch.stitch import FastMapper, Mapper, blenders
from octvr_tpu_torch.template import compile_rig
from octvr_tpu_torch.tools.mxu_taps_probe import make_probe_inputs
from blend_fixtures import CANVAS, blend_scene
from prep_fixtures import bench_vignettes, prep_numpy, rounding_edges
from remap_fixtures import H_B, IN_H, IN_W, LO, arc_maps, concat_maps, edge_maps, ragged_maps
from rigs import two_fisheye_rig
from taps_fixtures import edge_probe_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("maps", ["arc", "edge"])
@pytest.mark.parametrize("nc", [1, 2, 3])
def test_remap_kernel_matches_plain_on_card(cuda_device, maps, nc):
    """f32 within 1e-3 of the plain version; bf16 within 1.0 of the
    kernel's f32; one launch counted per call."""
    ma = arc_maps(64, 256) if maps == "arc" else edge_maps()
    plans = [remap_plan(*ma, IN_H, IN_W), remap_plan(*arc_maps(64, 256)[::-1], IN_H, IN_W)]
    group = remap_group(plans, cuda_device)
    rng = np.random.default_rng(30 + nc)
    planes = torch.from_numpy(
        rng.integers(0, 256, (2, nc, IN_H, IN_W), dtype=np.uint8)
    ).to(cuda_device)
    before = cuda_remap.LAUNCHES
    got = cuda_remap.remap_apply(planes, group, torch.float32)
    got16 = cuda_remap.remap_apply(planes, group, torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_remap.LAUNCHES == before + 2
    ref = remap_apply_reference(planes, group, torch.float32)
    for g, g16, r in zip(got, got16, ref):
        assert (g - r).abs().max().item() < 1e-3
        assert (g16.float() - g).abs().max().item() <= 1.0


def _group_and_planes(device, nc, seed, n=2, frames=None):
    maps = [arc_maps(64, 256), edge_maps()][:n]
    group = remap_group([remap_plan(*m, IN_H, IN_W) for m in maps], device)
    rng = np.random.default_rng(seed)
    shape = (n, nc, IN_H, IN_W) if frames is None else (frames, n, nc, IN_H, IN_W)
    return group, torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_bf16_store_equals_f32_cast(cuda_device, nc):
    """The kernel's bf16 store equals its f32 store cast afterwards, bit
    for bit: the equal-size rgb launch (bf16 out of the kernel) and the
    JAX package's mixed-size launch (f32, cast by the blend) agree."""
    group, planes = _group_and_planes(cuda_device, nc, 40 + nc)
    k32 = cuda_remap.remap_apply(planes, group, torch.float32)
    k16 = cuda_remap.remap_apply(planes, group, torch.bfloat16)
    for a, b in zip(k16, k32):
        assert torch.equal(a, b.to(torch.bfloat16))


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_frames_axis_equals_separate_launches(cuda_device, nc):
    """One frames-axis launch over B=3 frames gives, bit for bit, what B
    one-frame launches give; each variant counts its own launches."""
    group, planes = _group_and_planes(cuda_device, nc, 50 + nc, frames=3)
    cuda_remap.reset_counts()
    got = cuda_remap.remap_apply_frames(planes, group, torch.bfloat16)
    assert cuda_remap.COUNTS == {f"frames_nc{nc}_bf16": 1}
    for b in range(3):
        for g, one in zip(got, cuda_remap.remap_apply(planes[b], group, torch.bfloat16)):
            assert torch.equal(g[b], one)
    assert cuda_remap.COUNTS[f"nc{nc}_bf16"] == 3 and cuda_remap.LAUNCHES == 4


def _ragged(device, nc, seed, frames=None):
    group = remap_group([remap_plan(*m, IN_H, IN_W) for m in ragged_maps()], device)
    n = len(group.out_shapes)
    rng = np.random.default_rng(seed)
    shape = (n, nc, IN_H, IN_W) if frames is None else (frames, n, nc, IN_H, IN_W)
    return group, torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_one_frame_kernel_ragged_inputs(cuda_device, nc):
    """The one-frame kernel (two pixels per thread) on inputs whose
    counts and starts are no multiple of 2 (a 1-pixel input, an
    all-invalid one, the edge-clamp maps): f32 within 1e-3 of the plain
    version, exact zeros where invalid, the bf16 store equal to the cast
    f32 store.  A group one pixel past the kernel's per-input limit
    (2^31 - 513) is refused with the limits named, and nothing runs."""
    group, planes = _ragged(cuda_device, nc, 80 + nc)
    assert any(s % 2 for s in group.starts[1:-1])
    ref = remap_apply_reference(planes, group, torch.float32)
    assert ref[2].abs().max().item() == 0.0
    cuda_remap.reset_counts()
    k32, _ = cuda_remap.launch_flat(planes, group, torch.float32)
    k16, _ = cuda_remap.launch_flat(planes, group, torch.bfloat16)
    got = split_frame_outputs(k32, group, nc)
    for g, r in zip(got, ref):
        assert (g[0] - r).abs().max().item() < 1e-3
    assert torch.equal(k16, k32.to(torch.bfloat16))
    assert got[2].abs().max().item() == 0.0
    torch.cuda.synchronize()
    assert cuda_remap.COUNTS == {f"nc{nc}_f32": 1, f"nc{nc}_bf16": 1}
    if nc == 1:  # the refused launch still allocates its 4 GB bf16 output
        huge = dataclasses.replace(group, max_count=2**31 - 512, total=2**31 - 512)
        with pytest.raises(RuntimeError, match=r"src_rows \* W"):
            cuda_remap.launch_flat(planes, huge, torch.bfloat16)
        assert cuda_remap.COUNTS == {f"nc{nc}_f32": 1, f"nc{nc}_bf16": 1}


@pytest.mark.parametrize("frames", [1, 3, 4, 5])
@pytest.mark.parametrize("source", ["ragged", "concat"])
@pytest.mark.parametrize("nc", [1, 2, 3])
def test_frames_kernel_equals_one_frame_launches(cuda_device, nc, source, frames):
    """The frames kernel over B frames gives, bit for bit, what B
    one-frame launches give, f32 and bf16, on ragged inputs and on
    concat sources; one frames launch counted per call."""
    if source == "ragged":
        group, src = _ragged(cuda_device, nc, 90 + nc, frames=frames)
    else:
        group, src = _concat_case(cuda_device, nc, 95 + nc, frames=frames)
    tag = "concat_" if source == "concat" else ""
    for dtype in (torch.float32, torch.bfloat16):
        cuda_remap.reset_counts()
        got = cuda_remap.remap_apply_frames(src, group, dtype)
        assert cuda_remap.COUNTS == {f"frames_{tag}nc{nc}_{str(dtype)[6:].replace('float', 'f')}": 1}
        for b in range(frames):
            for g, one in zip(got, cuda_remap.remap_apply(src[b], group, dtype)):
                assert torch.equal(g[b], one)


def test_graph_replay_equals_eager(cuda_device):
    """One-frame and frames launches captured in a CUDA graph and
    replayed give the eager launches' outputs bit for bit."""
    group, planes = _ragged(cuda_device, 3, 99, frames=2)
    eager = [cuda_remap.launch_flat(planes[0], group, torch.bfloat16)[0],
             cuda_remap.launch_flat(planes, group, torch.bfloat16, frames=True)[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_remap.launch_flat(planes[0], group, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [cuda_remap.launch_flat(planes[0], group, torch.bfloat16)[0],
                cuda_remap.launch_flat(planes, group, torch.bfloat16, frames=True)[0]]
    for o in outs:
        o.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for o, e in zip(outs, eager):
        assert torch.equal(o, e)


# pyramid kernels (csrc/pyramid.cu): the input shapes [C, n_h, n_w] of
# each step, tiny, even and odd, and the 4K canvas (the largest length of
# its plans: the collapse's last up step writes it)
PYR_DOWN_SHAPES = [(2, 2), (3, 5), (5, 3), (64, 96), (67, 131), (130, 258), (1920, 3840)]
PYR_UP_SHAPES = [(1, 1), (2, 3), (5, 2), (33, 65), (64, 128), (960, 1920)]
PYR_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pyr_inputs(device, c, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 255, (c, *shape)).astype(np.float32))
    return x.to(device=device, dtype=dtype)


def _one_rounding(k, t32):
    """Each of ``k`` (the kernel's store) is a rounding to k's dtype of a
    value within a few f32 ulps of ``t32`` (the banded product's f32 sum):
    f32 within 1e-4; bf16 the twin's rounding, or its neighbour where the
    sum sits on a rounding edge.  Returns the share that differs from the
    twin's rounding."""
    if k.dtype == torch.float32:
        assert (k - t32).abs().max().item() <= 1e-4
        return 0.0
    e = torch.frexp(t32.abs())[1].float()
    half_ulp = torch.exp2(e - 9)  # half a bf16 ulp of |t| in [2^(e-1), 2^e)
    assert ((k.float() - t32).abs() <= half_ulp + t32.abs() * 2**-18 + 1e-30).all()
    return (k != t32.to(k.dtype)).float().mean().item()


@pytest.mark.parametrize("dtype", sorted(PYR_DTYPES))
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("shape", PYR_DOWN_SHAPES, ids=[f"{h}x{w}" for h, w in PYR_DOWN_SHAPES])
def test_pyr_down_kernel_matches_twin_on_card(cuda_device, shape, c, dtype):
    """One pyr_down_kernel launch against the banded products (the twin,
    on the card) on inputs in [0, 255]: f32 within 1e-4, bf16 one
    rounding of the twin's f32 sum (rarely the other neighbour)."""
    x = _pyr_inputs(cuda_device, c, shape, PYR_DTYPES[dtype], 60 + c)
    mats = {n: torch.from_numpy(down_matrix(n)).to(cuda_device) for n in set(shape)}
    cuda_pyramid.reset_counts()
    got = cuda_pyramid.down(x, mats)
    assert cuda_pyramid.COUNTS == {f"down_c{c}_{dtype}": 1}
    t32 = pyr_down_mm(x, mats[shape[0]], mats[shape[1]])
    assert got.dtype == x.dtype and got.shape == t32.shape == (c, shape[0] // 2, shape[1] // 2)
    assert _one_rounding(got, t32) <= 1e-3


@pytest.mark.parametrize("dtype", sorted(PYR_DTYPES))
@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("shape", PYR_UP_SHAPES, ids=[f"{h}x{w}" for h, w in PYR_UP_SHAPES])
def test_pyr_up_kernel_matches_twin_on_card(cuda_device, shape, c, dtype):
    """The up kernel's three epilogues.  Plain: against the banded
    products as the down step.  The Laplacian accumulate (into a strided
    window of a larger level) and the collapse: equal, bit for bit, to
    the eager torch ops on the card applied to the plain launch's
    output, and nothing outside the window written."""
    dt = PYR_DTYPES[dtype]
    x = _pyr_inputs(cuda_device, c, shape, dt, 70 + c)
    h2, w2 = 2 * shape[0], 2 * shape[1]
    mats = {n: torch.from_numpy(up_matrix(n)).to(cuda_device) for n in set(shape)}
    cuda_pyramid.reset_counts()
    u = cuda_pyramid.up(x, mats)
    t32 = pyr_up_mm(x, mats[shape[0]], mats[shape[1]])
    assert u.dtype == dt and u.shape == t32.shape == (c, h2, w2)
    assert _one_rounding(u, t32) <= 1e-3

    g = _pyr_inputs(cuda_device, c, (h2, w2), dt, 80 + c)
    w = (_pyr_inputs(cuda_device, 1, (h2, w2), dt, 90)[0] / 255).to(dt)
    level = _pyr_inputs(cuda_device, c, (h2 + 5, w2 + 7), dt, 100 + c)
    before = level.clone()
    dst = level[:, 3 : 3 + h2, 4 : 4 + w2]
    want = dst + (g - u) * w
    cuda_pyramid.up_laplacian(dst, g, x, w, mats)
    assert torch.equal(dst, want)
    level[:, 3 : 3 + h2, 4 : 4 + w2] = before[:, 3 : 3 + h2, 4 : 4 + w2]
    assert torch.equal(level, before)

    got = cuda_pyramid.up_collapse(x, g, w, mats)
    assert torch.equal(got, u + g * w)
    assert cuda_pyramid.COUNTS == {f"{v}_c{c}_{dtype}": 1 for v in ("up", "up_lap", "up_add")}


def test_pyramid_wrappers_raise_on_inputs_they_do_not_take(cuda_device):
    """A length the kernels refuse raises (nothing launched); so do
    operands of another dtype or device, a window whose rows are not one
    stride, and a dtype the kernels do not have."""
    mats = {n: torch.from_numpy(down_matrix(n)).to(cuda_device) for n in (4,)}
    cuda_pyramid.reset_counts()
    with pytest.raises(RuntimeError, match="refused"):
        cuda_pyramid.down(torch.zeros((1, 1, 4), device=cuda_device), mats)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_pyramid.down(torch.zeros((1, 4, 4), dtype=torch.float16, device=cuda_device), mats)
    x = torch.zeros((2, 2, 2), device=cuda_device)
    g = torch.zeros((2, 4, 4), device=cuda_device)
    w = torch.zeros((4, 4), device=cuda_device)
    up = {2: torch.from_numpy(up_matrix(2)).to(cuda_device)}
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_pyramid.up_laplacian(g.clone(), g.to(torch.bfloat16), x, w, up)
    with pytest.raises(ValueError, match="holds 1 planes"):
        cuda_pyramid.up_laplacian(torch.zeros((4, 4), device=cuda_device), g, x, w, up)
    with pytest.raises(ValueError, match="one stride"):
        cuda_pyramid.up_laplacian(torch.zeros((2, 2, 4, 4), device=cuda_device).transpose(0, 1), g, x, w, up)
    assert cuda_pyramid.LAUNCHES == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,c", [(0, 1), (1, 2), (3, 1), (4, 2), (5, 3)])
def test_multiband_blend_on_card_matches_cpu(cuda_device, seed, c, dtype):
    """multiband_blend through the pyramid kernels against the port on
    the CPU (the banded products): f32 within 1e-3 (the JAX package's
    bar), bf16 within the bf16 bars (mean < 1.5, 99th percentile < 6)
    of the CPU's bf16 and of its f32; a blend of B bands launches B
    grouped downs and one gathering accumulate over all its images and
    B collapse steps."""
    masks, rois, imgs, bands = blend_scene(seed, c=c)
    plan = blenders.build_multiband_plan(masks, rois, bands, CANVAS, dtype=dtype)
    ref = blenders.multiband_blend(plan.to("cpu"), [torch.from_numpy(i) for i in imgs], CANVAS)
    dplan = plan.to(cuda_device)
    cuda_pyramid.reset_counts()
    got = blenders.multiband_blend(dplan, [torch.from_numpy(i).to(cuda_device) for i in imgs], CANVAS).cpu()
    tag = "bf16" if dtype == "bfloat16" else "f32"
    assert cuda_pyramid.COUNTS == {f"down_group_c{c}_{tag}": bands, f"lap_gather_c{c}_{tag}": 1,
                                   f"up_add_c{c}_{tag}": bands}
    if dtype == "float32":
        assert (got - ref).abs().max().item() < 1e-3
        return
    ref32 = blenders.multiband_blend(
        blenders.build_multiband_plan(masks, rois, bands, CANVAS).to("cpu"), [torch.from_numpy(i) for i in imgs], CANVAS
    )
    for r in (ref, ref32):
        d = (got - r).abs()
        assert d.mean().item() < 1.5 and torch.quantile(d.flatten(), 0.99).item() < 6.0


def _stepwise():
    """Inside, the blend composes its pyramids from the per-step kernels
    camera by camera (``down``, ``up_laplacian``, the eager level-B add:
    ``cuda_pyramid.down_group_stepwise`` and ``lap_gather_stepwise``), the
    card's path before the grouped launches."""
    return mock.patch.multiple(cuda_pyramid, down_group=cuda_pyramid.down_group_stepwise,
                               lap_gather=cuda_pyramid.lap_gather_stepwise)


def _stepwise_blend(plan, imgs, canvas):
    """``multiband_blend`` inside ``_stepwise()``."""
    with _stepwise():
        return blenders.multiband_blend(plan, imgs, canvas)


def _group_counts(plan, c, tag):
    """COUNTS of one grouped blend over ``plan``: per camera chunk a
    grouped down per level, a gather per level and camera chunk, and B
    collapse steps."""
    groups = blenders.pyramid_groups(plan)
    B = plan.num_bands
    return {f"down_group_c{c}_{tag}": B * len(groups.cam_chunks), f"lap_gather_c{c}_{tag}": len(groups.lap),
            f"up_add_c{c}_{tag}": B}


# (scene, channels, lead): one camera; three; the 16 cameras of two
# clusters with an empty camera and uncovered band pixels; 36 cameras,
# more than one launch holds; a [2, C] batch of three
GROUP_SCENES = {"one": (3, ()), "three": (2, ()), "ring16": (1, ()), "split36": (1, ()), "batch": (3, (2,))}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scene", sorted(GROUP_SCENES))
def test_grouped_blend_equals_stepwise_on_card(cuda_device, scene, dtype):
    """multiband_blend on the card (one grouped down per level and one
    gathering accumulate over all the cameras) equals, byte for byte,
    the same blend composed from the per-step kernels and the eager
    level-B add, band levels and canvas; a band pixel no camera's aligned
    ROI reaches is 0; the launches are counted exactly."""
    from blend_fixtures import RING_CANVAS, ring_scene

    c, lead = GROUP_SCENES[scene]
    if scene in ("ring16", "split36"):
        masks, rois, imgs, bands = ring_scene(11, c=c, n=16 if scene == "ring16" else 36)
        canvas = RING_CANVAS
    else:
        masks, rois, imgs, bands = blend_scene(5, c=c, n=1 if scene == "one" else 3)
        canvas = CANVAS
    plan = blenders.build_multiband_plan(masks, rois, bands, canvas, dtype=dtype).to(cuda_device)
    ts = [torch.from_numpy(i).to(cuda_device) for i in imgs]
    if lead:
        ts = [torch.stack([t, 255 - t]) for t in ts]
    tag = "bf16" if dtype == "bfloat16" else "f32"
    cuda_pyramid.reset_counts()
    got = blenders.multiband_blend(plan, ts, canvas)
    torch.cuda.synchronize()
    assert cuda_pyramid.COUNTS == _group_counts(plan, c, tag)
    assert not any(k.startswith(("down_c", "up_lap")) for k in cuda_pyramid.COUNTS)
    if scene != "split36":
        assert cuda_pyramid.COUNTS == {f"down_group_c{c}_{tag}": bands, f"lap_gather_c{c}_{tag}": 1,
                                       f"up_add_c{c}_{tag}": bands}
    want = _stepwise_blend(plan, ts, canvas)
    assert got.shape == (*lead, c, canvas[1], canvas[0]) and torch.equal(got, want)
    grouped = blenders._grouped_bands(plan, ts)
    with _stepwise():
        stepwise = blenders._grouped_bands(plan, ts)
    groups = blenders.pyramid_groups(plan)
    for i, (g, s) in enumerate(zip(grouped, stepwise)):
        assert torch.equal(g, s), i
        covered = torch.zeros(groups.band_shapes[i], dtype=torch.bool, device=cuda_device)
        for (y, x), (h, w) in zip(groups.origins[i], groups.shapes[i]):
            covered[y : y + h, x : x + w] = True
        assert not bool((g[..., ~covered] != 0).any()), i
        if scene in ("ring16", "split36"):
            assert not bool(covered.all()), i


@pytest.mark.parametrize("config", ["mono360_4k", "cyl3dv_2304", "odyssey16_4k"])
def test_bench_stitch_grouped_pyramid_equals_stepwise_on_card(cuda_device, monkeypatch, config):
    """The benchmark configurations through ``deploy.System`` (the first
    set captured, the next two replayed): every output and gain equals,
    byte for byte, a System whose blends take the per-camera steps; a
    replayed set counts per multiband blend its grouped downs, gathers
    and collapse steps and no per-camera step; on the 4K plan's six
    cameras the f32 blend equals its stepwise composition too."""
    from benchmark import spec
    from benchmark.deploy import System
    from benchmark.frames import make_pool

    cfg = spec.config(spec.load(), config)
    system = System(cfg, "cuda")
    sets = make_pool(BENCH_SEED + 5, 3, system.n_cams, system.cam_size, cuda_device)
    got = []
    for k, frames in enumerate(sets):
        if k == 2:
            cuda_pyramid.reset_counts()
        got.append(system.stitch(frames))
    torch.cuda.synchronize()
    want = {}
    for m in system.mappers:
        if m.plan.blend_kind != "multiband":
            continue
        for bl, c in ((m.plan.blender, 1), (m.plan.blender_uv, 2)):
            for key, v in _group_counts(bl, c, "bf16").items():
                want[key] = want.get(key, 0) + v
    assert cuda_pyramid.COUNTS == want
    if config == "mono360_4k":
        gen = torch.Generator(device=cuda_device)
        gen.manual_seed(5)
        for bl, c in ((system.mappers[0].plan.blender, 1), (system.mappers[0].plan.blender_uv, 2)):
            bl32 = dataclasses.replace(
                bl, weight_pyrs=[[w.float() for w in p] for p in bl.weight_pyrs],
                inv_band_weights=[v.float() for v in bl.inv_band_weights], compute_dtype="float32",
            )
            imgs = [torch.rand((c, h, w), generator=gen, device=cuda_device) * 255 for _, _, w, h in bl.rois]
            canvas = (bl.align_result_roi[2], bl.align_result_roi[3])
            assert torch.equal(blenders.multiband_blend(bl32, imgs, canvas), _stepwise_blend(bl32, imgs, canvas))
    del system
    monkeypatch.setattr(cuda_pyramid, "down_group", cuda_pyramid.down_group_stepwise)
    monkeypatch.setattr(cuda_pyramid, "lap_gather", cuda_pyramid.lap_gather_stepwise)
    plain = System(cfg, "cuda")
    for k, (frames, (outs, gains)) in enumerate(zip(sets, got)):
        want_outs, want_gains = plain.stitch(frames)
        for o, wo in zip(outs, want_outs):
            assert torch.equal(o, wo), (config, k)
        for g, wg in zip(gains, want_gains):
            assert (g is None and wg is None) or torch.equal(g, wg), (config, k)


def test_pyramid_path_runs_no_matmul_on_card(cuda_device, monkeypatch):
    """On the card the multiband blend calls no matrix product at all,
    and the band-sharded window blends never reach the banded products:
    both go through the pyramid kernels."""
    def refuse(*a, **k):
        raise AssertionError("a matrix product on the card's pyramid path")

    masks, rois, imgs, bands = blend_scene(1, c=2)
    dplan = blenders.build_multiband_plan(masks, rois, bands, CANVAS, dtype="bfloat16").to(cuda_device)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "matmul", refuse)
        blenders.multiband_blend(dplan, [torch.from_numpy(i).to(cuda_device) for i in imgs], CANVAS)
    monkeypatch.setattr(cuda_pyramid, "pyr_down_mm", refuse)
    monkeypatch.setattr(cuda_pyramid, "pyr_up_mm", refuse)
    mt, sizes, frames = _small_rig(cuda_device)
    sm = ShardedMapper(mt, sizes, make_mesh(1, 2, device=cuda_device), blend=16, enable_gain=True)
    cuda_pyramid.reset_counts()
    sm.stitch_batch([torch.from_numpy(f[None]).to(cuda_device) for f in frames])
    torch.cuda.synchronize()
    assert {k.split("_c")[0] for k in cuda_pyramid.COUNTS} == {"down", "up"}


# prep kernel (csrc/prep.cu): every case byte for byte against the
# eager ops (prep_yuv_reference) on the card
PREP_FORMATS = ["yuv420p", "nv12"]
BENCH_SEED = 2**31 + 23  # past 32 signed bits, as the benchmark's seeds may be


def _as_format(buf, fmt):
    """A packed YUV420P buffer [..., H*3/2, W] in ``fmt``."""
    return buf if fmt == "yuv420p" else color.merge_frame(*color.split_frame(buf, "yuv420p"), fmt)


def _prep_on_card(buf, fmt, vig, vig_half):
    """The kernel's Y and U|V, after checking them byte for byte against
    the eager ops on the same tensors, with one launch counted."""
    before = cuda_prep.LAUNCHES
    got = cuda_prep.prep_yuv(buf, fmt, vig, vig_half)
    want = cuda_prep.prep_yuv_reference(buf, fmt, vig, vig_half)
    torch.cuda.synchronize()
    assert cuda_prep.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.uint8 and g.is_contiguous()
        assert torch.equal(g, w), (g != w).sum().item()
    return got


def _random_prep_case(device, lead, h, w, seed, vig_lead=()):
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(0, 256, (*lead, h * 3 // 2, w), dtype=np.uint8)).to(device)
    vig = torch.from_numpy(rng.uniform(0.3, 1.8, (*vig_lead, h, w)).astype(np.float32)).to(device)
    vh = torch.from_numpy(rng.uniform(0.3, 1.8, (*vig_lead, h // 2, w // 2)).astype(np.float32)).to(device)
    return buf, vig, vh


@pytest.mark.parametrize("stack", ["per_camera", "six_frames"])
@pytest.mark.parametrize("fmt", PREP_FORMATS)
def test_prep_kernel_bench_frames_on_card(cuda_device, fmt, stack):
    """The benchmark's 1920^2 frames (its generator, a large seed) with
    the bench rig's vignettes: each camera's frame with its own maps, or
    the six frames as one [6, ...] stack with [6, H, W] maps."""
    from benchmark.frames import make_pool

    frames = [_as_format(f, fmt) for f in make_pool(BENCH_SEED, 1, 6, (1920, 1920), cuda_device)[0]]
    maps = [tuple(torch.from_numpy(m).to(cuda_device) for m in pair) for pair in bench_vignettes(1920, 1920)]
    if stack == "six_frames":
        _prep_on_card(torch.stack(frames), fmt, *(torch.stack(m) for m in zip(*maps)))
        return
    for f, (vig, vh) in zip(frames, maps):
        _prep_on_card(f, fmt, vig, vh)


RING = (2028, 2704)  # odyssey16_4k's frames (H, W): 2.7K 4:3


def test_prep_kernel_ring_stack_on_card(cuda_device):
    """The odyssey16_4k ring's 16 frames as one [16, 3042, 2704] stack
    with [16, 2028, 2704] vignettes (non-square, 2704 luma and 1352
    chroma columns): byte-equal to ``prep_yuv_reference`` in one launch;
    then captured in a CUDA graph and replayed over a second set, each
    replay counting one launch and storing the eager ops' bytes."""
    from benchmark.frames import make_pool
    from octvr_tpu_torch.ops import launch_counts

    sets = [torch.stack(fs) for fs in make_pool(BENCH_SEED + 3, 2, 16, RING, cuda_device)]
    vig, vh = (torch.stack([torch.from_numpy(m) for m in pair]).to(cuda_device)
               for pair in zip(*bench_vignettes(*RING, config="odyssey16_4k")))
    assert tuple(sets[0].shape) == (16, 3042, 2704) and tuple(vig.shape) == (16, *RING)
    _prep_on_card(sets[0], "yuv420p", vig, vh)
    static = sets[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_prep.prep_yuv(static, "yuv420p", vig, vh)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with launch_counts.deferred() as held:
        with torch.cuda.graph(graph):
            outs = cuda_prep.prep_yuv(static, "yuv420p", vig, vh)
    for buf in sets:
        static.copy_(buf)
        before = cuda_prep.LAUNCHES
        graph.replay()
        launch_counts.replay(held)
        torch.cuda.synchronize()
        assert cuda_prep.LAUNCHES == before + 1
        for g, w in zip(outs, cuda_prep.prep_yuv_reference(buf, "yuv420p", vig, vh)):
            assert torch.equal(g, w), (g != w).sum().item()


PREP_GEOMETRIES = [(1082, 1922), (64, 56), (6, 10), (2, 2), (30, 1924)]


@pytest.mark.parametrize("fmt", PREP_FORMATS)
@pytest.mark.parametrize("hw", PREP_GEOMETRIES, ids=[f"{h}x{w}" for h, w in PREP_GEOMETRIES])
def test_prep_kernel_even_geometries_on_card(cuda_device, hw, fmt):
    """Even frame sizes whose width is not a multiple of 8 (the masked
    last span), a multiple of 8 but not 16, and the smallest."""
    buf, vig, vh = _random_prep_case(cuda_device, (), *hw, seed=hw[0] + hw[1])
    _prep_on_card(_as_format(buf, fmt), fmt, vig, vh)


@pytest.mark.parametrize("vig_lead", [(), (1,), (3,)], ids=["hw", "one_block", "per_block"])
@pytest.mark.parametrize("fmt", PREP_FORMATS)
def test_prep_kernel_block_stacks_on_card(cuda_device, fmt, vig_lead):
    """[B, k, h*3/2, W] source blocks (the ShardedMapper's) in one
    launch, with one vignette for all blocks or a slice per block."""
    buf, vig, vh = _random_prep_case(cuda_device, (2, 3), 96, 256, seed=7, vig_lead=vig_lead)
    y, uv = _prep_on_card(_as_format(buf, fmt), fmt, vig, vh)
    assert y.shape == (2, 3, 1, 96, 256) and uv.shape == (2, 3, 2, 48, 128)


@pytest.mark.parametrize("view", ["pitch", "pitch_offset2", "columns_strided", "vig_strided"])
@pytest.mark.parametrize("fmt", PREP_FORMATS)
def test_prep_kernel_strided_views_on_card(cuda_device, fmt, view):
    """Non-contiguous inputs: frames that are a window of wider rows (an
    aligned one and one 2 bytes in), frames whose columns are strided
    (copied once by the wrapper), and vignettes that are windows of
    wider maps."""
    h, w = 64, 192
    buf, vig, vh = _random_prep_case(cuda_device, (2,), h, w + 16, seed=11)
    buf = _as_format(buf, fmt)
    if view == "columns_strided":
        frames = buf.transpose(-1, -2).contiguous().transpose(-1, -2)[..., :w]
    else:
        off = 2 if view == "pitch_offset2" else 8
        frames = buf[..., off : off + w]
    if view == "vig_strided":
        vig, vh = vig[..., 4 : 4 + w], vh[..., 4 : 4 + w // 2]
    else:
        vig, vh = vig[..., :w].contiguous(), vh[..., : w // 2].contiguous()
    assert not frames.is_contiguous()
    _prep_on_card(frames, fmt, vig, vh)


@pytest.mark.parametrize("fmt", PREP_FORMATS)
def test_prep_kernel_rounding_edges_on_card(cuda_device, fmt):
    """The rounding-edge frame: the kernel stores the two-rounding bytes
    (``prep_numpy``), not those of a contracted multiply-add."""
    buf, vig, vh = (t.to(cuda_device) for t in rounding_edges(fmt))
    y, uv = _prep_on_card(buf, fmt, vig, vh)
    want_y, want_uv = prep_numpy(buf.cpu(), fmt, vig.cpu(), vh.cpu())
    np.testing.assert_array_equal(y[0].cpu().numpy(), want_y)
    np.testing.assert_array_equal(uv.cpu().numpy(), want_uv)
    _, fused_uv = prep_numpy(buf.cpu(), fmt, vig.cpu(), vh.cpu(), fused=True)
    assert (uv.cpu().numpy() != fused_uv).sum() > 0


def test_prep_wrapper_raises_on_card(cuda_device):
    """On the card the wrapper refuses a vignette on the CPU and more
    frames than a launch takes, and launches nothing."""
    buf, vig, vh = _random_prep_case(cuda_device, (), 8, 16, seed=3)
    before = cuda_prep.LAUNCHES
    with pytest.raises(ValueError, match="vig: device cpu"):
        cuda_prep.prep_yuv(buf, "yuv420p", vig.cpu(), vh)
    with pytest.raises(RuntimeError, match="1 to 65,535 frames"):
        cuda_prep.prep_yuv(buf.expand(65536, -1, -1), "yuv420p", vig, vh)
    assert cuda_prep.LAUNCHES == before


def _vignetted_frames(system):
    """Frames with a vignette that one set's stitch preps: per Mapper,
    its plan's inputs and overlays that have one."""
    return sum(
        ip.vignette is not None for m in system.mappers for ip in m.plan.inputs + m.plan.overlays
    )


@pytest.mark.parametrize("config", ["mono360_4k", "cyl3dv_2304"])
def test_bench_stitch_with_prep_kernel_equals_eager_prep_on_card(cuda_device, monkeypatch, config):
    """Both benchmark configurations through ``deploy.System`` (one Mapper
    per output, captured on the first set and replayed on the next two):
    every output and gain byte-equal to the same System whose prep is the
    eager ops (``prep_yuv_reference`` patched in); a replayed set counts
    one prep launch per frame with a vignette."""
    from benchmark import spec
    from benchmark.deploy import System
    from benchmark.frames import make_pool

    cfg = spec.config(spec.load(), config)
    system = System(cfg, "cuda")
    sets = make_pool(BENCH_SEED + 1, 3, system.n_cams, system.cam_size, cuda_device)
    got = []
    for k, frames in enumerate(sets):
        if k == 2:
            cuda_prep.reset_counts()
        got.append(system.stitch(frames))
    torch.cuda.synchronize()
    counts = dict(cuda_prep.COUNTS)
    n = _vignetted_frames(system)
    assert n == (6 if config == "mono360_4k" else 32)
    assert counts == {"yuv420p": n}
    del system
    monkeypatch.setattr(cuda_prep, "prep_yuv", cuda_prep.prep_yuv_reference)
    plain = System(cfg, "cuda")
    for k, (frames, (outs, gains)) in enumerate(zip(sets, got)):
        want_outs, want_gains = plain.stitch(frames)
        for o, wo in zip(outs, want_outs):
            assert torch.equal(o, wo), (config, k)
        for g, wg in zip(gains, want_gains):
            assert (g is None and wg is None) or torch.equal(g, wg), (config, k)


def test_ring_replay_equals_eager_on_card(cuda_device):
    """The benchmark's odyssey16_4k ring at its published size (16
    portrait 2704x2028 fisheyes, seven ROIs across +-180 degrees) through
    ``deploy.System``: the first set captures the graph and the next two
    replay it, each output and gain byte-equal to the Mapper's eager run
    of the same frames; a replayed set counts the remap, pyramid and prep
    launches of one eager call, one prep launch per camera."""
    from benchmark import spec
    from benchmark.deploy import System
    from benchmark.frames import make_pool

    system = System(spec.config(spec.load(), "odyssey16_4k"), "cuda")
    (m,) = system.mappers
    assert m.num_inputs == 16 and m.in_sizes == [RING] * 16
    sets = make_pool(BENCH_SEED + 2, 3, system.n_cams, system.cam_size, cuda_device)
    got = [system.stitch(s) for s in sets]
    for k, (s, (outs, gains)) in enumerate(zip(sets, got)):
        eo, eg = m._stitch_eager(s)
        assert torch.equal(outs[0], eo) and torch.equal(gains[0], eg), k
    counters = (cuda_remap, cuda_pyramid, cuda_prep)
    for c in counters:
        c.reset_counts()
    m._stitch_eager(sets[0])
    eager = [dict(c.COUNTS) for c in counters]
    for c in counters:
        c.reset_counts()
    system.stitch(sets[0])
    torch.cuda.synchronize()
    assert [dict(c.COUNTS) for c in counters] == eager
    assert eager[2] == {"yuv420p": 16} and all(eager)


def _small_rig(device, canvas=(256, 128)):
    rig = two_fisheye_rig()
    for s in rig["inputs"]:
        s["options"]["width"] = s["options"]["height"] = 256
    mt = compile_rig(rig, *canvas)
    mt.create_masks()
    rng = np.random.default_rng(1)
    return mt, [(256, 256)] * 2, [rng.integers(0, 256, (384, 256), dtype=np.uint8) for _ in range(2)]


@pytest.mark.parametrize("pipeline", ["yuv420", "rgb"])
def test_mapper_on_card_matches_cpu(cuda_device, pipeline):
    """Port on the card (kernel) vs port on the CPU (plain version), both
    f32, on a 256x128 two-fisheye rig: Y/UV mean < 0.2, gains 1e-3."""
    mt, sizes, frames = _small_rig(cuda_device)
    kw = dict(blend=16, enable_gain=True, pipeline=pipeline, blend_dtype="float32")
    out_cpu, g_cpu = Mapper(mt, sizes, device="cpu", **kw).stitch(frames)
    out, g = Mapper(mt, sizes, device=cuda_device, **kw).stitch(frames)
    d = (out.cpu().float() - out_cpu.float()).abs()
    assert d[:128].mean() < 0.2 and d[128:].mean() < 0.2
    assert (g.cpu() - g_cpu).abs().max().item() < 1e-3


def test_stitch_batch_on_card_equals_stitch(cuda_device):
    """yuv420 stitch_batch (frames-axis launches) on the card equals
    stitch frame by frame, bit for bit; FastMapper takes yuv420 there."""
    mt, sizes, frames = _small_rig(cuda_device)
    m = Mapper(mt, sizes, blend=16, device=cuda_device)
    assert m.plan.pipeline == "yuv420"
    sets = [frames, [255 - f for f in frames]]
    batch = [torch.from_numpy(np.stack(fs)).to(cuda_device) for fs in zip(*sets)]
    cuda_remap.reset_counts()
    out, g = m.stitch_batch(batch)
    assert cuda_remap.COUNTS == {"frames_nc1_bf16": 1, "frames_nc2_bf16": 1}
    for b, fs in enumerate(sets):
        o, gb = m.stitch(fs)
        assert torch.equal(out[b], o) and torch.equal(g[b], gb)
    assert FastMapper(mt, sizes, device=cuda_device).plan.pipeline == "yuv420"


GRAPH_CASES = {
    "yuv420": dict(blend=16),  # global gains, bf16 pyramids
    "rgb": dict(blend=16, pipeline="rgb"),
    "blocks": dict(blend=16, enable_gain="blocks"),
    "external_gains": dict(blend=16),
    "fast_nv12": None,  # FastMapper: NV12 in and out, feather, no gains
}


def _graph_mapper(device, case):
    mt, sizes, _ = _small_rig(device)
    if case == "fast_nv12":
        return FastMapper(mt, sizes, device=device)
    return Mapper(mt, sizes, device=device, **GRAPH_CASES[case])


def _case_gains(case, k, device):
    return torch.tensor([1.0 + 0.05 * k, 0.95], device=device) if case == "external_gains" else None


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_replay_equals_eager_on_card(cuda_device, case):
    """Mapper.stitch on the card (its first call captures the graph, the
    later ones replay it) equals ``_stitch_eager`` bit for bit on four
    distinct sets, host and device frames alternately; the first call
    opens ``mapper.capture`` and the later ones ``mapper.replay``; a
    replay counts the remap and pyramid launches of one eager call (a
    feather blend has none of the latter)."""
    from octvr_tpu_torch.runtime.timer import RECORDER

    m = _graph_mapper(cuda_device, case)
    sets = _pipeline_sets(4, seed=50)
    mark = RECORDER.new_id()
    got = []
    for k, s in enumerate(sets):
        frames = s if k % 2 == 0 else [torch.from_numpy(f).to(cuda_device) for f in s]
        got.append(m.stitch(frames, gains=_case_gains(case, k, cuda_device)))
    spans = RECORDER.spans(mark)
    roots = [x for x in spans if x.name == "mapper.stitch"]
    graph_kids = [[c.name for c in spans if c.parent == r.id] for r in roots]
    assert graph_kids == [["mapper.capture"]] + [["mapper.replay"]] * 3
    assert list(m._graphs) == [case == "external_gains"]
    for k, ((o, g), s) in enumerate(zip(got, sets)):
        eo, eg = m._stitch_eager(s, gains=_case_gains(case, k, cuda_device))
        assert torch.equal(o, eo) and torch.equal(g, eg), k
    cuda_remap.reset_counts()
    cuda_pyramid.reset_counts()
    m._stitch_eager(sets[0], gains=_case_gains(case, 0, cuda_device))
    eager, eager_pyr = dict(cuda_remap.COUNTS), dict(cuda_pyramid.COUNTS)
    cuda_remap.reset_counts()
    cuda_pyramid.reset_counts()
    m.stitch(sets[0], gains=_case_gains(case, 0, cuda_device))
    assert eager and cuda_remap.COUNTS == eager
    assert bool(eager_pyr) == (case != "fast_nv12") and cuda_pyramid.COUNTS == eager_pyr


def _bench_cap(size=192):
    """The benchmark's six-fisheye rig at ``size``^2 under a 64x64 north
    cap, which camera 5 (the south pole's) does not see."""
    import json
    import math
    from pathlib import Path

    rig = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "configs" / "mono360_4k.json").read_text())
    for s in rig["rig"]["inputs"]:
        s["options"]["width"] = s["options"]["height"] = size
    cap = {"type": "eqareanorthpole", "options": {"arctic_circle": math.pi / 4}}
    mt = compile_rig({"output": cap, "inputs": rig["rig"]["inputs"]}, 64, 64)
    mt.create_masks()
    return mt, [(size, size)] * 6


@pytest.mark.parametrize("blend", [0, 128], ids=["paste", "multiband_gains"])
def test_graphed_cap_with_an_empty_input_on_card(cuda_device, blend):
    """A graphed Mapper over a polar cap with an empty input (camera 5)
    replays equal to its eager stitch; its graph holds static inputs for
    the five covering frames alone, a replay's span has its copy in,
    launch and copy out, the empty camera's frame changes no byte, and
    the gains have the rig's length with 1.0 at camera 5."""
    from octvr_tpu_torch.runtime.timer import RECORDER

    mt, sizes = _bench_cap()
    m = Mapper(mt, sizes, blend=blend, enable_gain=blend > 0, device=cuda_device)
    assert m.plan.frame_idx == (0, 1, 2, 3, 4)
    rng = np.random.default_rng(54)
    sets = [[rng.integers(0, 256, (288, 192), dtype=np.uint8) for _ in range(6)] for _ in range(3)]
    sets.append(sets[1][:5] + [np.zeros_like(sets[1][5])])
    mark = RECORDER.new_id()
    got = [m.stitch(s) for s in sets]  # a capture, then replays
    spans = RECORDER.spans(mark)
    replays = [x for x in spans if x.name == "mapper.replay"]
    assert len(replays) == 3
    for r in replays:
        assert sorted(x.name for x in spans if x.parent == r.id) == ["mapper.copy_in", "mapper.copy_out", "mapper.launch"]
    assert len(m._graphs[False].inputs) == 5
    for (o, g), s in zip(got, sets):
        eo, eg = m._stitch_eager(s)
        assert torch.equal(o, eo) and torch.equal(g, eg)
        assert g.shape == (6,) and g[5].item() == 1.0
    assert torch.equal(got[3][0], got[1][0])


def test_replay_outputs_are_fresh_on_card(cuda_device):
    """Each replay returns its own tensors: an output kept from one call
    is not overwritten by the next."""
    m = _graph_mapper(cuda_device, "yuv420")
    a, b = _pipeline_sets(2, seed=51)
    m.stitch(a)  # the capture
    o1, g1 = m.stitch(a)
    kept = o1.clone(), g1.clone()
    o2, g2 = m.stitch(b)
    torch.cuda.synchronize()
    assert o1.data_ptr() != o2.data_ptr() and g1.data_ptr() != g2.data_ptr()
    assert torch.equal(o1, kept[0]) and torch.equal(g1, kept[1]) and not torch.equal(o1, o2)


def test_replay_on_two_streams_on_card(cuda_device):
    """One Mapper called from two streams in turn gives the eager
    outputs: a call on the second stream waits for the replay on the
    first before it rewrites the graph's inputs, though that replay is
    held back on its stream by a spin."""
    m = _graph_mapper(cuda_device, "yuv420")
    sets = [[torch.from_numpy(f).to(cuda_device) for f in s] for s in _pipeline_sets(3, seed=52)]
    want = [m._stitch_eager(s) for s in sets]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = []
    for k in range(8):
        st = streams[k % 2]
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            if k % 2 == 0:
                torch.cuda._sleep(5_000_000)
            got.append(m.stitch(sets[k % 3]))
    torch.cuda.synchronize()
    for k, (o, g) in enumerate(got):
        assert torch.equal(o, want[k % 3][0]) and torch.equal(g, want[k % 3][1]), k


def test_pipeline_over_graphed_mappers_on_card(cuda_device):
    """An AsyncMultiMapper over graph-backed Mappers, an owner and a gain
    copier (which replays its graph for given gains), pops the outputs
    of eager stitches, bit for bit, in order."""
    from octvr_tpu_torch.runtime import BUF_SIZE, AsyncMultiMapper

    mt, sizes, _ = _small_rig(cuda_device)
    m0 = Mapper(mt, sizes, blend=16, device=cuda_device)
    m1 = Mapper(mt, sizes, blend=-8, device=cuda_device)
    sets = _pipeline_sets(2 * BUF_SIZE + 1, seed=53)
    got = _drain_all(AsyncMultiMapper([m0, m1], gain_modes=[0, 0]), sets)
    assert list(m0._graphs) == [False] and list(m1._graphs) == [True]
    for outs, s in zip(got, sets):
        o0, g0 = m0._stitch_eager(s)
        o1, _ = m1._stitch_eager(s, gains=g0)
        assert np.array_equal(outs[0], o0.cpu().numpy()) and np.array_equal(outs[1], o1.cpu().numpy())


def test_tf32_after_capture_still_raises_on_card(cuda_device):
    """A process that allows TF32 matmuls after the graph was captured
    gets the same RuntimeError from a replayed stitch as from an eager
    one.  On the card the pyramid steps run no matrix product, so the
    canvas is 768x384: its 0.1 MP working grid pools at stride 2, and the
    gain stage's pooling product (``_pool_pow2``) stays in the path."""
    mt, sizes, _ = _small_rig(cuda_device, (768, 384))
    m = Mapper(mt, sizes, blend=16, device=cuda_device)
    assert all(ip.pool_cols is not None for ip in m.plan.inputs)
    (s,) = _pipeline_sets(1, seed=54)
    m.stitch(s)
    m.stitch(s)
    flags = _tf32_flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="highest"):
            m.stitch(s)
        with pytest.raises(RuntimeError, match="highest"):
            m._stitch_eager(s)
    finally:
        torch.set_float32_matmul_precision(flags[2])
    assert _tf32_flags() == flags


def _concat_case(device, nc, seed, frames=None):
    """Kernel 6's fixture: input A reads the whole 96x256 source, input B
    its rows [LO, LO+H_B) through its rebased map."""
    a, _, b_s = concat_maps()
    group = remap_group([remap_plan(*a, IN_H, IN_W), remap_plan(*b_s, H_B, IN_W)], device)
    rng = np.random.default_rng(seed)
    shape = (nc, IN_H, IN_W) if frames is None else (frames, nc, IN_H, IN_W)
    planes = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)
    src = concat_source([planes, planes[..., LO : LO + H_B, :]], frames=frames is not None)
    return group, src


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_concat_kernel_matches_plain_on_card(cuda_device, nc):
    """Kernel 6: f32 within 1e-3 of the plain version, the bf16 store
    equal to the cast f32 store, one concat launch counted per call."""
    group, src = _concat_case(cuda_device, nc, 60 + nc)
    assert group.concat
    cuda_remap.reset_counts()
    k32 = cuda_remap.remap_apply(src, group, torch.float32)
    k16 = cuda_remap.remap_apply(src, group, torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_remap.COUNTS == {f"concat_nc{nc}_f32": 1, f"concat_nc{nc}_bf16": 1}
    for a, b, r in zip(k32, k16, remap_apply_reference(src, group, torch.float32)):
        assert (a - r).abs().max().item() < 1e-3
        assert torch.equal(b, a.to(torch.bfloat16))


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_concat_frames_axis_equals_one_frame_on_card(cuda_device, nc):
    """Kernel 6 with the frames axis: one launch over B=3 frames of
    concat sources equals three one-frame launches bit for bit."""
    group, src = _concat_case(cuda_device, nc, 70 + nc, frames=3)
    cuda_remap.reset_counts()
    got = cuda_remap.remap_apply_frames(src, group, torch.bfloat16)
    assert cuda_remap.COUNTS == {f"frames_concat_nc{nc}_bf16": 1}
    for b in range(3):
        for g, one in zip(got, cuda_remap.remap_apply(src[b], group, torch.bfloat16)):
            assert torch.equal(g[b], one)


@pytest.mark.parametrize("src_windows", [False, True])
def test_sharded_on_card_matches_cpu(cuda_device, src_windows):
    """The band-sharded stitcher at S=4 on the card (kernel) vs on the
    CPU (plain version), both f32, on the two 1200^2 fisheyes -> 512x256
    rig, where source windows slice each camera to 768 rows: Y/UV mean
    < 0.2, gains 1e-3; with source windows both launches take kernel 6."""
    rig = two_fisheye_rig()
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [(1200, 1200)] * 2
    rng = np.random.default_rng(2)
    batch = [torch.from_numpy(rng.integers(0, 256, (1, 1800, 1200), dtype=np.uint8)) for _ in range(2)]
    kw = dict(blend=16, enable_gain=True, blend_dtype="float32", src_windows=src_windows)
    out_cpu, g_cpu = ShardedMapper(mt, sizes, make_mesh(1, 4, device="cpu"), **kw).stitch_batch(batch)
    sm = ShardedMapper(mt, sizes, make_mesh(1, 4, device=cuda_device), **kw)
    assert sm.plan.sliced == src_windows
    cuda_remap.reset_counts()
    out, g = sm.stitch_batch(batch)
    torch.cuda.synchronize()
    concat = "concat_" if src_windows else ""
    assert cuda_remap.COUNTS == {f"{concat}nc1_f32": 1, f"{concat}nc2_f32": 1}
    d = (sm.assemble_yuv(out[0]).cpu().float() - sm.assemble_yuv(out_cpu[0]).float()).abs()
    assert d[:256].mean() < 0.2 and d[256:].mean() < 0.2
    assert (g.cpu() - g_cpu).abs().max().item() < 1e-3


SHARDED_OPTIONS = {
    # name: (mixed sizes + an overlay, options, the launches of one stitch)
    "rgb_srcwin": (False, {"pipeline": "rgb", "src_windows": True}, {"concat_nc3_f32": 1}),
    "rgb_feather_mixed_overlay_rgb_out": (
        True, {"pipeline": "rgb", "blend": -8, "out_format": "rgb"}, {"nc3_f32": 2},
    ),
    "yuv420_blocks_paste_nv12_scale": (
        False, {"blend": 0, "enable_gain": "blocks", "frame_format": "nv12", "scale_output": (256, 128)},
        {"nc1_f32": 1, "nc2_f32": 1},
    ),
}


@pytest.mark.parametrize("name", sorted(SHARDED_OPTIONS))
def test_sharded_options_on_card_match_cpu(cuda_device, name):
    """The band-sharded stitcher's options at S=4 on the card (kernel)
    vs on the CPU (plain version), both f32, on the 512x256 rig of two
    1200^2 fisheyes (mixed: the second at 1000^2, and the first again as
    an overlay input): Y/UV (or RGB) mean < 0.2, gains 1e-3; each size
    group one launch, kernel 6 (concat) where source windows slice."""
    mixed, kw, launches = SHARDED_OPTIONS[name]
    rig = two_fisheye_rig()
    if mixed:
        rig["inputs"][1]["options"]["width"] = rig["inputs"][1]["options"]["height"] = 1000
    mt = compile_rig(rig, 512, 256)
    mt.create_masks()
    sizes = [(s["options"]["height"], s["options"]["width"]) for s in rig["inputs"]]
    if mixed:
        mt = dataclasses.replace(mt, overlay_inputs=[mt.inputs[0]])
        sizes.append(sizes[0])
    rng = np.random.default_rng(3)
    batch = [torch.from_numpy(rng.integers(0, 256, (1, h * 3 // 2, w), dtype=np.uint8)) for h, w in sizes]
    kw = {"blend": 16, "enable_gain": True, "blend_dtype": "float32", **kw}
    out_cpu, g_cpu = ShardedMapper(mt, sizes, make_mesh(1, 4, device="cpu"), **kw).stitch_batch(batch)
    sm = ShardedMapper(mt, sizes, make_mesh(1, 4, device=cuda_device), **kw)
    cuda_remap.reset_counts()
    out, g = sm.stitch_batch(batch)
    torch.cuda.synchronize()
    assert cuda_remap.COUNTS == launches
    if kw.get("out_format") == "rgb":
        assert (out.cpu() - out_cpu).abs().mean() < 0.2
    else:
        a, b = sm.assemble_yuv(out[0]).cpu().float(), sm.assemble_yuv(out_cpu[0]).float()
        oh = a.shape[0] * 2 // 3
        assert (a - b)[:oh].abs().mean() < 0.2 and (a - b)[oh:].abs().mean() < 0.2
    assert (g.cpu() - g_cpu).abs().max().item() < 1e-3


TAPS = {
    "fan": (mxu_taps.fan, mxu_taps.fan_reference),
    "mxu_folded": (mxu_taps.mxu_folded, mxu_taps.mxu_folded_reference),
    "mxu_exact2": (mxu_taps.mxu_exact2, mxu_taps.mxu_exact2_reference),
}


# (steps, g, kh, lo, hi): the probe's rows [16, 64) of 80 (kb 48, its
# defaults), kb 16 and kb 112 (MAX_VISITED, the product kernels' most),
# 7 steps x G=3 (7 blocks of 48 M-tiles: a partial wave), one step at
# G=1, fewer steps than the card's 132 SMs, a prime step count, taps from
# lo = 21 (not a multiple of 16: the visited rows are still [16, 64)), or
# "edge"
TAPS_CASES = {
    "kb48-8x2": (8, 2, 80, 16, 64),
    "kb48-64x8": (64, 8, 80, 16, 64),
    "kb48-7x3": (7, 3, 80, 16, 64),
    "kb16-7x3": (7, 3, 16, 0, 16),
    "kb112-5x2": (5, 2, 112, 0, 112),
    "kb48-1x1": (1, 1, 80, 16, 64),
    "kb48-100x2": (100, 2, 80, 16, 64),
    "kb48-293x1": (293, 1, 80, 16, 64),
    "lo21-4x2": (4, 2, 80, 21, 57),
    "edge": "edge",
}


@pytest.mark.parametrize("case", list(TAPS_CASES))
@pytest.mark.parametrize("body", sorted(TAPS))
def test_taps_kernel_matches_plain_on_card(cuda_device, body, case):
    """Kernel 8 (A, and B and B2 on wgmma) at 16, 48 and 112 visited
    rows, on a partial wave and on the edge taps: f32 within 1e-3 of its
    plain version, one launch counted per call."""
    fn, ref = TAPS[body]
    if case == "edge":
        (steps, g, kh, lo, hi), arrays = (2, 2, 80, 16, 64), edge_probe_inputs()
    else:
        steps, g, kh, lo, hi = TAPS_CASES[case]
        arrays = make_probe_inputs(steps, g, kh, lo, hi)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    mxu_taps.reset_counts()
    got = fn(*t, lo, hi)
    torch.cuda.synchronize()
    assert mxu_taps.COUNTS == {f"taps_{body}": 1} and mxu_taps.LAUNCHES == 1
    want = ref(*t, lo, hi)
    assert len(got) == len(want) == g
    for a, b in zip(got, want):
        assert a.shape == b.shape == (t[0].shape[0], 8, 128)
        assert (a - b).abs().max().item() < 1e-3


@pytest.mark.parametrize("body", sorted(TAPS))
def test_taps_wrapper_raises_on_inputs_it_does_not_take(cuda_device, body):
    """A wrong dtype, a window shorter than the visited rows, a
    non-contiguous input: the wrapper raises and launches nothing."""
    fn, _ = TAPS[body]
    oyl, fxy, win = (torch.from_numpy(a).to(cuda_device) for a in make_probe_inputs(4, 2, 80, 16, 64))
    mxu_taps.reset_counts()
    with pytest.raises(ValueError, match="int32"):
        fn(oyl, fxy, win.float(), 16, 64)
    with pytest.raises(ValueError, match="visited rows"):
        fn(oyl, fxy, win[:, :, :56].contiguous(), 16, 50)
    with pytest.raises(ValueError, match="contiguous"):
        fn(oyl, fxy, win.transpose(2, 3).contiguous().transpose(2, 3), 16, 64)
    assert mxu_taps.LAUNCHES == 0


# A's windows around its staging limit: kb = MAX_STAGED from lo = 16 in a
# taller window (the staged instance's widest), one chunk wider (the
# instance that gathers from global memory), and the edge taps at that
# width (a tap row at khi = KH, lanes 127 and 128)
FAN_WIDE_CASES = {
    "staged-widest": (3, 2, 144, 16, 16 + mxu_taps.MAX_STAGED),
    "global-one-chunk-wider": (3, 2, 144, 16, 32 + mxu_taps.MAX_STAGED),
    "global-edge": (2, 2, 128, 0, 128),
}


@pytest.mark.parametrize("case", list(FAN_WIDE_CASES))
def test_fan_kernel_around_its_staging_limit(cuda_device, case):
    """A at the most visited rows its kernel stages in shared memory and
    one chunk past them (the products take at most MAX_VISITED): f32
    within 1e-3 of its plain version, one launch counted per call."""
    steps, g, kh, lo, hi = FAN_WIDE_CASES[case]
    arrays = edge_probe_inputs(lo, hi, kh) if "edge" in case else make_probe_inputs(steps, g, kh, lo, hi)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    mxu_taps.reset_counts()
    got = mxu_taps.fan(*t, lo, hi)
    torch.cuda.synchronize()
    assert mxu_taps.COUNTS == {"taps_fan": 1} and mxu_taps.LAUNCHES == 1
    want = mxu_taps.fan_reference(*t, lo, hi)
    assert len(got) == len(want) == g
    for a, b in zip(got, want):
        assert a.shape == b.shape == (steps, 8, 128)
        assert (a - b).abs().max().item() < 1e-3


def test_fan_wrapper_raises_on_misaligned_inputs(cuda_device):
    """A reads its inputs in 16-byte vectors: a contiguous input that
    starts 4 bytes into its storage is refused before any launch."""
    oyl, fxy, win = (torch.from_numpy(a).to(cuda_device) for a in make_probe_inputs(4, 2, 80, 16, 64))
    shifted = torch.empty(oyl.numel() + 1, dtype=oyl.dtype, device=cuda_device)[1:].view(oyl.shape)
    shifted.copy_(oyl)
    mxu_taps.reset_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        mxu_taps.fan(shifted, fxy, win, 16, 64)
    assert mxu_taps.LAUNCHES == 0


def _pipeline_sets(n, seed):
    """n distinct frame sets for the 256^2 two-fisheye rig."""
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, (384, 256), dtype=np.uint8) for _ in range(2)] for _ in range(n)]


def _drain_all(amm, sets, pop_delay=0.0):
    """Pushes every set and the end of the stream from a thread while
    popping here (sleeping ``pop_delay`` s before each pop)."""
    import threading
    import time

    def push_all():
        for s in sets:
            amm.push(s)
        amm.close_input()

    pusher = threading.Thread(target=push_all)
    got = []
    try:
        pusher.start()
        for _ in sets:
            time.sleep(pop_delay)
            got.append(amm.pop())
        pusher.join(timeout=60)
        assert not pusher.is_alive()
        with pytest.raises(StopIteration):
            amm.pop()
    finally:
        amm.close()
    return got


@pytest.mark.parametrize("pop_delay", [0.0, 0.05], ids=["paced", "slow_drain"])
def test_pipeline_ring_reuse_on_card(cuda_device, pop_delay):
    """More frame sets than BUF_SIZE, each distinct, through the rings of
    pinned and device slots: every output bit-identical to a direct
    stitch of its own set, in order.  With a slow drain the pusher runs
    ahead until the rings are full, so a pinned slot rewritten before its
    copy completed, or a device slot before its stitch did, would show as
    a wrong frame.  The caller's arrays are never written."""
    from octvr_tpu_torch.runtime import BUF_SIZE, AsyncMultiMapper

    mt, sizes, _ = _small_rig(cuda_device)
    m = Mapper(mt, sizes, blend=16, device=cuda_device)
    sets = _pipeline_sets(3 * BUF_SIZE + 1, seed=40)
    kept = [[f.copy() for f in s] for s in sets]
    amm = AsyncMultiMapper([m])
    got = _drain_all(amm, sets, pop_delay)
    for outs, s, k in zip(got, sets, kept):
        assert all(np.array_equal(f, g) for f, g in zip(s, k))
        assert np.array_equal(outs[0], m.stitch(s)[0].cpu().numpy())
    st = amm.stats()
    assert st["frames"] == len(sets) and st["h2d_bytes"] == len(sets) * 2 * 384 * 256
    assert st["h2d_GBps"] > 0 and st["d2h_bytes"] == len(sets) * 192 * 256


def test_pipeline_device_frames_and_gain_copy_on_card(cuda_device):
    """Frame sets pushed as tensors on the card skip the rings and are
    left unwritten; a gain copier (gain_modes [0, 0]) equals a direct
    stitch with its owner's gains, bit for bit; checksums in checksum
    mode equal the host outputs' on every 8th frame."""
    from octvr_tpu_torch.runtime import AsyncMultiMapper

    mt, sizes, _ = _small_rig(cuda_device)
    m0 = Mapper(mt, sizes, blend=16, device=cuda_device)
    m1 = Mapper(mt, sizes, blend=-8, device=cuda_device)
    sets = [[torch.from_numpy(f).to(cuda_device) for f in s] for s in _pipeline_sets(8, seed=41)]
    kept = [[f.clone() for f in s] for s in sets]
    amm = AsyncMultiMapper([m0, m1], gain_modes=[0, 0])
    got = _drain_all(amm, sets)
    assert amm.stats()["h2d_bytes"] == 0
    chk = _drain_all(AsyncMultiMapper([m0], drain="checksum"), sets)
    for n, (outs, s, k) in enumerate(zip(got, sets, kept)):
        assert all(torch.equal(f, g) for f, g in zip(s, k))
        o0, g0 = m0.stitch(s)
        o1, _ = m1.stitch(s, gains=g0)
        assert np.array_equal(outs[0], o0.cpu().numpy()) and np.array_equal(outs[1], o1.cpu().numpy())
        want = int(o0[::101, ::103].to(torch.int64).sum()) if n % 8 == 7 else 0.0
        assert chk[n] == [want]


def test_pipeline_sharded_on_card(cuda_device):
    """ShardedMapper outputs at make_mesh(2, 2): an odd number of frame
    sets, so the last batch is padded; every real frame comes out, in
    order, equal to stitch_batch called directly, and no padding frame."""
    from octvr_tpu_torch.runtime import AsyncMultiMapper

    mt, sizes, _ = _small_rig(cuda_device)
    sm = ShardedMapper(mt, sizes, make_mesh(2, 2, device=cuda_device), blend=16)
    sets = _pipeline_sets(5, seed=42)
    got = _drain_all(AsyncMultiMapper([sm]), sets)
    assert len(got) == 5
    for b0 in range(0, 5, 2):
        batch = sets[b0 : b0 + 2]
        batch = batch + batch[-1:] * (2 - len(batch))
        out, _ = sm.stitch_batch([torch.from_numpy(np.stack(x)).to(cuda_device) for x in zip(*batch)])
        for b in range(min(2, 5 - b0)):
            assert np.array_equal(got[b0 + b][0], sm.assemble_yuv(out[b]).cpu().numpy())


def test_distributed_bands_on_card(cuda_device, tmp_path):
    """Two gloo ranks sharing the card, two bands each: DistributedBands'
    sum and concat of CUDA tensors (an all_reduce and an all_gather of
    tensors that stay on the card) equal LocalBands' on all four bands."""
    from octvr_tpu_torch.parallel import LocalBands
    from torch_dist_fixtures import launch

    x = np.random.default_rng(5).standard_normal((4, 3, 6, 10)).astype(np.float32)
    res = launch(tmp_path, 2, [dict(kind="bands", name="bands", S=4, x=x, dim=1)], device="cuda")["bands"]
    local = LocalBands(4)
    xt = torch.from_numpy(x).to(cuda_device)
    want_sum, want_cat = local.sum(xt).cpu().numpy(), local.concat(xt, 1).cpu().numpy()
    for r in res:
        assert r["on"].startswith("cuda")
        np.testing.assert_allclose(r["sum"], want_sum, rtol=1e-6, atol=1e-6)
        assert np.array_equal(r["concat"], want_cat)


def test_map_cli_on_card_matches_cpu(cuda_device, tmp_path, monkeypatch, capfd):
    """``map`` without OCTVR_PLATFORM runs on the card, its colour
    conversions there too: the PNG within the map CLI's RGB bars
    (tests/test_torch_cli.py: per channel mean < 0.2, max <= 6) of the
    same steps by the port on the CPU, gains within 1e-3.  Feather
    blend: f32 on both devices (the card's multiband default is bf16)."""
    from octvr_tpu_torch.cli import map as tmap
    from octvr_tpu_torch.ops.color import rgb_to_yuv420p, yuv420p_to_rgb
    from octvr_tpu_torch.template import save_npz
    from octvr_tpu_torch.utils.png import read_png, write_png

    monkeypatch.delenv("OCTVR_PLATFORM", raising=False)
    mt, sizes, frames = _small_rig(cuda_device)
    save_npz(mt, str(tmp_path / "t.npz"))
    imgs = [np.clip(yuv420p_to_rgb(torch.from_numpy(f)).numpy(), 0, 255).astype(np.uint8) for f in frames]
    pngs = [str(tmp_path / f"cam{k}.png") for k in range(2)]
    for p, img in zip(pngs, imgs):
        write_png(p, img)
    before = cuda_remap.LAUNCHES
    tmap.main(["-t", str(tmp_path / "t.npz"), "-o", str(tmp_path / "out.png"), "--blend", "-8", "--gain", *pngs])
    assert cuda_remap.LAUNCHES > before
    line = [s for s in capfd.readouterr().err.splitlines() if s.startswith("gains:")][0]
    g_card = np.array(line.split("[")[1].split("]")[0].split(), np.float32)

    m = Mapper(mt, sizes, blend=-8, enable_gain=True, pipeline="yuv420", device="cpu")
    out, g_cpu = m.stitch([rgb_to_yuv420p(torch.from_numpy(i.astype(np.float32))) for i in imgs])
    ref = np.clip(yuv420p_to_rgb(out).numpy(), 0, 255).astype(np.uint8)
    d = np.abs(read_png(str(tmp_path / "out.png")).astype(np.float32) - ref)
    assert d.shape == ref.shape and d.reshape(-1, 3).mean(0).max() < 0.2 and d.max() <= 6
    assert np.abs(g_card - g_cpu.numpy()).max() < 1e-3


# ------------------------------------------------- the registration path


def _scene():
    """chip_smoke.py's copy of the tests' synthetic world (held equal to
    tests/test_registration.py's by tests/test_torch_register_e2e.py)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ring_grays(n=5, step=30.0):
    from octvr_tpu_torch.registration import rgb_to_gray

    scene = _scene()
    imgs = [scene.render_view(R, 380.0, 400, 300) for R in scene.yaw_cameras(n, step)]
    return imgs, [rgb_to_gray(torch.from_numpy(im)) for im in imgs]


def _tf32_flags():
    return (
        torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_tf32,
        torch.get_float32_matmul_precision(),
    )


@pytest.mark.parametrize("finder", ["fast", "blob"])
def test_features_on_card_match_cpu(cuda_device, finder):
    """detect_and_describe / the blobs on the card against the port on
    the CPU on the same gray: the bars of tests/test_torch_features.py
    (keypoint sets within 1%, angles within 1e-3 rad, >= 99.5% of the
    descriptor bits equal)."""
    from octvr_tpu_torch.registration import detect_and_describe, detect_and_describe_blobs
    from registration_fixtures import assert_feature_parity

    fn = detect_and_describe if finder == "fast" else detect_and_describe_blobs
    _, grays = _ring_grays(2)
    for g in grays:
        card = fn(g, max_features=600, device=cuda_device)
        assert card.keypoints.device.type == cuda_device.type
        p = assert_feature_parity(card, fn(g, max_features=600, device="cpu"))
        if finder == "blob":
            assert p["max_desc"] < 1e-3, p


def test_registration_takes_no_tf32_path(cuda_device):
    """The process's TF32 flags are the same after every registration
    call on the card; the features, the 2-NN and the card's BA give the
    same results with cuDNN's TF32 flag off as on (its default: the
    convolutions run in f64); with TF32 matmuls allowed the 2-NN's f32
    product raises (``require_full_f32``) rather than run in TF32."""
    import copy

    from octvr_tpu_torch.registration import (
        detect_and_describe,
        detect_and_describe_blobs,
        estimate_rotations,
        match_images,
    )
    from octvr_tpu_torch.registration.bundle_torch import bundle_adjust_ray_torch

    _, grays = _ring_grays(3)

    def run():
        feats = [detect_and_describe(g, max_features=600, device=cuda_device) for g in grays]
        blob = detect_and_describe_blobs(grays[0], max_features=300, device=cuda_device)
        matches = match_images(feats, device=cuda_device)
        cams, _ = estimate_rotations(feats, matches)
        cams, rms = bundle_adjust_ray_torch(feats, matches, copy.deepcopy(cams), 0.5, device=cuda_device)
        return feats + [blob], matches, [c.focal for c in cams]

    flags = _tf32_flags()
    base = run()
    assert _tf32_flags() == flags
    try:
        torch.backends.cudnn.allow_tf32 = not flags[0]
        other = run()
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="highest"):
            match_images(base[0][:2], device=cuda_device)
    finally:
        torch.backends.cudnn.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[2])
    assert _tf32_flags() == flags
    for a, b in zip(base[0], other[0]):
        assert torch.equal(a.descriptors, b.descriptors) and torch.equal(a.angle, b.angle)
    for key, mi in base[1].items():
        assert np.array_equal(mi.pairs, other[1][key].pairs)
    np.testing.assert_allclose(base[2], other[2], rtol=1e-4)


def test_register_images_on_card_matches_cpu(cuda_device):
    """register_images on the card against the port on the CPU on the
    tests' 5-camera ring: the same indices, focals within 0.5%, rms
    within 10%; the features stay on the card."""
    from octvr_tpu_torch.registration import register_images

    imgs, _ = _ring_grays(5)
    card = register_images(imgs, conf_thresh=0.5, device=cuda_device)
    cpu = register_images(imgs, conf_thresh=0.5, device="cpu")
    assert card.indices == cpu.indices == list(range(5))
    np.testing.assert_allclose(
        [c.focal for c in card.cameras], [c.focal for c in cpu.cameras], rtol=5e-3
    )
    assert abs(card.rms - cpu.rms) <= 0.1 * cpu.rms
    assert all(f.descriptors.device.type == cuda_device.type for f in card.features)
    assert card.times["total"] > 0
