"""Port tests that need an NVIDIA card: the CUDA remap kernels (NC=1, 2
and 3; the one-frame kernel on ragged inputs and on a shape it refuses;
the frames kernel against one-frame launches; stacked or concat
sources; a CUDA-graph replay) and the
three kernels of the MXU-taps probe (kernel 8) against their plain
torch versions, and the port's Mapper and ShardedMapper (every option
group) on the card against the port on the CPU.  They carry the
``cuda`` marker and skip without a card.
This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from octvr_tpu_torch.ops import cuda_remap, mxu_taps
from octvr_tpu_torch.ops.remap import (
    concat_source,
    remap_apply_reference,
    remap_group,
    remap_plan,
    split_frame_outputs,
)
from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
from octvr_tpu_torch.stitch import FastMapper, Mapper
from octvr_tpu_torch.template import compile_rig
from octvr_tpu_torch.tools.mxu_taps_probe import make_probe_inputs
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


def _small_rig(device):
    rig = two_fisheye_rig()
    for s in rig["inputs"]:
        s["options"]["width"] = s["options"]["height"] = 256
    mt = compile_rig(rig, 256, 128)
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
