"""The input stage shared by the Mapper and the ShardedMapper
(``octvr_tpu_torch.stitch.frames`` and the packed layout of
``octvr_tpu_torch.ops.color``): the split and merge over leading dims,
the prep over a [B, k, H*3/2, W] stack of source blocks against the same
call per frame and block, the frame checks of both stitchers, and the
prep kernel's wrapper (``ops.cuda_prep``) on the CPU: its plain version,
its refusals, and the rounding-edge frames that the on-card tests hold
the kernel to."""

import numpy as np
import pytest
import torch

from octvr_tpu_torch.ops import color, cuda_prep
from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
from octvr_tpu_torch.stitch import Mapper
from octvr_tpu_torch.stitch.frames import prep_rgb, prep_yuv
from octvr_tpu_torch.template import compile_rig
from prep_fixtures import prep_numpy, rounding_edges
from rigs import two_fisheye_rig

B, K, H, W = 2, 3, 16, 24


def _bufs(seed=0):
    """B x K packed frames [B, K, H*3/2, W], random bytes."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (B, K, H * 3 // 2, W), dtype=np.uint8))


def _vignettes(kind):
    """(vig, vig_half) as the ShardedMapper holds them for K blocks: one
    map for every block ([1, H, W], a band that reads every row), a
    slice per block ([K, H, W]), or none."""
    if kind == "off":
        return None, None
    rng = np.random.default_rng(1)
    n = 1 if kind == "shared" else K
    vig = torch.from_numpy(rng.uniform(0.4, 1.6, (n, H, W)).astype(np.float32))
    return vig, vig.reshape(n, H // 2, 2, W // 2, 2).mean(dim=(2, 4))


def _block(v, j):
    return None if v is None else v[j % v.shape[0]]


@pytest.mark.parametrize("pipeline", ["yuv420", "rgb"])
@pytest.mark.parametrize("vignette", ["off", "shared", "per_block"])
@pytest.mark.parametrize("fmt", ["yuv420p", "nv12"])
def test_prep_over_blocks_equals_per_frame(fmt, vignette, pipeline):
    """One prep call over the [B, K] stack gives, byte for byte, the
    call on each frame's block with that block's vignette; the yuv420
    prep per block is the vignette multiply, chroma about 128, clamp,
    round and cast in f32; without a vignette Y is a view of the
    frames."""
    bufs = _bufs()
    vig, vig_half = _vignettes(vignette)
    if pipeline == "rgb":
        got = prep_rgb(bufs, fmt, vig)
        assert got.shape == (B, K, 3, H, W) and got.dtype == torch.uint8
        for b in range(B):
            for j in range(K):
                assert torch.equal(got[b, j], prep_rgb(bufs[b, j], fmt, _block(vig, j)))
        return
    y, uv = prep_yuv(bufs, fmt, vig, vig_half)
    assert y.shape == (B, K, 1, H, W) and uv.shape == (B, K, 2, H // 2, W // 2)
    assert y.dtype == uv.dtype == torch.uint8
    if vig is None:
        assert y.untyped_storage().data_ptr() == bufs.untyped_storage().data_ptr()
    for b in range(B):
        for j in range(K):
            yb, uvb = prep_yuv(bufs[b, j], fmt, _block(vig, j), _block(vig_half, j))
            assert torch.equal(y[b, j], yb) and torch.equal(uv[b, j], uvb)
            planes = [p.numpy().astype(np.float32) for p in color.split_frame(bufs[b, j], fmt)]
            want_y, want_uv = planes[0], np.stack(planes[1:])
            if vig is not None:
                want_y = want_y * _block(vig, j).numpy()
                want_uv = (want_uv - 128.0) * _block(vig_half, j).numpy() + 128.0
            for got, want in ((yb[0], want_y), (uvb, want_uv)):
                want = np.clip(np.round(np.clip(want, 0.0, 255.0)), 0, 255).astype(np.uint8)
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", ["yuv420p", "nv12"])
@pytest.mark.parametrize("op", ["split", "merge"])
def test_packed_layout_over_leading_dims(op, fmt):
    """split_yuv420p, split_nv12, merge_yuv420p and merge_nv12 over a
    [B, K] stack equal the same function per frame, and split_frame and
    merge_frame dispatch to them by format name."""
    bufs = _bufs(2)
    split = color.split_nv12 if fmt == "nv12" else color.split_yuv420p
    merge = color.merge_nv12 if fmt == "nv12" else color.merge_yuv420p
    planes = split(bufs)
    if op == "split":
        assert all(p.untyped_storage().data_ptr() == bufs.untyped_storage().data_ptr() for p in planes)
        for got in (planes, color.split_frame(bufs, fmt)):
            for b in range(B):
                for j in range(K):
                    assert all(torch.equal(g[b, j], w) for g, w in zip(got, split(bufs[b, j])))
        return
    y, u, v = (p.contiguous() for p in planes)
    for got in (merge(y, u, v), color.merge_frame(y, u, v, fmt)):
        assert torch.equal(got, bufs)
        for b in range(B):
            for j in range(K):
                assert torch.equal(got[b, j], merge(y[b, j], u[b, j], v[b, j]))


CAM = 64


@pytest.fixture(scope="module")
def stitchers():
    """A Mapper and a ShardedMapper on the two-fisheye rig at 64^2 ->
    128x64, and one frame per camera."""
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"].update(width=CAM, height=CAM)
    mt = compile_rig(rig, 128, 64)
    mt.create_masks()
    sizes = [(CAM, CAM)] * 2
    frames = [np.full((CAM * 3 // 2, CAM), 128, dtype=np.uint8) for _ in sizes]
    return {
        "Mapper.stitch": Mapper(mt, sizes, blend=8, enable_gain=False, device="cpu").stitch,
        "Mapper.stitch_batch": Mapper(mt, sizes, blend=8, enable_gain=False, device="cpu").stitch_batch,
        "ShardedMapper.stitch_batch": ShardedMapper(
            mt, sizes, make_mesh(1, 2, device="cpu"), blend=8, enable_gain=False
        ).stitch_batch,
    }, frames


def _faulty(fault, frames, batched):
    """The call's frames with one fault, and the refusal's wording."""
    fs = [f[None].repeat(2, axis=0) if batched else f for f in frames]
    if fault == "count":
        return fs[:1], "1 frames for 2 inputs"
    if fault == "dtype":
        return [fs[0].astype(np.float32)] + fs[1:], "want uint8"
    if fault == "shape":
        return [fs[0][..., :-2]] + fs[1:], "want uint8"
    return [fs[0][:1]] + fs[1:], "same number of frames"  # unequal B


@pytest.mark.parametrize(
    "entry,fault",
    [(e, f) for e in ("Mapper.stitch", "Mapper.stitch_batch", "ShardedMapper.stitch_batch")
     for f in ("count", "dtype", "shape", "batch") if not (e == "Mapper.stitch" and f == "batch")],
)
def test_frame_checks_refuse(stitchers, entry, fault):
    """Each stitcher refuses a wrong frame count, dtype or shape, and a
    batch whose inputs hold unequal numbers of frames, with one wording
    of each ValueError; the same frames without the fault stitch."""
    calls, frames = stitchers
    batched = entry.endswith("stitch_batch")
    bad, wording = _faulty(fault, frames, batched)
    with pytest.raises(ValueError, match=wording):
        calls[entry](bad)
    calls[entry]([f[None].repeat(2, axis=0) if batched else f for f in frames])


@pytest.mark.parametrize("stack", ["one_frame", "blocks"])
@pytest.mark.parametrize("vignette", ["off", "shared", "per_block"])
@pytest.mark.parametrize("fmt", ["yuv420p", "nv12"])
def test_cpu_prep_is_the_plain_version(monkeypatch, fmt, vignette, stack):
    """On the CPU ``stitch.frames.prep_yuv`` is ``prep_yuv_reference``,
    and its bytes are the eager ops' of the parent (``prep_numpy``, the
    same f32 arithmetic in numpy), over one frame [H*3/2, W] and over a
    [B, K] stack; no kernel launch is counted."""
    from octvr_tpu_torch.stitch import frames

    bufs = _bufs(4)
    vig, vig_half = _vignettes(vignette)
    if stack == "one_frame":
        bufs = bufs[1, 2]
        vig, vig_half = _block(vig, 2), _block(vig_half, 2)
    calls = []
    real = cuda_prep.prep_yuv_reference
    monkeypatch.setattr(cuda_prep, "prep_yuv_reference", lambda *a: calls.append(a) or real(*a))
    launches = cuda_prep.LAUNCHES
    y, uv = frames.prep_yuv(bufs, fmt, vig, vig_half)
    assert len(calls) == 1 and calls[0][0] is bufs and cuda_prep.LAUNCHES == launches
    ry, ruv = real(bufs, fmt, vig, vig_half)
    assert torch.equal(y, ry) and torch.equal(uv, ruv)
    lead = tuple(bufs.shape[:-2])
    assert y.shape == (*lead, 1, H, W) and uv.shape == (*lead, 2, H // 2, W // 2)
    if vig is None:
        assert y.untyped_storage().data_ptr() == bufs.untyped_storage().data_ptr()
        return
    want_y, want_uv = prep_numpy(bufs, fmt, vig, vig_half)
    np.testing.assert_array_equal(y[..., 0, :, :].numpy(), want_y)
    np.testing.assert_array_equal(uv.numpy(), want_uv)


def _refused(fault):
    """(frames, format, vig, vig_half) with one fault, and the wording
    of its refusal."""
    bufs = _bufs(5)
    vig, vig_half = _vignettes("per_block")
    if fault == "frame_dtype":
        return (bufs.float(), "yuv420p", vig, vig_half), "frames: dtype torch.float32"
    if fault == "vig_dtype":
        return (bufs, "yuv420p", vig.double(), vig_half), "vig: dtype torch.float64"
    if fault == "frame_shape":
        return (bufs[..., :-1, :], "yuv420p", vig, vig_half), "frames: shape"
    if fault == "vig_shape":
        return (bufs, "yuv420p", vig[..., :-2], vig_half), "vig: shape"
    if fault == "vig_half_shape":
        return (bufs, "yuv420p", vig, vig_half[:2]), "vig_half: shape"
    if fault == "vig_lead":
        return (bufs, "yuv420p", vig[None].expand(3, -1, -1, -1), vig_half), "vig: shape"
    if fault == "vig_device":
        return (bufs, "yuv420p", vig.to("meta"), vig_half), "vig: device meta"
    if fault == "vig_half_device":
        return (bufs, "nv12", vig, vig_half.to("meta")), "vig_half: device meta"
    return (bufs, "uyvy", vig, vig_half), "unknown frame format"


@pytest.mark.parametrize(
    "fault",
    ["frame_dtype", "vig_dtype", "frame_shape", "vig_shape", "vig_half_shape", "vig_lead", "vig_device",
     "vig_half_device", "format"],
)
def test_prep_wrapper_refuses(fault):
    """``cuda_prep.prep_yuv`` refuses a wrong dtype, a wrong vignette
    shape (trailing or leading dims) and a vignette on another device
    than the frames, one wording each, on any device; the same call
    without the fault runs."""
    args, wording = _refused(fault)
    with pytest.raises(ValueError, match=wording):
        cuda_prep.prep_yuv(*args)
    bufs = _bufs(5)
    cuda_prep.prep_yuv(bufs, "yuv420p", *_vignettes("per_block"))


@pytest.mark.parametrize("fmt", ["yuv420p", "nv12"])
def test_rounding_edges_catch_a_contracted_kernel(fmt):
    """On the rounding-edge frame the CPU prep stores the two-rounding
    bytes, and the chroma expression fused into one multiply-add (f64,
    then one rounding to f32) stores another byte at some sites, as
    rounding Y's halves away from zero does: the fixture tells a kernel
    that does either from the eager ops."""
    buf, vig, vig_half = rounding_edges(fmt)
    y, uv = cuda_prep.prep_yuv(buf, fmt, vig, vig_half)
    want_y, want_uv = prep_numpy(buf, fmt, vig, vig_half)
    np.testing.assert_array_equal(y[0].numpy(), want_y)
    np.testing.assert_array_equal(uv.numpy(), want_uv)
    _, fused_uv = prep_numpy(buf, fmt, vig, vig_half, fused=True)
    assert (fused_uv != want_uv).sum() > 0
    yf = color.split_frame(buf, fmt)[0].numpy().astype(np.float32) * vig.numpy()
    away = np.clip(np.floor(np.clip(yf, 0.0, 255.0) + 0.5), 0, 255).astype(np.uint8)
    assert (away != want_y).sum() > 0
