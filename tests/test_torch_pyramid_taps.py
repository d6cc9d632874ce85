"""The pyramid kernels (csrc/pyramid.cu) modelled on the CPU, where no
kernel runs:

- their index and weight rule (``axis_taps``) in numpy: per output the
  folded (source, weight) taps, which rebuild ``down_matrix(n)`` and
  ``up_matrix(n)`` exactly at every length 2..300, at every length of
  the benchmark's multiband plans (``mono360_4k``, ``cyl3dv_2304``) and
  of ``chip_smoke.py``'s band-sharded 4K plans;
- the up kernel's epilogues, the Laplacian accumulate and the collapse,
  as the kernel orders its f32 ops and roundings, in plain torch: the
  port's ``multiband_blend`` on the CPU with its up steps run so gives
  its eager bytes bit for bit, in bf16 and in f32;
- chip_smoke.py's byte bound and per-launch checks of the kernels, over
  the plain versions."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from octvr_tpu_torch.ops import cuda_pyramid
from octvr_tpu_torch.ops.pyramid import down_matrix, pyr_up_mm, up_matrix
from octvr_tpu_torch.stitch import blenders as tb

from blend_fixtures import CANVAS, blend_scene

DOWN_W = np.array([1, 4, 6, 4, 1], dtype=np.float32) / 16.0
UP_W = np.array([1, 4, 6, 4, 1], dtype=np.float32) * 2.0 / 16.0

# The axis lengths (keys of every plan's ``down_mats``) of the benchmark
# configurations' multiband plans, Y and U|V grids, and of the sharded
# 4K plans of chip_smoke.py (``build_sharded_4k``, yuv420 and rgb),
# read from the plans built on the card's machine.
PLAN_LENGTHS = {
    "mono360_4k": (
        20, 21, 28, 30, 31, 32, 40, 42, 56, 60, 62, 64, 80, 84, 112, 120, 124, 128, 160, 168, 224, 240,
        248, 256, 320, 336, 448, 480, 496, 512, 640, 672, 896, 960, 992, 1024, 1280, 1344, 1792, 1920,
        1984, 2048, 3840,
    ),
    "cyl3dv_2304": (
        8, 16, 19, 22, 32, 38, 44, 64, 76, 88, 128, 152, 176, 256, 304, 352, 512, 608, 704, 1024, 1216,
        1408, 2048,
    ),
    "sharded_4k": (
        8, 16, 30, 31, 32, 33, 60, 62, 64, 66, 120, 124, 128, 132, 240, 248, 256, 264, 480, 496, 512,
        528, 960, 992, 1024, 1920, 1984, 2048, 3840,
    ),
}


def axis_taps(i, n, up):
    """Output i's taps along an axis of n sources, as the kernels' rule
    gives them: [(source, weight)] in ascending source order, the weights
    of taps that land on one source summed in tap order."""
    taps = {}
    for k in range(5):
        if up:
            z = i + k - 2  # the zero-stuffed axis
            if z < 0 or z >= 2 * n or z % 2:
                continue
            j, w = z // 2, UP_W[k]
        else:
            j = 2 * i + k - 2
            if j < 0:
                j = -j
            if j >= n:
                j = 2 * (n - 1) - j
            w = DOWN_W[k]
        taps[j] = np.float32(taps.get(j, np.float32(0)) + w)
    return sorted(taps.items())


def tap_matrix(n, up):
    """The matrix the taps of every output of an n-length axis make."""
    n_out = 2 * n if up else n // 2
    m = np.zeros((n_out, n), dtype=np.float32)
    for i in range(n_out):
        for j, w in axis_taps(i, n, up):
            m[i, j] = w
    return m


@pytest.mark.parametrize("lengths", ["range", *PLAN_LENGTHS])
def test_taps_rebuild_the_banded_matrices(lengths):
    """At each length n the taps rebuild down_matrix(n), up_matrix(n) and
    up_matrix(n // 2) (the up step from the level below) exactly; no
    output has more than five taps or a source outside [0, n)."""
    ns = range(2, 301) if lengths == "range" else PLAN_LENGTHS[lengths]
    assert ns
    for n in ns:
        assert np.array_equal(tap_matrix(n, up=False), down_matrix(n)), n
        for m in (n, n // 2):
            assert np.array_equal(tap_matrix(m, up=True), up_matrix(m)), (n, m)
        for i in range(n // 2):
            taps = axis_taps(i, n, up=False)
            assert len(taps) <= 5 and all(0 <= j < n for j, _ in taps)


def _rnd(v, dtype):
    return v.to(dtype).float()


def laplacian_epilogue(dst, g, u, w):
    """The kernel's ``dst += (g - up(x)) * w``: ``u`` the f32 sum of the
    up step, every op in f32 and rounded to the dtype after it."""
    dt = dst.dtype
    lap = _rnd(g.float() - _rnd(u, dt), dt)
    return (dst.float() + _rnd(lap * w.float(), dt)).to(dt)


def collapse_epilogue(u, d, s):
    """The kernel's ``up(x) + d * s``, rounded as ``laplacian_epilogue``."""
    dt = d.dtype
    return (_rnd(u, dt) + _rnd(d.float() * s.float(), dt)).to(dt)


def kernel_order_ops():
    """The per-step entries of ``ops.cuda_pyramid`` that the CPU path of
    ``multiband_blend`` calls (``{name: function}``), with the up steps
    run as the kernel runs them: the f32 sum of the banded product, then
    the epilogue."""
    def up32(x, mats):
        return pyr_up_mm(x, mats[x.shape[-2]], mats[x.shape[-1]])

    def up_laplacian(dst, g, x, w, mats):
        return dst.copy_(laplacian_epilogue(dst, g, up32(x, mats), w))

    def up_collapse(x, d, s, mats):
        return collapse_epilogue(up32(x, mats), d, s)

    return {"down": cuda_pyramid.down_reference, "up_laplacian": up_laplacian, "up_collapse": up_collapse}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("seed,c", [(0, 1), (1, 2), (3, 1), (4, 2)])
def test_epilogue_rounding_equals_eager_blend(seed, c, dtype, monkeypatch):
    """The epilogues' rounding sequence gives the eager blend's bytes on
    tests/test_torch_blend.py's scenes."""
    masks, rois, imgs, bands = blend_scene(seed, c=c)
    plan = tb.build_multiband_plan(masks, rois, bands, CANVAS, dtype=dtype).to("cpu")
    ts = [torch.from_numpy(i) for i in imgs]
    want = tb.multiband_blend(plan, ts, CANVAS)
    for name, fn in kernel_order_ops().items():
        monkeypatch.setattr(cuda_pyramid, name, fn)
    got = tb.multiband_blend(plan, ts, CANVAS)
    assert torch.equal(got, want)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("seed,c", [(0, 1), (1, 2), (5, 3)])
def test_chip_smoke_pyramid_bound_counts_each_launch(seed, c):
    """chip_smoke.py's byte count of a blend's pyramid kernels equals the
    bytes of the operands that the card's blend hands each grouped launch
    (every camera's levels and weight levels, the weights once for all
    channels, each band level written once) and each collapse step."""
    smoke = _chip_smoke()
    masks, rois, imgs, bands = blend_scene(seed, c=c)
    plan = tb.build_multiband_plan(masks, rois, bands, CANVAS, dtype="bfloat16").to("cpu")
    moved = []
    real = {name: getattr(cuda_pyramid, name) for name in ("down_group", "lap_gather", "up_collapse")}

    def down_group(groups, i, x, mats):
        out = real["down_group"](groups, i, x, mats)
        moved.append(x.numel() + out.numel())
        return out

    def lap_gather(groups, gauss, mats):
        out = real["lap_gather"](groups, gauss, mats)
        weights = sum(w.numel() for pyr in groups.weights for w in pyr)
        moved.append(sum(g.numel() for g in gauss) + sum(g.numel() for g in gauss[1:]) + weights
                     + sum(b.numel() for b in out))
        return out

    def up_collapse(x, d, s, mats):
        out = real["up_collapse"](x, d, s, mats)
        moved.append(x.numel() + d.numel() + s.numel() + out.numel())
        return out

    ts = [torch.from_numpy(i) for i in imgs]
    with smoke._pyramid_ops(down_group=down_group, lap_gather=lap_gather, up_collapse=up_collapse):
        got = tb.multiband_blend(plan, ts, CANVAS)
    assert tb.cuda_pyramid is cuda_pyramid
    assert all(getattr(cuda_pyramid, name) is fn for name, fn in real.items())
    assert torch.equal(got, tb.multiband_blend(plan, ts, CANVAS))
    assert len(moved) == 2 * bands + 1
    assert smoke._pyramid_bytes(plan, c, 2) == 2 * sum(moved)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_chip_smoke_pyramid_checks(dtype):
    """chip_smoke.py's per-launch checks of the pyramid kernels, run
    here over the plain versions (which they hold to themselves): every
    camera's grouped down step through its per-step down, and every up
    step of a blend, checked, none off; and its rounding check refuses a
    store two bf16 ulps off its f32 sum, or an f32 store 1e-3 off."""
    smoke = _chip_smoke()
    masks, rois, imgs, bands = blend_scene(1, c=2)
    plan = tb.build_multiband_plan(masks, rois, bands, CANVAS, dtype=dtype).to("cpu")
    checks = []
    with smoke._pyramid_ops(**smoke._checked_pyramid_ops(checks)):
        got = tb.multiband_blend(plan, [torch.from_numpy(i) for i in imgs], CANVAS)
    assert torch.equal(got, tb.multiband_blend(plan, [torch.from_numpy(i) for i in imgs], CANVAS))
    assert len(checks) == 2 * len(imgs) * bands + bands
    assert all(share == 0.0 and err <= 1e-4 for share, err in checks)
    t32 = torch.linspace(1, 255, 1000)
    if dtype == "bfloat16":
        off = t32.to(torch.bfloat16).view(torch.int16) + 2
        with pytest.raises(AssertionError, match="not a rounding"):
            smoke._one_rounding(off.view(torch.bfloat16), t32)
    else:
        with pytest.raises(AssertionError, match="off its banded product"):
            smoke._one_rounding(t32 + 1e-3, t32)
