"""The port's band-sharded plan (octvr_tpu_torch/parallel/sharded.py)
against the JAX package's ``build_sharded_plan``, field by field, for
every plan kind (both pipelines, multiband, feather, paste, blocks
gains, overlays, scale_output, NV12, mixed sizes), and the per-shard
remap taps against the JAX plain gather; also ``sharded_plan_from_jax``,
the options that raise, and the port's freedom from the JAX package.

The plan builders are the same numpy arithmetic, so every field is held
with ``np.array_equal``; no JIT runs here."""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu.ops.remap import remap_apply as jax_remap_apply
from octvr_tpu.ops.remap import remap_plan as jax_remap_plan
from octvr_tpu.parallel.sharded import build_sharded_plan as jax_build_sharded_plan
from octvr_tpu_torch.ops.remap import remap_apply_reference, remap_group
from octvr_tpu_torch.parallel import ShardedMapper, build_sharded_plan, make_mesh
from octvr_tpu_torch.parallel.convert import sharded_plan_from_jax
from octvr_tpu_torch.stitch import FastMapper, Mapper
from octvr_tpu_torch.parallel.sharded import _Geom, _union_box, _window_maps
from sharded_fixtures import fisheye_rig, mixed_rig, nv12_frames, six_cam_small, with_overlay

torch.set_num_threads(2)

# (rig, S, options; yuv420 and blend 32 unless given): the split on
# (blend 32 -> 4 bands, split level 2), the split off (coarse_split = the
# band count), S=1 (halo 0), the six-camera rig with source windows
# (kernel 6's concat layout), and every other plan kind
CONFIGS = {
    "fisheye_s4_split": ("fisheye", 4, {}),
    "fisheye_s4_nosplit": ("fisheye", 4, {"coarse_split": 4}),
    "fisheye_s1": ("fisheye", 1, {}),
    "sixcam_s4_srcwin": ("sixcam", 4, {"src_windows": True}),
    "fisheye_s4_rgb": ("fisheye", 4, {"pipeline": "rgb"}),
    "fisheye_s4_feather": ("fisheye", 4, {"blend": -8}),
    "fisheye_s4_paste_rgb": ("fisheye", 4, {"blend": 0, "pipeline": "rgb"}),
    "fisheye_s4_blocks": ("fisheye", 4, {"enable_gain": "blocks"}),
    "fisheye_s4_scale_nv12": ("fisheye", 4, {"scale_output": (192, 96), "frame_format": "nv12"}),
    "overlay_s4": ("overlay", 4, {}),
    "mixed_s4_srcwin_rgb": ("mixed", 4, {"src_windows": True, "pipeline": "rgb"}),
}

_SAME = (
    "S", "bh", "halo", "ext", "Hp", "Wp", "num_bands", "num_bands_uv",
    "stride", "ralign", "ghalo", "rois", "roi_oy_static", "roi_oy", "src_h",
    "src_row0_static", "src_row0", "split_level", "split_level_uv",
    "coarse_row_idx", "coarse_row_idx_uv", "weight_pyrs", "inv_band_weights",
    "weight_pyrs_uv", "inv_band_weights_uv", "wp_coarse", "inv_bw_coarse",
    "wp_coarse_uv", "inv_bw_coarse_uv", "gm_i", "union_row_mask",
    "union_row_mask_uv", "union_col_mask", "union_col_mask_uv",
    "pool_cols_roi", "pool_cols_roi_uv", "down_mats",
    "up_mats", "num_overlays", "blend_kind", "pipeline", "frame_format",
    "group_idx", "out_size", "obh", "oW", "compute_dtype", "feather_w",
    "feather_w_uv", "overlay_masks", "overlay_masks_uv", "resize_v",
    "resize_h", "resize_v_uv", "resize_h_uv",
)


@pytest.fixture(scope="module")
def rigs():
    fisheye = fisheye_rig()
    return {"fisheye": fisheye, "sixcam": six_cam_small(), "mixed": mixed_rig(), "overlay": with_overlay(*fisheye)}


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def _plans(rigs, name, **extra):
    rig, S, kw = CONFIGS[name]
    mt, sizes, _ = rigs[rig]
    kw = {"blend": 32, "pipeline": "yuv420", **kw, **extra}
    return mt, sizes, build_sharded_plan(mt, sizes, S, **kw), jax_build_sharded_plan(mt, sizes, S, **kw)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_fields_equal_jax(rigs, name):
    mt, sizes, port, ref = _plans(rigs, name)
    for f in _SAME:
        assert _equal(getattr(port, f), getattr(ref, f)), f
    assert port.gain.N == ref.N and port.gain.pairs == ref.pairs
    assert np.array_equal(port.gain.b, ref.gain_b)
    assert np.array_equal(port.gain.A_static, ref.gain_A_static)
    assert (port.gain_blocks is None) == (ref.gain_blocks is None)
    if port.gain_blocks is not None:
        for f in ("num_images", "block", "nby", "nbx", "canvas", "rois", "cover", "N", "A_static", "b"):
            assert _equal(getattr(port.gain_blocks, f), getattr(ref.gain_blocks, f)), f
    # the JAX plan keeps ones where a camera has no vignette
    halves = (port.vignette_half or [], ref.vignette_half or [])
    for v, rv in zip(port.vignette + halves[0], ref.vignette + halves[1]):
        assert np.array_equal(rv, np.ones_like(rv) if v is None else v)
    assert (port.vignette_half is None) == (ref.vignette_half is None)
    concat = [bool(rp.concat_heights) for rp in ref.remap_groups]
    assert port.sliced == any(concat)
    assert [g.concat for g in port.to("cpu").remap_groups] == concat
    if name == "sixcam_s4_srcwin":
        # side cameras sliced, poles whole: kernel 6 takes the launch
        assert concat and any(h < 240 for h in port.src_h), port.src_h
    if name == "fisheye_s4_split":
        assert port.split_level == 2 and port.split_level_uv == 1
    if name == "fisheye_s4_nosplit":
        assert port.split_level == -1 and port.halo >= 5 * (1 << port.num_bands)
    if name == "fisheye_s1":
        assert port.halo == 0 and port.split_level == -1


def test_sliced_taps_equal_jax_gather_on_unsliced_source(rigs):
    """The contract kernel 6 keeps: each (input, band) window remap
    through the port's taps on the sliced source equals the JAX plain
    gather on the unsliced source through the un-rebased window maps.
    The rebased map is rounded to f32, which moves a tap by ~1e-5 px and
    so a weight by a few 1e-5: under 0.01 between neighbours 255 apart,
    hence the bar of 0.02."""
    mt, sizes, _ = rigs["sixcam"]
    plan = build_sharded_plan(mt, sizes, 4, blend=32, src_windows=True)
    g = _Geom(plan.S, plan.bh, plan.halo, plan.rois, plan.roi_oy, _union_box(mt, 1 << plan.num_bands))
    rng = np.random.default_rng(5)
    worst, sliced = 0.0, 0
    for div, plans in ((1, plan.remap), (2, plan.remap_uv)):
        band_maps = _window_maps(mt, g, plan.Hp, plan.Wp, div)
        for i in range(plan.num_inputs):
            H, W = plan.in_sizes[i][0] // div, plan.in_sizes[i][1] // div
            img = rng.integers(0, 256, (1, H, W), dtype=np.uint8)
            h = plan.src_h[i] // div
            for s in range(plan.S):
                r0 = int(plan.src_row0[s, i]) // div
                got = remap_apply_reference(
                    torch.from_numpy(img[None, :, r0 : r0 + h].copy()), remap_group([plans[i][s]], "cpu")
                )[0]
                want = jax_remap_apply(
                    jnp.asarray(img, jnp.float32), jax_remap_plan(*band_maps[s][i], H, W)
                )
                worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
                sliced += h < H
    print(f"sliced taps vs JAX gather on the unsliced source: max abs {worst:.3g}")
    assert sliced > 0 and worst < 0.02


@pytest.mark.parametrize(
    "name,dtype",
    [("fisheye_s4_split", "float32"), ("fisheye_s4_split", "bfloat16"), ("sixcam_s4_srcwin", "float32"),
     ("fisheye_s4_rgb", "bfloat16"), ("fisheye_s4_feather", "float32"), ("fisheye_s4_paste_rgb", "float32"),
     ("fisheye_s4_blocks", "float32"), ("fisheye_s4_scale_nv12", "float32"), ("overlay_s4", "float32"),
     ("mixed_s4_srcwin_rgb", "float32")],
)
def test_plan_from_jax_stitches_like_port_plan(rigs, name, dtype):
    """A plan carried across from the JAX package stitches bit for bit
    like the port's own, for every plan kind; bf16 leaves (ml_dtypes
    arrays) arrive bit for bit."""
    rig, S, kw = CONFIGS[name]
    mt, sizes, frames = rigs[rig]
    _, _, port, ref = _plans(rigs, name, blend_dtype=dtype)
    port = port.to("cpu")
    carried = sharded_plan_from_jax(ref, mt, sizes, "cpu")
    if port.blend_kind == "multiband":
        assert carried.weight_pyrs[0][0].dtype == getattr(torch, dtype)
    for f in ("weight_pyrs", "inv_bw_coarse_uv", "feather_w", "overlay_masks"):
        assert _equal_tensors(getattr(carried, f), getattr(port, f)), f
    if kw.get("frame_format") == "nv12":
        frames = nv12_frames(frames)
    frames = [torch.from_numpy(f[None].copy()) for f in frames]
    mesh = make_mesh(1, S, device="cpu")
    a = ShardedMapper.from_plan(port, mesh).stitch_batch(frames)
    b = ShardedMapper.from_plan(carried, mesh).stitch_batch(frames)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _equal_tensors(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_tensors(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or torch.equal(a, b)


def test_unported_options_raise(rigs):
    """Every option of the JAX ShardedMapper is ported: what is left to
    raise are values no ShardedMapper takes, each a ValueError."""
    mt, sizes, _ = rigs["fisheye"]
    mesh = make_mesh(1, 2, device="cpu")
    for kw in (
        {"pipeline": "rgba"},
        {"out_format": "rgba"},
        {"out_format": "rgb", "pipeline": "yuv420"},
        {"enable_gain": "local"},
        {"frame_format": "uyvy"},
        {"blend_dtype": "float16"},
        {"scale_output": (127, 64)},
    ):
        with pytest.raises(ValueError):
            ShardedMapper(mt, sizes, mesh, **kw)
    with pytest.raises(ValueError, match="sizes"):
        ShardedMapper(mt, [(256, 256)] * 3, mesh)
    with pytest.raises(ValueError, match="even"):
        ShardedMapper(mt, [(256, 256), (241, 241)], mesh)
    sm = ShardedMapper(mt, [(256, 256), (240, 240)], mesh, pipeline="rgb", blend=-8)
    assert sm.plan.group_idx == ((0,), (1,)) and sm.plan.remap is None
    with pytest.raises(ValueError, match="stacked"):
        sm.stitch_batch(torch.zeros((1, 2, 384, 256), dtype=torch.uint8))


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception):
        make_mesh(1, 4, device="cuda")


def test_entry_points_default_to_the_card(rigs, monkeypatch):
    """Mapper, FastMapper and make_mesh run on the card unless asked for
    the CPU, and ShardedMapper takes the mesh's device; so do the CLIs
    without OCTVR_PLATFORM, and an AsyncMultiMapper over CUDA mappers.
    Without a card the default raises, with no fallback to the CPU."""
    from types import SimpleNamespace

    from octvr_tpu_torch.cli import apply_platform_env, monkey, stream
    from octvr_tpu_torch.runtime import AsyncMultiMapper

    monkeypatch.delenv("OCTVR_PLATFORM", raising=False)
    mt, sizes, _ = rigs["fisheye"]
    makers = (
        lambda: Mapper(mt, sizes, blend=16),
        lambda: FastMapper(mt, sizes),
        lambda: make_mesh(1, 2),
        lambda: SimpleNamespace(device=apply_platform_env()),
    )
    for make in makers:
        if torch.cuda.is_available():
            assert make().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="is_available"):
                make()
    if not torch.cuda.is_available():
        clis = (
            lambda: stream.main(["--in_size", "8x8", "--outputs", "t.npz", "--out", "o.yuv"]),
            lambda: monkey.main(["-t", "t.npz", "--inputs", "a,b", "--in_size", "8x8"]),
            lambda: AsyncMultiMapper([SimpleNamespace(device=torch.device("cuda"))]),
        )
        for run in clis:
            with pytest.raises(RuntimeError, match="is_available"):
                run()
    monkeypatch.setenv("OCTVR_PLATFORM", "cpu")
    assert apply_platform_env().type == "cpu"
    monkeypatch.setenv("OCTVR_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="OCTVR_PLATFORM"):
        apply_platform_env()
    sm = ShardedMapper(mt, sizes, make_mesh(1, 2, device="cpu"), blend=16)
    assert sm.device.type == "cpu" and sm.plan.weight_pyrs[0][0].device.type == "cpu"


ROOT = Path(__file__).resolve().parents[1]
_BANNED = ("octvr_tpu", "bench", "jax", "jaxlib", "ml_dtypes")


def _imported(path):
    """Top-level package names a file imports (relative imports aside)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    """The port and chip_smoke.py import nothing of octvr_tpu, bench,
    jax or ml_dtypes: by their source (every import statement, those
    inside functions included), and at run time (a fresh interpreter
    that imports every module of the port is left without them)."""
    files = sorted((ROOT / "octvr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imported(f) if m in _BANNED]
    assert not bad, bad
    mods = [
        ".".join(f.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for f in files if f.name != "chip_smoke.py"
    ]
    assert len(mods) > 20 and "octvr_tpu_torch.template.compiler" in mods
    assert {"octvr_tpu_torch.runtime", "octvr_tpu_torch.runtime.pipeline", "octvr_tpu_torch.presets",
            "octvr_tpu_torch.cli.stream", "octvr_tpu_torch.cli.map", "octvr_tpu_torch.cli.monkey",
            "octvr_tpu_torch.cli.monkey_gen"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_BANNED!r})\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
