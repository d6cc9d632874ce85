"""The port's own offline stage (octvr_tpu_torch: geometry, cameras,
vignette, raster, the host resize, template compiler, seams and
template files) against the JAX package's originals, bit for bit
(``np.array_equal``): both are the same numpy code, so every compiled
field, seam mask, vignette, raster and ``.dat`` byte must agree; and
``chip_smoke.py``'s copy of the 4K rig equals ``bench.six_cam_rig``."""

import importlib.util
import io
import math
from pathlib import Path

import numpy as np
import pytest

import bench
from octvr_tpu.ops.resize import resize_bilinear
from octvr_tpu.template import compile_rig as jax_compile_rig
from octvr_tpu.template import dump_dat as jax_dump_dat
from octvr_tpu.template import load_dat as jax_load_dat
from octvr_tpu.utils.raster import fill_poly as jax_fill_poly
from octvr_tpu.vignette import vignette_map as jax_vignette_map
from octvr_tpu_torch.cameras import REGISTRY
from octvr_tpu_torch.ops.resize import resize_bilinear_host
from octvr_tpu_torch.template import compile_rig, dump_dat, load_dat, load_npz, save_npz
from octvr_tpu_torch.utils.raster import fill_poly
from octvr_tpu_torch.vignette import vignette_map
from rigs import two_fisheye_rig

ROOT = Path(__file__).resolve().parents[1]
PI = math.pi

_PINHOLE = {"fx": 700.0, "fy": 700.0, "cx": 640.0, "cy": 480.0, "dist_coeffs": [0.05, -0.01, 0.0, 0.0],
            "width": 1280, "height": 960}
# one camera of each registry type (options as in tests/test_cameras.py)
CAMERAS = {
    "equirectangular": {},
    "stupidoval": {},
    "cubic": {},
    "eqareanorthpole": {},
    "eqareasouthpole": {},
    "normal": {"aspect_ratio": 16 / 9, "cam_opt": 0.7},
    "perspective": {"aspect_ratio": 16 / 9, "sf": 2.0},
    "pinhole": _PINHOLE,
    "fisheye": _PINHOLE,
    "fullframe_fisheye": {"width": 1920, "height": 1440, "hfov": PI, "center_dx": 3.0, "center_dy": -2.0,
                          "radial": [0.01, -0.02, 0.03], "vignette": [1.0, -0.15, 0.05, 0.0]},
    "ocam_fisheye": {"pol": [-200.0, 0.0, 0.001], "invpol": [150.0, 80.0, 10.0], "xc": 240.0, "yc": 240.0,
                     "c": 1.0, "d": 0.0, "e": 0.0, "width": 480, "height": 480},
}


def _type_rig(cam_type):
    """The camera type under test, then a full-frame fisheye facing away
    with an include mask (the include-mask priority and fill_poly)."""
    rig = two_fisheye_rig()
    second = rig["inputs"][1]
    second["options"]["include_masks"] = [{"type": "polygonal", "args": [500, 500, 700, 520, 680, 700, 520, 690]}]
    return {"output": rig["output"], "inputs": [{"type": cam_type, "options": dict(CAMERAS[cam_type])}, second]}


def _six_cam_small():
    rig = bench.six_cam_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = spec["options"]["height"] = 240
    return rig


RIGS = {
    "two_fisheye": (two_fisheye_rig, 256, 128),
    "six_cam_240": (_six_cam_small, 480, 240),
    **{f"type_{t}": (lambda t=t: _type_rig(t), 128, 64) for t in sorted(CAMERAS)},
}


def _assert_templates_equal(a, b):
    assert a.out_size == b.out_size and a.out_type == b.out_type
    assert len(a.inputs) == len(b.inputs) and len(a.overlay_inputs) == len(b.overlay_inputs)
    for x, y in zip(a.inputs + a.overlay_inputs, b.inputs + b.overlay_inputs):
        assert tuple(x.roi) == tuple(y.roi)
        for f in ("map1", "map2", "mask"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
        assert (x.vignette is None) == (y.vignette is None)
        assert x.vignette is None or np.array_equal(x.vignette, y.vignette)
    assert len(a.seam_masks) == len(b.seam_masks)
    for x, y in zip(a.seam_masks, b.seam_masks):
        assert np.array_equal(x, y)


def test_registry_has_every_type():
    assert set(REGISTRY) == set(CAMERAS)


@pytest.mark.parametrize("name", sorted(RIGS))
def test_compile_rig_equals_jax_package(name):
    make, w, h = RIGS[name]
    mt, ref = compile_rig(make(), w, h), jax_compile_rig(make(), w, h)
    assert np.array_equal(mt._visible_mask, ref._visible_mask)
    mt.create_masks()
    ref.create_masks()
    _assert_templates_equal(mt, ref)
    assert any((i.mask > 0).any() for i in mt.inputs)


def test_vignette_raster_and_host_resize_equal_jax_package():
    opts = {"vignette": [1.0, -0.2, 0.07, -0.01], "exposure": 0.3}
    assert np.array_equal(vignette_map(opts), jax_vignette_map(opts))
    assert vignette_map({}) is None and jax_vignette_map({}) is None
    for pts in ([(3, 2), (40, 5), (50, 33), (10, 44)], [(0, 0), (63, 10), (20, 47)]):
        a, b = np.zeros((48, 64), np.uint8), np.zeros((48, 64), np.uint8)
        fill_poly(a, pts, 255)
        jax_fill_poly(b, pts, 255)
        assert np.array_equal(a, b) and a.any()
    rng = np.random.default_rng(3)
    for img in (rng.uniform(0, 2, (37, 53)).astype(np.float32), rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)):
        for shape in ((17, 91), (80, 60), img.shape[:2]):
            got, want = resize_bilinear_host(img, *shape), resize_bilinear(img, *shape)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dat_bytes_equal_and_cross_load(tmp_path):
    make, w, h = RIGS["type_fullframe_fisheye"]
    mt, ref = compile_rig(make(), w, h), jax_compile_rig(make(), w, h)
    mt.create_masks()
    ref.create_masks()
    a, b = io.BytesIO(), io.BytesIO()
    dump_dat(mt, a)
    jax_dump_dat(ref, b)
    assert a.getvalue() == b.getvalue() and len(a.getvalue()) > 0
    _assert_templates_equal(load_dat(io.BytesIO(b.getvalue())), ref)
    _assert_templates_equal(jax_load_dat(io.BytesIO(a.getvalue())), mt)
    save_npz(mt, tmp_path / "t.npz")
    _assert_templates_equal(load_npz(tmp_path / "t.npz"), mt)


def test_chip_smoke_rig_equals_bench():
    """chip_smoke.py carries its own copy of the 4K rig (bench.py:32-69)
    and imports nothing of bench; loading it runs no phase."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.six_cam_rig() == bench.six_cam_rig()
