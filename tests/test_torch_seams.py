"""The port's rest of the offline stage against the JAX package's
originals on the same seeded numpy inputs: the seam finders (graph cut
and dp, each with the "color" and "color_grad" costs, BFS, Voronoi,
``grad_magnitude``), ``MapperTemplate.create_masks`` for every seam
kind, ``morph_control_points``, the ``Timelapser`` and the resize modes,
all bit for bit (``np.array_equal``: both are the same numpy code); the
conv-form pyramid ops (plain torch against JAX's XLA convolutions)
within atol 1e-4; and the F9 guard, every name of every JAX module's
``__all__`` present in its port counterpart."""

import importlib
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu.ops import pyramid as jpyramid
from octvr_tpu.ops import resize as jresize
from octvr_tpu.stitch.timelapser import Timelapser as JaxTimelapser
from octvr_tpu.template import compile_rig as jax_compile_rig
from octvr_tpu.template import graphcut as jgraphcut
from octvr_tpu.template import seam as jseam
from octvr_tpu.template.morph import morph_control_points as jax_morph
from octvr_tpu_torch.ops import pyramid
from octvr_tpu_torch.ops import resize
from octvr_tpu_torch.stitch.timelapser import Timelapser
from octvr_tpu_torch.template import compile_rig, graphcut, seam
from octvr_tpu_torch.template.morph import morph_control_points
from rigs import two_fisheye_rig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PI = math.pi
SEEDS = [0, 1, 2]
CAM = 128


def _disc(h, w, rng):
    """A u8 mask: an ellipse filling most of [h, w], off-centre by seed."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = h / 2 + rng.uniform(-2, 2), w / 2 + rng.uniform(-3, 3)
    inside = ((yy - cy) / (0.48 * h)) ** 2 + ((xx - cx) / (0.48 * w)) ** 2 < 1
    return np.where(inside, 255, 0).astype(np.uint8)


def _scene(seed):
    """Three overlapping inputs on a small canvas: u8 masks, (x, y)
    corners and f32 RGB images in [0, 1], each of its mask's size."""
    rng = np.random.default_rng(seed)
    masks, corners, images = [], [], []
    for k in range(3):
        h, w = int(rng.integers(20, 28)), int(rng.integers(30, 40))
        masks.append(_disc(h, w, rng))
        corners.append((int(18 * k + rng.integers(0, 4)), int(rng.integers(0, 6))))
        base = rng.random((h, w, 3)).astype(np.float32)
        images.append(0.5 * base + 0.5 * np.roll(base, 1, axis=1))
    return masks, corners, images


FINDERS = {
    "graphcut_color": lambda m, s, i, c: m.graphcut_seam_find(i, s, c, cost_type="color"),
    "graphcut_color_grad": lambda m, s, i, c: m.graphcut_seam_find(i, s, c, cost_type="color_grad"),
    "dp_color": lambda m, s, i, c: m.dp_seam_find(i, s, c, cost_type="color"),
    "dp_color_grad": lambda m, s, i, c: m.dp_seam_find(i, s, c, cost_type="color_grad"),
    "bfs": lambda m, s, i, c: m.bfs_seam_find(s, c),
    "voronoi": lambda m, s, i, c: m.voronoi_seam_find(s, c),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("finder", [*sorted(FINDERS), "grad_magnitude"])
def test_seam_finders_bit_equal(finder, seed):
    masks, corners, images = _scene(seed)
    if finder == "grad_magnitude":
        for img in images + [images[0][..., 0]]:
            for got, want in zip(graphcut.grad_magnitude(img), jgraphcut.grad_magnitude(img), strict=True):
                assert np.array_equal(got, want)
        return
    mod = {"graphcut": (graphcut, jgraphcut)}.get(finder.split("_")[0], (seam, jseam))
    got = FINDERS[finder](mod[0], masks, images, corners)
    want = FINDERS[finder](mod[1], masks, images, corners)
    assert len(got) == len(want) == 3
    for g, w, m in zip(got, want, masks):
        assert g.dtype == w.dtype == np.uint8 and np.array_equal(g, w)
    # each finder keeps a pixel it was given or drops it, never adds one,
    # and the scene's overlaps make it drop some
    assert all(((g > 0) <= (m > 0)).all() for g, m in zip(got, masks))
    assert sum(int(((m > 0) & (g == 0)).sum()) for g, m in zip(got, masks)) > 0
    if finder == "bfs":  # the BFS finder partitions: no pixel kept twice
        count = np.zeros((40, 80), np.int32)
        for g, (x, y) in zip(got, corners):
            count[y : y + g.shape[0], x : x + g.shape[1]] += g > 0
        assert count.max() == 1


def _two_fisheye(cam=CAM):
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = spec["options"]["height"] = cam
    return rig


@pytest.fixture(scope="module")
def templates():
    """The two-fisheye rig (128^2 cameras -> 256x128) compiled by both
    packages, and two seeded RGB u8 camera images."""
    rig = _two_fisheye()
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (CAM, CAM, 3), dtype=np.uint8)
    imgs = [base, np.roll(base, 7, axis=1) // 2 + 40]
    return compile_rig(rig, 256, 128), jax_compile_rig(rig, 256, 128), imgs


@pytest.mark.parametrize(
    "kind", ["auto", "auto_no_images", "distance", "dp", "dp_grad", "graphcut", "graphcut_grad"]
)
def test_create_masks_every_seam_kind_bit_equal(templates, kind):
    mt, jmt, imgs = templates
    if kind == "auto_no_images":
        kind, imgs = "auto", None
    got = mt.create_masks(imgs, seam=kind)
    want = jmt.create_masks(imgs, seam=kind)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # the masks partition the canvas (tests/test_template.py's bars)
    count = np.zeros((128, 256), np.int32)
    for inp, sm in zip(mt.inputs, got):
        x, y, rw, rh = inp.roi
        count[y : y + rh, x : x + rw] += sm > 128
    assert (count >= 1).mean() > 0.98 and (count > 1).mean() < 0.02


def test_create_masks_raises_as_jax(templates):
    mt, jmt, imgs = templates
    for kind in ("dp", "graphcut_grad"):
        with pytest.raises(ValueError, match="needs input images"):
            mt.create_masks(None, seam=kind)
        with pytest.raises(ValueError, match="needs input images"):
            jmt.create_masks(None, seam=kind)
    with pytest.raises(ValueError, match="unknown seam kind"):
        mt.create_masks(imgs, seam="voronoi")
    with pytest.raises(ValueError, match="unknown seam kind"):
        jmt.create_masks(imgs, seam="voronoi")


def test_morph_control_points_bit_equal(capfd):
    """tests/test_warpers_morph.py's scene: a control point in the
    overlap, camera 1's observation perturbed; the maps and masks after
    the morph, and the seam masks made from them."""
    rig = two_fisheye_rig()
    mt, jmt = compile_rig(rig, 256, 128), jax_compile_rig(rig, 256, 128)
    cam0, cam1 = mt._input_cams
    ll = np.array([[PI / 2 * 0.95, 0.1]])
    p0, p1 = cam0.obj_to_image(ll)[0], cam1.obj_to_image(ll)[0]
    cps = [[0, 1, p0[0], p0[1], p1[0] + 0.004, p1[1]], [0, 1, p0[0], p0[1] + 0.01, p1[0], p1[1] + 0.012]]
    before = [inp.map1.copy() for inp in mt.inputs]
    assert morph_control_points(mt, cps) is mt
    jax_morph(jmt, cps)
    assert "Number of control points: 2" in capfd.readouterr().err
    assert sum((b != inp.map1).sum() for b, inp in zip(before, mt.inputs)) > 0
    for a, b in zip(mt.inputs, jmt.inputs, strict=True):
        assert np.array_equal(a.map1, b.map1) and np.array_equal(a.map2, b.map2)
        assert np.array_equal(a.mask, b.mask) and a.roi == b.roi
    for g, w in zip(mt.create_masks(), jmt.create_masks(), strict=True):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("kind", [Timelapser.AS_IS, Timelapser.CROP])
def test_timelapser_bit_equal(kind):
    rng = np.random.default_rng(kind)
    corners = [(3, 2), (20, 0), (9, 11)]
    sizes = [(16, 12), (14, 18), (20, 9)]  # (w, h)
    tl, jtl = Timelapser(kind), JaxTimelapser(kind)
    tl.initialize(corners, sizes)
    jtl.initialize(corners, sizes)
    assert tl.dst_roi == jtl.dst_roi
    for c, (w, h) in zip(corners, sizes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = rng.integers(0, 2, (h, w)).astype(np.uint8) * 255
        got, want = tl.process(img, mask, c), jtl.process(img, mask, c)
        assert got.dtype == np.uint8 and np.array_equal(got, want) and got is tl.frame


RESIZE_CASES = {
    "u8_rgb_down": ((37, 51, 3), np.uint8, (16, 20)),
    "u8_gray_up": ((9, 14), np.uint8, (31, 23)),
    "f32_rgb_down": ((40, 60, 3), np.float32, (20, 30)),
    "f32_gray_odd": ((33, 47), np.float32, (12, 17)),
    "f32_identity": ((12, 18, 3), np.float32, (12, 18)),
}


def _resize_input(shape, dtype, seed=3):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return (rng.random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
@pytest.mark.parametrize("mode", ["bilinear", "nearest", "area"])
def test_resize_modes_bit_equal(mode, case):
    shape, dtype, (oh, ow) = RESIZE_CASES[case]
    img = _resize_input(shape, dtype)
    got = getattr(resize, f"resize_{mode}")(img, oh, ow)
    want = getattr(jresize, f"resize_{mode}")(img, oh, ow)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_resize_area_integer_factor():
    img = _resize_input((24, 36, 3), np.float32)
    got, want = resize.resize_area(img, 6, 12), jresize.resize_area(img, 6, 12)
    assert got.shape == (6, 12, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 16, 24), (2, 9, 13), (1, 7, 6), (3, 33, 64)])
def test_pyramid_conv_form_matches_jax(shape):
    """pyr_down (ceil(H/2), reflect-101), pyr_up (2h, zero-stuffed,
    padding (2, 3)), gaussian_pyramid and laplacian_merge on odd and even
    sizes, within atol 1e-4 of the JAX package's XLA convolutions."""
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    t, j = torch.from_numpy(x), jnp.asarray(x)
    down, up = pyramid.pyr_down(t), pyramid.pyr_up(t)
    assert down.shape == (shape[0], -(-shape[1] // 2), -(-shape[2] // 2))
    assert up.shape == (shape[0], 2 * shape[1], 2 * shape[2])
    np.testing.assert_allclose(down.numpy(), np.asarray(jpyramid.pyr_down(j)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(up.numpy(), np.asarray(jpyramid.pyr_up(j)), rtol=0, atol=1e-4)
    gp, jgp = pyramid.gaussian_pyramid(t, 2), jpyramid.gaussian_pyramid(j, 2)
    assert len(gp) == len(jgp) == 3
    for a, b in zip(gp, jgp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    # a Laplacian pyramid whose levels the up-steps fit: each level twice
    # the size of the next
    h, w = shape[1] // 4 + 1, shape[2] // 4 + 1
    rng = np.random.default_rng(7)
    lap = [rng.random((shape[0], h * 4 // s, w * 4 // s)).astype(np.float32) for s in (1, 2, 4)]
    got = pyramid.laplacian_merge([torch.from_numpy(a) for a in lap])
    want = jpyramid.laplacian_merge([jnp.asarray(a) for a in lap])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# JAX modules with no counterpart file in the port, each with its reason
NO_COUNTERPART = {
    "ops.pallas_remap": "the TPU remap kernels and their tile plans: replaced by csrc/remap.cu "
    "(ROADMAP, 'Do not port': fan_chunk, choose_patches, pallas_remap_plan, merge_remap_plans)",
    "utils.pytree": "JAX pytree registration, which torch has no use for",
    "registration.bundle_jax": "the JAX LM; the port's is registration/bundle_torch.py, mesh= included",
}
# names of a ported module's __all__ that the port leaves out on purpose
EXEMPT_NAMES = {
    ("ops.remap", "remap_apply"): "the XLA twin on JAX's RemapPlan; the port's is remap_apply_reference "
    "on a RemapGroup",
}


def test_port_exports_every_jax_name():
    """F9's guard: for every module of octvr_tpu with a counterpart in
    octvr_tpu_torch, each name of the JAX module's ``__all__`` is an
    attribute of the port's module (a few named exemptions above)."""
    checked, missing, without = 0, [], []
    for f in sorted((ROOT / "octvr_tpu").rglob("*.py")):
        rel = f.relative_to(ROOT / "octvr_tpu")
        mod = ".".join(rel.with_suffix("").parts).removesuffix("__init__").rstrip(".")
        if not (ROOT / "octvr_tpu_torch" / rel).exists():
            without.append(mod)
            continue
        names = getattr(importlib.import_module(".".join(filter(None, ("octvr_tpu", mod)))), "__all__", ())
        port = importlib.import_module(".".join(filter(None, ("octvr_tpu_torch", mod))))
        for name in names:
            checked += 1
            if not hasattr(port, name) and (mod, name) not in EXEMPT_NAMES:
                missing.append(f"{mod}.{name}")
    assert not missing, missing
    assert sorted(without) == sorted(NO_COUNTERPART)
    assert checked > 150
