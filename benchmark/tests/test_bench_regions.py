"""The plain reference on a region that a camera does not see, at a small
copy of OwlLive's ``cylinder_slice_2x25_3dv`` layout over the bench rig
(192^2 cameras): per eye a 512x128 equirect band between +-45 degrees of
latitude and two 64x64 equal-area polar caps on a 576x256 canvas.  The
camera facing one pole sees nothing of the other pole's cap, so each cap
has one empty input.  The reference's definition of an empty input, and
the port against the reference on what the layout needs and the port
already runs (the band over all six cameras, a cap over the rig without
its empty camera)."""

import json
import math

import numpy as np
import pytest
import torch

from benchmark import check, deploy, frames
from benchmark.reference.offline import compile_template
from benchmark.reference.stitch import ReferenceOutput

PI = math.pi
SPECS = {
    "band": {"type": "equirectangular", "options": {"max_lat": PI / 4, "min_lat": -PI / 4}},
    "north": {"type": "eqareanorthpole", "options": {"arctic_circle": PI / 4}},
    "south": {"type": "eqareasouthpole", "options": {"antarctic_circle": -PI / 4}},
}
SIZE = {"band": (512, 128), "north": (64, 64), "south": (64, 64)}
EMPTY = {"band": None, "north": 5, "south": 4}  # the camera facing the other pole
# (name, region, rect, blend, gain mode): projection_modes.cpp's six regions
LAYOUT = [
    ("band0", "band", [0, 0, 512, 128], 128, 0),
    ("north0", "north", [512, 0, 64, 64], 0, -1),
    ("south0", "south", [512, 64, 64, 64], 0, -1),
    ("band1", "band", [0, 128, 512, 128], 128, 3),
    ("north1", "north", [512, 128, 64, 64], 0, -1),
    ("south1", "south", [512, 192, 64, 64], 0, -1),
]
FLOAT32_BARS = {"y_mae": 1e-3, "uv_mae": 1e-3, "far_share": 0.0, "gain_rel": 1e-5}
INPUT_KEYS = ("roi", "map1", "map2", "mask", "seam", "vignette")


@pytest.fixture(autouse=True, scope="module")
def _steady_sqrt():
    """The first ``torch.sqrt`` of a CPU process can round apart from
    every later call (torch 2.13 on AVX-512, in about a third of the
    processes): take it here, so that the byte-for-byte comparisons
    below compare steady calls."""
    torch.sqrt(torch.rand(20000) * 1000)


def _config(small, path, outputs, without=None):
    """``small`` with ``outputs`` ((name, region, rect, blend, gain mode)
    tuples), over the rig less camera ``without``, written to ``path``."""
    c = dict(small)
    c["outputs"] = [{"name": n, "rect": rect, "output": SPECS[r], "blend": b, "gain_mode": g}
                    for n, r, rect, b, g in outputs]
    if without is not None:
        c["rig"] = dict(c["rig"], inputs=[i for k, i in enumerate(c["rig"]["inputs"]) if k != without])
    c.pop("path")
    path.write_text(json.dumps(c))
    return dict(c, path=str(path))


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("region", sorted(SPECS))
def test_every_region_compiles_with_its_empty_input(small, region):
    inputs = small["rig"]["inputs"]
    t = compile_template(SPECS[region], inputs, *SIZE[region])
    empty = [k for k, i in enumerate(t["inputs"]) if i.get("empty")]
    assert empty == ([] if EMPTY[region] is None else [EMPTY[region]])
    assert all(i == {"empty": True, "roi": None} for i in t["inputs"] if i.get("empty"))
    k = EMPTY[region]
    if k is None:
        return
    without = compile_template(SPECS[region], inputs[:k] + inputs[k + 1:], *SIZE[region])
    assert without["size"] == t["size"]
    for a, b in zip([i for i in t["inputs"] if not i.get("empty")], without["inputs"]):
        for key in INPUT_KEYS:
            assert _same(a[key], b[key]), key
    with pytest.raises(ValueError, match="no input covers"):
        compile_template(SPECS[region], [inputs[k]], *SIZE[region])


@pytest.mark.parametrize("region,blend,gain", [
    ("north", 0, False), ("south", 0, False),  # the layout's paste
    ("north", 128, True), ("south", 128, True),  # the multiband and gain branches
])
def test_empty_input_stitches_as_the_rig_without_it(small, region, blend, gain):
    inputs = small["rig"]["inputs"]
    k = EMPTY[region]
    cam = tuple(small["camera_size"])
    full = ReferenceOutput(compile_template(SPECS[region], inputs, *SIZE[region]), cam, blend, gain, "cpu")
    less = ReferenceOutput(compile_template(SPECS[region], inputs[:k] + inputs[k + 1:], *SIZE[region]),
                           cam, blend, gain, "cpu")
    pool = frames.make_pool(2**31 + 19, 2, len(inputs), cam, "cpu")
    given = np.linspace(0.9, 1.1, len(inputs))  # a copier's gains, one per camera of the rig
    for fs in pool:
        out, g = full.stitch(fs)
        want, want_g = less.stitch(fs[:k] + fs[k + 1:])
        assert torch.equal(out, want)
        assert g.shape == (len(inputs),) and g[k] == 1.0
        assert np.array_equal(np.delete(g, k), want_g)
        assert gain != np.allclose(want_g, 1.0)  # gains solved, not all 1
        out, _ = full.stitch(fs, gains=given)
        want, _ = less.stitch(fs[:k] + fs[k + 1:], gains=np.delete(given, k))
        assert torch.equal(out, want)


def test_six_region_layout_checks_against_itself(small, tmp_path, monkeypatch):
    """The whole layout through ``check.Reference`` and ``check.numbers``:
    the reference against itself reads 0, and ``gain_rel`` is taken over
    the two bands that solve their gains (outputs 0 and 3)."""
    monkeypatch.setattr(check, "CACHE", tmp_path / "ref")
    config = _config(small, tmp_path / "cyl.json", LAYOUT)
    reference = check.Reference(config, "cpu")
    assert reference.gain_modes == [0, -1, -1, 3, -1, -1]
    pool = frames.make_pool(2**31 + 23, 1, 6, tuple(small["camera_size"]), "cpu")
    outs, gains = reference.stitch(pool[0])
    assert [tuple(o.shape) for o in outs] == [(192, 512), (96, 64), (96, 64)] * 2
    assert all(np.array_equal(g, np.ones(6)) for g in gains[1:3] + gains[4:])
    kept = {0: (0, outs, gains)}
    assert check.numbers(reference, pool, kept) == dict.fromkeys(check.NUMBERS + check.INFO, 0.0)
    for k, moved in ((0, True), (3, True), (1, False)):
        bent = [g * (1.01 if j == k else 1.0) for j, g in enumerate(gains)]
        found = check.numbers(reference, pool, {0: (0, outs, bent)})
        assert (found["gain_rel"] == pytest.approx(0.01)) if moved else found["gain_rel"] == 0.0


@pytest.mark.parametrize("region,blend,gain_mode", [
    ("band", 128, 0), ("band", 0, -1),  # over all six cameras
    ("north", 0, -1), ("south", 0, -1),  # over the rig without the empty camera
])
def test_port_against_reference_on_the_layout(small, tmp_path, monkeypatch, region, blend, gain_mode):
    monkeypatch.setattr(check, "CACHE", tmp_path / "ref")
    monkeypatch.setattr(deploy, "CACHE", tmp_path / "cache")
    small["mapper"]["blend_dtype"] = "float32"
    outputs = [(region, region, [0, 0, *SIZE[region]], blend, gain_mode)]
    config = _config(small, tmp_path / f"{region}.json", outputs, without=EMPTY[region])
    system = deploy.System(config, "cpu")
    reference = check.Reference(config, "cpu")
    pool = frames.make_pool(2**31 + 29, 2, system.n_cams, system.cam_size, "cpu")
    kept = {k: (k, *system.stitch(pool[k])) for k in range(2)}
    found = check.numbers(reference, pool, kept)
    for k, bar in FLOAT32_BARS.items():
        assert found[k] <= bar, (k, found)
