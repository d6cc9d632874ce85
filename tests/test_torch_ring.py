"""The port on a small copy of the benchmark's ``odyssey16_4k`` ring (a
GoPro Odyssey: 16 portrait 4:3 fisheyes 22.5 degrees apart, each rolled
by 90 degrees) stitched to a mono360 canvas: 208x156 frames, the
published 2704x2028 over 13, on a 384x192 canvas.  Seven cameras see
across +-180 degrees, so their ROIs span the canvas's width; each
covered direction lies in about 4.5 cameras; the rows beyond about +-61
degrees of latitude lie in none.

Held to the plain reference (``benchmark/reference``): the template,
input by input; the stitch in float32 and bfloat16 under the bars of
``benchmark/tests/test_bench_reference.py``, with the reference's
float8 control failing them; the rows that no camera sees.  And the
plan counter (``stitch.mapper.PLANS``) with the benchmark's readers of
it, ``roi_sweep`` and ``roi_fill_pct``."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, deploy, frames, spec
from benchmark.reference.offline import compile_template
from octvr_tpu_torch.stitch import mapper as port_mapper
from octvr_tpu_torch.stitch.mapper import PLANS, build_plan
from octvr_tpu_torch.template import compile_rig

ROOT = Path(__file__).resolve().parents[1]
CAM = (156, 208)  # (H, W): the published 2028x2704 over 13
CANVAS = (384, 192)
WIDE = (768, 384)  # the canvas at which the reference's template wraps seven ROIs
# the cameras whose ROI spans the canvas: those with |yaw| >= 112.5
# degrees, but at 384 wide camera 11 (-112.5) stops short of +180
FULL_WIDTH = {CANVAS: range(5, 11), WIDE: range(5, 12)}
BARS = {  # benchmark/tests/test_bench_reference.py's
    "float32": {"y_mae": 1e-3, "uv_mae": 1e-3, "far_share": 0.0, "gain_rel": 1e-5},
    "bfloat16": {"y_mae": 1.0, "uv_mae": 0.5, "far_share": 0.0, "gain_rel": 1e-3},
}
SEED = 2**31 + 97  # past 32 signed bits, as the benchmark's seeds may be


@pytest.fixture(autouse=True, scope="module")
def _steady_sqrt():
    """The first ``torch.sqrt`` of a CPU process can round apart from
    every later call (torch 2.13 on AVX-512): take it here, so that the
    byte-for-byte comparisons below compare steady calls."""
    torch.sqrt(torch.rand(20000) * 1000)


def ring_config(canvas=CANVAS):
    """The benchmark's odyssey16_4k configuration at CAM and ``canvas``."""
    c = json.loads((ROOT / "benchmark" / "configs" / "odyssey16_4k.json").read_text())
    c["camera_size"] = list(CAM)
    for i in c["rig"]["inputs"]:
        i["options"]["height"], i["options"]["width"] = CAM
    c["outputs"][0]["rect"] = [0, 0, *canvas]
    return c


_TEMPLATES = {}


def _templates(canvas):
    """(the reference's template, the port's) of the ring at ``canvas``,
    compiled once per module."""
    if canvas not in _TEMPLATES:
        c = ring_config(canvas)
        out, inputs = c["outputs"][0]["output"], c["rig"]["inputs"]
        mt = compile_rig({"output": out, "inputs": inputs}, *canvas)
        mt.create_masks()
        _TEMPLATES[canvas] = compile_template(out, inputs, *canvas), mt
    return _TEMPLATES[canvas]


def _reference_shape(ref):
    """``plan_shape``'s numbers worked out from the reference's template."""
    W, H = ref["size"]
    ins = ref["inputs"]
    return {
        "plans": 1,
        "inputs": len(ins),
        "empty_inputs": 0,
        "canvas_px": W * H,
        "roi_px": sum(i["roi"][2] * i["roi"][3] for i in ins),
        "valid_px": sum(int(np.count_nonzero(i["mask"])) for i in ins),
        "wrapped": sum(i["roi"][2] == W and i["mask"][:, 0].any() and i["mask"][:, -1].any() for i in ins),
    }


def _uncovered_rows(ref):
    """The canvas rows in which no camera of the reference's template
    has a valid pixel."""
    W, H = ref["size"]
    seen = np.zeros(H, dtype=bool)
    for i in ref["inputs"]:
        x, y, w, h = i["roi"]
        seen[y : y + h] |= i["mask"].any(axis=1)
    return np.flatnonzero(~seen)


@pytest.mark.parametrize("canvas", [CANVAS, WIDE], ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("k", range(16))
def test_ring_template_equals_the_reference(k, canvas):
    """Camera k's ROI, maps, mask and vignette as the reference's, its
    distance seam within 1e-3; the cameras that see across +-180
    degrees, and only they, span the canvas's width."""
    ref, mt = _templates(canvas)
    r, p = ref["inputs"][k], mt.inputs[k]
    assert r["roi"] == p.roi
    np.testing.assert_allclose(r["map1"], p.map1, atol=1e-6)
    np.testing.assert_allclose(r["map2"], p.map2, atol=1e-6)
    assert np.array_equal(r["mask"], p.mask)
    assert np.array_equal(r["vignette"], p.vignette)
    assert np.mean(r["seam"] != mt.seam_masks[k]) < 1e-3
    assert (p.roi[2] == canvas[0]) == (k in FULL_WIDTH[canvas])


@pytest.mark.parametrize("canvas", [CANVAS, WIDE], ids=lambda c: f"{c[0]}x{c[1]}")
def test_plan_counter_sums_the_template(canvas):
    """One ``build_plan`` adds to ``PLANS`` the sums over the port's
    template, equal to those over the reference's, its ``wrapped`` the
    reference's own count (seven at 768x384)."""
    ref, mt = _templates(canvas)
    PLANS.reset()
    build_plan(mt, [CAM] * 16, 128, True, "float32", "yuv420")
    want = _reference_shape(ref)
    assert PLANS.counts == want
    assert want["inputs"] == 16 and want["wrapped"] >= 6
    if canvas == WIDE:
        assert want["wrapped"] == 7
    # what the full-size ring sweeps: about 7.7 canvases, 40% of it valid
    assert 7.0 < want["roi_px"] / want["canvas_px"] < 8.5
    assert 0.35 < want["valid_px"] / want["roi_px"] < 0.45


def test_plan_counter_counts_a_plan_with_an_empty_input_once():
    """A template with an empty input (the bench rig under a north cap,
    which the south camera does not see) is one plan of six inputs, one
    of them empty, summed over the five that cover."""
    rig = json.loads((ROOT / "benchmark" / "configs" / "mono360_4k.json").read_text())["rig"]
    for s in rig["inputs"]:
        s["options"]["width"] = s["options"]["height"] = 96
    cap = {"type": "eqareanorthpole", "options": {"arctic_circle": math.pi / 4}}
    mt = compile_rig({"output": cap, "inputs": rig["inputs"]}, 64, 64)
    mt.create_masks()
    PLANS.reset()
    build_plan(mt, [(96, 96)] * 6, 0, False, "float32", "yuv420")
    live = [i for i in mt.inputs if i.roi[2]]
    assert PLANS.counts == {
        "plans": 1, "inputs": 6, "empty_inputs": 1, "canvas_px": 64 * 64,
        "roi_px": sum(i.roi[2] * i.roi[3] for i in live),
        "valid_px": sum(int(np.count_nonzero(i.mask)) for i in live),
        "wrapped": sum(i.roi[2] == 64 and i.mask[:, 0].any() and i.mask[:, -1].any() for i in live),
    }


def _system(tmp_path, monkeypatch, dtype):
    """The small ring as the benchmark deploys it, on the CPU, with the
    reference beside it (both caches in ``tmp_path``)."""
    monkeypatch.setattr(deploy, "CACHE", tmp_path / "cache")
    monkeypatch.setattr(check, "CACHE", tmp_path / "ref")
    c = ring_config()
    c["mapper"]["blend_dtype"] = dtype
    path = tmp_path / "ring.json"
    path.write_text(json.dumps(c))
    c["path"] = str(path)
    return deploy.System(c, "cpu"), check.Reference(c, "cpu")


@pytest.mark.parametrize("dtype", sorted(BARS))
def test_ring_port_against_reference(tmp_path, monkeypatch, dtype):
    """The port's stitch of two sets within the reference's bars, and the
    reference computed in float8 (the control) outside them; the rows
    that no camera sees as the reference's."""
    system, reference = _system(tmp_path, monkeypatch, dtype)
    assert system.n_cams == 16 and system.cam_size == CAM
    pool = frames.make_pool(SEED, 2, system.n_cams, system.cam_size, "cpu")
    kept = {k: (k, *system.stitch(pool[k])) for k in range(2)}
    found = check.numbers(reference, pool, kept)
    for name, bar in BARS[dtype].items():
        assert found[name] <= bar, (name, found)
    control = check.numbers(reference, pool, kept, outputs_of=lambda k: reference.stitch(pool[k], quantize="float8_e4m3fn"))
    assert control["y_mae"] > 3 * max(found["y_mae"], 0.3)
    assert control["far_share"] > 0.05
    assert not check.verdict(control, spec.limits("odyssey16_4k"))[0]
    # the rows no camera sees: the blend's coarse levels carry the content
    # next to them into them (the weight totals are WEIGHT_EPS only at
    # full resolution), on both sides alike: byte for byte in float32
    rows = _uncovered_rows(_templates(CANVAS)[0])
    H = CANVAS[1]
    assert 55 <= len(rows) <= 65  # about 31% of the canvas
    unseen = set(rows.tolist())
    uv_rows = [H + r for r in range(H // 2) if {2 * r, 2 * r + 1} <= unseen]
    for k in range(2):
        out, want = kept[k][1][0], reference.stitch(pool[k])[0][0]
        d = (out.to(torch.int16) - want.to(torch.int16)).abs()
        for picked in (rows, uv_rows):
            assert want[picked].float().sub(128.0 if picked is uv_rows else 0.0).abs().max() > 8
            if dtype == "float32":
                assert d[picked].max() == 0
            else:
                assert d[picked].float().mean() <= BARS[dtype]["y_mae"] and d[picked].max() <= check.FAR


@pytest.mark.parametrize("name", ["roi_sweep", "roi_fill_pct"])
def test_roi_readers_read_the_plan_counter(tmp_path, monkeypatch, name):
    """The benchmark's readers over the counter a System's plans leave:
    the ROI box pixels over the canvas pixels, and the valid pixels over
    the ROI box pixels in %; nothing where the counter holds another
    number of plans than the run's outputs, or where the port has none."""
    ref, _ = _templates(CANVAS)
    PLANS.reset()
    _system(tmp_path, monkeypatch, "float32")
    want = _reference_shape(ref)
    read = spec.reader(name)
    value = want["roi_px"] / want["canvas_px"] if name == "roi_sweep" else 100.0 * want["valid_px"] / want["roi_px"]
    assert read({"outputs": 1}) == pytest.approx(value, rel=1e-12)
    assert read({"outputs": 2}) is None
    monkeypatch.delattr(port_mapper, "PLANS")
    assert read({"outputs": 1}) is None
