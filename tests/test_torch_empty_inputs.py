"""The port on a template with an empty input (a camera that covers no
pixel of the output, ``template.compiler.empty_input``), at a small copy
of OwlLive's ``cylinder_slice_2x25_3dv`` layout over the benchmark's
six-fisheye rig (192^2 cameras; per eye a 512x128 equirect band between
+-45 degrees of latitude and two 64x64 equal-area polar caps on a 576x256
canvas).  The camera facing one pole sees nothing of the other pole's
cap, so each cap has one empty input.

The contract, the plain reference's (``benchmark/reference``): an output
with camera k empty stitches, byte for byte, as the output compiled over
the rig without k from the frames without frame k; its gains are that
output's, with 1.0 put back at k.  Here: the compiler, the template
files, Mapper, FastMapper and ``stitch_batch`` on the caps, the six
regions through an AsyncMultiMapper against the reference, the replay's
spans and copies (a CUDA graph faked on the CPU), and ShardedMapper's
refusal."""

import contextlib
import io
import json
import math
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, frames
from octvr_tpu.template import dump_dat as jax_dump_dat
from octvr_tpu_torch.parallel import ShardedMapper, make_mesh
from octvr_tpu_torch.runtime import AsyncMultiMapper
from octvr_tpu_torch.runtime.timer import RECORDER
from octvr_tpu_torch.stitch import FastMapper, Mapper
from octvr_tpu_torch.stitch.mapper import build_plan
from octvr_tpu_torch.template import compile_rig, dump_dat, load_dat, load_npz, save_npz
from octvr_tpu_torch.template.compiler import MapperTemplate, empty_input, is_empty

ROOT = Path(__file__).resolve().parents[1]
PI = math.pi
CAM = 192
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
FLOAT32_BARS = {"y_mae": 1e-3, "uv_mae": 1e-3, "far_share": 0.0}  # benchmark/tests/test_bench_regions.py's
INPUT_KEYS = ("roi", "map1", "map2", "mask", "vignette")


@pytest.fixture(autouse=True, scope="module")
def _steady_sqrt():
    """The first ``torch.sqrt`` of a CPU process can round apart from
    every later call (torch 2.13 on AVX-512): take it here, so that the
    byte-for-byte comparisons below compare steady calls."""
    torch.sqrt(torch.rand(20000) * 1000)


def _config():
    """The benchmark's mono360_4k configuration with 192^2 cameras."""
    c = json.loads((ROOT / "benchmark" / "configs" / "mono360_4k.json").read_text())
    c["camera_size"] = [CAM, CAM]
    for i in c["rig"]["inputs"]:
        i["options"]["width"] = i["options"]["height"] = CAM
    return c


INPUTS = _config()["rig"]["inputs"]
SIZES = [(CAM, CAM)] * len(INPUTS)
_TEMPLATES = {}


def _compile(region, without=None):
    """The port's template of ``region`` over the rig (less camera
    ``without``), seams included; compiled once per module."""
    key = (region, without)
    if key not in _TEMPLATES:
        inputs = [i for k, i in enumerate(INPUTS) if k != without]
        mt = compile_rig({"output": SPECS[region], "inputs": inputs}, *SIZE[region])
        mt.create_masks()
        _TEMPLATES[key] = mt
    return _TEMPLATES[key]


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return a is not None and b is not None and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _drop(seq, k):
    return [x for j, x in enumerate(seq) if j != k]


def _pool(seed, count=2):
    return frames.make_pool(seed, count, len(INPUTS), (CAM, CAM), "cpu")


@pytest.mark.parametrize("region", sorted(SPECS))
def test_compile_rig_keeps_the_empty_camera(region):
    """Exactly camera 5 is empty in the north cap and camera 4 in the
    south cap (none in the band); every other input, and its seam mask,
    is bit-equal to the one compiled over the rig without that camera;
    a rig of cameras that cover nothing still raises."""
    mt = _compile(region)
    k = EMPTY[region]
    assert [j for j, inp in enumerate(mt.inputs) if is_empty(inp)] == ([] if k is None else [k])
    assert len(mt.seam_masks) == len(mt.inputs) == len(INPUTS)
    if k is None:
        return
    assert mt.inputs[k].roi == (0, 0, 0, 0) and mt.inputs[k].vignette is None
    assert mt.inputs[k].map1.shape == mt.inputs[k].mask.shape == mt.seam_masks[k].shape == (0, 0)
    less = _compile(region, without=k)
    for a, b in zip(_drop(mt.inputs, k), less.inputs):
        for key in INPUT_KEYS:
            assert _same(getattr(a, key), getattr(b, key)), key
    for a, b in zip(_drop(mt.seam_masks, k), less.seam_masks):
        assert _same(a, b)
    with pytest.raises(ValueError, match="no input covers"):
        compile_rig({"output": SPECS[region], "inputs": [INPUTS[k]]}, *SIZE[region])


MAPPER_CASES = {
    "paste": dict(blend=0, enable_gain=False),  # the layout's caps
    "multiband_solved": dict(blend=128, enable_gain=True),
    "multiband_given": dict(blend=128, enable_gain=True),
    "fast": None,  # FastMapper: NV12 framing, feather, no gains, its own pipeline (rgb on the CPU)
}


def _mapper(mt, sizes, case, pipeline):
    if case == "fast":
        return FastMapper(mt, sizes, device="cpu")
    return Mapper(mt, sizes, pipeline=pipeline, device="cpu", **MAPPER_CASES[case])


@pytest.mark.parametrize("case,pipeline", [(c, p) for c in sorted(MAPPER_CASES) for p in ("yuv420", "rgb")
                                           if c != "fast" or p == "rgb"])
@pytest.mark.parametrize("region", ["north", "south"])
def test_mapper_stitches_as_the_rig_without_the_empty_camera(region, case, pipeline):
    """Byte for byte as the Mapper over the rig without camera k fed the
    frames without frame k, gains solved or given, by ``stitch`` and by
    ``stitch_batch``; the empty camera's frame (all 0 or all 255)
    changes no byte; gains have the rig's length with 1.0 at k."""
    k = EMPTY[region]
    m = _mapper(_compile(region), SIZES, case, pipeline)
    less = _mapper(_compile(region, without=k), _drop(SIZES, k), case, pipeline)
    assert m.plan.frame_idx == tuple(_drop(range(len(INPUTS)), k)) and less.plan.frame_idx == ()
    assert m.num_inputs == len(INPUTS) - 1 and m.cameras == len(INPUTS)
    given = torch.linspace(0.9, 1.1, len(INPUTS)) if case == "multiband_given" else None
    pool = _pool(2**31 + 19)
    for fs in pool:
        out, g = m.stitch(fs, gains=given)
        want, want_g = less.stitch(_drop(fs, k), gains=None if given is None else torch.stack(_drop(given, k)))
        assert torch.equal(out, want)
        assert g.shape == (len(INPUTS),) and g[k].item() == 1.0
        assert torch.equal(torch.stack(_drop(g, k)), want_g)
        if case == "multiband_solved":
            assert not torch.allclose(want_g, torch.ones_like(want_g))  # solved, not all 1
        for fill in (0, 255):
            other = fs[:k] + [torch.full_like(fs[k], fill)] + fs[k + 1:]
            o, og = m.stitch(other, gains=given)
            assert torch.equal(o, out) and torch.equal(og, g)
    batch = [torch.stack(per_cam) for per_cam in zip(*pool)]
    bgains = None if given is None else torch.stack([given, given.flip(0)])
    outs, gs = m.stitch_batch(batch, gains=bgains)
    want, want_g = less.stitch_batch(_drop(batch, k), gains=None if bgains is None else bgains[:, _drop(range(len(INPUTS)), k)])
    assert torch.equal(outs, want) and gs.shape == (2, len(INPUTS))
    assert torch.equal(gs[:, k], torch.ones(2)) and torch.equal(gs[:, _drop(range(len(INPUTS)), k)], want_g)


def test_layout_through_async_multimapper_against_reference(tmp_path, monkeypatch):
    """The six regions, each a port Mapper (float32 pyramids), through an
    AsyncMultiMapper with the layout's gain sharing, against the plain
    reference (float32) within the bars of the benchmark's CPU tests."""
    monkeypatch.setattr(check, "CACHE", tmp_path / "ref")
    config = dict(_config(), name="cyl_small")
    config["outputs"] = [{"name": n, "rect": rect, "output": SPECS[r], "blend": b, "gain_mode": g}
                         for n, r, rect, b, g in LAYOUT]
    path = tmp_path / "cyl_small.json"
    path.write_text(json.dumps(config))
    config["path"] = str(path)
    mappers = [Mapper(_compile(r), SIZES, blend=b, enable_gain=g >= 0, pipeline="yuv420",
                      blend_dtype="float32", device="cpu") for _, r, _, b, g in LAYOUT]
    modes = [g for *_, g in LAYOUT]
    pool = _pool(2**31 + 29)
    amm = AsyncMultiMapper(mappers, gain_modes=modes)
    try:
        for fs in pool:
            amm.push([f.numpy() for f in fs])
        got = [amm.pop() for _ in pool]
    finally:
        amm.close()
    reference = check.Reference(config, "cpu")
    kept = {i: (i, outs, None) for i, outs in enumerate(got)}
    assert [tuple(np.asarray(o).shape) for o in got[0]] == [(192, 512), (96, 64), (96, 64)] * 2
    found = check.numbers(reference, pool, kept)
    for name, bar in FLOAT32_BARS.items():
        assert found[name] <= bar, (name, found)


def _read_input_head(buf, offset):
    """The ROI and the four (type, rows, cols) mat headers of an input
    whose mats are all 0x0, from ``offset`` of a ``.dat``."""
    vals = struct.unpack_from("<16q", buf, offset)
    return vals[:4], [vals[4 + 3 * i: 7 + 3 * i] for i in range(4)]


@pytest.mark.parametrize("region", ["north", "south"])
def test_dat_round_trip_of_an_empty_input(region):
    """``.dat``: the empty input is a zero ROI with 0x0 mats (and a 0x0
    seam mask), read back as empty; the template reads back field for
    field and writes the same bytes again."""
    mt = _compile(region)
    k = EMPTY[region]
    f = io.BytesIO()
    dump_dat(mt, f)
    data = f.getvalue()
    back = load_dat(io.BytesIO(data))
    assert is_empty(back.inputs[k]) and back.seam_masks[k].shape == (0, 0)
    for a, b in zip(mt.inputs, back.inputs):
        for key in INPUT_KEYS:
            assert _same(getattr(a, key), getattr(b, key)), key
    assert all(_same(a, b) for a, b in zip(mt.seam_masks, back.seam_masks))
    again = io.BytesIO()
    dump_dat(back, again)
    assert again.getvalue() == data
    # the bytes of the empty input: walk past the covering inputs before it
    offset = 5 + 3 * 8
    for inp in mt.inputs[:k]:
        offset += 4 * 8
        for m in (inp.map1, inp.map2, inp.mask, inp.vignette):
            offset += 3 * 8 + (0 if m is None else m.nbytes)
    roi, heads = _read_input_head(data, offset)
    assert roi == (0, 0, 0, 0) and [h[1:] for h in heads] == [(0, 0)] * 4


def test_npz_round_trip_of_an_empty_input(tmp_path):
    """``.npz``: the template reads back field for field, and a Mapper
    over it stitches the same bytes."""
    mt = _compile("north")
    save_npz(mt, tmp_path / "north.npz")
    back = load_npz(tmp_path / "north.npz")
    for a, b in zip(mt.inputs, back.inputs):
        for key in INPUT_KEYS:
            assert _same(getattr(a, key), getattr(b, key)), key
    assert all(_same(a, b) for a, b in zip(mt.seam_masks, back.seam_masks))
    fs = _pool(2**31 + 31, 1)[0]
    kw = dict(blend=0, enable_gain=False, pipeline="yuv420", device="cpu")
    assert torch.equal(Mapper(mt, SIZES, **kw).stitch(fs)[0], Mapper(back, SIZES, **kw).stitch(fs)[0])


def test_template_without_an_empty_input_is_unchanged():
    """A template with no empty input (the mono360 output of the small
    rig) writes the JAX package's ``.dat`` bytes, and its plan has no
    frame map: the Mapper's path is the one it always took."""
    mt = compile_rig({"output": {"type": "equirectangular", "options": {}}, "inputs": INPUTS}, 384, 192)
    mt.create_masks()
    assert not any(is_empty(inp) for inp in mt.inputs)
    ours, theirs = io.BytesIO(), io.BytesIO()
    dump_dat(mt, ours)
    jax_dump_dat(mt, theirs)
    assert ours.getvalue() == theirs.getvalue()
    plan = build_plan(mt, SIZES, 128, True, "float32")
    assert plan.frame_idx == () and plan.frame_sizes == ()
    m = Mapper(mt, SIZES, blend=128, device="cpu")
    assert m._live is None and m.cameras == m.num_inputs == len(INPUTS)
    g = torch.rand(len(INPUTS))
    assert m._plan_gains(g) is g and m._rig_gains(g) is g  # no selection, no expansion


# --------------------------------------------- a CUDA graph faked on the CPU


class _FakeStream:
    def wait_stream(self, other):
        pass

    def wait_event(self, event):
        pass


class _FakeEvent:
    def record(self, stream=None):
        pass


class _FakeGraph:
    """Replays the captured ``Mapper._stitch_planned`` call over the
    graph's static inputs into its static outputs, as the card does."""

    capturing = None

    def replay(self):
        for dst, src in zip(self.out, self.fn()):
            dst.copy_(src)


@pytest.fixture
def fake_graph(monkeypatch):
    stream = _FakeStream()

    @contextlib.contextmanager
    def graph(g, stream=None, capture_error_mode=None):
        _FakeGraph.capturing = g
        try:
            yield
        finally:
            _FakeGraph.capturing = None

    planned = Mapper._stitch_planned

    def stitch_planned(self, bufs, gains):
        out = planned(self, bufs, gains)
        g = _FakeGraph.capturing
        if g is not None:
            g.fn = lambda: planned(self, bufs, gains)
            g.out = out
            g.bufs = bufs
        return out

    monkeypatch.setattr(Mapper, "_stitch_planned", stitch_planned)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)


@pytest.mark.parametrize("region", ["north", "band"])
def test_replay_spans_and_copies(fake_graph, region):
    """``Mapper.stitch`` along its graph path (the graph faked on the
    CPU): the first call captures, every later one replays with the three
    children ``mapper.copy_in``, ``mapper.launch`` and
    ``mapper.copy_out``; the graph holds static inputs for the covering
    frames alone, and a replay gives the eager stitch's bytes whatever
    the empty camera's frame holds."""
    m = Mapper(_compile(region), SIZES, blend=0, enable_gain=False, pipeline="yuv420", device="cpu")
    m._graphed = True
    pool = _pool(2**31 + 37, 3)
    mark = RECORDER.new_id()
    got = [m.stitch(fs) for fs in pool]
    k = EMPTY[region]
    if k is not None:
        got.append(m.stitch(pool[0][:k] + [torch.zeros_like(pool[0][k])] + pool[0][k + 1:]))
    spans = RECORDER.spans(mark)
    roots = [s for s in spans if s.name == "mapper.stitch"]
    kids = {r.id: [s for s in spans if s.parent == r.id] for r in roots}
    assert [[s.name for s in kids[r.id]] for r in roots] == [["mapper.capture"]] + [["mapper.replay"]] * (len(got) - 1)
    for r in roots[1:]:
        (replay,) = kids[r.id]
        names = [s.name for s in sorted((s for s in spans if s.parent == replay.id), key=lambda s: s.start_ns)]
        assert names == ["mapper.copy_in", "mapper.launch", "mapper.copy_out"]
    graph = m._graphs[False]
    assert len(graph.inputs) == len(INPUTS) - (k is not None)
    for (o, g), fs in zip(got, pool + pool[:1]):
        eo, eg = m._stitch_eager(fs)
        assert torch.equal(o, eo) and torch.equal(g, eg)


def test_sharded_mapper_refuses_an_empty_input():
    """ShardedMapper refuses a template with an empty input at
    construction, naming the camera; over the rig without it, it
    builds."""
    with pytest.raises(ValueError, match="camera 5 covers no pixel"):
        ShardedMapper(_compile("north"), SIZES, make_mesh(1, 2, device="cpu"), blend=0, enable_gain=False)
    ShardedMapper(_compile("north", without=5), SIZES[:5], make_mesh(1, 2, device="cpu"), blend=0, enable_gain=False)


def test_mapper_over_no_covering_input_raises():
    """A plan needs a covering input: a template whose inputs are all
    empty is refused by the Mapper."""
    mt = MapperTemplate(out_size=(64, 64), inputs=[empty_input()], seam_masks=[np.zeros((0, 0), np.uint8)])
    with pytest.raises(ValueError, match="no input covers"):
        Mapper(mt, SIZES[:1], device="cpu")
