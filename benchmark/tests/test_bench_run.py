"""The whole run of a cell on the CPU at a small size, with the chip's
look skipped: a cell, configuration, traffic mix and metric added as
files and entries alone are picked up by name; and with the timed path
broken underneath, ``correct`` comes out false for each fault a cell of
this system can have."""

import json

import pytest
import torch

from benchmark import run

SECONDS = 1.0


def _run(spec, monkeypatch=None):
    result, compared = run.run_cell(spec, "t", 2**31 + 4242, SECONDS, 0, "cpu")
    return result, dict((n, v) for n, v, _ in compared)


def test_new_pieces_are_found_by_name(small, bench_dir, cell_spec):
    (bench_dir / "traffic" / "resident_two.json").write_text(json.dumps({"kind": "resident", "pool": 2, "warmup": 1}))
    (bench_dir / "metrics" / "sets_seen.t.py").write_text(
        '"""Frame sets of the window."""\n\n\ndef read(rec):\n    return float(rec["frames"])\n'
    )
    metric = {"name": "sets_seen.t", "unit": "sets", "better": "higher", "source": "host_clock",
              "layer": "stitch (host dispatch)", "moves": "fps"}
    spec = cell_spec(small, "resident_two", [metric])
    result, _ = run.run_cell(spec, "t", 2**31 + 11, SECONDS, 0, "cpu")
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "fps"}
    traced, _ = run.run_cell(spec, "t", 2**31 + 12, SECONDS, 1, "cpu")
    assert traced["metrics"]["sets_seen.t"]["value"] == traced["attempted"] > 0
    assert "plan_build_s" in traced["metrics"] and "breakdown" in traced
    assert list(traced)[-1] == "checked"


@pytest.mark.parametrize("traffic", ["resident", "live_16fps"])
def test_sound_run_is_correct(small, bench_dir, cell_spec, traffic):
    result, numbers = _run(cell_spec(small, traffic))
    assert result["correct"], numbers
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"


def _patch_stitch(monkeypatch, wrap):
    from octvr_tpu_torch.stitch import Mapper

    orig = Mapper.stitch
    state = {"calls": 0}

    def stitch(self, frames, gains=None):
        state["calls"] += 1
        return wrap(self, orig(self, frames, gains=gains), state)

    monkeypatch.setattr(Mapper, "stitch", stitch)


def _stale(self, res, state):
    """A step that returns its state unchanged: every set gets the
    outputs of the call before it (the window's first, the warm-up's
    last), so that one set in the window is enough to show it."""
    before = state.get("before", res)
    state["before"] = res
    return before


def _altered(self, res, state):
    """An answer altered where it is produced: one 16x16 block of Y."""
    out, gains = res
    out = out.clone()
    out[40:56, 100:116] ^= 0x55
    return out, gains


def _control(self, res, state):
    """The reference in float8 in the program's place."""
    return state["control"](res)


@pytest.mark.parametrize("traffic", ["resident", "live_16fps"])
@pytest.mark.parametrize("fault", [_stale, _altered])
def test_faults_make_the_run_incorrect(small, bench_dir, cell_spec, monkeypatch, traffic, fault):
    _patch_stitch(monkeypatch, fault)
    result, numbers = _run(cell_spec(small, traffic))
    assert not result["correct"], numbers


def test_lost_sets_make_the_run_incorrect(small, bench_dir, cell_spec, monkeypatch):
    """Sets that never come back: the stitch stage fails mid-window."""

    def lose(self, res, state):
        if state["calls"] > 12:
            raise RuntimeError("lost")
        return res

    _patch_stitch(monkeypatch, lose)
    result, numbers = _run(cell_spec(small, "live_16fps"))
    assert not result["correct"] and result["failed"] > 0


def test_control_is_incorrect(small, bench_dir, cell_spec, monkeypatch):
    """The control at a test's size: the reference computed in float8,
    the precision below the configuration's bfloat16, put in the
    program's place (frames back from the reference's output)."""
    from benchmark import check

    ref = check.Reference(small, "cpu")

    def control(self, frames, gains=None):
        outs, g = ref.outputs[0].stitch(list(frames), gains=None if gains is None else gains.numpy(), quantize="float8_e4m3fn")
        return outs, torch.as_tensor(g, dtype=torch.float32)

    from octvr_tpu_torch.stitch import Mapper

    monkeypatch.setattr(Mapper, "stitch", control)
    result, numbers = _run(cell_spec(small, "resident"))
    assert not result["correct"], numbers
    assert numbers["y_mae"] > 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mono360_4k-resident", "mono360_4k-live"])
def test_cell_on_card(cell):
    """Each cell of BENCHMARK.json at its own size on the card, a short
    window, traced: correct, and every per-layer metric read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from benchmark import spec as specs

    spec = specs.load()
    result, numbers = run.run_cell(spec, cell, 2**31 + 77, 3.0, 1, "cuda")
    assert result["correct"], numbers
    assert set(result["metrics"]) == {m["name"] for m in specs.metrics_for(spec, cell, "per_layer")}
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def test_live_trace_names_its_gaps_by_its_schedule(small, bench_dir, cell_spec):
    """A traced live run: the idle gaps are named by the segment's own
    schedule: a set in flight, or none between arrivals."""
    from benchmark import drive

    spec = cell_spec(small, "live_16fps")
    result, _ = run.run_cell(spec, "t", 2**31 + 13, SECONDS, 1, "cpu")
    names = {name for name, _ in result["breakdown"]["idle_gaps"]}
    assert names and names <= {drive.IN_FLIGHT, drive.BETWEEN}
