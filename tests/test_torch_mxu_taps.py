"""Kernel 8, the MXU-taps probe (tools/mxu_taps_probe.py), against the
port (octvr_tpu_torch/ops/mxu_taps.py, tools/mxu_taps_probe.py).

The JAX probe's bodies are closures inside its ``main()``, so it is run
as a script in interpret mode with ``pallas_call`` wrapped to record the
inputs and outputs of each launch (``jax.jit`` made the identity so the
recorder sees arrays, ``jax.config.update`` a no-op so the probe sets no
compilation cache), at two settings: the defaults at 2 steps x G=2, and
3 steps x G=1 with taps in rows [0, 32) of 32 (chunk 0, a different
KB).  The port's workload is bit-equal to the probe's, and its plain
versions of the three bodies match the captured outputs to max abs
< 1e-3 (the probe's B2 bar)."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch

from octvr_tpu_torch.ops import mxu_taps
from octvr_tpu_torch.tools import mxu_taps_probe
from taps_fixtures import edge_probe_inputs

torch.set_num_threads(2)

PROBE = Path(__file__).resolve().parents[1] / "tools" / "mxu_taps_probe.py"
SETTINGS = {
    "defaults": dict(steps=2, g=2, kh=80, lo=16, hi=64),
    "chunk0": dict(steps=3, g=1, kh=32, lo=0, hi=32),
}
BODIES = {
    "kern_fan": mxu_taps.fan_reference,
    "kern_mxu": mxu_taps.mxu_folded_reference,
    "kern_mxu2": mxu_taps.mxu_exact2_reference,
}


def _run_jax_probe(mp, steps, g, kh, lo, hi):
    """{body name: (inputs, outputs)} of each body's first launch, and
    the probe's JSON line."""
    real = pl.pallas_call
    calls = {}

    def recording(kern, **kw):
        f = real(kern, **kw)

        def call(*args):
            outs = f(*args)
            calls.setdefault(
                kern.__name__, ([np.asarray(a) for a in args], [np.asarray(o) for o in outs])
            )
            return outs

        return call

    mp.setattr(pl, "pallas_call", recording)
    mp.setattr(jax, "jit", lambda f, *a, **k: f)
    mp.setattr(jax.config, "update", lambda *a, **k: None)
    argv = ["mxu_taps_probe.py", "--interpret", "--iters", "1"]
    for key, v in dict(steps=steps, g=g, kh=kh, lo=lo, hi=hi).items():
        argv += [f"--{key}", str(v)]
    mp.setattr(sys, "argv", argv)
    spec = importlib.util.spec_from_file_location("jax_mxu_taps_probe", PROBE)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        probe.main()
    return calls, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}
    for name, setting in SETTINGS.items():
        with pytest.MonkeyPatch.context() as mp:
            runs[name] = _run_jax_probe(mp, **setting)
    return runs


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_probe_inputs_bit_equal(jax_runs, setting):
    calls, _ = jax_runs[setting]
    assert sorted(calls) == sorted(BODIES)
    mine = mxu_taps_probe.make_probe_inputs(**SETTINGS[setting])
    for body, (args, _) in calls.items():
        for a, b in zip(args, mine):
            assert a.dtype == b.dtype and np.array_equal(a, b), body


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_plain_versions_match_jax_probe(jax_runs, setting, body):
    s = SETTINGS[setting]
    args, outs = jax_runs[setting][0][body]
    got = BODIES[body](*(torch.from_numpy(np.array(a)) for a in args), s["lo"], s["hi"])
    assert len(got) == len(outs) == s["g"]
    for o, t in zip(outs, got):
        assert tuple(t.shape) == o.shape == (s["steps"], 8, 128) and t.dtype == torch.float32
        err = np.abs(o - t.numpy()).max()
        assert err < 1e-3, err


def _direct(oyl, fxy, win, lo, hi):
    """f64 numpy bilinear sample, taps outside the visited rows or the
    128 lanes adding 0."""
    klo, khi = mxu_taps.visited_rows(lo, hi)
    u = oyl.astype(np.int64) & 0xFFFFFFFF
    oy0, oy1, l0, l1 = u[:, :, :8] & 0xFFFF, u[:, :, :8] >> 16, u[:, :, 8:] & 0xFFFF, u[:, :, 8:] >> 16
    fx, fy = fxy[:, :, :8].astype(np.float64), fxy[:, :, 8:].astype(np.float64)
    n = np.arange(oyl.shape[0])[:, None, None, None]

    def tap(oy, lane):
        ok = (oy >= klo) & (oy < khi) & (lane < 128)
        return np.where(ok, win[n, 0, np.minimum(oy, win.shape[2] - 1), np.minimum(lane, 127)], 0.0)

    mix0 = tap(oy0, l0) * (1 - fx) + tap(oy0, l1) * fx
    mix1 = tap(oy1, l0) * (1 - fx) + tap(oy1, l1) * fx
    return ((1 - fy) * mix0 + fy * mix1).transpose(1, 0, 2, 3)


def test_edge_taps_agree_across_plain_versions():
    lo, hi = 16, 64
    arrays = edge_probe_inputs(lo, hi)
    want = _direct(*arrays, lo, hi)
    t = [torch.from_numpy(a) for a in arrays]
    outs = {name: np.stack([o.numpy() for o in fn(*t, lo, hi)]) for name, fn in BODIES.items()}
    for name, got in outs.items():
        err = np.abs(got - want).max()
        assert err < 1e-3, (name, err)


def test_wrappers_take_plain_versions_on_cpu_and_check_arguments():
    """On CPU tensors a wrapper returns its plain version's output and
    launches nothing; it raises on an input its kernel does not take."""
    lo, hi = 16, 64
    t = [torch.from_numpy(a) for a in mxu_taps_probe.make_probe_inputs(2, 2, 80, lo, hi)]
    mxu_taps.reset_counts()
    for fn, ref in ((mxu_taps.fan, mxu_taps.fan_reference),
                    (mxu_taps.mxu_folded, mxu_taps.mxu_folded_reference),
                    (mxu_taps.mxu_exact2, mxu_taps.mxu_exact2_reference)):
        for a, b in zip(fn(*t, lo, hi), ref(*t, lo, hi)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="int32"):
            fn(t[0].to(torch.int64), t[1], t[2], lo, hi)
        with pytest.raises(ValueError, match="visited rows"):
            fn(t[0], t[1], t[2][:, :, :56], lo, 50)
        with pytest.raises(ValueError, match="lo < hi"):
            fn(*t, 40, 40)
        with pytest.raises(ValueError, match="win"):
            fn(t[0], t[1], t[2][:1], lo, hi)
    assert mxu_taps.LAUNCHES == 0 and mxu_taps.COUNTS == {}


def test_entry_point_needs_a_card_and_prints_probe_keys(jax_runs, capsys):
    """Without a card the default device raises (no fallback to the
    CPU); with --device cpu it prints the JAX probe's JSON keys."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        mxu_taps_probe.main(["--steps", "2", "--g", "2", "--iters", "1"])
    got = mxu_taps_probe.main(["--device", "cpu", "--steps", "2", "--g", "2", "--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_runs["defaults"][1]
    assert list(line) == list(want) and line == got
    assert {k: line[k] for k in ("metric", "steps", "g", "kh", "visited_rows")} == {
        k: want[k] for k in ("metric", "steps", "g", "kh", "visited_rows")
    }
