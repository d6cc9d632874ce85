"""Kernel 8, the MXU-taps probe (tools/mxu_taps_probe.py), against the
port (octvr_tpu_torch/ops/mxu_taps.py, tools/mxu_taps_probe.py).

The JAX probe's bodies are closures inside its ``main()``, so it is run
as a script in interpret mode with ``pallas_call`` wrapped to record the
inputs and outputs of each launch (``jax.jit`` made the identity so the
recorder sees arrays, ``jax.config.update`` a no-op so the probe sets no
compilation cache), at three settings: the defaults at 2 steps x G=2,
3 steps x G=1 with taps in rows [0, 32) of 32 (chunk 0, a different
KB), and 2 steps x G=1 with taps in rows [8, 128) of 144 (128 visited
rows, wider than A's kernel stages in shared memory).  The port's workload is bit-equal to the probe's, and its plain
versions of the three bodies match the captured outputs to max abs
< 1e-3 (the probe's B2 bar).  B's Hopper kernel takes its f32 product as
three bf16 products (the weights split into hi + mid + lo terms on the
tensor cores); ``_folded_three_terms`` emulates that arithmetic on the
CPU and is held to B's plain version and to the JAX body."""

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
    # 128 visited rows, one chunk past what A's kernel stages in shared
    # memory (MAX_STAGED): the width its global-memory instance gathers
    "wide": dict(steps=2, g=1, kh=144, lo=8, hi=128),
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


def test_wide_setting_is_past_the_fans_staging_limit():
    klo, khi = mxu_taps.visited_rows(SETTINGS["wide"]["lo"], SETTINGS["wide"]["hi"])
    assert khi - klo == mxu_taps.MAX_STAGED + mxu_taps.CHUNK


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


ULPS4 = 2.0 ** -14  # four f32 ulps of a value in [128, 256)


def _split3(w):
    """f32 weights -> three bf16 terms (as f32): each the round-to-nearest
    bf16 of what the terms before it left, as the folded kernel splits W
    in registers (``split3`` in csrc/mxu_taps.cu)."""
    hi = w.to(torch.bfloat16).float()
    rest = w - hi
    mid = rest.to(torch.bfloat16).float()
    return hi, mid, (rest - mid).to(torch.bfloat16).float()


def _folded_three_terms(oyl, fxy, win, lo, hi):
    """B as the wgmma kernel computes it: the one-hot f32 weights W of
    the plain version split into three bf16 terms, three f32 products of
    the terms with the bf16 window (each product exact: 8-bit times 8-bit
    significands), summed in f32, then the two horizontal taps."""
    klo, khi = mxu_taps.visited_rows(lo, hi)
    oy0, oy1, l0, l1, fx, fy = mxu_taps._unpack(oyl, fxy)
    n = oy0.shape[0]
    k = torch.arange(klo, khi)
    w_t = (torch.where(mxu_taps._onehot_t(oy0, k), (1.0 - fy).reshape(n, -1, 1), 0.0)
           + torch.where(mxu_taps._onehot_t(oy1, k), fy.reshape(n, -1, 1), 0.0))
    rows = win[:, 0, klo:khi].to(torch.bfloat16).float()
    hi_t, mid_t, lo_t = (torch.bmm(t, rows) for t in _split3(w_t))
    v = ((hi_t + mid_t) + lo_t).reshape(*oy0.shape, mxu_taps.TW)
    return mxu_taps._tiles(mxu_taps._lane(v, l0) * (1.0 - fx) + mxu_taps._lane(v, l1) * fx)


def test_three_term_split_is_exact_on_probe_weights():
    """hi + mid + lo gives back every f32 weight the probe makes (1 - fy,
    fy and their sum) exactly; two terms alone leave up to ~4e-6, ~1e-3
    of a gray level of 255 per tap."""
    _, fxy, _ = mxu_taps_probe.make_probe_inputs(16, 8, 80, 16, 64)
    fy = torch.from_numpy(fxy[:, :, 8:]).reshape(-1)
    w = torch.cat([1.0 - fy, fy, (1.0 - fy) + fy])
    hi, mid, lo = _split3(w)
    assert torch.equal(hi.double() + mid.double() + lo.double(), w.double())
    assert (hi.double() + mid.double() - w.double()).abs().max().item() > 1e-7


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_folded_three_terms_match_plain_and_jax(jax_runs, setting):
    """The three-term emulation within 2^-14 of B's plain version (four
    f32 ulps of a value under 256: the two differ only in the order of
    their f32 additions) and 1e-3 of the JAX probe's ``kern_mxu``
    (Precision.HIGHEST)."""
    s = SETTINGS[setting]
    args, outs = jax_runs[setting][0]["kern_mxu"]
    t = [torch.from_numpy(np.array(a)) for a in args]
    got = _folded_three_terms(*t, s["lo"], s["hi"])
    plain = mxu_taps.mxu_folded_reference(*t, s["lo"], s["hi"])
    assert len(got) == len(outs) == s["g"]
    for a, b, o in zip(got, plain, outs):
        assert (a - b).abs().max().item() < ULPS4
        assert np.abs(a.numpy() - o).max() < 1e-3


def test_folded_three_terms_on_edge_taps():
    """On the edge taps (rows at both ends of the visited range, a tap
    row past it, lane 128) the emulation stays within 2^-14 of B's plain
    version and 1e-3 of the f64 direct sample."""
    lo, hi = 16, 64
    arrays = edge_probe_inputs(lo, hi)
    t = [torch.from_numpy(a) for a in arrays]
    got = _folded_three_terms(*t, lo, hi)
    for a, b in zip(got, mxu_taps.mxu_folded_reference(*t, lo, hi)):
        assert (a - b).abs().max().item() < ULPS4
    assert np.abs(np.stack([a.numpy() for a in got]) - _direct(*arrays, lo, hi)).max() < 1e-3


def test_chip_smoke_taps_floors_at_probe_defaults():
    """chip_smoke.py's kernel 8 bound at the probe's defaults (1,917 steps
    x G=8, rows [16, 64), kb 48): the function's byte bound 0.1078 ms for
    every body; the formulation floors 6 px kb 128 / 989e12 = 0.5853 ms
    for B (three bf16 products), 0.3902 ms for B2 (two), and A's f32 FMAs
    on the CUDA cores."""
    spec = importlib.util.spec_from_file_location("chip_smoke", PROBE.parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    px = 1917 * 8 * 8 * 128
    got = {b: smoke._taps_bound(b, 1917, 8, 16, 64) for b in ("fan", "mxu_folded", "mxu_exact2")}
    for body, (nbytes, flops, bound, by, floor) in got.items():
        assert nbytes == 20 * px + 1917 * 48 * 128 * 4
        assert by == "bytes" and round(bound, 4) == 0.1078, body
    assert got["mxu_folded"][1] == 6 * px * 48 * 128 and abs(got["mxu_folded"][4] - 0.5853) < 1e-4
    assert got["mxu_exact2"][1] == 4 * px * 48 * 128 and abs(got["mxu_exact2"][4] - 0.3902) < 1e-4
    assert got["fan"][1] == 12 * px and got["fan"][4] == pytest.approx(12 * px / 67e12 * 1e3)
