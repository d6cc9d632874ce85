"""The frozen copy of the remap's byte bound equals chip_smoke.py's
``_bound`` on a small plan on the CPU."""

import importlib.util

import numpy as np
import torch

from benchmark import roofline

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    s = importlib.util.spec_from_file_location("chip_smoke_for_bound", ROOT / "chip_smoke.py")
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def test_remap_bound_equals_the_smoke():
    from octvr_tpu_torch.ops.remap import remap_group, remap_plan

    rng = np.random.default_rng(3)
    plans = []
    for _ in range(3):
        m1 = rng.uniform(0, 1, (24, 40)).astype(np.float32)
        m2 = rng.uniform(0, 1, (24, 40)).astype(np.float32)
        m1[rng.uniform(size=m1.shape) < 0.3] = -1
        plans.append(remap_plan(m1, m2, 32, 48))
    g = remap_group(plans, "cpu")
    smoke = _chip_smoke()
    assert roofline.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert roofline.F32_FLOP_PER_S == smoke.F32_FLOP_PER_S
    for dtype, store in ((torch.bfloat16, 2), (torch.float32, 4)):
        for frames in (1, 4):
            ours = roofline.remap_bound([(g, 1), (g, 2)], store, frames)
            theirs = smoke._bound([(g, 1), (g, 2)], dtype, frames)
            assert ours[0] == theirs[0] and ours[2] == theirs[2]
            assert abs(ours[1] * 1e3 - theirs[1]) < 1e-12
