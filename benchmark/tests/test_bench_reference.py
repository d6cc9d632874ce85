"""The plain reference against the port on the CPU at a small size: its
own offline stage gives the port's template, and the port in float32
gives the reference's frames to a few pixels; the port's bfloat16 path
and the float8 control read apart."""

import numpy as np
import pytest

from benchmark import check, frames
from benchmark.deploy import System
from benchmark.reference.offline import compile_template


def test_reference_template_equals_the_port(small):
    from octvr_tpu_torch.template import compile_rig

    o = small["outputs"][0]
    mt = compile_rig({"output": o["output"], "inputs": small["rig"]["inputs"]}, *o["rect"][2:])
    mt.create_masks()
    ref = compile_template(o["output"], small["rig"]["inputs"], *o["rect"][2:])
    assert ref["size"] == mt.out_size
    for r, p, seam in zip(ref["inputs"], mt.inputs, mt.seam_masks):
        assert r["roi"] == p.roi
        np.testing.assert_allclose(r["map1"], p.map1, atol=1e-6)
        np.testing.assert_allclose(r["map2"], p.map2, atol=1e-6)
        assert np.array_equal(r["mask"], p.mask)
        assert np.array_equal(r["vignette"], p.vignette)
        assert np.mean(r["seam"] != seam) < 1e-3


@pytest.mark.parametrize("dtype,bars", [
    ("float32", {"y_mae": 1e-3, "uv_mae": 1e-3, "far_share": 0.0, "gain_rel": 1e-5}),
    ("bfloat16", {"y_mae": 1.0, "uv_mae": 0.5, "far_share": 0.0, "gain_rel": 1e-3}),
])
def test_port_against_reference(small, tmp_path, monkeypatch, dtype, bars):
    monkeypatch.setattr(check, "CACHE", tmp_path / "ref")
    small["mapper"]["blend_dtype"] = dtype
    system = System(small, "cpu")
    reference = check.Reference(small, "cpu")
    pool = frames.make_pool(2**31 + 7, 2, system.n_cams, system.cam_size, "cpu")
    kept = {k: (k, *system.stitch(pool[k])) for k in range(2)}
    found = check.numbers(reference, pool, kept)
    for k, bar in bars.items():
        assert found[k] <= bar, (k, found)
    control = check.numbers(reference, pool, kept, outputs_of=lambda k: reference.stitch(pool[k], quantize="float8_e4m3fn"))
    assert control["y_mae"] > 3 * max(found["y_mae"], 0.3)
    assert control["far_share"] > 0.05
