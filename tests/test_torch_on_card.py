"""Port tests that need an NVIDIA card: the CUDA remap kernel against its
plain torch version, and the port's Mapper on the card against the port
on the CPU.  They carry the ``cuda`` marker and skip without a card.
This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_on_card.py -q
"""

import numpy as np
import pytest
import torch

from octvr_tpu.template import compile_rig
from octvr_tpu_torch.ops import cuda_remap
from octvr_tpu_torch.ops.remap import remap_apply_reference, remap_group, remap_plan
from octvr_tpu_torch.stitch import Mapper
from remap_fixtures import IN_H, IN_W, arc_maps, edge_maps
from rigs import two_fisheye_rig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("maps", ["arc", "edge"])
@pytest.mark.parametrize("nc", [1, 2])
def test_remap_kernel_matches_plain_on_card(cuda_device, maps, nc):
    """f32 within 1e-3 of the plain version; bf16 within 1.0 of the
    kernel's f32; one launch counted per call."""
    ma = arc_maps(64, 256) if maps == "arc" else edge_maps()
    plans = [remap_plan(*ma, IN_H, IN_W), remap_plan(*arc_maps(64, 256)[::-1], IN_H, IN_W)]
    group = remap_group(plans, cuda_device)
    rng = np.random.default_rng(30 + nc)
    planes = torch.from_numpy(
        rng.integers(0, 256, (2, nc, IN_H, IN_W), dtype=np.uint8)
    ).to(cuda_device)
    before = cuda_remap.LAUNCHES
    got = cuda_remap.remap_apply(planes, group, torch.float32)
    got16 = cuda_remap.remap_apply(planes, group, torch.bfloat16)
    torch.cuda.synchronize()
    assert cuda_remap.LAUNCHES == before + 2
    ref = remap_apply_reference(planes, group, torch.float32)
    for g, g16, r in zip(got, got16, ref):
        assert (g - r).abs().max().item() < 1e-3
        assert (g16.float() - g).abs().max().item() <= 1.0


def test_mapper_on_card_matches_cpu(cuda_device):
    """Port on the card (kernel) vs port on the CPU (plain version), both
    f32, on a 256x128 two-fisheye rig: Y/UV mean < 0.2, gains 1e-3."""
    rig = two_fisheye_rig()
    for s in rig["inputs"]:
        s["options"]["width"] = s["options"]["height"] = 256
    mt = compile_rig(rig, 256, 128)
    mt.create_masks()
    sizes = [(256, 256)] * 2
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (384, 256), dtype=np.uint8) for _ in sizes]
    kw = dict(blend=16, enable_gain=True, pipeline="yuv420", blend_dtype="float32")
    out_cpu, g_cpu = Mapper(mt, sizes, device="cpu", **kw).stitch(frames)
    out, g = Mapper(mt, sizes, device=cuda_device, **kw).stitch(frames)
    d = (out.cpu().float() - out_cpu.float()).abs()
    assert d[:128].mean() < 0.2 and d[128:].mean() < 0.2
    assert (g.cpu() - g_cpu).abs().max().item() < 1e-3
