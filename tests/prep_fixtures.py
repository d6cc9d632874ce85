"""Inputs and yardsticks of the yuv420 prep's tests, on the CPU
(tests/test_torch_frames.py) and on the card (tests/test_torch_on_card.py):

- ``prep_numpy``: the prep's arithmetic in numpy float32, each op
  rounded once, as the eager torch ops have it; with ``fused`` the
  chroma expression as one fused multiply-add would give it (emulated
  in float64, exact for these operands, then rounded once to float32),
  which is what a kernel whose compiler contracted it would store;
- ``rounding_edges``: a frame and vignettes whose products land on x.5,
  just beside it and on the clamp edges, so that a kernel that rounds
  once where the ops round twice, rounds half away from zero or clamps
  in another order stores another byte;
- ``bench_vignettes``: the benchmark rig's vignette maps at a frame size.
"""

import json
from pathlib import Path

import numpy as np
import torch

from octvr_tpu_torch.ops import color
from octvr_tpu_torch.stitch.frames import vignette_maps
from octvr_tpu_torch.vignette import vignette_map

ROOT = Path(__file__).resolve().parents[1]
EDGE_H, EDGE_W = 32, 64  # rounding_edges' frame: 2,048 luma values, 512 chroma sites a plane


def _q(x):
    return np.clip(np.rint(np.clip(x, 0.0, 255.0)), 0, 255).astype(np.uint8)


def prep_numpy(buf, fmt, vig, vig_half, fused=False):
    """(Y [..., H, W], U|V [..., 2, H/2, W/2]) uint8 of packed frames
    ``buf`` (numpy or CPU tensor) with the vignettes, in numpy f32."""
    y, u, v = (np.asarray(p) for p in color.split_frame(torch.as_tensor(np.asarray(buf)), fmt))
    vig, vig_half = np.asarray(vig, np.float32), np.asarray(vig_half, np.float32)[..., None, :, :]
    c = np.stack([u, v], axis=-3).astype(np.float32) - np.float32(128.0)
    if fused:
        uv = (c.astype(np.float64) * vig_half.astype(np.float64) + 128.0).astype(np.float32)
    else:
        uv = c * vig_half + np.float32(128.0)
    return _q(y.astype(np.float32) * vig), _q(uv)


def _fused_apart():
    """(c, vh) pairs, one per c where any exists, on which the fused
    chroma expression stores another byte than the two roundings."""
    pairs = []
    for c in range(256):
        d = np.float32(c - 128)
        if not d:
            continue
        # vignettes near those that put the exact sum on m + 0.5, +- 8 ulps
        vh0 = ((np.arange(256) + 0.5 - 128.0) / float(d)).astype(np.float32)
        vh0 = vh0[(vh0 >= 0.3) & (vh0 <= 3.0)]
        vhs = (vh0.view(np.int32)[:, None] + np.arange(-8, 9, dtype=np.int32)).view(np.float32).ravel()
        two = _q(d * vhs + np.float32(128.0))
        one = _q((np.float64(d) * vhs.astype(np.float64) + 128.0).astype(np.float32))
        hit = np.nonzero(two != one)[0]
        if hit.size:
            pairs.append((c, vhs[hit[0]]))
    return pairs


def rounding_edges(fmt):
    """(buf [H*3/2, W] uint8, vig [H, W], vig_half [H/2, W/2] f32), CPU
    tensors, ``fmt`` "yuv420p" or "nv12": luma products on x.5 (odd
    values times 0.5 and 1.5), one f32 ulp beside it, and on the clamp
    edges (255.5, 256.5, below 0); chroma values on which the fused
    expression rounds apart (``_fused_apart``), on ties (128 +- x.5) and
    past both clamp edges.  The rest is random bytes and vignettes in
    [0.4, 1.6]."""
    rng = np.random.default_rng(23)
    h, w = EDGE_H, EDGE_W
    y = rng.integers(0, 256, h * w).astype(np.uint8)
    vig = rng.uniform(0.4, 1.6, h * w).astype(np.float32)
    odd = np.arange(1, 256, 2)
    below = np.nextafter(np.float32(0.5), np.float32(0.0))
    above = np.nextafter(np.float32(0.5), np.float32(1.0))
    luma = [(y_, np.float32(s)) for s in (0.5, 1.5) for y_ in odd]
    luma += [(y_, s) for s in (below, above) for y_ in odd[::8]]
    luma += [(255, np.float32(s)) for s in (1.0, 1.001953125, 1.5, 255.0 / 255.5)]
    luma += [(1, np.float32(s)) for s in (254.5, 255.5, 256.5, -0.5, 0.5, -3.0)]
    for k, (y_, s) in enumerate(luma):
        y[k], vig[k] = y_, s
    hc, wc = h // 2, w // 2
    u = rng.integers(0, 256, hc * wc).astype(np.uint8)
    v = rng.integers(0, 256, hc * wc).astype(np.uint8)
    vh = rng.uniform(0.4, 1.6, hc * wc).astype(np.float32)
    chroma = _fused_apart()
    chroma += [(128 + d, np.float32(0.5)) for d in (-3, -1, 1, 3, 5)]  # ties 126.5 ... 130.5
    chroma += [(255, np.float32(1.0 + 0.5 / 127)), (255, np.float32(1.5)), (0, np.float32(1.5)),
               (0, np.float32(1.0 + 0.5 / 128)), (1, np.float32(1.0 + 0.5 / 127))]
    if len(chroma) > hc * wc or len(luma) > h * w:
        raise AssertionError("rounding_edges' frame is too small for its cases")
    for k, (c, s) in enumerate(chroma):
        u[k], v[k], vh[k] = c, c, s
    planes = [torch.from_numpy(a) for a in (y.reshape(h, w), u.reshape(hc, wc), v.reshape(hc, wc))]
    buf = color.merge_frame(*planes, fmt)
    return buf, torch.from_numpy(vig.reshape(h, w)), torch.from_numpy(vh.reshape(hc, wc))


def bench_vignettes(h, w, config="mono360_4k"):
    """Per camera of a benchmark configuration's rig (the bench rig of
    benchmark/configs/mono360_4k.json by default), its vignette maps at
    frame size (h, w) as the Mapper's plan holds them: ``vignette_maps``
    of the camera's 512^2 map, f32 numpy pairs."""
    config = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    return [vignette_maps(vignette_map(inp["options"]), h, w, True) for inp in config["rig"]["inputs"]]
