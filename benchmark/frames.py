"""Camera frame sets made from the seed.

Each set holds one packed YUV420P uint8 [H*3/2, W] frame per camera.
The content has a scene's spatial structure rather than white noise:
smooth large-scale shading, mid-scale texture, hard-edged blocks and a
little grain, with chroma that drifts slowly, and each camera's
exposure set apart from the others by up to +-20%, so that the gains
and the seams have real work.  Only the content depends on the seed:
every seed gives the same sizes.  Everything is made on the device in a
few large calls from one ``torch.Generator``.
"""

import torch
import torch.nn.functional as F


def _field(gen, n, h, w, cells, lo, hi, device, mode="bilinear"):
    """[n, h, w] f32: a random grid of ``cells`` x ``cells`` values in
    [lo, hi) enlarged to h x w."""
    g = torch.rand((n, 1, cells, cells), generator=gen, device=device) * (hi - lo) + lo
    kw = {} if mode == "nearest" else {"align_corners": False}
    return F.interpolate(g, size=(h, w), mode=mode, **kw)[:, 0]


def make_pool(seed, count, cameras, size, device):
    """``count`` distinct frame sets of ``cameras`` frames of ``size``
    (H, W), on ``device``, from ``seed``."""
    h, w = size
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n = count * cameras
    exposure = torch.rand((1, cameras, 1, 1), generator=gen, device=device) * 0.4 + 0.8
    y = (
        _field(gen, n, h, w, 6, 50.0, 200.0, device)
        + _field(gen, n, h, w, 48, -25.0, 25.0, device)
        + torch.where(_field(gen, n, h, w, 24, 0.0, 1.0, device, "nearest") > 0.8, 35.0, 0.0)
        + torch.randn((n, h, w), generator=gen, device=device) * 3.0
    )
    y = (y.view(count, cameras, h, w) * exposure).clamp(0, 255).round().to(torch.uint8)
    uv = (
        _field(gen, 2 * n, h // 2, w // 2, 8, 98.0, 158.0, device)
        + torch.randn((2 * n, h // 2, w // 2), generator=gen, device=device) * 2.0
    ).clamp(0, 255).round().to(torch.uint8).view(count, cameras, 2, h // 2, w // 2)
    frames = torch.empty((count, cameras, h * 3 // 2, w), dtype=torch.uint8, device=device)
    frames[:, :, :h] = y
    frames[:, :, h:, : w // 2] = uv[:, :, 0]
    frames[:, :, h:, w // 2 :] = uv[:, :, 1]
    return [list(frames[k].unbind(0)) for k in range(count)]
