"""Packed YUV420P / NV12 split and merge, and the planar RGB conversions
of the rgb pipeline (octvr_tpu/ops/color.py).

Frame layout (mapper.hpp:75-83 of the reference): one [H*3/2, W] uint8
buffer; Y is the top HxW, U is rows [H, H*3/2) cols [0, W/2), V is rows
[H, H*3/2) cols [W/2, W).  NV12 keeps Y on top and interleaves U and V
below it (UVUV rows, mapper_fast.cpp:153-176).  The split and merge
take any leading dims, [..., H*3/2, W] <-> [..., H, W] planes.

YUV matrices: full-range BT.601 (JPEG), the JAX package's f32
expressions term for term, so values that round at .5 fall the same
way.  The chroma up- and down-sampling is ``repeat_interleave`` and
strided adds where the JAX package uses its up_cols/down_cols matmuls:
both are exact in f32 (one non-zero term, or two halves, per output).

The interleaved conversions of the CLIs ([H, W, 3] RGB, packed UYVY
4:2:2, NV12) are thin wrappers over the planar ones
(octvr_tpu/ops/color.py:79-203).
"""

import torch

__all__ = [
    "merge_frame",
    "merge_nv12",
    "merge_uyvy",
    "merge_yuv420p",
    "nv12_to_rgb",
    "planes_to_rgb_planar",
    "rgb_planar_to_planes",
    "rgb_planar_to_yuv420p",
    "rgb_to_nv12",
    "rgb_to_yuv420p",
    "split_frame",
    "split_nv12",
    "split_uyvy",
    "split_yuv420p",
    "uyvy_to_yuv420p",
    "yuv420p_to_rgb",
    "yuv420p_to_rgb_planar",
]


def split_yuv420p(buf):
    """[..., H*3/2, W] packed -> (Y [..., H, W], U, V [..., H/2, W/2])
    views."""
    h = buf.shape[-2] * 2 // 3
    w = buf.shape[-1]
    return buf[..., :h, :], buf[..., h:, : w // 2], buf[..., h:, w // 2 :]


def merge_yuv420p(y, u, v):
    """Y [..., H, W], U, V [..., H/2, W/2] -> packed [..., H*3/2, W]."""
    return torch.cat([y, torch.cat([u, v], dim=-1)], dim=-2)


def split_nv12(buf):
    """NV12 [..., H*3/2, W] -> (Y [..., H, W], U, V [..., H/2, W/2])
    views."""
    h = buf.shape[-2] * 2 // 3
    uv = buf[..., h:, :].unflatten(-1, (-1, 2))
    return buf[..., :h, :], uv[..., 0], uv[..., 1]


def merge_nv12(y, u, v):
    """Y [..., H, W], U, V [..., H/2, W/2] -> NV12 [..., H*3/2, W]."""
    return torch.cat([y, torch.stack([u, v], dim=-1).flatten(-2)], dim=-2)


def split_frame(buf, frame_format):
    """A packed ``frame_format`` ("yuv420p" or "nv12") buffer
    [..., H*3/2, W] -> its planes (Y [..., H, W], U, V [..., H/2, W/2])."""
    return (split_nv12 if frame_format == "nv12" else split_yuv420p)(buf)


def merge_frame(y, u, v, frame_format):
    """Planes Y [..., H, W], U, V [..., H/2, W/2] -> the packed
    ``frame_format`` buffer [..., H*3/2, W]."""
    return (merge_nv12 if frame_format == "nv12" else merge_yuv420p)(y, u, v)


def _up2(c):
    """Nearest 2x chroma upsample [..., h, w] -> [..., 2h, 2w]."""
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def planes_to_rgb_planar(y, u, v, dtype=torch.float32):
    """uint8 planes Y [..., H, W], U and V [..., H/2, W/2] -> planar RGB
    [..., 3, H, W] in [0, 255], computed in ``dtype``."""
    yf = y.to(dtype)
    uf = _up2(u.to(dtype) - 128.0)
    vf = _up2(v.to(dtype) - 128.0)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return torch.clamp(torch.stack([r, g, b], dim=-3), 0.0, 255.0)


def yuv420p_to_rgb_planar(buf, dtype=torch.float32):
    """Packed YUV420P uint8 [H*3/2, W] -> planar RGB [3, H, W]."""
    return planes_to_rgb_planar(*split_yuv420p(buf), dtype=dtype)


def yuv420p_to_rgb(buf, dtype=torch.float32):
    """Packed YUV420P uint8 [H*3/2, W] -> RGB [H, W, 3] in [0, 255]."""
    return yuv420p_to_rgb_planar(buf, dtype).movedim(0, -1)


def _box2(c):
    """2x2 box mean of [..., h, w] by strided adds (rows, then columns)."""
    cr = (c[..., 0::2, :] + c[..., 1::2, :]) * 0.5
    return (cr[..., 0::2] + cr[..., 1::2]) * 0.5


def _quantize(x):
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def rgb_planar_to_planes(rgb):
    """Planar RGB f32 [..., 3, H, W] in [0, 255] -> uint8 (Y [..., H, W],
    U, V [..., H/2, W/2]); chroma is box-averaged 2x2 before
    subsampling."""
    r, g, b = rgb.unbind(-3)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return _quantize(y), _quantize(_box2(u)), _quantize(_box2(v))


def rgb_planar_to_yuv420p(rgb):
    """Planar RGB f32 [3, H, W] in [0, 255] -> packed YUV420P uint8
    [H*3/2, W]."""
    return merge_yuv420p(*rgb_planar_to_planes(rgb))


def rgb_to_yuv420p(rgb):
    """RGB float [H, W, 3] in [0, 255] -> packed YUV420P uint8
    [H*3/2, W]; chroma box-averaged 2x2 before subsampling."""
    return rgb_planar_to_yuv420p(rgb.movedim(-1, 0))


def split_uyvy(buf):
    """Packed UYVY 4:2:2 [H, W*2] or [H, W, 2] uint8 -> (Y [H, W],
    U [H, W/2], V [H, W/2]); bytes per two pixels are U0 Y0 V0 Y1 (the
    DeckLink SDI capture layout, uyvy.cu:17-30)."""
    quads = buf.reshape(buf.shape[0], -1, 4)
    y = quads[..., 1::2].reshape(buf.shape[0], -1)
    return y, quads[..., 0], quads[..., 2]


def merge_uyvy(y, u, v):
    h, w = y.shape
    y2 = y.reshape(h, w // 2, 2)
    return torch.stack([u, y2[..., 0], v, y2[..., 1]], dim=-1).reshape(h, w * 2)


def uyvy_to_yuv420p(buf):
    """Packed UYVY 4:2:2 -> packed YUV420P [H*3/2, W]: split, then each
    chroma row pair averaged (rounding up at .5) down to 4:2:0."""
    y, u, v = split_uyvy(buf)

    def rows2(c):
        ci = c.to(torch.int32)
        return ((ci[0::2] + ci[1::2] + 1) >> 1).to(torch.uint8)

    return merge_yuv420p(y, rows2(u), rows2(v))


def nv12_to_rgb(buf, dtype=torch.float32):
    """NV12 uint8 [H*3/2, W] -> RGB [H, W, 3] in [0, 255]."""
    return planes_to_rgb_planar(*split_nv12(buf), dtype=dtype).movedim(0, -1)


def rgb_to_nv12(rgb):
    """RGB float [H, W, 3] in [0, 255] -> NV12 uint8 [H*3/2, W]."""
    return merge_nv12(*rgb_planar_to_planes(rgb.movedim(-1, 0)))
