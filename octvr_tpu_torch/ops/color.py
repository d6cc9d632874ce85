"""Packed YUV420P split and merge (octvr_tpu/ops/color.py).

Frame layout (mapper.hpp:75-83 of the reference): one [H*3/2, W] uint8
buffer; Y is the top HxW, U is rows [H, H*3/2) cols [0, W/2), V is rows
[H, H*3/2) cols [W/2, W).
"""

import torch

__all__ = ["merge_yuv420p", "split_yuv420p"]


def split_yuv420p(buf):
    """[H*3/2, W] packed -> (Y [H,W], U [H/2,W/2], V [H/2,W/2]) views."""
    h = buf.shape[0] * 2 // 3
    w = buf.shape[1]
    return buf[:h], buf[h:, : w // 2], buf[h:, w // 2 :]


def merge_yuv420p(y, u, v):
    return torch.cat([y, torch.cat([u, v], dim=1)], dim=0)
