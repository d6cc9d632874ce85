"""The input stage of both stitchers (stitch.mapper.Mapper and
parallel.sharded.ShardedMapper): what a call's camera frames must be,
the vignette maps of the plan, and the prep that turns a packed frame
into the uint8 planes the remap reads.

A frame is one packed YUV420P or NV12 uint8 buffer [H*3/2, W]
(ops.color).  The prep takes any leading dims, [..., H*3/2, W]: the
Mapper preps one frame per input, the ShardedMapper the B x k source
blocks of an input (k per-band row slices, ``_slice_src``), each block
with its own slice of the vignette.  The vignettes broadcast from the
right over the planes: [H, W] for every block, or [k, H, W] per block.
The yuv420 prep with a vignette is one kernel launch on the card
(ops.cuda_prep).
"""

import numpy as np
import torch

from ..ops import cuda_prep
from ..ops.color import _quantize, planes_to_rgb_planar, split_frame
from ..ops.resize import resize_bilinear_host

__all__ = ["check_frames", "prep_rgb", "prep_yuv", "rgb_prep", "vignette_maps"]


def check_frames(frames, sizes, batched):
    """One call's frames as uint8 tensors, where they lie (host or
    device): per input (then per overlay input) a packed [H*3/2, W]
    buffer, or with ``batched`` a [B, H*3/2, W] stack with the same B for
    every input, (H, W) from ``sizes``.  A numpy array is copied into a
    tensor.  Anything else raises ValueError."""
    if len(frames) != len(sizes):
        raise ValueError(f"{len(frames)} frames for {len(sizes)} inputs and overlay inputs")
    bufs = []
    for f, (h, w) in zip(frames, sizes):
        if not isinstance(f, torch.Tensor):
            f = torch.from_numpy(np.array(f))  # a writable copy
        want = (h * 3 // 2, w)
        if f.dtype != torch.uint8 or f.dim() != 2 + batched or tuple(f.shape[-2:]) != want:
            lead = "B, " if batched else ""
            raise ValueError(f"want uint8 [{lead}{want[0]}, {want[1]}], got {f.dtype} {tuple(f.shape)}")
        bufs.append(f)
    if batched and len({f.shape[0] for f in bufs}) != 1:
        raise ValueError("every input needs the same number of frames")
    return bufs


def vignette_maps(vignette, in_h, in_w, yuv):
    """A template input's vignette on the host: resized (bilinear) to
    the frame, f32 [in_h, in_w], and for the yuv420 pipeline its 2x2
    mean on the chroma grid, f32 [in_h/2, in_w/2] (else None); (None,
    None) without a vignette."""
    if vignette is None:
        return None, None
    vig = np.asarray(resize_bilinear_host(vignette, in_h, in_w)).astype(np.float32)
    if not yuv:
        return vig, None
    return vig, vig.reshape(in_h // 2, 2, in_w // 2, 2).mean(axis=(1, 3)).astype(np.float32)


def prep_yuv(buf, frame_format, vig, vig_half):
    """The yuv420 prep of packed frames [..., H*3/2, W]: split, vignette
    multiply (chroma about 128), clip, round and clip to uint8.  Returns
    Y [..., 1, H, W] and U|V [..., 2, H/2, W/2]; without a vignette
    (``vig`` None) Y is a view of ``buf``.  With one it is
    ``cuda_prep.prep_yuv``: a kernel launch on the card, the eager ops
    on the CPU."""
    if vig is None:
        return cuda_prep.prep_yuv_reference(buf, frame_format, None, None)
    return cuda_prep.prep_yuv(buf, frame_format, vig, vig_half)


def rgb_prep(y, u, v, vignette):
    """The rgb prep of planes Y [..., H, W], U, V [..., H/2, W/2]: planar
    RGB f32 -> vignette multiply and clip -> round and clip to uint8
    [..., 3, H, W] (the JAX pack_rgb quantization without its int32
    packing)."""
    rgb = planes_to_rgb_planar(y, u, v)
    if vignette is not None:
        rgb = torch.clamp(rgb * vignette.unsqueeze(-3), 0.0, 255.0)
    return _quantize(rgb)


def prep_rgb(buf, frame_format, vig):
    """The rgb prep of packed frames [..., H*3/2, W]: uint8 RGB
    [..., 3, H, W] (:func:`rgb_prep`)."""
    return rgb_prep(*split_frame(buf, frame_format), vig)
