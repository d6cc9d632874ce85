"""Wrapper of the Hopper prep kernel (csrc/prep.cu): the yuv420 input
stage of a stack of packed frames with a vignette.

``prep_yuv(buf, frame_format, vig, vig_half)`` takes packed YUV420P or
NV12 frames [..., H*3/2, W] (uint8), the vignette f32 [..., H, W] and
its chroma-grid map f32 [..., H/2, W/2], and returns Y [..., 1, H, W]
and U|V [..., 2, H/2, W/2] (uint8): the split, the vignette multiply
(chroma about 128), clip, round and clip to uint8.  A vignette's
leading dims are 1 or the last of the frames' leading dims: [H, W] serves
every frame, [k, H, W] gives each of k blocks (``ShardedMapper``'s band
slices) its own.

For a CPU tensor it is its plain version (``prep_yuv_reference``, the
eager ops); for a CUDA tensor one launch of ``prep_yuv_kernel`` over
every frame of the stack, byte for byte the eager ops' result.  There is
no fallback from one to the other.  The kernel is in the ``product``
library (utils/build.py).

``LAUNCHES`` counts kernel launches in all, and ``COUNTS`` per variant:
the format, with the frames' leading rank where it is not 0
(``"yuv420p"``, ``"nv12"``, ``"yuv420p_lead2"``, ...); a launch
captured into a CUDA graph is counted at each replay
(``launch_counts``).
"""

import ctypes

import torch

from ..utils.build import load_library
from .color import _quantize, split_frame
from .cuda_pyramid import plane_layout
from .launch_counts import Counter

__all__ = ["COUNTS", "LAUNCHES", "prep_yuv", "prep_yuv_reference", "reset_counts"]

_COUNTER = Counter()
COUNTS = _COUNTER.counts
reset_counts = _COUNTER.reset  # set every count to 0
__getattr__ = _COUNTER.module_getattr(__name__)  # LAUNCHES: the launches in all

_FORMATS = {"yuv420p": 0, "nv12": 1}
_PLANE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]  # pointer, plane stride, row pitch
# (format, frames, h, w, vig, vig planes, vig_half, vig_half planes, out_y, out_uv, planes, stream)
_ARGTYPES = (
    [ctypes.c_int] + _PLANE + [ctypes.c_int, ctypes.c_int]
    + (_PLANE + [ctypes.c_int]) * 2
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
)
_ENTRY = []  # the ctypes function, once loaded
_INVALID_VALUE = 1  # cudaErrorInvalidValue: a launch the kernel refuses


def _entry():
    if not _ENTRY:
        fn = load_library("product").octvr_prep_yuv
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def prep_yuv_reference(buf, frame_format, vig, vig_half):
    """The plain version of ``prep_yuv``, eager torch ops; without a
    vignette (``vig`` None) Y is a view of ``buf`` and U|V one stack."""
    y, u, v = split_frame(buf, frame_format)
    uv = torch.stack([u, v], dim=-3)
    if vig is not None:
        y = _quantize(torch.clamp(y.float() * vig, 0.0, 255.0))
        uv = _quantize(torch.clamp((uv.float() - 128.0) * vig_half.unsqueeze(-3) + 128.0, 0.0, 255.0))
    return y.unsqueeze(-3), uv


def _check(buf, frame_format, vig, vig_half):
    """Raises ValueError on what ``prep_yuv`` does not take; returns
    (H, W)."""
    if frame_format not in _FORMATS:
        raise ValueError(f"unknown frame format {frame_format!r}, not in {sorted(_FORMATS)}")
    if buf.dtype != torch.uint8:
        raise ValueError(f"frames: dtype {buf.dtype}, want torch.uint8")
    rows, w = buf.shape[-2:] if buf.dim() >= 2 else (0, 0)
    h = rows * 2 // 3
    if buf.dim() < 2 or h < 2 or h % 2 or rows != h * 3 // 2 or w < 2 or w % 2:
        raise ValueError(f"frames: shape {tuple(buf.shape)}, want [..., H*3/2, W] with H and W even")
    lead = tuple(buf.shape[:-2])
    for name, t, shape in (("vig", vig, (h, w)), ("vig_half", vig_half, (h // 2, w // 2))):
        if t is None:
            raise ValueError(f"{name}: None, want a tensor (without a vignette the prep is "
                             "prep_yuv_reference's view and stack)")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, want torch.float32")
        own = tuple(t.shape[:-2])
        while own and own[0] == 1:
            own = own[1:]
        if tuple(t.shape[-2:]) != shape or t.dim() - 2 > len(lead) or own != lead[len(lead) - len(own):]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want [..., {shape[0]}, {shape[1]}] with leading "
                             f"dims 1 or the last of the frames' {lead}")
        if t.device != buf.device:
            raise ValueError(f"{name}: device {t.device}, the frames on {buf.device}")
    return h, w


def _planes(t):
    """(``t``, or its contiguous copy where its leading axes do not form
    one stride; its (pointer, plane stride, row pitch) as a stack of
    planes; their count).  The caller holds the tensor until the
    launch."""
    lay = plane_layout(t)
    if lay is None:
        t = t.contiguous()
        lay = plane_layout(t)
    return (t, *lay)


def prep_yuv(buf, frame_format, vig, vig_half):
    """Packed frames [..., H*3/2, W] -> (Y [..., 1, H, W], U|V [..., 2,
    H/2, W/2]) uint8 with the vignette applied: on a CUDA tensor one
    kernel launch, on a CPU tensor ``prep_yuv_reference``.  Raises
    ValueError on a format, dtype, shape or device it does not take."""
    h, w = _check(buf, frame_format, vig, vig_half)
    if buf.device.type == "cpu":
        return prep_yuv_reference(buf, frame_format, vig, vig_half)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    lead = tuple(buf.shape[:-2])
    y = torch.empty((*lead, 1, h, w), dtype=torch.uint8, device=buf.device)
    uv = torch.empty((*lead, 2, h // 2, w // 2), dtype=torch.uint8, device=buf.device)
    buf, frames, planes = _planes(buf)
    vig, vs, nv = _planes(vig)
    vig_half, hs, nh = _planes(vig_half)
    args = (_FORMATS[frame_format], *frames, h, w, *vs, nv, *hs, nh, y.data_ptr(), uv.data_ptr(), planes)
    fn = _entry()
    if buf.device.index != torch.cuda.current_device():
        with torch.cuda.device(buf.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err == _INVALID_VALUE:
        raise RuntimeError(f"prep kernel refused frames {tuple(buf.shape)}: it takes 1 to 65,535 frames")
    if err != 0:
        raise RuntimeError(f"prep kernel launch failed: CUDA error {err}")
    rank = len(lead)
    _COUNTER.add({frame_format if rank == 0 else f"{frame_format}_lead{rank}": 1})
    return y, uv
