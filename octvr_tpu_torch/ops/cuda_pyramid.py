"""Wrapper of the Hopper pyramid kernels (csrc/pyramid.cu): the steps
of the multiband blend's Gaussian and Laplacian pyramids.

Each function takes a stack of planes [..., h, w] and works on every
plane alike, in the input's dtype (float32 or bfloat16), with the
matrices of ``down_matrix``/``up_matrix`` (``mats``: a plan's
``down_mats`` or ``up_mats``, keyed by axis length):

- ``down(x, mats)``: [..., n_h, n_w] -> [..., n_h//2, n_w//2];
- ``up(x, mats)``: [..., h, w] -> [..., 2h, 2w];
- ``up_laplacian(dst, g, x, w, mats)``: ``dst += (g - up(x)) * w`` in
  place, ``dst`` a view of a band level, ``w`` a weight level [2h, 2w];
- ``up_collapse(x, d, s, mats)``: ``up(x) + d * s``, ``s`` an inverse
  band weight level [2h, 2w].

For a CPU tensor each is its plain version (``*_reference``): the banded
products (``ops/pyramid.py`` ``pyr_down_mm``/``pyr_up_mm``, full f32,
cast to the input's dtype after each step) and the same eager torch ops
around them, one rounding to the dtype after each.  For a CUDA tensor each is one
kernel launch (``pyr_down_kernel``, ``pyr_up_kernel``), which keeps
those roundings step for step; there is no fallback from one to the
other, and the card path runs no matrix product.  The kernels are the
``product`` library (utils/build.py).

``LAUNCHES`` counts kernel launches in all, and ``COUNTS`` per variant
(``"down_c1_bf16"``, ``"up_lap_c2_bf16"``, ``"up_add_c1_f32"``, ...: the
step, the channels ``x.shape[-3]``, the dtype); a launch captured into
a CUDA graph is counted at each replay (``launch_counts``).
"""

import ctypes

import torch

from ..utils.build import load_library
from .launch_counts import Counter
from .pyramid import pyr_down_mm, pyr_up_mm

__all__ = [
    "COUNTS",
    "LAUNCHES",
    "down",
    "down_reference",
    "reset_counts",
    "up",
    "up_collapse",
    "up_collapse_reference",
    "up_laplacian",
    "up_laplacian_reference",
    "up_reference",
]

_COUNTER = Counter()
COUNTS = _COUNTER.counts
reset_counts = _COUNTER.reset  # set every count to 0
__getattr__ = _COUNTER.module_getattr(__name__)  # LAUNCHES: the launches in all


_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MODES = {"up": 0, "up_lap": 1, "up_add": 2}
_PLANE = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]  # pointer, plane stride, row stride
_ARGTYPES = {
    # (x, n_h, n_w, out, planes, stream)
    "down": _PLANE + [ctypes.c_int, ctypes.c_int] + _PLANE + [ctypes.c_int, ctypes.c_void_p],
    # (mode, x, n_h, n_w, a, b, out, planes, stream)
    "up": [ctypes.c_int] + _PLANE + [ctypes.c_int, ctypes.c_int] + _PLANE * 3 + [ctypes.c_int, ctypes.c_void_p],
}
_ENTRIES = {}  # (step, dtype) -> ctypes function
_INVALID_VALUE = 1  # cudaErrorInvalidValue: a shape the kernels refuse


def _entry(step, dtype):
    fn = _ENTRIES.get((step, dtype))
    if fn is None:
        fn = getattr(load_library("product"), f"octvr_pyr_{step}_{_TAGS[dtype]}")
        fn.argtypes = _ARGTYPES[step]
        fn.restype = ctypes.c_int
        _ENTRIES[(step, dtype)] = fn
    return fn


def plane_layout(t):
    """(pointer, plane stride, row stride) of ``t`` [..., h, w] as a stack
    of planes, and their count; None where the last axis is not dense or
    the leading axes do not form one stride.  A stack of one plane has
    plane stride 0, so it broadcasts over any stack.  The prep kernel's
    wrapper (``cuda_prep``) lays out its operands with it too."""
    h, w = t.shape[-2:]
    if t.stride(-1) != 1 and w > 1:
        return None
    lead = [(n, s) for n, s in zip(t.shape[:-2], t.stride()[:-2]) if n != 1]
    for (_, s), (n1, s1) in zip(lead, lead[1:]):
        if s != s1 * n1:
            return None
    count = 1
    for n, _ in lead:
        count *= n
    pitch = t.stride(-2) if h > 1 else w
    if pitch >= 2**31:
        return None
    return (t.data_ptr(), lead[-1][1] if count > 1 else 0, pitch), count


def _operand(t, name, x, shape, planes, broadcast=False):
    """The layout of operand ``t``: on ``x``'s device and dtype, [..., *shape],
    ``planes`` planes (or one, with ``broadcast``)."""
    if t.device != x.device or t.dtype != x.dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, the input {x.dtype} on {x.device}")
    if tuple(t.shape[-2:]) != shape:
        raise ValueError(f"{name} is {tuple(t.shape)}, expected [..., {shape[0]}, {shape[1]}]")
    lay = plane_layout(t)
    if lay is None:
        raise ValueError(f"{name}: the last axis must be dense and the leading axes one stride, "
                         f"strides {tuple(t.stride())}")
    if lay[1] != planes and not (broadcast and lay[1] == 1):
        raise ValueError(f"{name} holds {lay[1]} planes, the input {planes}")
    return lay[0]


def _launch(variant, x, out, a=None, b=None):
    """One kernel launch of ``variant`` ("down", "up", "up_lap",
    "up_add") over the planes of CUDA tensor ``x`` into ``out`` (a, b:
    the up step's operands, b broadcast over the planes).  Returns
    ``out``."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _TAGS:
        raise ValueError(f"pyramid kernels take float32 or bfloat16, got {x.dtype}")
    lay = plane_layout(x)
    if lay is None:
        x = x.contiguous()
        lay = plane_layout(x)
    xs, planes = lay
    n_h, n_w = x.shape[-2:]
    shape = (n_h // 2, n_w // 2) if variant == "down" else (2 * n_h, 2 * n_w)
    os_ = _operand(out, "out", x, shape, planes)
    if variant == "down":
        step, args = "down", (*xs, n_h, n_w, *os_, planes)
    else:
        none = (0, 0, 0)
        a_s = none if a is None else _operand(a, "a", x, shape, planes)
        b_s = none if b is None else _operand(b, "b", x, shape, planes, broadcast=True)
        step, args = "up", (_MODES[variant], *xs, n_h, n_w, *a_s, *b_s, *os_, planes)
    fn = _entry(step, x.dtype)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err == _INVALID_VALUE:
        raise RuntimeError(
            f"pyramid kernel refused {variant} of {tuple(x.shape)}: it takes 1 to 65,535 planes "
            "and at least 2 rows and columns going down"
        )
    if err != 0:
        raise RuntimeError(f"pyramid kernel launch failed: CUDA error {err}")
    c = x.shape[-3] if x.dim() >= 3 else 1
    _COUNTER.add({f"{variant}_c{c}_{_TAGS[x.dtype]}": 1})
    return out


def down_reference(x, mats):
    """The plain version of ``down``: the banded products in f32, then
    the cast to ``x``'s dtype."""
    h, w = x.shape[-2:]
    return pyr_down_mm(x, mats[h], mats[w]).to(x.dtype)


def up_reference(x, mats):
    """The plain version of ``up``."""
    h, w = x.shape[-2:]
    return pyr_up_mm(x, mats[h], mats[w]).to(x.dtype)


def up_laplacian_reference(dst, g, x, w, mats):
    """The plain version of ``up_laplacian``: eager ops, in place."""
    dst += (g - up_reference(x, mats)) * w
    return dst


def up_collapse_reference(x, d, s, mats):
    """The plain version of ``up_collapse``."""
    return up_reference(x, mats) + d * s


def _on_cpu(x):
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def down(x, mats):
    """[..., n_h, n_w] -> [..., n_h//2, n_w//2] in ``x``'s dtype: the
    5-tap step down, reflect-101 (``down_matrix`` along both axes,
    ``mats`` a plan's ``down_mats``)."""
    if _on_cpu(x):
        return down_reference(x, mats)
    h, w = x.shape[-2:]
    return _launch("down", x, x.new_empty((*x.shape[:-2], h // 2, w // 2)))


def up(x, mats):
    """[..., h, w] -> [..., 2h, 2w] in ``x``'s dtype: the zero-stuffed
    5-tap step up (``up_matrix`` along both axes, ``mats`` a plan's
    ``up_mats``)."""
    if _on_cpu(x):
        return up_reference(x, mats)
    h, w = x.shape[-2:]
    return _launch("up", x, x.new_empty((*x.shape[:-2], 2 * h, 2 * w)))


def up_laplacian(dst, g, x, w, mats):
    """``dst += (g - up(x)) * w`` in place, each op rounded to the dtype:
    the Laplacian level of a Gaussian pair (g [..., 2h, 2w], x [..., h,
    w]) weighted by ``w`` [2h, 2w] and added into ``dst``, a view of a
    band level.  Returns ``dst``."""
    if _on_cpu(x):
        return up_laplacian_reference(dst, g, x, w, mats)
    return _launch("up_lap", x, dst, g, w)


def up_collapse(x, d, s, mats):
    """``up(x) + d * s``, each op rounded to the dtype: one step of the
    collapse, ``d`` [..., 2h, 2w] a band level and ``s`` [2h, 2w] its
    inverse band weight."""
    if _on_cpu(x):
        return up_collapse_reference(x, d, s, mats)
    return _launch("up_add", x, torch.empty_like(d, memory_format=torch.contiguous_format), d, s)
