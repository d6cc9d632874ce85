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

The multiband blend runs its pyramids per level over all its cameras
(``PyramidGroups``, the host tables of one plan's grouped launches):

- ``down_group(groups, i, x, mats)``: level i -> i + 1 of every camera,
  ``x`` the level-i arena [..., S_i] (camera k's level at its offset of
  each plane), one launch (``pyr_down_group_kernel``) per camera chunk;
- ``lap_gather(groups, gauss, mats)``: every band level [..., h_i, w_i]
  of the blend, the cameras' weighted Laplacian levels summed in
  ascending camera order as the per-camera steps sum them, from the
  Gaussian arenas; one launch (``pyr_lap_gather_kernel``) per chunk.

Their compositions camera by camera from the per-step entries,
``down_group_stepwise`` and ``lap_gather_stepwise``, are their CPU path
(the banded products) and, on the card, the per-step kernels that the
grouped launches equal byte for byte.

``LAUNCHES`` counts kernel launches in all, and ``COUNTS`` per variant
(``"down_c1_bf16"``, ``"up_lap_c2_bf16"``, ``"up_add_c1_f32"``,
``"down_group_c1_bf16"``, ``"lap_gather_c2_bf16"``, ...: the step, the
channels ``x.shape[-3]``, the dtype); a launch captured into a CUDA
graph is counted at each replay (``launch_counts``).
"""

import ctypes

import numpy as np
import torch

from ..utils.build import load_library
from .launch_counts import Counter
from .pyramid import pyr_down_mm, pyr_up_mm

__all__ = [
    "COUNTS",
    "LAUNCHES",
    "MAX_CAMS",
    "MAX_LEVELS",
    "PyramidGroups",
    "down",
    "down_group",
    "down_group_stepwise",
    "down_reference",
    "lap_gather",
    "lap_gather_stepwise",
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
    # (desc, src, dst, planes, stream)
    "down_group": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p],
    # (desc, gauss, band, n_levels, planes, stream)
    "lap_gather": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
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
    _call(step, x, args, f"{variant} of {tuple(x.shape)}: it takes 1 to 65,535 planes "
          "and at least 2 rows and columns going down")
    c = x.shape[-3] if x.dim() >= 3 else 1
    _COUNTER.add({f"{variant}_c{c}_{_TAGS[x.dtype]}": 1})
    return out


def _call(step, x, args, what):
    """Calls ``step``'s entry for ``x``'s dtype with ``args`` on the
    current stream of ``x``'s device; raises if the kernel refused the
    launch (``what`` says which) or it failed."""
    fn = _entry(step, x.dtype)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err == _INVALID_VALUE:
        raise RuntimeError(f"pyramid kernel refused {what}")
    if err != 0:
        raise RuntimeError(f"pyramid kernel launch failed: CUDA error {err}")


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


# ---------------------------------------------------------------- grouped

MAX_CAMS = 32  # cameras of one grouped launch (csrc/pyramid.cu kMaxCams)
MAX_LEVELS = 8  # band levels of one gather launch (kMaxLevels)
DOWN_TILE = (16, 64)  # output rows, columns of a down block (kDownRows, kDownCols)
UP_TILE = (16, 128)  # of an up or gather block (kUpRows, kUpCols)
_DOWN_HEAD, _DOWN_FIELDS = 3, 6  # csrc/pyramid.cu kDownHead, kDownFields
_LAP_HEAD, _LEVEL_FIELDS, _CAM_FIELDS = 3, 8, 7  # kLapHead, kLevelFields, kCamFields


def _tiles(h, w, tile):
    """(tiles across, tiles in all) of an [h, w] output in ``tile``s."""
    across = -(-w // tile[1])
    return across, across * -(-h // tile[0])


class PyramidGroups:
    """The host tables of a multiband plan's grouped pyramid launches,
    built once per plan (``align_rois`` and ``align_result_roi`` as
    ``MultiBandPlan`` has them, B = ``num_bands``):

    - ``shapes[i][k]``, ``origins[i][k]``: camera k's level i, [h, w], and
      its aligned ROI's (row, column) on band level i;
    - ``offsets[i][k]``: where camera k's level i starts in each plane of
      the level-i arena, which holds the cameras in order, each [h, w];
      ``arena_sizes[i]`` the plane's length S_i; ``band_shapes[i]``;
    - ``down[i]``: the tables of the launches of level i -> i + 1, one per
      chunk of at most ``MAX_CAMS`` cameras (``cam_chunks``), in order;
    - ``lap``: the gather launches' tables, one per chunk of at most
      ``MAX_LEVELS`` levels (coarse first) and ``MAX_CAMS`` cameras, the
      camera chunks of a level chunk in order, each after the first
      adding to the bands it left (``lap_chunks``: (levels, cameras,
      accumulate)).

    The tables are int64 arrays laid out as csrc/pyramid.cu reads them,
    with the pointers of ``weights`` (per camera, per level [h, w], the
    plan's ``weight_pyrs``; 0 without) in the gather tables."""

    def __init__(self, align_rois, align_result_roi, num_bands, weights=None):
        B = num_bands
        arx, ary, arw, arh = align_result_roi
        n = len(align_rois)
        self.num_bands, self.cameras, self.weights = B, n, weights
        self.band_shapes = [(arh >> i, arw >> i) for i in range(B + 1)]
        self.shapes = [[(ah >> i, aw >> i) for _, _, aw, ah in align_rois] for i in range(B + 1)]
        self.origins = [[((ay - ary) >> i, (ax - arx) >> i) for ax, ay, _, _ in align_rois] for i in range(B + 1)]
        self.offsets, self.arena_sizes = [], []
        for i in range(B + 1):
            sizes = [h * w for h, w in self.shapes[i]]
            self.offsets.append([sum(sizes[:k]) for k in range(n)])
            self.arena_sizes.append(sum(sizes))
        if self.arena_sizes[0] >= 2**31:
            raise ValueError(f"the level-0 arena holds {self.arena_sizes[0]} elements a plane, the kernels 2^31 - 1")
        for i in range(B):
            for (h, w), (y, x) in zip(self.shapes[i], self.origins[i]):
                if h % 2 or w % 2 or y % 2 or x % 2:
                    raise ValueError(f"level {i} of a camera, {h}x{w} at ({y}, {x}), is not even: "
                                     "the aligned ROIs are not aligned to 2^num_bands")
        if weights is not None:
            if len(weights) != n or any(len(pyr) != B + 1 for pyr in weights):
                raise ValueError(f"{len(weights)} weight pyramids of {sorted({len(p) for p in weights})} levels for "
                                 f"{n} cameras of {B + 1} levels (a template without seam masks?)")
            for k, pyr in enumerate(weights):
                for i, wt in enumerate(pyr):
                    if tuple(wt.shape) != self.shapes[i][k] or not wt.is_contiguous():
                        raise ValueError(f"weight level {i} of camera {k} is {tuple(wt.shape)}, "
                                         f"expected a dense {self.shapes[i][k]}")
        chunks = [range(s, min(s + MAX_CAMS, n)) for s in range(0, n, MAX_CAMS)]
        self.cam_chunks = chunks
        self.down = [[self._down_table(i, ch) for ch in chunks] for i in range(B)]
        levels = list(range(B, -1, -1))
        self.lap_chunks = [
            (levels[s : s + MAX_LEVELS], ch, j > 0)
            for s in range(0, B + 1, MAX_LEVELS)
            for j, ch in enumerate(chunks)
        ]
        self.lap = [self._lap_table(*c) for c in self.lap_chunks]

    def level(self, arena, i, k):
        """Camera k's level i in the level-i arena [..., S_i]: a [..., h, w] view."""
        h, w = self.shapes[i][k]
        off = self.offsets[i][k]
        return arena[..., off : off + h * w].unflatten(-1, (h, w))

    def _down_table(self, i, cams):
        t = [len(cams), self.arena_sizes[i], self.arena_sizes[i + 1]]
        end = 0
        for k in cams:
            h, w = self.shapes[i][k]
            across, tiles = _tiles(h // 2, w // 2, DOWN_TILE)
            end += tiles
            t += [self.offsets[i][k], self.offsets[i + 1][k], h, w, across, end]
        return np.array(t, dtype=np.int64)

    def _lap_table(self, levels, cams, accumulate):
        B = self.num_bands
        t = [len(levels), len(cams), int(accumulate)]
        end = 0
        for i in levels:
            bh, bw = self.band_shapes[i]
            across, tiles = _tiles(bh, bw, UP_TILE)
            end += tiles
            coarse = self.arena_sizes[i + 1] if i < B else 0
            t += [i, int(i == B), bh, bw, self.arena_sizes[i], coarse, across, end]
        for i in levels:
            for k in cams:
                (y, x), (h, w) = self.origins[i][k], self.shapes[i][k]
                coarse = self.offsets[i + 1][k] if i < B else 0
                wt = 0 if self.weights is None else self.weights[k][i].data_ptr()
                t += [y, x, h, w, self.offsets[i][k], coarse, wt]
        return np.array(t, dtype=np.int64)


def _arena(x, groups, i):
    """The planes of ``x``, the level-i arena [..., S_i] on the card: its
    plane count, after checking its dtype, shape and layout."""
    if x.dtype not in _TAGS:
        raise ValueError(f"pyramid kernels take float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] != groups.arena_sizes[i] or not x.is_contiguous():
        raise ValueError(f"level-{i} arena is {tuple(x.shape)}, expected a dense [..., {groups.arena_sizes[i]}]")
    return x.numel() // groups.arena_sizes[i]


def _count_group(variant, x):
    c = x.shape[-2] if x.dim() >= 2 else 1
    _COUNTER.add({f"{variant}_c{c}_{_TAGS[x.dtype]}": 1})


def down_group_stepwise(groups, i, x, mats):
    """``down_group`` camera by camera: ``down`` of each camera's level
    (on the CPU the banded product, ``down_group``'s plain version; on
    the card one per-step kernel launch per camera)."""
    out = x.new_empty((*x.shape[:-1], groups.arena_sizes[i + 1]))
    for k in range(groups.cameras):
        groups.level(out, i + 1, k).copy_(down(groups.level(x, i, k), mats))
    return out


def lap_gather_stepwise(groups, gauss, mats):
    """``lap_gather`` camera by camera: per camera in order and level,
    ``up_laplacian`` into the band level's window (at level B the eager
    ``dst += g * w``) over zeroed bands (on the CPU the banded products
    and eager ops, ``lap_gather``'s plain version; on the card the
    per-step kernels)."""
    B = groups.num_bands
    lead = gauss[0].shape[:-1]
    bands = [gauss[0].new_zeros((*lead, h, w)) for h, w in groups.band_shapes]
    for k in range(groups.cameras):
        for i in range(B + 1):
            (y, x), (h, w) = groups.origins[i][k], groups.shapes[i][k]
            dst = bands[i][..., y : y + h, x : x + w]
            g, wt = groups.level(gauss[i], i, k), groups.weights[k][i]
            if i < B:
                up_laplacian(dst, g, groups.level(gauss[i + 1], i + 1, k), wt, mats)
            else:
                dst += g * wt
    return bands


def down_group(groups, i, x, mats):
    """Level i -> i + 1 of every camera of ``groups`` (a ``PyramidGroups``):
    ``x`` the level-i arena [..., S_i], returns the level-(i + 1) arena,
    each camera's level ``down`` of its level i.  On the card one
    ``pyr_down_group_kernel`` launch per camera chunk."""
    if _on_cpu(x):
        return down_group_stepwise(groups, i, x, mats)
    planes = _arena(x, groups, i)
    out = x.new_empty((*x.shape[:-1], groups.arena_sizes[i + 1]))
    for table in groups.down[i]:
        _call("down_group", x, (table.ctypes.data, x.data_ptr(), out.data_ptr(), planes),
              f"down_group of level {i}, {tuple(x.shape)}")
        _count_group("down_group", x)
    return out


def lap_gather(groups, gauss, mats):
    """The band levels of a blend, [..., h_i, w_i] for i = 0..B: per level
    the sum over the cameras, in ascending order, of ``(g_i - up(g_{i+1}))
    * w_i`` on each camera's aligned ROI (at level B ``g_B * w_B``), each op
    rounded to the dtype as ``up_laplacian`` and the eager add round it;
    0 where no camera's ROI reaches.  ``gauss``: the Gaussian arenas of
    levels 0..B (``down_group``), the weights those of ``groups``.  On
    the card one ``pyr_lap_gather_kernel`` launch per chunk, each band
    pixel stored once."""
    x = gauss[0]
    if _on_cpu(x):
        return lap_gather_stepwise(groups, gauss, mats)
    planes = _arena(x, groups, 0)
    for i, g in enumerate(gauss):
        if _arena(g, groups, i) != planes or g.dtype != x.dtype or g.device != x.device:
            raise ValueError(f"level-{i} arena {g.dtype} {tuple(g.shape)} on {g.device} does not match level 0's")
    w0 = groups.weights[0][0]
    if w0.dtype != x.dtype or w0.device != x.device:
        raise ValueError(f"weights are {w0.dtype} on {w0.device}, the arenas {x.dtype} on {x.device}")
    lead = x.shape[:-1]
    bands = [x.new_empty((*lead, h, w)) for h, w in groups.band_shapes]
    n = len(gauss)
    gp = (ctypes.c_longlong * n)(*(g.data_ptr() for g in gauss))
    bp = (ctypes.c_longlong * n)(*(b.data_ptr() for b in bands))
    for table in groups.lap:
        _call("lap_gather", x, (table.ctypes.data, ctypes.addressof(gp), ctypes.addressof(bp), n, planes),
              f"lap_gather of {tuple(x.shape)}")
        _count_group("lap_gather", x)
    return bands
