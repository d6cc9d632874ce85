"""The band-sharded stitcher (octvr_tpu/parallel/sharded.py) on torch.

The output canvas is split into ``S`` horizontal bands, each with its
own halo of recomputed rows.  Only two things ever cross bands: a sum of
the exposure-gain statistics, and a concatenation of the band-interior
level-L Gaussian rows in the two-level multiband blend.  Every per-band
constant is homogenized, so the bands' plans stack on a leading ``S``
axis, and here all ``S`` bands run in one process on one device, with
the band axis written out as the leading axis of every band tensor: the
gain sum is a sum over it and the gather a concatenation along it
(:class:`LocalBands`, the one object a distributed band group replaces).
A band group costs about the launches of one band.

Per frame set (packed YUV420P, equal camera sizes):

    per input: source rows of each band's window (src_windows), split,
    vignette, quantize -> one remap launch per plane for every (input,
    band) pair (Y at full and U|V at half resolution; the CUDA kernel's
    source blocks, TPU kernel 6, when slices differ in height) ->
    centre chroma -> working-grid norms -> band sum -> gains -> per
    input window pyramids pasted into band pyramids (single level, or
    fine levels per band and the coarse levels once on the gathered
    level-L rows) -> union clamp -> packed YUV420P band outputs.

This slice runs the yuv420 pipeline with multiband blending, pairwise
gains (solved or injected), source windows on and off, and equal camera
sizes; the other options of the JAX ShardedMapper raise
``NotImplementedError`` (ROADMAP queue 1 item 19b).
"""

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np
import torch
from octvr_tpu.ops.resize import resize_bilinear
from octvr_tpu.template.compiler import MapperTemplate

from ..ops.color import merge_yuv420p
from ..ops.cuda_remap import remap_apply, remap_apply_frames
from ..ops.pyramid import down_matrix, pyr_down_mm, pyr_up_mm, up_matrix
from ..ops.remap import concat_source, remap_group, remap_plan
from ..stitch.blenders import WEIGHT_EPS, np_pyr_down
from ..stitch.gain import BETA, GainPlan, finish_gain_plan, solve_pair_means
from ..stitch.mapper import _pool_cols_matrix, _pool_pow2, _quantize, _working_stride
from ..stitch.yuv_mode import half_maps, yuv_rgb_norm
from ..utils.device import resolve_device, tree_to

__all__ = [
    "BandMesh",
    "LocalBands",
    "ShardedMapper",
    "ShardedPlan",
    "build_sharded_plan",
    "make_mesh",
]

_LATER = "not ported yet (ROADMAP queue 1 item 19b)"


class LocalBands:
    """The band group of ``S`` bands held in one process: band tensors
    carry the bands on their leading axis.  A ``torch.distributed``
    group of bands replaces this object and nothing else."""

    def __init__(self, n_space: int):
        self.size = n_space

    def sum(self, x):
        """x [S, ...] per band -> [...], the sum over all bands."""
        return x.sum(dim=0)

    def concat(self, x, dim: int):
        """x [S, ...] per band -> the bands' tensors concatenated along
        ``dim`` of one band's tensor."""
        return torch.cat(x.unbind(0), dim=dim)


@dataclass(frozen=True)
class BandMesh:
    """One process holding ``n_space`` bands on one device; ``n_data``
    splits a batch of frame sets into that many equal parts, as the JAX
    mesh's 'data' axis does."""

    n_data: int
    n_space: int
    device: torch.device


def make_mesh(n_data: int, n_space: int, *, device) -> BandMesh:
    """The counterpart of the JAX ``make_mesh``: all bands in this
    process, on ``device`` ("cuda" without a card raises)."""
    if n_data < 1 or n_space < 1:
        raise ValueError(f"mesh ({n_data}, {n_space}) needs positive sizes")
    return BandMesh(n_data, n_space, resolve_device(device))


@dataclass
class ShardedPlan:
    """The band-sharded plan (the JAX ShardedPlan's fields of this
    slice).  Built on the host by :func:`build_sharded_plan` (numpy;
    ``remap``/``remap_uv`` as per input, per band RemapPlans) and moved
    to a device by :meth:`to` (tensors; one RemapGroup per plane whose
    inputs are the (input, band) pairs, input-major)."""

    num_inputs: int
    S: int
    bh: int  # band height (canvas rows per band)
    halo: int
    ext: int  # bh + 2*halo
    Hp: int  # padded canvas height (S * bh)
    Wp: int  # padded canvas width
    canvas_size: tuple  # true (W, H)
    in_size: tuple  # (H, W) of every camera
    num_bands: int
    num_bands_uv: int
    stride: int  # working-grid stride (gains), divides bh
    ralign: int
    ghalo: int  # halo // stride
    rois: tuple  # per input (x0, iw, hmax): canvas x, window height
    roi_oy_static: tuple  # per input: the window row offset, or None
    roi_oy: np.ndarray  # [S, n] i32 per-band window row offsets
    src_h: tuple  # per input: source rows of one band's slice
    src_row0_static: tuple  # per input: the slice's first row, or None
    src_row0: np.ndarray  # [S, n] i32
    compute_dtype: str = "float32"
    remap: object = None
    remap_uv: object = None
    split_level: int = -1
    split_level_uv: int = -1
    wp_coarse: Optional[List] = None  # [coarse level][input] [Hp>>l, iw>>l]
    inv_bw_coarse: Optional[List] = None  # per level [Hp>>l, Wp>>l]
    wp_coarse_uv: Optional[List] = None
    inv_bw_coarse_uv: Optional[List] = None
    coarse_row_idx: object = None  # [S, ext>>L] i32
    coarse_row_idx_uv: object = None
    union_row_mask: object = None  # [S, ext] f32
    union_row_mask_uv: object = None  # [S, ext/2]
    union_col_mask: object = None  # [Wp]
    union_col_mask_uv: object = None  # [Wp/2]
    weight_pyrs: Optional[List] = None  # [level][input] [S, hmax>>l, iw>>l]
    inv_band_weights: Optional[List] = None  # per level [S, ext>>l, Wp>>l]
    weight_pyrs_uv: Optional[List] = None
    inv_band_weights_uv: Optional[List] = None
    gain: object = None  # GainPlan (N, pairs, b, A_static), no masks
    gm_i: object = None  # [S, P, gh, gw] f32 pair masks (both sides)
    vignette: list = None  # per input [H, W] f32, None without one
    vignette_half: list = None  # per input [H/2, W/2]
    pool_cols_roi: object = None  # {iw: [iw, iw/stride]}
    pool_cols_roi_uv: object = None  # {iw/2: [iw/2, iw/stride]}
    down_mats: dict = field(default_factory=dict)  # {n: [n/2, n]}
    up_mats: dict = field(default_factory=dict)  # {n: [2n, n]}

    def to(self, device):
        """Device copy: blend constants in ``compute_dtype``, the rest as
        they are; ``roi_oy`` and ``src_row0`` stay on the host."""
        cdt = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        blend = (
            "weight_pyrs", "inv_band_weights", "wp_coarse", "inv_bw_coarse",
            "weight_pyrs_uv", "inv_band_weights_uv", "wp_coarse_uv",
            "inv_bw_coarse_uv", "down_mats", "up_mats",
        )
        other = (
            "coarse_row_idx", "coarse_row_idx_uv", "union_row_mask",
            "union_row_mask_uv", "union_col_mask", "union_col_mask_uv",
            "gain", "gm_i", "vignette", "vignette_half", "pool_cols_roi",
            "pool_cols_roi_uv",
        )
        kw = {f: tree_to(getattr(self, f), device, cdt) for f in blend}
        kw.update({f: tree_to(getattr(self, f), device) for f in other})
        for f in ("coarse_row_idx", "coarse_row_idx_uv"):
            if kw[f] is not None:
                kw[f] = kw[f].long()
        blocks = _src_blocks(self)
        return replace(
            self,
            remap=_band_group(self.remap, blocks, device, self.sliced),
            remap_uv=_band_group(self.remap_uv, blocks, device, self.sliced),
            **kw,
        )

    @property
    def sliced(self) -> bool:
        """Some input reads a slice of its camera's rows (src_windows)."""
        return any(h < self.in_size[0] for h in self.src_h)


def _src_blocks(plan):
    """Per input, its number of source blocks: one per band when the
    band slices start at different rows, else one that every band
    reads."""
    return [
        plan.S if h < plan.in_size[0] and r is None else 1
        for h, r in zip(plan.src_h, plan.src_row0_static)
    ]


def _band_group(plans, blocks, device, sliced):
    """One RemapGroup over the (input, band) pairs, input-major; pair
    (i, s) reads input i's block s (or its only block).  With ``sliced``
    the launch is the concat-source mode (TPU kernel 6)."""
    base = np.concatenate([[0], np.cumsum(blocks)])
    flat, idx = [], []
    for i, per_band in enumerate(plans):
        for s, p in enumerate(per_band):
            flat.append(p)
            idx.append(int(base[i]) + (s if blocks[i] > 1 else 0))
    return remap_group(flat, device, blocks=idx, concat=sliced)


# ------------------------------------------------------------ plan build


def _round_up(v, m):
    return (v + m - 1) // m * m


def _round_down(v, m):
    return v // m * m


def _coarse_row_map(n, lo, hi, start, nrows):
    """Extended-band row gather into the global level-L reconstruction:
    reflect-101 about the union top, symmetric reflection about hi-0.5
    at the bottom (sharded.py:322 of the JAX package)."""
    idx = np.arange(start, start + n)
    r = np.where(idx < lo, 2 * lo - idx, idx)
    r = np.where(r > hi - 1, 2 * hi - 1 - r, r)
    return np.clip(r, 0, nrows - 1).astype(np.int32)


def _full_canvas_maps(mt: MapperTemplate, Hp, Wp):
    """Each input's ROI maps pasted into padded full-canvas maps (-1 =
    invalid)."""
    maps = []
    for inp in mt.inputs:
        m1 = np.full((Hp, Wp), -1.0, dtype=np.float32)
        m2 = np.full((Hp, Wp), -1.0, dtype=np.float32)
        x, y, w, h = inp.roi
        m1[y : y + h, x : x + w] = inp.map1
        m2[y : y + h, x : x + w] = inp.map2
        maps.append((m1, m2))
    return maps


def _refl_idx(n, lo, hi, start=0):
    """Gather indices [start, start+n) reflect-101-mapped into [lo, hi)
    (single bounce; clipped for degenerate spans)."""
    idx = np.arange(start, start + n)
    r = np.where(idx < lo, 2 * lo - idx, idx)
    r = np.where(r > hi - 1, 2 * (hi - 1) - r, r)
    return np.clip(r, lo, hi - 1)


def _refl_fill(a, lo_y, hi_y, lo_x, hi_x):
    """In-array reflect-101 fill of rows/cols outside the union box."""
    a = a[np.clip(_refl_idx(a.shape[0], lo_y, hi_y), 0, a.shape[0] - 1)]
    return a[:, np.clip(_refl_idx(a.shape[1], lo_x, hi_x), 0, a.shape[1] - 1)]


def _union_box(mt, step):
    """The camera union's step-aligned bounds (arx, ary, arx1, ary1): the
    single-chip blend's reflect-101 boundary."""
    rois = [i.roi for i in mt.inputs]
    return (
        _round_down(min(r[0] for r in rois), step),
        _round_down(min(r[1] for r in rois), step),
        _round_up(max(r[0] + r[2] for r in rois), step),
        _round_up(max(r[1] + r[3] for r in rois), step),
    )


@dataclass(frozen=True)
class _Geom:
    """What the band and window slicing needs of a plan."""

    S: int
    bh: int
    halo: int
    rois: tuple
    roi_oy: np.ndarray
    union: tuple  # (arx, ary, arx1, ary1)

    def band_slice(self, arr, s, level=0, div=1, pad_value=0.0, reflect=False):
        """Rows of extended band s from a full padded array at pyramid
        ``level`` on the grid of ``div`` (1 luma, 2 chroma).
        ``reflect``: rows outside the union box come from its reflect-101
        extension; else ``pad_value`` outside the canvas."""
        h_l = (self.halo // div) >> level
        bh_l = (self.bh // div) >> level
        top = s * bh_l - h_l
        n = bh_l + 2 * h_l
        if reflect:
            _, ary, _, ary1 = self.union
            r = _refl_idx(n, (ary // div) >> level, (ary1 // div) >> level, start=top)
            return arr[np.clip(r, 0, arr.shape[0] - 1)]
        pad = np.full((h_l,) + arr.shape[1:], pad_value, dtype=arr.dtype)
        big = np.concatenate([pad, arr, pad], axis=0)
        return big[top + h_l : top + h_l + n]

    def wslice(self, arr, s, i, level=0, div=1, pad_value=0.0, reflect=False):
        """Input i's window of band s at pyramid ``level``."""
        x0, iw, hmax = self.rois[i]
        b = self.band_slice(arr, s, level, div, pad_value, reflect)
        o = (int(self.roi_oy[s, i]) // div) >> level
        return b[
            o : o + ((hmax // div) >> level),
            ((x0 // div) >> level) : (((x0 + iw) // div) >> level),
        ]


def _window_maps(mt, g: _Geom, Hp, Wp, div):
    """Per band, per input the window maps on the luma (div 1) or chroma
    (div 2: half_maps of the reflected luma maps) grid, reflect-extended
    about the union box: reflecting map values reproduces the warped
    image's reflection at the single-chip blend's aligned-ROI
    boundary."""

    def refl(maps, d):
        arx, ary, arx1, ary1 = (v // d for v in g.union)
        return [
            (_refl_fill(m1, ary, ary1, arx, arx1), _refl_fill(m2, ary, ary1, arx, arx1))
            for m1, m2 in maps
        ]

    maps = refl(_full_canvas_maps(mt, Hp, Wp), 1)
    if div == 2:
        maps = refl([half_maps(m1, m2, (0, 0, Wp, Hp))[:2] for m1, m2 in maps], 2)
    return [
        [
            (
                g.wslice(m1, s, i, div=div, pad_value=-1.0, reflect=True),
                g.wslice(m2, s, i, div=div, pad_value=-1.0, reflect=True),
            )
            for i, (m1, m2) in enumerate(maps)
        ]
        for s in range(g.S)
    ]


def _source_windows(band_maps, in_h, S, src_windows):
    """Per input the rows of the camera each band's window maps sample:
    (src_h per input, src_row0 [S, n]).  The slice height is homogenized
    over the bands; slicing is off unless it saves 16 rows or more."""
    n = len(band_maps[0])
    spans = np.zeros((S, n, 2), dtype=np.int64)
    for i in range(n):
        for s in range(S):
            m2 = band_maps[s][i][1]
            valid = m2 >= 0
            if valid.any():
                py = m2[valid].astype(np.float64) * in_h - 0.5
                lo = max(0, int(np.floor(py.min())) - 4)
                hi_ = min(in_h, int(np.ceil(py.max())) + 5)
            else:
                lo, hi_ = 0, min(in_h, 8)
            spans[s, i] = (lo, hi_)
    src_h = [0] * n
    src_row0 = np.zeros((S, n), dtype=np.int32)
    for i in range(n):
        h_i = int((spans[:, i, 1] - spans[:, i, 0]).max())
        h_i = min(in_h, _round_up(h_i, 4) + 4)
        if not src_windows or in_h - h_i < 16 or S == 1:
            h_i = in_h
        src_h[i] = h_i
        for s in range(S):
            lo = min(max(0, int(spans[s, i, 0])), in_h - h_i)
            src_row0[s, i] = (lo // 2) * 2
    return tuple(src_h), src_row0


def _band_remap_plans(band_maps, src_h, src_row0, in_size, div):
    """Per input, per band RemapPlans of the window maps, rebased onto
    the band's source slice (py' = py - row0, over the sliced height;
    the rebased map is rounded to f32 first, as the JAX package does)."""
    in_h, in_w = in_size[0] // div, in_size[1] // div
    S, n = src_row0.shape
    plans = []
    for i in range(n):
        h = src_h[i] // div
        per_band = []
        for s in range(S):
            m1, m2 = band_maps[s][i]
            if h < in_h:
                valid = m2 >= 0
                row0 = src_row0[s, i] // div
                if div == 2 and valid.any():
                    py = m2[valid].astype(np.float64) * in_h - 0.5
                    assert py.min() >= row0 - 1 and py.max() <= row0 + h, (
                        "chroma taps escape the source-row slice"
                    )
                m2b = m2.copy()
                m2b[valid] = (m2[valid].astype(np.float64) * in_h - row0) / h
                m2 = m2b.astype(np.float32)
            per_band.append(remap_plan(m1, m2, h, in_w))
        plans.append(per_band)
    return plans


def _check_slice(mt, in_sizes, blend, enable_gain):
    """Raise NotImplementedError for what this slice does not run yet."""
    if blend <= 0:
        raise NotImplementedError(f"feather or no blend (blend={blend}): {_LATER}")
    if enable_gain not in (False, True):
        raise NotImplementedError(f"enable_gain={enable_gain!r}: {_LATER}")
    if mt.overlay_inputs:
        raise NotImplementedError(f"overlay inputs: {_LATER}")
    if len(in_sizes) != len(mt.inputs):
        raise ValueError(f"{len(in_sizes)} sizes for {len(mt.inputs)} inputs")
    if len({tuple(s) for s in in_sizes}) != 1:
        raise NotImplementedError(f"mixed camera sizes {sorted({tuple(s) for s in in_sizes})}: {_LATER}")
    h, w = in_sizes[0]
    W, H = mt.out_size
    if h % 2 or w % 2 or W % 2 or H % 2:
        raise ValueError("the yuv420 pipeline needs even frame geometry")


def build_sharded_plan(
    mt: MapperTemplate,
    in_sizes,
    n_space: int,
    blend: int = 128,
    enable_gain: bool = True,
    blend_dtype: str = "float32",
    coarse_split=None,
    src_windows: bool = False,
) -> ShardedPlan:
    """Host (numpy) plan of the yuv420 band stitch, the JAX package's
    arithmetic (sharded.py:433-1376) for this slice's options.  Every
    per-frame stage runs at window size [hmax_i, iw_i]: the x window is
    band-independent, the y window has one height per input and a
    per-band offset."""
    if blend_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"blend dtype must be 'float32' or 'bfloat16', got {blend_dtype!r}")
    _check_slice(mt, in_sizes, blend, enable_gain)
    W, H = mt.out_size
    ncam = len(mt.inputs)
    in_size = tuple(in_sizes[0])
    B = int(math.ceil(math.log(blend) / math.log(2.0)) - 1.0)
    stride = _working_stride(W, H)
    step = 1 << B
    # two-level split: fine levels 0..L-1 per band under a 5*2^L halo,
    # coarse levels L..B once on the gathered level-L Gaussian
    if coarse_split is None:
        L = 2 if (n_space > 1 and B > 2) else B
    else:
        L = max(1, min(int(coarse_split), B))
    split = L < B
    fine_step = (1 << L) if split else step
    ralign = max(step, stride, 4)
    ralign_y = max(fine_step, stride, 4) if split else ralign
    _m = n_space * ralign_y
    Hp = _round_up(H, _m * step // math.gcd(_m, step))
    Wp = _round_up(W, ralign)
    bh = Hp // n_space
    halo = _round_up(5 * fine_step, ralign_y)
    if n_space == 1:
        halo, split, L, fine_step = 0, False, B, step
    ext = bh + 2 * halo
    S = n_space
    assert ext % ralign_y == 0 and halo % max(stride, 1) == 0

    # per-input aligned windows: band-independent x extent, one y
    # height over the bands, per-band y offset; gap = the blend
    # weights' pyramid support
    gap, gap_y = 5 * step, 5 * fine_step
    union = _union_box(mt, step)
    arx, ary, arx1, ary1 = union
    rois = []
    oy_table = np.zeros((S, ncam), dtype=np.int32)
    oy_static = []
    for idx, inp in enumerate(mt.inputs):
        x, y, w_, h_ = inp.roi
        x0 = max(0, _round_down(x - gap, ralign))
        x1 = min(Wp, _round_up(x + w_ + gap, ralign))
        wins = []
        for s in range(S):
            top = s * bh - halo
            ly0 = max(0, _round_down(y - gap_y - top, ralign_y))
            ly1 = min(ext, _round_up(y + h_ + gap_y - top, ralign_y))
            wins.append((ly0, ly1) if ly1 > ly0 else None)
        hmax = max((w1 - w0 for w0, w1 in filter(None, wins)), default=0)
        hmax = min(ext, max(hmax, ralign_y))
        oys = [0 if wnd is None else min(wnd[0], ext - hmax) for wnd in wins]
        oy_table[:, idx] = oys
        rois.append((x0, x1 - x0, hmax))
        oy_static.append(oys[0] if all(o == oys[0] for o in oys) else None)
    rois = tuple(rois)
    g = _Geom(S, bh, halo, rois, oy_table, union)

    band_maps = _window_maps(mt, g, Hp, Wp, div=1)
    src_h, src_row0 = _source_windows(band_maps, in_size[0], S, src_windows)
    src_static = tuple(
        int(src_row0[0, i]) if (src_row0[:, i] == src_row0[0, i]).all() else None
        for i in range(ncam)
    )
    remap = _band_remap_plans(band_maps, src_h, src_row0, in_size, div=1)
    remap_uv = _band_remap_plans(
        _window_maps(mt, g, Hp, Wp, div=2), src_h, src_row0, in_size, div=2
    )

    B_uv = max(1, B - 1)
    plan = ShardedPlan(
        num_inputs=ncam,
        S=S,
        bh=bh,
        halo=halo,
        ext=ext,
        Hp=Hp,
        Wp=Wp,
        canvas_size=(W, H),
        in_size=in_size,
        num_bands=B,
        num_bands_uv=B_uv,
        stride=stride,
        ralign=ralign_y,
        ghalo=halo // stride,
        rois=rois,
        roi_oy_static=tuple(oy_static),
        roi_oy=oy_table,
        src_h=src_h,
        src_row0_static=src_static,
        src_row0=src_row0,
        compute_dtype=blend_dtype,
        remap=remap,
        remap_uv=remap_uv,
    )
    bh2, halo2, ext2 = bh // 2, halo // 2, ext // 2

    full_masks = []
    for inp in mt.inputs:
        fm = np.zeros((Hp, Wp), dtype=np.uint8)
        x, y, w_, h_ = inp.roi
        fm[y : y + h_, x : x + w_] = inp.mask
        full_masks.append(fm)

    def h2(a):
        return a.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3)).astype(np.float32)

    # ---- multiband constants: full-canvas weight pyramids, reflect-
    # filled about the union box at every level
    full_seams = []
    for inp, sm in zip(mt.inputs, mt.seam_masks):
        fs = np.zeros((Hp, Wp), dtype=np.float32)
        x, y, w_, h_ = inp.roi
        fs[y : y + h_, x : x + w_] = sm.astype(np.float32) / 255.0
        full_seams.append(fs)

    def pyramids(seams, nb, div):
        ux0, uy0, ux1, uy1 = (v // div for v in union)
        pyrs = []
        for fs in seams:
            pyr = [_refl_fill(fs, uy0, uy1, ux0, ux1)]
            for l in range(nb):
                pyr.append(
                    _refl_fill(
                        np_pyr_down(pyr[-1]),
                        uy0 >> (l + 1), uy1 >> (l + 1), ux0 >> (l + 1), ux1 >> (l + 1),
                    )
                )
            pyrs.append(pyr)
        bw = [np.sum([p[l] for p in pyrs], axis=0) + WEIGHT_EPS for l in range(nb + 1)]
        return pyrs, bw

    def inv(a):
        return (1.0 / np.maximum(a, WEIGHT_EPS)).astype(np.float32)

    def fine_constants(pyrs, bw, n_fine, div):
        wp = [
            [np.stack([g.wslice(p[l], s, i, level=l, div=div, reflect=True) for s in range(S)])
             for i, p in enumerate(pyrs)]
            for l in range(n_fine)
        ]
        ibw = [
            inv(np.stack([g.band_slice(bw[l], s, level=l, div=div, reflect=True) for s in range(S)]))
            for l in range(n_fine)
        ]
        return wp, ibw

    def coarse_constants(pyrs, bw, Lc, nb, div):
        wp = [
            [pyrs[i][l][:, ((x0 // div) >> l) : (((x0 + iw) // div) >> l)]
             for i, (x0, iw, _) in enumerate(rois)]
            for l in range(Lc, nb + 1)
        ]
        ibw = [inv(bw[l]) for l in range(Lc, nb + 1)]
        ridx = np.zeros((S, (ext // div) >> Lc), np.int32)
        for s in range(S):
            top = (s * (bh // div) - halo // div) >> Lc
            ridx[s] = _coarse_row_map(
                (ext // div) >> Lc, (ary // div) >> Lc, (ary1 // div) >> Lc,
                top, (Hp // div) >> Lc,
            )
        return wp, ibw, ridx

    pyrs, bw = pyramids(full_seams, B, 1)
    plan.weight_pyrs, plan.inv_band_weights = fine_constants(pyrs, bw, L if split else B + 1, 1)
    if split:
        plan.split_level = L
        plan.wp_coarse, plan.inv_bw_coarse, plan.coarse_row_idx = coarse_constants(pyrs, bw, L, B, 1)

    # chroma at half resolution with B_uv = B-1 bands
    pyrs_uv, bw_uv = pyramids([h2(fs) for fs in full_seams], B_uv, 2)
    L_uv = max(1, L - 1) if split else B_uv
    split_uv = split and L_uv < B_uv and halo2 >= 5 * (1 << L_uv)
    if not split_uv:
        L_uv = B_uv
    plan.weight_pyrs_uv, plan.inv_band_weights_uv = fine_constants(
        pyrs_uv, bw_uv, L_uv if split_uv else B_uv + 1, 2
    )
    if split_uv:
        plan.split_level_uv = L_uv
        plan.wp_coarse_uv, plan.inv_bw_coarse_uv, plan.coarse_row_idx_uv = coarse_constants(
            pyrs_uv, bw_uv, L_uv, B_uv, 2
        )

    # banded matrices for every axis length the two blends touch
    lengths = set()
    for div, nb in ((1, B), (2, B_uv)):
        for l in range(nb + 1):
            lengths |= {(ext // div) >> l, (Wp // div) >> l, (Hp // div) >> l}
            for x0, iw, hmax in rois:
                lengths |= {(hmax // div) >> l, (iw // div) >> l}
    for nl in lengths:
        if nl >= 2:
            plan.down_mats[nl] = down_matrix(nl)
            plan.up_mats[nl >> 1] = up_matrix(nl >> 1)

    # ---- gains on the global working grid: the single-chip Mapper's
    # blocks, summed over the bands
    if enable_gain and ncam > 1:
        assert bh % stride == 0 and Wp % stride == 0
        work = []
        for fm in full_masks:
            mb = (fm > 0).astype(np.float32)
            pooled = mb.reshape(Hp // stride, stride, Wp // stride, stride).mean(axis=(1, 3))
            work.append(pooled > 0.999)
        gh = bh // stride
        pairs, gm = [], []
        N = np.zeros((ncam, ncam), dtype=np.int64)
        for i in range(ncam):
            N[i, i] = max(1, int(np.count_nonzero(work[i])))
        for i in range(ncam):
            for j in range(i + 1, ncam):
                inter = work[i] & work[j]
                cnt = int(inter.sum())
                N[i, j] = N[j, i] = max(1, cnt)
                if cnt:
                    pairs.append((i, j))
                    gm.append(inter.astype(np.float32))
        plan.gain = finish_gain_plan(
            GainPlan(
                num_images=ncam,
                N=tuple(tuple(int(v) for v in row) for row in N),
                b=(BETA * N.sum(axis=1)).astype(np.float32),
                A_static=np.diag(BETA * N.sum(axis=1)).astype(np.float32),
                pairs=tuple(pairs),
            )
        )
        if pairs:
            stack = np.stack(gm)
            plan.gm_i = np.stack([stack[:, s * gh : (s + 1) * gh] for s in range(S)])

    # ---- union-box clamps, only when the camera union leaves canvas
    # rows or columns uncovered
    if arx > 0 or ary > 0 or arx1 < W or ary1 < H:
        rows = np.zeros((S, ext), dtype=np.float32)
        rows_uv = np.zeros((S, ext2), dtype=np.float32)
        for s in range(S):
            r = s * bh - halo + np.arange(ext)
            rows[s] = ((r >= ary) & (r < ary1)).astype(np.float32)
            r2 = s * bh2 - halo2 + np.arange(ext2)
            rows_uv[s] = ((r2 >= ary // 2) & (r2 < ary1 // 2)).astype(np.float32)
        plan.union_row_mask = rows
        plan.union_row_mask_uv = rows_uv
        c = np.arange(Wp)
        plan.union_col_mask = ((c >= arx) & (c < arx1)).astype(np.float32)
        c2 = np.arange(Wp // 2)
        plan.union_col_mask_uv = ((c2 >= arx // 2) & (c2 < arx1 // 2)).astype(np.float32)

    # ---- vignettes (None where the template has none: the JAX package's
    # ones, whose multiply changes no byte)
    Hi, Wi = in_size
    plan.vignette = [
        None if inp.vignette is None
        else np.asarray(resize_bilinear(inp.vignette, Hi, Wi)).astype(np.float32)
        for inp in mt.inputs
    ]
    plan.vignette_half = [
        None if v is None
        else v.reshape(Hi // 2, 2, Wi // 2, 2).mean(axis=(1, 3)).astype(np.float32)
        for v in plan.vignette
    ]
    if stride > 1:
        plan.pool_cols_roi = {iw: _pool_cols_matrix(iw, stride) for _, iw, _ in set(rois)}
        if stride > 2:
            plan.pool_cols_roi_uv = {
                iw // 2: _pool_cols_matrix(iw // 2, stride // 2) for _, iw, _ in set(rois)
            }
    return plan


# ----------------------------------------------------------- band helpers


def _win_oy(plan: ShardedPlan, i: int, div: int = 1):
    """Input i's window row offset in its band: an int when it is the
    same in every band, else the per-band offsets [S] (numpy)."""
    o = plan.roi_oy_static[i]
    if o is not None:
        return o // div
    return plan.roi_oy[:, i] // div


def _src_row0(plan: ShardedPlan, i: int, div: int = 1):
    """Input i's source slice offset: an int when it is the same in every
    band, else the per-band offsets [S] (numpy)."""
    o = plan.src_row0_static[i]
    if o is not None:
        return o // div
    return plan.src_row0[:, i] // div


class ShardedMapper:
    """Stitch batches of frame sets as ``S`` horizontal bands (the JAX
    ShardedMapper, yuv420 pipeline).

    ``mesh`` (:func:`make_mesh`) gives the band count, the data split of
    a batch and the device.  blend > 0 is the multiband width;
    enable_gain: True (pairwise global gains) or False; blend_dtype:
    "float32" or "bfloat16", None picks bfloat16 on CUDA and float32 on
    the CPU; coarse_split: the two-level blend's split level (None: 2
    when S > 1, the number of bands turns it off); src_windows: each
    band preps and gathers only the camera rows its windows sample.
    Other options raise NotImplementedError (ROADMAP queue 1 item
    19b)."""

    def __init__(
        self,
        mt: MapperTemplate,
        in_sizes,
        mesh: BandMesh,
        blend: int = 128,
        enable_gain: bool = True,
        out_format: str = "yuv420p",
        blend_dtype: str = None,
        pipeline: str = None,
        scale_output=None,
        frame_format: str = "yuv420p",
        coarse_split=None,
        src_windows: bool = False,
    ):
        if out_format != "yuv420p":
            raise NotImplementedError(f"out_format={out_format!r}: {_LATER}")
        if pipeline not in (None, "yuv420"):
            raise NotImplementedError(f"pipeline={pipeline!r}: {_LATER}")
        if scale_output is not None and tuple(scale_output) != tuple(mt.out_size):
            raise NotImplementedError(f"scale_output={scale_output!r}: {_LATER}")
        if frame_format != "yuv420p":
            raise NotImplementedError(f"frame_format={frame_format!r}: {_LATER}")
        if blend_dtype is None:
            blend_dtype = "bfloat16" if mesh.device.type == "cuda" else "float32"
        host = build_sharded_plan(
            mt, in_sizes, mesh.n_space, blend=blend, enable_gain=enable_gain,
            blend_dtype=blend_dtype, coarse_split=coarse_split, src_windows=src_windows,
        )
        self._bind(host.to(mesh.device), mesh)

    @classmethod
    def from_plan(cls, plan: ShardedPlan, mesh: BandMesh):
        """A ShardedMapper over a plan already on ``mesh.device``
        (ShardedPlan.to, or parallel.convert.sharded_plan_from_jax)."""
        self = cls.__new__(cls)
        self._bind(plan, mesh)
        return self

    def _bind(self, plan: ShardedPlan, mesh: BandMesh):
        if mesh.n_space != plan.S:
            raise ValueError(f"mesh has {mesh.n_space} bands, the plan {plan.S}")
        self.plan = plan
        self.mesh = mesh
        self.device = mesh.device
        self.group = LocalBands(plan.S)
        self._rows_cache = {}
        n = plan.num_inputs
        dev = self.device
        # per input, the source-row gather of each band's slice (packed
        # buffer rows: luma, then the chroma block rows), and the slices
        # of the vignettes; None where no slicing happens
        self._src_idx, self._vig, self._vig_half = [], [], []
        Hi = plan.in_size[0]
        for i in range(n):
            h = plan.src_h[i]
            r0 = np.atleast_1d(_src_row0(plan, i))
            if h >= Hi:
                self._src_idx.append(None)
            else:
                rows = np.concatenate(
                    [r0[:, None] + np.arange(h), Hi + r0[:, None] // 2 + np.arange(h // 2)], axis=1
                )
                self._src_idx.append(torch.from_numpy(rows.reshape(-1)).to(dev))
            for out, v, d in ((self._vig, plan.vignette[i], 1), (self._vig_half, plan.vignette_half[i], 2)):
                if v is None:
                    out.append(None)
                elif h >= Hi:
                    out.append(v[None])
                else:
                    idx = (r0[:, None] // d + np.arange(h // d)).reshape(-1)
                    out.append(v[torch.from_numpy(idx).to(dev)].view(len(r0), h // d, -1))
        self._cnt = (
            None if plan.gm_i is None
            else torch.tensor([float(plan.gain.N[i][j]) for i, j in plan.gain.pairs] * 2, device=dev)
        )

    # ------------------------------------------------------------ helpers

    def _rows(self, oy, c, H, h):
        """Flat row index of a [S, c, h, .] window at per-band row
        offsets ``oy`` in a [S, c, H, .] band tensor (cached: the offsets
        are plan constants)."""
        key = (oy.tobytes(), c, H, h)
        if key not in self._rows_cache:
            S = len(oy)
            rows = (np.arange(S)[:, None, None] * c + np.arange(c)[None, :, None]) * H
            rows = rows + oy[:, None, None] + np.arange(h)[None, None, :]
            self._rows_cache[key] = torch.from_numpy(rows.reshape(-1).astype(np.int64)).to(self.device)
        return self._rows_cache[key]

    def _paste_add(self, dst, src, oy, ox):
        """dst[s, :, oy:oy+h, ox:ox+w] += src[s] for every band s, in
        place; ``oy`` is an int or per-band offsets [S] (one index_add
        over all bands, no loop)."""
        h, w = src.shape[-2:]
        src = src.to(dst.dtype)
        if isinstance(oy, (int, np.integer)):
            dst[..., oy : oy + h, ox : ox + w] += src
            return dst
        S, c, H, W = dst.shape
        rows = self._rows(np.asarray(oy, np.int64), c, H, h)
        dst.view(S * c * H, W)[:, ox : ox + w].index_add_(0, rows, src.reshape(S * c * h, w))
        return dst

    # --------------------------------------------------------------- prep

    def _slice_src(self, buf, i):
        """Input i's packed frames [B, Hi*3/2, Wi] -> its source blocks
        [B, k, h*3/2, Wi]: k = S per-band slices of rows [row0, row0+h)
        plus the matching chroma block rows, or k = 1 when every band
        reads the same rows."""
        plan = self.plan
        h = plan.src_h[i]
        Hi = plan.in_size[0]
        if h >= Hi:
            return buf[:, None]
        idx = self._src_idx[i]
        return buf.index_select(1, idx).view(buf.shape[0], -1, h * 3 // 2, buf.shape[2])

    def _prep_band_yuv(self, frames):
        """Source slice, plane split, vignette and quantize of B frame
        sets.  Returns per input its Y blocks [B, k, 1, h, W] and U|V
        blocks [B, k, 2, h/2, W/2], uint8."""
        ys, uvs = [], []
        for i, buf in enumerate(frames):
            blocks = self._slice_src(buf, i)
            h, w = blocks.shape[-2] * 2 // 3, blocks.shape[-1]
            y = blocks[..., :h, :]
            uv = torch.stack([blocks[..., h:, : w // 2], blocks[..., h:, w // 2 :]], dim=2)
            if self._vig[i] is not None:
                y = _quantize(torch.clamp(y.float() * self._vig[i], 0.0, 255.0))
                uv = _quantize(
                    torch.clamp((uv.float() - 128.0) * self._vig_half[i][:, None] + 128.0, 0.0, 255.0)
                )
            ys.append(y[:, :, None])
            uvs.append(uv)
        return ys, uvs

    def _remap_dtype(self):
        return getattr(torch, self.plan.compute_dtype)

    def _remap(self, parts, group, frames):
        """One launch over every (input, band) pair: the frames axis for
        ``frames``, else one frame.  parts: per input its source blocks
        [B, k, C, h, W].  Returns per input its windows [B, S, C, hmax,
        iw], views of the kernel's one output buffer."""
        src = concat_source(parts, frames=True)
        S, dtype = self.plan.S, self._remap_dtype()
        if frames:
            out = remap_apply_frames(src, group, dtype, run=S)
        else:
            out = [o[None] for o in remap_apply(src[0], group, dtype, run=S)]
        return out if S > 1 else [o[:, None] for o in out]

    # -------------------------------------------------------------- gains

    def _window_norm_grid_yuv(self, wy, wuv, i):
        """Working-grid RGB norms of input i's windows (pooled luma and
        pooled centred chroma), pasted into each band's interior grid:
        [S, bh/st, Wp/st], the single-chip Mapper's global blocks."""
        plan = self.plan
        x0, iw, hmax = plan.rois[i]
        st = plan.stride
        S = plan.S
        y = _pool_pow2(
            wy.float().flatten(0, 1), st,
            col_mat=(plan.pool_cols_roi[iw] if st > 1 else None),
        )
        uvf = wuv.float().flatten(0, 1)
        if st >= 2:
            uv = _pool_pow2(uvf, st // 2, col_mat=(plan.pool_cols_roi_uv[iw // 2] if st > 2 else None))
        else:  # stride 1: nearest 2x chroma upsample onto the luma grid
            uv = uvf.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :hmax, :iw]
        uv = uv.unflatten(0, (S, 2))
        nrm = yuv_rgb_norm(y, uv[:, 0], uv[:, 1])
        grid = torch.zeros((S, 1, plan.ext // st, plan.Wp // st), dtype=torch.float32, device=nrm.device)
        self._paste_add(grid, nrm[:, None], _win_oy(plan, i, div=st), x0 // st)
        gh = plan.bh // st
        return grid[:, 0, plan.ghalo : plan.ghalo + gh]

    def _solve_band_gains(self, norms):
        """The pairwise gain solve from per-band interior norm grids: each
        band's pair sums, summed over the band group, so every band
        solves the same global system."""
        plan = self.plan
        gm = plan.gm_i
        sums = [(norms[i] * gm[:, p]).sum(dim=(1, 2)) for p, (i, _) in enumerate(plan.gain.pairs)]
        sums += [(norms[j] * gm[:, p]).sum(dim=(1, 2)) for p, (_, j) in enumerate(plan.gain.pairs)]
        sums = self.group.sum(torch.stack(sums, dim=1))
        return solve_pair_means(plan.gain, sums / self._cnt)

    # -------------------------------------------------------------- blend

    def _blend_windows(self, imgs, wins, weight_pyrs, inv_bw, B, ext_v, W_v, coarse=None):
        """Multiband blend of per-input windows [S, c, hmax_i, iw_i] into
        one band stack [S, c, ext_v, W_v].  wins: per input (x0, iw, hmax,
        oy) in this plane's units.  Window pyramids paste-add into band
        pyramids; ``coarse`` is the two-level split's context or None."""
        plan = self.plan
        cdt = self._remap_dtype()
        S, c = imgs[0].shape[:2]
        dev = imgs[0].device

        def down(z):
            hh, ww = z.shape[-2:]
            return pyr_down_mm(z, plan.down_mats[hh], plan.down_mats[ww]).to(cdt)

        def up(z):
            hh, ww = z.shape[-2:]
            return pyr_up_mm(z, plan.up_mats[hh], plan.up_mats[ww]).to(cdt)

        if coarse is not None:
            return self._blend_windows_split(imgs, wins, weight_pyrs, inv_bw, B, ext_v, W_v, down, up, cdt, coarse)

        dst = [torch.zeros((S, c, ext_v >> l, W_v >> l), dtype=cdt, device=dev) for l in range(B + 1)]
        for i, wd in enumerate(imgs):
            x0, iw, hmax, oy = wins[i]
            gauss = [wd]
            for _ in range(B):
                gauss.append(down(gauss[-1]))
            for l in range(B + 1):
                lap = gauss[l] - up(gauss[l + 1]) if l < B else gauss[B]
                self._paste_add(dst[l], lap * weight_pyrs[l][i][:, None], oy >> l, x0 >> l)
        for l in range(B + 1):
            dst[l] = dst[l] * inv_bw[l][:, None]
        band = dst[B]
        for l in range(B - 1, -1, -1):
            band = up(band) + dst[l]
        return band

    def _blend_windows_split(self, imgs, wins, wp_fine, inv_fine, B, ext_v, W_v, down, up, cdt, co):
        """Two-level multiband blend: fine levels 0..L-1 per band as in
        the single-level path; the band-interior rows of each window's
        level-L Gaussian are concatenated over the band group, the
        coarse levels L..B run once on that global level, and each band
        gathers its extended rows back (reflect-101 row map) to seed its
        fine collapse."""
        L = co["L"]
        halo_v, bh_v = co["halo"], co["bh"]
        S, c = imgs[0].shape[:2]
        dev = imgs[0].device
        dst = [torch.zeros((S, c, ext_v >> l, W_v >> l), dtype=cdt, device=dev) for l in range(L)]
        g_slices = []
        for i, wd in enumerate(imgs):
            x0, iw, hmax, oy = wins[i]
            gauss = [wd]
            for _ in range(L):
                gauss.append(down(gauss[-1]))
            for l in range(L):
                lap = gauss[l] - up(gauss[l + 1])
                self._paste_add(dst[l], lap * wp_fine[l][i][:, None], oy >> l, x0 >> l)
            # the window pasted into the extended band first, so a short
            # window never under-covers the interior rows
            buf = torch.zeros((S, c, ext_v >> L, iw >> L), dtype=cdt, device=dev)
            self._paste_add(buf, gauss[L], oy >> L, 0)
            g_slices.append(buf[:, :, (halo_v >> L) : (halo_v >> L) + (bh_v >> L)])

        widths = [g.shape[-1] for g in g_slices]
        full = self.group.concat(torch.cat(g_slices, dim=-1), dim=1)  # [c, Hp_v>>L, sum(iw>>L)]
        expected = co["S"] * (bh_v >> L)
        if full.shape[1] != expected:
            raise ValueError(
                f"split blend gathered {full.shape[1]} level-{L} rows, expected {expected} "
                f"(S={co['S']} x {bh_v >> L}): the band group does not match the plan"
            )
        Hp_L = full.shape[1]
        nl = B - L + 1
        dstC = [torch.zeros((c, (Hp_L << L) >> l, W_v >> l), dtype=cdt, device=dev) for l in range(L, B + 1)]
        off = 0
        for i in range(len(imgs)):
            x0 = wins[i][0]
            g = full[:, :, off : off + widths[i]]
            off += widths[i]
            gaussC = [g]
            for _ in range(L, B):
                gaussC.append(down(gaussC[-1]))
            for li, l in enumerate(range(L, B + 1)):
                lap = gaussC[li] - up(gaussC[li + 1]) if l < B else gaussC[-1]
                contrib = lap * co["wp"][li][i][None]
                dstC[li][:, :, (x0 >> l) : (x0 >> l) + contrib.shape[-1]] += contrib
        for li in range(nl):
            dstC[li] = dstC[li] * co["inv"][li][None]
        accC = dstC[-1]
        for li in range(nl - 2, -1, -1):
            accC = up(accC) + dstC[li]
        acc = accC[:, co["ridx"]].movedim(1, 0)  # each band's extended rows
        for l in range(L - 1, -1, -1):
            acc = up(acc) + dst[l] * inv_fine[l][:, None]
        return acc

    # ----------------------------------------------------------- post-warp

    def _postwarp_band_yuv(self, warped_y, warped_uv, gains_in):
        """Everything after the remap of one frame set: chroma centring,
        gains, the two plane blends, union clamp, packed YUV420P band
        outputs.  warped_*: per input [S, C, h, w].  Returns (out uint8
        [S*bh*3/2, Wp], gains [n])."""
        plan = self.plan
        n = plan.num_inputs
        ext, Wp, halo, bh = plan.ext, plan.Wp, plan.halo, plan.bh
        halo2, bh2 = halo // 2, bh // 2
        warped_uv = [w - 128.0 for w in warped_uv]

        gains = torch.ones(n, dtype=torch.float32, device=self.device)
        if plan.gm_i is not None:
            if gains_in is None:
                norms = [self._window_norm_grid_yuv(warped_y[i], warped_uv[i], i) for i in range(n)]
                gains = self._solve_band_gains(norms)
            else:
                gains = gains_in.float()
            # cast the scalar, not the image: f32 * bf16 would promote
            factors = [g.to(warped_y[0].dtype) for g in gains.unbind(0)]
            warped_y = [w * f for w, f in zip(warped_y, factors)]
            warped_uv = [w * f for w, f in zip(warped_uv, factors)]

        wins = [plan.rois[i] + (_win_oy(plan, i),) for i in range(n)]
        wins_uv = [
            (plan.rois[i][0] // 2, plan.rois[i][1] // 2, plan.rois[i][2] // 2, _win_oy(plan, i, div=2))
            for i in range(n)
        ]
        coarse_y = coarse_uv = None
        if plan.split_level >= 0:
            coarse_y = dict(L=plan.split_level, wp=plan.wp_coarse, inv=plan.inv_bw_coarse,
                            ridx=plan.coarse_row_idx, halo=halo, bh=bh, S=plan.S)
        if plan.split_level_uv >= 0:
            coarse_uv = dict(L=plan.split_level_uv, wp=plan.wp_coarse_uv, inv=plan.inv_bw_coarse_uv,
                             ridx=plan.coarse_row_idx_uv, halo=halo2, bh=bh2, S=plan.S)
        band_y = self._blend_windows(
            warped_y, wins, plan.weight_pyrs, plan.inv_band_weights,
            plan.num_bands, ext, Wp, coarse=coarse_y,
        ).float()
        band_uv = self._blend_windows(
            warped_uv, wins_uv, plan.weight_pyrs_uv, plan.inv_band_weights_uv,
            plan.num_bands_uv, ext // 2, Wp // 2, coarse=coarse_uv,
        ).float()
        if plan.union_row_mask is not None:
            band_y = band_y * plan.union_row_mask[:, None, :, None] * plan.union_col_mask
            band_uv = band_uv * plan.union_row_mask_uv[:, None, :, None] * plan.union_col_mask_uv

        y8 = _quantize(band_y[:, 0, halo : halo + bh])
        uv8 = _quantize(band_uv[:, :, halo2 : halo2 + bh2] + 128.0)
        out = torch.cat([y8, torch.cat([uv8[:, 0], uv8[:, 1]], dim=-1)], dim=-2)
        return out.reshape(plan.S * bh * 3 // 2, Wp), gains

    # ------------------------------------------------------------ forward

    def _stitch_bands(self, frames, gains_in):
        """B frame sets (per input [B, Hi*3/2, Wi]): one remap launch per
        plane for all of them (the frames axis when B > 1), post-warp
        frame by frame.  Returns (out [B, S*bh*3/2, Wp], gains [B, n])."""
        nb = frames[0].shape[0]
        ys, uvs = self._prep_band_yuv(frames)
        wy = self._remap(ys, self.plan.remap, nb > 1)
        wuv = self._remap(uvs, self.plan.remap_uv, nb > 1)
        outs, gains = [], []
        for b in range(nb):
            o, g = self._postwarp_band_yuv(
                [w[b] for w in wy],
                [w[b] for w in wuv],
                None if gains_in is None else gains_in[b],
            )
            outs.append(o)
            gains.append(g)
        return torch.stack(outs), torch.stack(gains)

    def _frames_to_device(self, frames):
        n = self.plan.num_inputs
        Hi, Wi = self.plan.in_size
        want = (Hi * 3 // 2, Wi)
        if not isinstance(frames, (list, tuple)):
            f = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(np.array(frames))
            if f.dim() != 4 or f.shape[1] != n:
                raise ValueError(f"want a stacked uint8 [B, {n}, {want[0]}, {want[1]}], got {tuple(f.shape)}")
            frames = f.unbind(1)
        if len(frames) != n:
            raise ValueError(f"{len(frames)} frame stacks for {n} inputs")
        bufs = []
        for f in frames:
            if not isinstance(f, torch.Tensor):
                f = torch.from_numpy(np.array(f))
            f = f.to(self.device)
            if f.dtype != torch.uint8 or f.dim() != 3 or tuple(f.shape[1:]) != want:
                raise ValueError(f"want uint8 [B, {want[0]}, {want[1]}], got {f.dtype} {tuple(f.shape)}")
            bufs.append(f)
        if len({f.shape[0] for f in bufs}) != 1:
            raise ValueError("every input needs the same number of frames")
        return bufs

    def stitch_batch(self, frames, gains=None):
        """frames: per input a uint8 [B, Hi*3/2, Wi] stack (B divisible by
        the mesh's data size), or one stacked [B, n, Hi*3/2, Wi].
        ``gains`` ([B, n] f32) replaces the solved pairwise gains.
        Returns (out uint8 [B, S*bh*3/2, Wp]: per band packed YUV420P
        buffers stacked along rows, see :meth:`assemble_yuv`; gains f32
        [B, n]) on the mapper's device."""
        bufs = self._frames_to_device(frames)
        B = bufs[0].shape[0]
        nd = self.mesh.n_data
        if B % nd:
            raise ValueError(f"batch {B} is not divisible by the mesh's data size {nd}")
        if gains is not None:
            gains = torch.as_tensor(gains, dtype=torch.float32, device=self.device)
            if tuple(gains.shape) != (B, self.plan.num_inputs):
                raise ValueError(f"gains must be [{B}, {self.plan.num_inputs}], got {tuple(gains.shape)}")
        nb = B // nd
        outs, gs = [], []
        for k in range(nd):
            part = slice(k * nb, (k + 1) * nb)
            o, g = self._stitch_bands([f[part] for f in bufs], None if gains is None else gains[part])
            outs.append(o)
            gs.append(g)
        return torch.cat(outs), torch.cat(gs)

    def assemble_yuv(self, out_b):
        """One frame's band stack [S*bh*3/2, Wp] -> the packed YUV420P
        canvas [H*3/2, W]."""
        W, H = self.plan.canvas_size
        S, bh, Wp = self.plan.S, self.plan.bh, self.plan.Wp
        bands = torch.as_tensor(out_b).reshape(S, bh * 3 // 2, Wp)
        y = bands[:, :bh].reshape(S * bh, Wp)[:H, :W]
        u = bands[:, bh:, : Wp // 2].reshape(S * bh // 2, Wp // 2)[: H // 2, : W // 2]
        v = bands[:, bh:, Wp // 2 :].reshape(S * bh // 2, Wp // 2)[: H // 2, : W // 2]
        return merge_yuv420p(y, u, v)
