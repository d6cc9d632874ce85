"""The band-sharded stitcher (octvr_tpu/parallel/sharded.py) on torch.

The output canvas is split into ``S`` horizontal bands, each with its
own halo of recomputed rows.  Only two things ever cross bands: a sum of
the exposure-gain statistics (the pairwise sums, or the block sums of
the blocks gains), and a concatenation of the band-interior level-L
Gaussian rows in the two-level multiband blend.  Every per-band
constant is homogenized, so the bands' plans stack on a leading band
axis, which every band tensor carries.  A process holds the bands
``[band_lo, band_hi)`` of its mesh: all ``S`` of them on a
:func:`make_mesh` mesh, whose band group (:class:`LocalBands`) sums over
the band axis and concatenates along it; or its share of a data row of
a ``torch.distributed`` mesh (runtime/distributed.py), whose band group
(:class:`DistributedBands`) does the same and then one ``all_reduce`` or
``all_gather`` over the row's ranks.  A band group costs about the
launches of one band.

Per frame set (packed YUV420P or NV12 frames):

    yuv420: per input: source rows of each band's window (src_windows),
    split, vignette, quantize -> per equal-size camera group one remap
    launch per plane for every (input, band) pair (Y at full and U|V at
    half resolution; the CUDA kernel's source blocks, TPU kernel 6, when
    the blocks are camera-row slices) -> centre chroma -> gains ->
    blend -> union clamp -> overlays -> (resize) -> packed band outputs.
    rgb: per input: source rows, split, planar RGB, vignette, quantize ->
    per group one NC=3 launch -> gains -> blend -> union clamp ->
    overlays -> clip -> (resize) -> packed band outputs, or planar RGB
    f32 with ``out_format="rgb"``.

Gains: pairwise (solved or injected) or blocks, on the single-chip
Mapper's working grid, summed over the bands.  Blends: multiband (per
input window pyramids pasted into band pyramids; single level, or fine
levels per band and the coarse levels once on the gathered level-L
rows), feather, or an averaged paste (``blend == 0``).
"""

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from scipy.ndimage import distance_transform_edt

from ..ops import cuda_pyramid
from ..ops.color import _quantize, merge_frame, rgb_planar_to_planes, split_frame
from ..ops.cuda_remap import remap_apply, remap_apply_frames
from ..ops.pyramid import down_matrix, require_full_f32, up_matrix
from ..ops.remap import concat_source, remap_group, remap_plan
from ..stitch.blenders import WEIGHT_EPS, np_pyr_down
from ..stitch.gain import BETA, GainPlan, finish_gain_plan, solve_pair_means
from ..stitch.gain_blocks import assemble_and_solve_lattice, build_blocks_gain_plan
from ..stitch.frames import check_frames, prep_rgb, prep_yuv, vignette_maps
from ..stitch.mapper import _pool_cols_matrix, _pool_pow2, _working_stride, size_groups
from ..stitch.yuv_mode import half_maps, yuv_rgb_norm
from ..template.compiler import MapperTemplate, is_empty
from ..utils.device import resolve_device, tree_to

__all__ = [
    "BandMesh",
    "DistributedBands",
    "LocalBands",
    "ShardedMapper",
    "ShardedPlan",
    "build_sharded_plan",
    "make_mesh",
]


class LocalBands:
    """The band group of ``S`` bands held in one process: band tensors
    carry the bands on their leading axis."""

    def __init__(self, n_space: int):
        self.size = n_space

    def sum(self, x):
        """x [S, ...] per band -> [...], the sum over all bands."""
        return x.sum(dim=0)

    def concat(self, x, dim: int):
        """x [S, ...] per band -> the bands' tensors concatenated along
        ``dim`` of one band's tensor."""
        return torch.cat(x.unbind(0), dim=dim)


class DistributedBands:
    """The band group of a data row whose ``S`` bands are spread over
    the ranks of the process group ``group``, each rank holding
    ``band_hi - band_lo`` consecutive bands, in rank order: band tensors
    carry this rank's bands on their leading axis.  gloo and NCCL both
    take the tensors where they lie, on the CPU or the card."""

    def __init__(self, group, band_lo: int, band_hi: int, S: int):
        self.group = group
        self.size = S
        self.ranks = dist.get_world_size(group)
        if self.ranks * (band_hi - band_lo) != S:
            raise ValueError(
                f"{self.ranks} ranks holding bands [{band_lo}, {band_hi}) each do not make {S} bands"
            )

    def sum(self, x):
        """x [k, ...] for this rank's k bands -> [...], the sum over
        every band of the row (one all_reduce)."""
        y = x.sum(dim=0)
        dist.all_reduce(y, group=self.group)
        return y

    def concat(self, x, dim: int):
        """x [k, ...] for this rank's k bands -> every band's tensor of
        the row concatenated along ``dim`` of one band's tensor, in band
        order (one all_gather)."""
        y = torch.cat(x.unbind(0), dim=dim).contiguous()
        parts = [torch.empty_like(y) for _ in range(self.ranks)]
        dist.all_gather(parts, y, group=self.group)
        return torch.cat(parts, dim=dim)


@dataclass(frozen=True)
class BandMesh:
    """A process's place in a ('data', 'space') mesh: ``n_data`` data
    rows of ``n_space`` bands, this process holding bands
    ``[band_lo, band_hi)`` on ``device``.  From :func:`make_mesh`: one
    process holds every band and every data row, and splits a batch of
    frame sets into ``n_data`` equal parts as the JAX mesh's 'data' axis
    does.  From runtime.distributed.make_global_mesh: the process is one
    rank of data row ``data_index``, whose ranks ``group`` joins, and
    ``ranks`` lists the mesh's ranks row by row, all of them joined by
    ``mesh_group``."""

    n_data: int
    n_space: int
    device: torch.device
    band_lo: int = 0
    band_hi: Optional[int] = None  # None: n_space
    data_index: int = 0
    group: object = None  # None: every band in this process
    ranks: tuple = ()
    mesh_group: object = None

    def __post_init__(self):
        if self.band_hi is None:
            object.__setattr__(self, "band_hi", self.n_space)

    @property
    def local_data(self) -> int:
        """The data rows whose frame sets this process stitches."""
        return self.n_data if self.group is None else 1


def make_mesh(n_data: int, n_space: int, *, device="cuda") -> BandMesh:
    """The counterpart of the JAX ``make_mesh``: all bands in this
    process, on ``device`` (the card by default; "cuda" without a card
    raises)."""
    if n_data < 1 or n_space < 1:
        raise ValueError(f"mesh ({n_data}, {n_space}) needs positive sizes")
    return BandMesh(n_data, n_space, resolve_device(device))


@dataclass
class ShardedPlan:
    """The band-sharded plan (the JAX ShardedPlan's fields).  Built on
    the host by :func:`build_sharded_plan` (numpy; ``remap``/``remap_uv``
    as per input, per band RemapPlans) and moved to a device by
    :meth:`to` (tensors; per equal-size group one RemapGroup per plane
    whose inputs are the group's (input, band) pairs, input-major, in
    ``remap_groups``/``remap_uv_groups``; ``remap``/``remap_uv`` are then
    the only group's, or None for mixed sizes).  Inputs are the cameras,
    then the overlay inputs."""

    num_inputs: int  # cameras (blended)
    S: int
    bh: int  # band height (canvas rows per band)
    halo: int
    ext: int  # bh + 2*halo
    Hp: int  # padded canvas height (S * bh)
    Wp: int  # padded canvas width
    canvas_size: tuple  # true (W, H)
    in_sizes: tuple  # (H, W) per camera, then per overlay input
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
    num_overlays: int = 0
    blend_kind: str = "multiband"  # "multiband" | "feather" | "none"
    pipeline: str = "yuv420"  # "yuv420" | "rgb"
    frame_format: str = "yuv420p"  # "yuv420p" | "nv12", in and out
    group_idx: tuple = ()  # per equal-size group: input indices
    out_size: tuple = None  # (ow, oh) after scale_output
    obh: int = 0  # output rows per band (bh when unscaled)
    oW: int = 0  # output band width (Wp when unscaled)
    compute_dtype: str = "float32"
    remap: object = None
    remap_uv: object = None
    remap_groups: tuple = ()
    remap_uv_groups: tuple = ()
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
    feather_w: object = None  # per camera [S, hmax, iw] f32
    feather_w_uv: object = None  # per camera [S, hmax/2, iw/2]
    weight_pyrs: Optional[List] = None  # [level][input] [S, hmax>>l, iw>>l]
    inv_band_weights: Optional[List] = None  # per level [S, ext>>l, Wp>>l]
    weight_pyrs_uv: Optional[List] = None
    inv_band_weights_uv: Optional[List] = None
    gain: object = None  # GainPlan (N, pairs, b, A_static), no masks
    gm_i: object = None  # [S, P, gh, gw] f32 pair masks (both sides)
    gain_blocks: object = None  # BlocksGainPlan on the working canvas
    overlay_masks: object = None  # [S, nov, ext, Wp] f32
    overlay_masks_uv: object = None  # [S, nov, ext/2, Wp/2]
    resize_v: object = None  # dict y0, y1 [S, obh] i32 (band rows), fy f32
    resize_h: object = None  # dict x0, x1 [ow] i32, fx f32
    resize_v_uv: object = None
    resize_h_uv: object = None
    vignette: list = None  # per input [H, W] f32, None without one
    vignette_half: list = None  # per input [H/2, W/2] (yuv420)
    pool_cols_roi: object = None  # {iw: [iw, iw/stride]}
    pool_cols_roi_uv: object = None  # {iw/2: [iw/2, iw/stride]}
    down_mats: dict = field(default_factory=dict)  # {n: [n/2, n]}
    up_mats: dict = field(default_factory=dict)  # {n: [2n, n]}
    band_lo: int = 0  # the bands [band_lo, band_hi) of S this plan holds
    band_hi: Optional[int] = None  # None: S

    def __post_init__(self):
        if self.band_hi is None:
            self.band_hi = self.S

    @property
    def n_local(self) -> int:
        """The bands this plan holds: the leading axis of its per-band
        tables and of the band tensors."""
        return self.band_hi - self.band_lo

    def bands(self, lo: int, hi: int):
        """The host plan of bands [lo, hi) of this whole host plan: every
        per-band table cut to those bands; ``S`` and the geometry stay
        global (a rank's share of a data row, moved to its device by
        :meth:`to`)."""
        if self.remap_groups or self.n_local != self.S:
            raise ValueError("bands() cuts a whole host plan, before .to()")
        if not 0 <= lo < hi <= self.S:
            raise ValueError(f"bands [{lo}, {hi}) of {self.S}")

        def cut(a):  # bands on the leading axis
            return None if a is None else a[lo:hi]

        def each(xs):  # a list of tables
            return None if xs is None else [cut(a) for a in xs]

        def rows(t):  # the output resize's row taps
            return None if t is None else {k: cut(v) for k, v in t.items()}

        return replace(
            self,
            band_lo=lo,
            band_hi=hi,
            roi_oy=cut(self.roi_oy),
            src_row0=cut(self.src_row0),
            remap=each(self.remap),
            remap_uv=each(self.remap_uv),
            coarse_row_idx=cut(self.coarse_row_idx),
            coarse_row_idx_uv=cut(self.coarse_row_idx_uv),
            union_row_mask=cut(self.union_row_mask),
            union_row_mask_uv=cut(self.union_row_mask_uv),
            feather_w=each(self.feather_w),
            feather_w_uv=each(self.feather_w_uv),
            weight_pyrs=None if self.weight_pyrs is None else [each(l) for l in self.weight_pyrs],
            weight_pyrs_uv=None if self.weight_pyrs_uv is None else [each(l) for l in self.weight_pyrs_uv],
            inv_band_weights=each(self.inv_band_weights),
            inv_band_weights_uv=each(self.inv_band_weights_uv),
            gm_i=cut(self.gm_i),
            overlay_masks=cut(self.overlay_masks),
            overlay_masks_uv=cut(self.overlay_masks_uv),
            resize_v=rows(self.resize_v),
            resize_v_uv=rows(self.resize_v_uv),
        )

    def to(self, device):
        """Device copy: multiband constants in ``compute_dtype``, the rest
        as they are; ``roi_oy`` and ``src_row0`` stay on the host."""
        cdt = torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32
        blend = (
            "weight_pyrs", "inv_band_weights", "wp_coarse", "inv_bw_coarse",
            "weight_pyrs_uv", "inv_band_weights_uv", "wp_coarse_uv",
            "inv_bw_coarse_uv", "down_mats", "up_mats",
        )
        other = (
            "coarse_row_idx", "coarse_row_idx_uv", "union_row_mask",
            "union_row_mask_uv", "union_col_mask", "union_col_mask_uv",
            "feather_w", "feather_w_uv", "gain", "gm_i", "gain_blocks",
            "overlay_masks", "overlay_masks_uv", "resize_v", "resize_h",
            "resize_v_uv", "resize_h_uv", "vignette", "vignette_half",
            "pool_cols_roi", "pool_cols_roi_uv",
        )
        kw = {f: tree_to(getattr(self, f), device, cdt) for f in blend}
        kw.update({f: tree_to(getattr(self, f), device) for f in other})
        for f in ("coarse_row_idx", "coarse_row_idx_uv"):
            if kw[f] is not None:
                kw[f] = kw[f].long()
        for f in ("resize_v", "resize_h", "resize_v_uv", "resize_h_uv"):
            if kw[f] is not None:
                kw[f] = {k: v if v.is_floating_point() else v.long() for k, v in kw[f].items()}
        blocks = _src_blocks(self)

        def groups(per_input):
            if per_input is None:
                return ()
            return tuple(
                _band_group(
                    [per_input[i] for i in idxs], [blocks[i] for i in idxs], device,
                    any(self.src_h[i] < self.in_sizes[i][0] for i in idxs),
                )
                for idxs in self.group_idx
            )

        g, g_uv = groups(self.remap), groups(self.remap_uv)
        return replace(
            self,
            remap=g[0] if len(g) == 1 else None,
            remap_uv=g_uv[0] if len(g_uv) == 1 else None,
            remap_groups=g,
            remap_uv_groups=g_uv,
            **kw,
        )

    @property
    def sliced(self) -> bool:
        """Some input reads a slice of its camera's rows (src_windows)."""
        return any(h < hw[0] for h, hw in zip(self.src_h, self.in_sizes))


def _src_blocks(plan):
    """Per input, its number of source blocks: one per band of the plan
    when the band slices start at different rows, else one that every
    band reads."""
    return [
        plan.n_local if h < hw[0] and r is None else 1
        for h, hw, r in zip(plan.src_h, plan.in_sizes, plan.src_row0_static)
    ]


def _band_group(plans, blocks, device, sliced):
    """One RemapGroup over the (input, band) pairs of a size group,
    input-major; pair (i, s) reads input i's block s (or its only
    block).  ``plans``: per input its per-band RemapPlans; ``blocks``:
    per input its block count.  With ``sliced`` the launch is the
    concat-source mode (TPU kernel 6)."""
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
    """Each input's (then each overlay input's) ROI maps pasted into
    padded full-canvas maps (-1 = invalid)."""
    maps = []
    for inp in mt.inputs + mt.overlay_inputs:
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


def _window_maps(mt, g: _Geom, Hp, Wp, div, reflect=True):
    """Per band, per input (then overlay input) the window maps on the
    luma (div 1) or chroma (div 2: half_maps of the luma maps) grid.
    With ``reflect`` (multiband) the cameras' maps are reflect-extended
    about the union box: reflecting map values reproduces the warped
    image's reflection at the single-chip blend's aligned-ROI boundary.
    Overlays are pastes and are never reflected."""
    ncam = len(mt.inputs)

    def refl(maps, d):
        arx, ary, arx1, ary1 = (v // d for v in g.union)
        return [
            (_refl_fill(m1, ary, ary1, arx, arx1), _refl_fill(m2, ary, ary1, arx, arx1))
            if reflect and i < ncam else (m1, m2)
            for i, (m1, m2) in enumerate(maps)
        ]

    maps = refl(_full_canvas_maps(mt, Hp, Wp), 1)
    if div == 2:
        maps = refl([half_maps(m1, m2, (0, 0, Wp, Hp))[:2] for m1, m2 in maps], 2)
    return [
        [
            (
                g.wslice(m1, s, i, div=div, pad_value=-1.0, reflect=reflect and i < ncam),
                g.wslice(m2, s, i, div=div, pad_value=-1.0, reflect=reflect and i < ncam),
            )
            for i, (m1, m2) in enumerate(maps)
        ]
        for s in range(g.S)
    ]


def _source_windows(band_maps, in_heights, S, src_windows):
    """Per input the rows of the camera each band's window maps sample:
    (src_h per input, src_row0 [S, n]).  The slice height is homogenized
    over the bands; slicing is off unless it saves 16 rows or more."""
    n = len(band_maps[0])
    spans = np.zeros((S, n, 2), dtype=np.int64)
    for i in range(n):
        in_h = in_heights[i]
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
        in_h = in_heights[i]
        h_i = int((spans[:, i, 1] - spans[:, i, 0]).max())
        h_i = min(in_h, _round_up(h_i, 4) + 4)
        if not src_windows or in_h - h_i < 16 or S == 1:
            h_i = in_h
        src_h[i] = h_i
        for s in range(S):
            lo = min(max(0, int(spans[s, i, 0])), in_h - h_i)
            src_row0[s, i] = (lo // 2) * 2
    return tuple(src_h), src_row0


def _band_remap_plans(band_maps, src_h, src_row0, in_sizes, div):
    """Per input, per band RemapPlans of the window maps, rebased onto
    the band's source slice (py' = py - row0, over the sliced height;
    the rebased map is rounded to f32 first, as the JAX package does)."""
    S, n = src_row0.shape
    plans = []
    for i in range(n):
        in_h, in_w = in_sizes[i][0] // div, in_sizes[i][1] // div
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


def _plane_remaps(mt, g, plan, yuv, multiband):
    """(remap, remap_uv) of a plan whose geometry and source windows are
    set: per input, per band RemapPlans on the luma (or RGB) grid and,
    for yuv420, on the chroma grid (else None)."""
    remap = _band_remap_plans(
        _window_maps(mt, g, plan.Hp, plan.Wp, 1, multiband), plan.src_h, plan.src_row0, plan.in_sizes, 1
    )
    if not yuv:
        return remap, None
    return remap, _band_remap_plans(
        _window_maps(mt, g, plan.Hp, plan.Wp, 2, multiband), plan.src_h, plan.src_row0, plan.in_sizes, 2
    )


def _check_options(mt, in_sizes, pipeline, enable_gain, frame_format, out_size):
    """Raise ValueError on options the band stitch does not take.
    Returns (H, W) per camera, then per overlay input: sizes given for
    the cameras only repeat the first camera's size for the overlays, as
    in the JAX package."""
    if pipeline not in ("rgb", "yuv420"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if frame_format not in ("yuv420p", "nv12"):
        raise ValueError(f"unknown frame_format {frame_format!r}")
    if enable_gain not in (False, True, "blocks"):
        raise ValueError(f"unknown enable_gain {enable_gain!r}")
    for k, inp in enumerate(mt.inputs):
        if is_empty(inp):
            raise ValueError(
                f"camera {k} covers no pixel of the output (an empty input): the band-sharded "
                "stitcher takes none; stitch the output with Mapper"
            )
    ncam, nov = len(mt.inputs), len(mt.overlay_inputs)
    sizes = [tuple(int(v) for v in s) for s in in_sizes]
    if len(sizes) == ncam and nov:
        sizes += [sizes[0]] * nov
    if len(sizes) != ncam + nov:
        raise ValueError(f"{len(in_sizes)} sizes for {ncam} inputs and {nov} overlay inputs")
    if any(h % 2 or w % 2 for h, w in sizes):
        raise ValueError(f"packed YUV420P/NV12 frames need even camera sizes, got {sizes}")
    if (pipeline == "yuv420" or frame_format == "nv12") and (out_size[0] % 2 or out_size[1] % 2):
        raise ValueError(f"the output size {tuple(out_size)} must be even")
    return tuple(sizes)


def _resize_halo(S, W, H, oh, obh, bh):
    """Rows the output resize's vertical taps reach past a band's
    interior, over both planes (sharded.py:530-555 of the JAX package)."""
    need = 0
    for s in range(S):
        for src_h, dst_h, b_l, up in ((H, oh, bh, 1), (H // 2, oh // 2, bh // 2, 2)):
            nrows = obh // up
            yo = s * nrows + np.arange(nrows)
            ys = (yo + 0.5) * (src_h / dst_h) - 0.5
            y0 = np.clip(np.floor(ys), 0, src_h - 1).astype(np.int64)
            y1 = np.minimum(y0 + 1, src_h - 1)
            top = s * b_l
            need = max(need, (top - int(y0.min())) * up, (int(y1.max()) - (top + b_l - 1)) * up)
    return need


def _vtab(S, src_h, dst_h, nrows, b_l, h_l):
    """Per band INTER_LINEAR row taps of its output rows, as rows of its
    extended band (sharded.py:1328 of the JAX package)."""
    y0t = np.zeros((S, nrows), np.int32)
    y1t = np.zeros((S, nrows), np.int32)
    fyt = np.zeros((S, nrows), np.float32)
    for s in range(S):
        yo = s * nrows + np.arange(nrows)
        ys = (yo + 0.5) * (src_h / dst_h) - 0.5
        y0 = np.clip(np.floor(ys), 0, src_h - 1).astype(np.int64)
        y1 = np.minimum(y0 + 1, src_h - 1)
        fy = np.clip(ys - y0, 0.0, 1.0)
        top = s * b_l - h_l
        assert y0.min() - top >= 0 and y1.max() - top < b_l + 2 * h_l, (
            "scale_output vertical taps escape the extended band"
        )
        y0t[s], y1t[s], fyt[s] = y0 - top, y1 - top, fy
    return dict(y0=y0t, y1=y1t, fy=fyt)


def _htab(src_w, dst_w):
    """INTER_LINEAR column taps, the same for every band."""
    xs = (np.arange(dst_w) + 0.5) * (src_w / dst_w) - 0.5
    x0 = np.clip(np.floor(xs), 0, src_w - 1).astype(np.int64)
    x1 = np.minimum(x0 + 1, src_w - 1)
    fx = np.clip(xs - x0, 0.0, 1.0)
    return dict(x0=x0.astype(np.int32), x1=x1.astype(np.int32), fx=fx.astype(np.float32))


def build_sharded_plan(
    mt: MapperTemplate,
    in_sizes,
    n_space: int,
    blend: int = 128,
    enable_gain=True,
    blend_dtype: str = "float32",
    pipeline: str = "yuv420",
    scale_output=None,
    frame_format: str = "yuv420p",
    coarse_split=None,
    src_windows: bool = False,
) -> ShardedPlan:
    """Host (numpy) plan of the band stitch, the JAX package's arithmetic
    (sharded.py:433-1376).  Every per-frame stage runs at window size
    [hmax_i, iw_i]: the x window is band-independent, the y window has
    one height per input and a per-band offset.  in_sizes: (H, W) per
    camera, then per overlay input (or per camera only)."""
    if blend_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"blend dtype must be 'float32' or 'bfloat16', got {blend_dtype!r}")
    W, H = mt.out_size
    out_size = tuple(scale_output) if scale_output else (W, H)
    sizes = _check_options(mt, in_sizes, pipeline, enable_gain, frame_format, out_size)
    yuv = pipeline == "yuv420"
    ncam, nov = len(mt.inputs), len(mt.overlay_inputs)
    if blend > 0:
        kind, B = "multiband", int(math.ceil(math.log(blend) / math.log(2.0)) - 1.0)
    else:
        kind, B = ("feather" if blend < 0 else "none"), 0
    multiband = kind == "multiband"
    stride = _working_stride(W, H)
    step = 1 << B
    # two-level split: fine levels 0..L-1 per band under a 5*2^L halo,
    # coarse levels L..B once on the gathered level-L Gaussian
    if coarse_split is None:
        L = 2 if (multiband and n_space > 1 and B > 2) else B
    else:
        L = max(1, min(int(coarse_split), B))
    split = multiband and L < B
    fine_step = (1 << L) if split else step
    ralign = max(step, stride, 4)
    ralign_y = max(fine_step, stride, 4) if split else ralign
    _m = n_space * ralign_y
    Hp = _round_up(H, _m * step // math.gcd(_m, step))
    Wp = _round_up(W, ralign)
    bh = Hp // n_space
    halo = _round_up(5 * fine_step if multiband else 8, ralign_y)
    ow, oh = out_size
    obh = bh
    if out_size != (W, H):
        # each band emits its own output rows; their vertical taps must
        # stay inside the extended band
        obh = _round_up(oh, n_space * 2) // n_space
        need = _resize_halo(n_space, W, H, oh, obh, bh)
        if n_space > 1 and need > 0:
            halo = max(halo, _round_up(need, ralign_y))
    if n_space == 1:
        halo, split, L, fine_step = 0, False, B, step
    ext = bh + 2 * halo
    S = n_space
    assert ext % ralign_y == 0 and halo % max(stride, 1) == 0

    # per-input aligned windows: band-independent x extent, one y
    # height over the bands, per-band y offset; gap = the blend
    # weights' pyramid support (cameras of a multiband blend only)
    gap, gap_y = (5 * step, 5 * fine_step) if multiband else (0, 0)
    union = _union_box(mt, step) if multiband and ncam else (0, 0, Wp, Hp)
    arx, ary, arx1, ary1 = union
    rois = []
    oy_table = np.zeros((S, ncam + nov), dtype=np.int32)
    oy_static = []
    for idx, inp in enumerate(mt.inputs + mt.overlay_inputs):
        x, y, w_, h_ = inp.roi
        g_x, g_y = (gap, gap_y) if idx < ncam else (0, 0)
        x0 = max(0, _round_down(x - g_x, ralign))
        x1 = min(Wp, _round_up(x + w_ + g_x, ralign))
        wins = []
        for s in range(S):
            top = s * bh - halo
            ly0 = max(0, _round_down(y - g_y - top, ralign_y))
            ly1 = min(ext, _round_up(y + h_ + g_y - top, ralign_y))
            wins.append((ly0, ly1) if ly1 > ly0 else None)
        hmax = max((w1 - w0 for w0, w1 in filter(None, wins)), default=0)
        hmax = min(ext, max(hmax, ralign_y))
        oys = [0 if wnd is None else min(wnd[0], ext - hmax) for wnd in wins]
        oy_table[:, idx] = oys
        rois.append((x0, x1 - x0, hmax))
        oy_static.append(oys[0] if all(o == oys[0] for o in oys) else None)
    rois = tuple(rois)
    g = _Geom(S, bh, halo, rois, oy_table, union)

    band_maps = _window_maps(mt, g, Hp, Wp, 1, multiband)
    src_h, src_row0 = _source_windows(band_maps, [h for h, _ in sizes], S, src_windows)
    src_static = tuple(
        int(src_row0[0, i]) if (src_row0[:, i] == src_row0[0, i]).all() else None
        for i in range(ncam + nov)
    )

    B_uv = max(1, B - 1) if multiband else 0
    plan = ShardedPlan(
        num_inputs=ncam,
        S=S,
        bh=bh,
        halo=halo,
        ext=ext,
        Hp=Hp,
        Wp=Wp,
        canvas_size=(W, H),
        in_sizes=sizes,
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
        num_overlays=nov,
        blend_kind=kind,
        pipeline=pipeline,
        frame_format=frame_format,
        group_idx=size_groups(sizes),
        out_size=out_size,
        obh=obh,
        oW=ow if out_size != (W, H) else Wp,
        compute_dtype=blend_dtype if multiband else "float32",
    )
    plan.remap, plan.remap_uv = _plane_remaps(mt, g, plan, yuv, multiband)
    bh2, halo2, ext2 = bh // 2, halo // 2, ext // 2

    full_masks = []
    for inp in mt.inputs:
        fm = np.zeros((Hp, Wp), dtype=np.uint8)
        x, y, w_, h_ = inp.roi
        fm[y : y + h_, x : x + w_] = inp.mask
        full_masks.append(fm)

    def h2(a):
        return a.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3)).astype(np.float32)

    if kind == "feather":
        # full-canvas feather weights, normalized by their sum, sliced to
        # each camera's windows
        border = -blend
        dst = np.full((Hp, Wp), WEIGHT_EPS, dtype=np.float32)
        raw = []
        for fm in full_masks:
            wmap = distance_transform_edt(fm > 0).astype(np.float32) - border
            np.maximum(wmap, 0.0, out=wmap)
            raw.append(wmap)
            dst += wmap
        norm = [wm / dst for wm in raw]
        plan.feather_w = [np.stack([g.wslice(wm, s, i) for s in range(S)]) for i, wm in enumerate(norm)]
        if yuv:
            plan.feather_w_uv = [
                np.stack([g.wslice(h2(wm), s, i, div=2) for s in range(S)]) for i, wm in enumerate(norm)
            ]
    elif multiband:
        _multiband_constants(plan, mt, g, union, split, L, yuv)

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
        if enable_gain == "blocks":
            # the BlocksGainCompensator lattice on the working canvas
            # (exposure_compensate.cpp:330-438); each band's block sums
            # are summed over the band group at solve time
            ws_w, ws_h = -(-W // stride), -(-H // stride)
            masks_ws = [wk[:ws_h, :ws_w].astype(np.uint8) * 255 for wk in work]
            plan.gain_blocks = build_blocks_gain_plan(masks_ws, [(0, 0, ws_w, ws_h)] * ncam, (ws_w, ws_h))

    # ---- overlay paste masks on the extended-band rows (the halo rows
    # feed the output resize taps)
    if nov:
        oms = []
        for inp in mt.overlay_inputs:
            fm = np.zeros((Hp, Wp), dtype=np.float32)
            x, y, w_, h_ = inp.roi
            fm[y : y + h_, x : x + w_] = (inp.mask > 0).astype(np.float32)
            oms.append(fm)
        plan.overlay_masks = np.stack([np.stack([g.band_slice(om, s) for om in oms]) for s in range(S)])
        if yuv:
            oms_uv = [(h2(om) > 0).astype(np.float32) for om in oms]
            plan.overlay_masks_uv = np.stack(
                [np.stack([g.band_slice(om, s, div=2) for om in oms_uv]) for s in range(S)]
            )

    # ---- union-box clamps (multiband), only when the camera union
    # leaves canvas rows or columns uncovered
    if multiband and (arx > 0 or ary > 0 or arx1 < W or ary1 < H):
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
    vigs = [vignette_maps(inp.vignette, *hw, yuv) for inp, hw in zip(mt.inputs + mt.overlay_inputs, sizes)]
    plan.vignette = [v for v, _ in vigs]
    if yuv:
        plan.vignette_half = [vh for _, vh in vigs]
    if out_size != (W, H):
        plan.resize_v = _vtab(S, H, oh, obh, bh, halo)
        plan.resize_h = _htab(W, ow)
        if yuv:
            plan.resize_v_uv = _vtab(S, H // 2, oh // 2, obh // 2, bh2, halo2)
            plan.resize_h_uv = _htab(W // 2, ow // 2)
    if stride > 1:
        cams = set(rois[:ncam])
        plan.pool_cols_roi = {iw: _pool_cols_matrix(iw, stride) for _, iw, _ in cams}
        if yuv and stride > 2:
            plan.pool_cols_roi_uv = {iw // 2: _pool_cols_matrix(iw // 2, stride // 2) for _, iw, _ in cams}
    return plan


def _multiband_constants(plan, mt, g, union, split, L, yuv):
    """The multiband blend's constants: full-canvas weight pyramids,
    reflect-filled about the union box at every level, sliced into the
    cameras' windows (fine levels) or kept whole (coarse levels of the
    two-level split); chroma at half resolution with one band fewer."""
    S, bh, halo, ext, Hp, Wp = plan.S, plan.bh, plan.halo, plan.ext, plan.Hp, plan.Wp
    B, B_uv = plan.num_bands, plan.num_bands_uv
    ncam = plan.num_inputs
    rois = plan.rois[:ncam]
    ary, ary1 = union[1], union[3]
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
    planes = ((1, B),)
    if yuv:
        pyrs_uv, bw_uv = pyramids(
            [fs.reshape(Hp // 2, 2, Wp // 2, 2).mean(axis=(1, 3)).astype(np.float32) for fs in full_seams],
            B_uv, 2,
        )
        L_uv = max(1, L - 1) if split else B_uv
        split_uv = split and L_uv < B_uv and halo // 2 >= 5 * (1 << L_uv)
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
        planes += ((2, B_uv),)

    # banded matrices for every axis length the blends touch
    lengths = set()
    for div, nb in planes:
        for l in range(nb + 1):
            lengths |= {(ext // div) >> l, (Wp // div) >> l, (Hp // div) >> l}
            for x0, iw, hmax in rois:
                lengths |= {(hmax // div) >> l, (iw // div) >> l}
    for nl in lengths:
        if nl >= 2:
            plan.down_mats[nl] = down_matrix(nl)
            plan.up_mats[nl >> 1] = up_matrix(nl >> 1)


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
    ShardedMapper).

    ``mesh`` gives the band count, this process's bands, the data split
    of a batch and the device: a :func:`make_mesh` mesh (every band in
    this process) or a runtime.distributed.make_global_mesh one (this
    rank's bands of its data row; it stitches its row's frame sets).
    blend: > 0 multiband width, < 0 feather border, 0 an averaged
    paste; enable_gain: False, True (pairwise global gains) or
    "blocks"; out_format: "yuv420p" (packed band
    buffers, see :meth:`assemble_yuv`) or "rgb" (planar f32, rgb
    pipeline only); blend_dtype: "float32" or "bfloat16", None picks
    bfloat16 on CUDA and float32 on the CPU; pipeline: "yuv420", "rgb",
    or None, which picks yuv420 when the output format and every size
    are even-friendly (sharded.py:2325-2340 of the JAX package);
    scale_output: output (W, H) or None; frame_format: "yuv420p" or
    "nv12", in and out; coarse_split: the two-level blend's split level
    (None: 2 when S > 1, the number of bands turns it off); src_windows:
    each band preps and gathers only the camera rows its windows sample.
    in_sizes: (H, W) per camera, then per overlay input (or per camera
    only: the overlays then take the first camera's size)."""

    def __init__(
        self,
        mt: MapperTemplate,
        in_sizes,
        mesh: BandMesh,
        blend: int = 128,
        enable_gain=True,
        out_format: str = "yuv420p",
        blend_dtype: str = None,
        pipeline: str = None,
        scale_output=None,
        frame_format: str = "yuv420p",
        coarse_split=None,
        src_windows: bool = False,
    ):
        if out_format not in ("yuv420p", "rgb"):
            raise ValueError(f"unknown out_format {out_format!r}")
        if pipeline not in (None, "rgb", "yuv420"):
            raise ValueError(f"unknown pipeline {pipeline!r}")
        W0, H0 = mt.out_size
        osz = tuple(scale_output) if scale_output else (W0, H0)
        if pipeline is None:
            even = all(h % 2 == 0 and w % 2 == 0 for h, w in in_sizes)
            even = even and all(v % 2 == 0 for v in (W0, H0) + osz)
            pipeline = "yuv420" if out_format == "yuv420p" and even else "rgb"
        if pipeline == "yuv420" and out_format != "yuv420p":
            raise ValueError("out_format='rgb' needs pipeline='rgb'")
        if out_format == "yuv420p" and (osz[0] % 2 or osz[1] % 2):
            raise ValueError(f"packed YUV420P/NV12 output needs an even size, got {osz}")
        if blend_dtype is None:
            blend_dtype = "bfloat16" if mesh.device.type == "cuda" else "float32"
        host = build_sharded_plan(
            mt, in_sizes, mesh.n_space, blend=blend, enable_gain=enable_gain,
            blend_dtype=blend_dtype, pipeline=pipeline, scale_output=scale_output,
            frame_format=frame_format, coarse_split=coarse_split, src_windows=src_windows,
        )
        self._bind(host.bands(mesh.band_lo, mesh.band_hi).to(mesh.device), mesh, out_format)

    @classmethod
    def from_plan(cls, plan: ShardedPlan, mesh: BandMesh, out_format: str = "yuv420p"):
        """A ShardedMapper over a plan already on ``mesh.device``
        (ShardedPlan.to, or parallel.convert.sharded_plan_from_jax) that
        holds the mesh's bands (ShardedPlan.bands first on a rank of a
        global mesh)."""
        if out_format not in ("yuv420p", "rgb") or (out_format == "rgb" and plan.pipeline != "rgb"):
            raise ValueError(f"out_format {out_format!r} on the {plan.pipeline} pipeline")
        self = cls.__new__(cls)
        self._bind(plan, mesh, out_format)
        return self

    def _bind(self, plan: ShardedPlan, mesh: BandMesh, out_format: str):
        if mesh.n_space != plan.S:
            raise ValueError(f"mesh has {mesh.n_space} bands, the plan {plan.S}")
        if (plan.band_lo, plan.band_hi) != (mesh.band_lo, mesh.band_hi):
            raise ValueError(
                f"the plan holds bands [{plan.band_lo}, {plan.band_hi}), this rank of the mesh "
                f"[{mesh.band_lo}, {mesh.band_hi}): cut the host plan with ShardedPlan.bands"
            )
        self.plan = plan
        self.mesh = mesh
        self.device = mesh.device
        self.out_format = out_format
        if mesh.group is None:
            self.group = LocalBands(plan.S)
        else:
            self.group = DistributedBands(mesh.group, mesh.band_lo, mesh.band_hi, plan.S)
        self._rows_cache = {}
        dev = self.device
        # per input, the source-row gather of each band's slice (packed
        # buffer rows: luma, then the chroma block rows), and the slices
        # of the vignettes; None where no slicing happens
        self._src_idx, self._vig, self._vig_half = [], [], []
        halves = plan.vignette_half or [None] * len(plan.in_sizes)
        for i, (Hi, _) in enumerate(plan.in_sizes):
            h = plan.src_h[i]
            r0 = np.atleast_1d(_src_row0(plan, i))
            if h >= Hi:
                self._src_idx.append(None)
            else:
                rows = np.concatenate(
                    [r0[:, None] + np.arange(h), Hi + r0[:, None] // 2 + np.arange(h // 2)], axis=1
                )
                self._src_idx.append(torch.from_numpy(rows.reshape(-1)).to(dev))
            for out, v, d in ((self._vig, plan.vignette[i], 1), (self._vig_half, halves[i], 2)):
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
        self._lattice_taps = {}
        if plan.gain_blocks is not None:
            for i in range(plan.num_inputs):
                for div in (1, 2) if plan.pipeline == "yuv420" else (1,):
                    self._lattice_taps[i, div] = self._lattice_window_taps(i, div)

    # ------------------------------------------------------------ helpers

    def _rows(self, oy, c, H, h):
        """Flat row index of a [k, c, h, .] window at per-band row
        offsets ``oy`` [k] in a [k, c, H, .] band tensor (cached: the offsets
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
        h = self.plan.src_h[i]
        if h >= self.plan.in_sizes[i][0]:
            return buf[:, None]
        return buf.index_select(1, self._src_idx[i]).view(buf.shape[0], -1, h * 3 // 2, buf.shape[2])

    def _prep(self, frames):
        """The input stage (``stitch.frames``) of B frame sets over each
        input's source blocks, with the vignettes' per-band slices.
        Returns per input its Y blocks [B, k, 1, h, W] and U|V blocks
        [B, k, 2, h/2, W/2] as two tuples on the yuv420 pipeline, its
        RGB blocks [B, k, 3, h, W] (a list) on the rgb one, uint8."""
        fmt = self.plan.frame_format
        if self.plan.pipeline == "yuv420":
            return tuple(
                zip(*(
                    prep_yuv(self._slice_src(buf, i), fmt, self._vig[i], self._vig_half[i])
                    for i, buf in enumerate(frames)
                ))
            )
        return [prep_rgb(self._slice_src(buf, i), fmt, self._vig[i]) for i, buf in enumerate(frames)]

    def _remap_dtype(self):
        """Multiband takes its compute dtype straight out of the kernel;
        the other blends take f32."""
        return getattr(torch, self.plan.compute_dtype) if self.plan.blend_kind == "multiband" else torch.float32

    def _remap(self, parts, groups, frames):
        """Per size group one launch over its (input, band) pairs: the
        frames axis for ``frames``, else one frame.  parts: per input its
        source blocks [B, k, C, h, W].  Returns per input its windows
        [B, k, C, hmax, iw] for the plan's k bands, views of its group's
        output buffer."""
        k, dtype = self.plan.n_local, self._remap_dtype()
        out = [None] * len(parts)
        for idxs, group in zip(self.plan.group_idx, groups):
            src = concat_source([parts[i] for i in idxs], frames=True)
            if frames:
                res = remap_apply_frames(src, group, dtype, run=k)
            else:
                res = [o[None] for o in remap_apply(src[0], group, dtype, run=k)]
            for i, o in zip(idxs, res):
                out[i] = o if k > 1 else o[:, None]
        return out

    # -------------------------------------------------------------- gains

    def _window_norm_grid(self, nrm, i):
        """Input i's working-grid norms [k, hmax/st, iw/st] pasted into
        each band's interior grid: [k, bh/st, Wp/st], the single-chip
        Mapper's global blocks."""
        plan = self.plan
        x0 = plan.rois[i][0]
        st = plan.stride
        grid = torch.zeros((plan.n_local, 1, plan.ext // st, plan.Wp // st), dtype=torch.float32, device=nrm.device)
        self._paste_add(grid, nrm[:, None], _win_oy(plan, i, div=st), x0 // st)
        gh = plan.bh // st
        return grid[:, 0, plan.ghalo : plan.ghalo + gh]

    def _norm_rgb(self, w, i):
        """RGB L2 norm of input i's pooled windows [k, 3, hmax, iw]."""
        plan = self.plan
        st = plan.stride
        x = _pool_pow2(w.float().flatten(0, 1), st, col_mat=(plan.pool_cols_roi[plan.rois[i][1]] if st > 1 else None))
        x = x.unflatten(0, (plan.n_local, 3))
        return self._window_norm_grid(torch.sqrt(torch.sum(x * x, dim=1)), i)

    def _norm_yuv(self, wy, wuv, i):
        """RGB norm of input i's pooled luma and pooled centred chroma
        windows (yuv_rgb_norm)."""
        plan = self.plan
        x0, iw, hmax = plan.rois[i]
        st = plan.stride
        y = _pool_pow2(wy.float().flatten(0, 1), st, col_mat=(plan.pool_cols_roi[iw] if st > 1 else None))
        uvf = wuv.float().flatten(0, 1)
        if st >= 2:
            uv = _pool_pow2(uvf, st // 2, col_mat=(plan.pool_cols_roi_uv[iw // 2] if st > 2 else None))
        else:  # stride 1: nearest 2x chroma upsample onto the luma grid
            uv = uvf.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)[:, :hmax, :iw]
        uv = uv.unflatten(0, (plan.n_local, 2))
        return self._window_norm_grid(yuv_rgb_norm(y, uv[:, 0], uv[:, 1]), i)

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

    def _solve_band_block_lattice(self, norms):
        """The blocks-gain lattice from per-band interior norm grids: each
        band pastes its rows into the working canvas and sums its
        per-block pair products; the band group sums those, so every band
        solves the same lattice (sharded.py:1537 of the JAX package)."""
        plan = self.plan
        gbp = plan.gain_blocks
        n, S, k = gbp.num_images, plan.S, plan.n_local
        Hc, Wc = gbp.canvas
        gh, gw = norms[0].shape[-2:]
        block, nby, nbx = gbp.block, gbp.nby, gbp.nbx
        nm = torch.stack(norms, dim=1)  # [k, n, gh, gw]
        nm = nm[..., :Wc] if gw >= Wc else torch.nn.functional.pad(nm, (0, Wc - gw))
        canvas = nm.new_zeros((k, n, S, gh, Wc))
        band = torch.arange(k, device=nm.device)
        canvas[band, :, plan.band_lo + band] = nm  # band s owns working rows [s*gh, (s+1)*gh)
        canvas = canvas.flatten(2, 3)
        if S * gh < Hc:
            canvas = torch.nn.functional.pad(canvas, (0, 0, 0, Hc - S * gh))
        canvas = canvas[:, :, :Hc] * gbp.cover
        require_full_f32()
        sums = torch.einsum(
            "siyaxb,jyaxb->syxij",
            canvas.reshape(k, n, nby, block, nbx, block),
            gbp.cover.reshape(n, nby, block, nbx, block),
        )
        off = 1.0 - torch.eye(n, dtype=torch.float32, device=nm.device)
        I = self.group.sum(sums).reshape(nby * nbx, n, n) * off / gbp.N
        return assemble_and_solve_lattice(gbp, I)

    def _lattice_window_taps(self, i, div):
        """Bilinear taps of the gain lattice over input i's window in
        each of the plan's k bands (div 1: luma or RGB grid, 2: chroma
        grid, where the lattice scale doubles): (y0, y1, fy [k, h, 1], x0,
        x1, fx [1, w])."""
        plan = self.plan
        gbp = plan.gain_blocks
        dev = self.device
        x0, iw, hmax = plan.rois[i]
        oy = np.asarray(_win_oy(plan, i, div=div))
        row_top = np.arange(plan.band_lo, plan.band_hi) * (plan.bh // div) - plan.halo // div + oy
        scale = div / plan.stride
        h, w = hmax // div, iw // div
        rows = torch.from_numpy(row_top.astype(np.int64)).to(dev)[:, None] + torch.arange(h, device=dev)
        ys = ((rows + 0.5) * scale) / gbp.block - 0.5
        xs = ((x0 // div + torch.arange(w, device=dev) + 0.5) * scale) / gbp.block - 0.5
        y0 = torch.floor(ys).long().clamp(0, gbp.nby - 1)
        x0i = torch.floor(xs).long().clamp(0, gbp.nbx - 1)
        y1 = (y0 + 1).clamp(max=gbp.nby - 1)
        x1i = (x0i + 1).clamp(max=gbp.nbx - 1)
        fy = torch.clamp(ys - y0, 0.0, 1.0)[..., None]
        fx = torch.clamp(xs - x0i, 0.0, 1.0)[None, :]
        return y0, y1, fy, x0i, x1i, fx

    def _sample_lattice_window(self, lattice, i, div=1):
        """Input i's gain map over its window in every band, [k, h, w]
        (gain_blocks.sample_block_lattice at per-band row offsets)."""
        y0, y1, fy, x0, x1, fx = self._lattice_taps[i, div]
        g = lattice[..., i]
        top = g[y0][..., x0] * (1 - fx) + g[y0][..., x1] * fx
        bot = g[y1][..., x0] * (1 - fx) + g[y1][..., x1] * fx
        return top * (1 - fy) + bot * fy

    def _apply_gains(self, planes, norms, gains_in):
        """Exposure gains on the cameras' windows of every plane.
        planes: per plane (windows per input [S, C, h, w], div);
        ``norms()`` gives the working-grid norms.  Returns (per plane the
        scaled windows, gains [n]: the pairwise gains, ones for blocks
        gains or none)."""
        plan = self.plan
        n = plan.num_inputs
        gains = torch.ones(n, dtype=torch.float32, device=self.device)
        if plan.gain_blocks is not None:
            lattice = self._solve_band_block_lattice(norms())
            return [
                [w * self._sample_lattice_window(lattice, i, div)[:, None].to(w.dtype) if i < n else w
                 for i, w in enumerate(ws)]
                for ws, div in planes
            ], gains
        if plan.gm_i is not None:
            gains = gains_in.float() if gains_in is not None else self._solve_band_gains(norms())
            # cast the scalar, not the image: f32 * bf16 would promote
            factors = [g.to(planes[0][0][0].dtype) for g in gains.unbind(0)]
            return [[w * factors[i] if i < n else w for i, w in enumerate(ws)] for ws, _ in planes], gains
        return [ws for ws, _ in planes], gains

    # -------------------------------------------------------------- blend

    def _blend_windows(self, imgs, wins, weight_pyrs, inv_bw, feather_w, B, ext_v, W_v, coarse=None):
        """Blend per-input windows [S, c, hmax_i, iw_i] into one band stack
        [S, c, ext_v, W_v].  wins: per input (x0, iw, hmax, oy) in this
        plane's units.  Multiband: window pyramids paste-add into band
        pyramids, ``coarse`` the two-level split's context or None;
        feather: weighted paste-add; none: the average of the covering
        windows (a window covers where any channel is non-zero)."""
        plan = self.plan
        S, c = imgs[0].shape[:2]
        dev = imgs[0].device
        if plan.blend_kind == "feather":
            band = torch.zeros((S, c, ext_v, W_v), dtype=imgs[0].dtype, device=dev)
            for im, fw, (x0, _, _, oy) in zip(imgs, feather_w, wins):
                self._paste_add(band, im * fw[:, None], oy, x0)
            return band
        if plan.blend_kind == "none":
            band = torch.zeros((S, c, ext_v, W_v), dtype=torch.float32, device=dev)
            total = torch.zeros((S, 1, ext_v, W_v), dtype=torch.float32, device=dev)
            for im, (x0, _, _, oy) in zip(imgs, wins):
                self._paste_add(band, im.float(), oy, x0)
                self._paste_add(total, (im != 0).any(dim=1, keepdim=True).float(), oy, x0)
            return band / torch.clamp(total, min=1.0)
        cdt = self._remap_dtype()

        def down(z):
            return cuda_pyramid.down(z, plan.down_mats)

        def up(z):
            return cuda_pyramid.up(z, plan.up_mats)

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

    def _coarse(self, div):
        """The two-level split's context of the luma (div 1) or chroma
        (div 2) blend, or None without a split."""
        plan = self.plan
        if div == 1 and plan.split_level >= 0:
            return dict(L=plan.split_level, wp=plan.wp_coarse, inv=plan.inv_bw_coarse,
                        ridx=plan.coarse_row_idx, halo=plan.halo, bh=plan.bh, S=plan.S)
        if div == 2 and plan.split_level_uv >= 0:
            return dict(L=plan.split_level_uv, wp=plan.wp_coarse_uv, inv=plan.inv_bw_coarse_uv,
                        ridx=plan.coarse_row_idx_uv, halo=plan.halo // 2, bh=plan.bh // 2, S=plan.S)
        return None

    def _blend_plane(self, warped, div):
        """Blend the cameras' windows of one plane (div 1: Y or RGB, div
        2: U|V) into a band stack [S, c, ext/div, Wp/div] f32, clamped to
        the camera union."""
        plan = self.plan
        n = plan.num_inputs
        wins = [(x0 // div, iw // div, hmax // div, _win_oy(plan, i, div=div))
                for i, (x0, iw, hmax) in enumerate(plan.rois[:n])]
        uv = div == 2
        band = self._blend_windows(
            warped[:n], wins,
            plan.weight_pyrs_uv if uv else plan.weight_pyrs,
            plan.inv_band_weights_uv if uv else plan.inv_band_weights,
            plan.feather_w_uv if uv else plan.feather_w,
            plan.num_bands_uv if uv else plan.num_bands,
            plan.ext // div, plan.Wp // div, coarse=self._coarse(div),
        ).float()
        if plan.union_row_mask is not None:
            rows = plan.union_row_mask_uv if uv else plan.union_row_mask
            cols = plan.union_col_mask_uv if uv else plan.union_col_mask
            band = band * rows[:, None, :, None] * cols
        return band

    def _overlays(self, band, warped, div):
        """Paste each overlay's window onto the band stack where its mask
        is set (mapper.cpp:279-282), extended rows included: they feed
        the output resize."""
        plan = self.plan
        n = plan.num_inputs
        masks = plan.overlay_masks_uv if div == 2 else plan.overlay_masks
        S, c, ext_v, W_v = band.shape
        for k in range(plan.num_overlays):
            ov = torch.zeros_like(band)
            self._paste_add(ov, warped[n + k].float(), _win_oy(plan, n + k, div=div), plan.rois[n + k][0] // div)
            m = masks[:, k][:, None]
            band = band * (1.0 - m) + ov * m
        return band

    def _out_rows(self, band, div):
        """The band stack's output rows [S, c, obh/div, oW/div]: the
        interior rows, or the output resize from the extended rows
        (INTER_LINEAR, per-band row taps, shared column taps)."""
        plan = self.plan
        vt = plan.resize_v_uv if div == 2 else plan.resize_v
        if vt is None:
            return band[:, :, plan.halo // div : plan.halo // div + plan.bh // div]
        ht = plan.resize_h_uv if div == 2 else plan.resize_h
        S, c, _, W_v = band.shape
        rows0 = band.gather(2, vt["y0"][:, None, :, None].expand(S, c, -1, W_v))
        rows1 = band.gather(2, vt["y1"][:, None, :, None].expand(S, c, -1, W_v))
        fx, fy = ht["fx"], vt["fy"][:, None, :, None]
        top = rows0.index_select(3, ht["x0"]) * (1 - fx) + rows0.index_select(3, ht["x1"]) * fx
        bot = rows1.index_select(3, ht["x0"]) * (1 - fx) + rows1.index_select(3, ht["x1"]) * fx
        return top * (1 - fy) + bot * fy

    def _pack(self, y8, u8, v8):
        """Per-band uint8 planes Y [S, obh, oW], U, V [S, obh/2, oW/2] ->
        the packed band buffers [S*obh*3/2, oW] in the frame format."""
        return merge_frame(y8, u8, v8, self.plan.frame_format).flatten(0, 1)

    # ----------------------------------------------------------- post-warp

    def _postwarp_band_yuv(self, warped_y, warped_uv, gains_in):
        """Everything after the remap of one frame set: chroma centring,
        gains, the two plane blends, union clamp, overlays, output rows,
        packed band outputs.  warped_*: per input [S, C, h, w].  Returns
        (out uint8 [S*obh*3/2, oW], gains [n])."""
        n = self.plan.num_inputs
        warped_uv = [w - 128.0 for w in warped_uv]
        (warped_y, warped_uv), gains = self._apply_gains(
            [(warped_y, 1), (warped_uv, 2)],
            lambda: [self._norm_yuv(warped_y[i], warped_uv[i], i) for i in range(n)],
            gains_in,
        )
        band_y = self._overlays(self._blend_plane(warped_y, 1), warped_y, 1)
        band_uv = self._overlays(self._blend_plane(warped_uv, 2), warped_uv, 2)
        out_y = self._out_rows(band_y, 1)
        out_uv = self._out_rows(band_uv, 2) + 128.0
        return self._pack(_quantize(out_y[:, 0]), _quantize(out_uv[:, 0]), _quantize(out_uv[:, 1])), gains

    def _postwarp_band_rgb(self, warped, gains_in):
        """The rgb band path after the remap of one frame set: gains,
        blend, union clamp, overlays, clip, output rows; packed band
        outputs [S*obh*3/2, oW] uint8 (rgb_planar_to_planes), or planar
        RGB f32 [3, S*obh, oW] for ``out_format="rgb"``.  warped: per
        input [S, 3, h, w].  Returns (out, gains [n])."""
        n = self.plan.num_inputs
        (warped,), gains = self._apply_gains(
            [(warped, 1)], lambda: [self._norm_rgb(warped[i], i) for i in range(n)], gains_in
        )
        band = self._overlays(self._blend_plane(warped, 1), warped, 1)
        out = self._out_rows(torch.clamp(band, 0.0, 255.0), 1)
        if self.out_format == "rgb":
            return out.movedim(0, 1).flatten(1, 2), gains
        return self._pack(*rgb_planar_to_planes(out)), gains

    # ------------------------------------------------------------ forward

    def _stitch_bands(self, frames, gains_in):
        """B frame sets (per input [B, Hi*3/2, Wi]).  yuv420: one remap
        launch per plane per size group for all of them (the frames axis
        when B > 1), post-warp frame by frame; rgb: frame by frame, one
        NC=3 launch per size group each (as the JAX package's rgb band
        path loops frames).  Returns (out [B, ...], gains [B, n])."""
        nb = frames[0].shape[0]
        outs, gains = [], []
        if self.plan.pipeline == "yuv420":
            ys, uvs = self._prep(frames)
            wy = self._remap(ys, self.plan.remap_groups, nb > 1)
            wuv = self._remap(uvs, self.plan.remap_uv_groups, nb > 1)
            for b in range(nb):
                o, g = self._postwarp_band_yuv(
                    [w[b] for w in wy], [w[b] for w in wuv], None if gains_in is None else gains_in[b]
                )
                outs.append(o)
                gains.append(g)
        else:
            for b in range(nb):
                parts = self._prep([f[b : b + 1] for f in frames])
                warped = self._remap(parts, self.plan.remap_groups, False)
                o, g = self._postwarp_band_rgb([w[0] for w in warped], None if gains_in is None else gains_in[b])
                outs.append(o)
                gains.append(g)
        return torch.stack(outs), torch.stack(gains)

    def _frames_to_device(self, frames):
        """The call's frames, per input a [B, Hi*3/2, Wi] stack or one
        stacked [B, n, Hi*3/2, Wi], checked (``stitch.frames.check_frames``)
        and on the device, per input."""
        sizes = self.plan.in_sizes
        n = len(sizes)
        if not isinstance(frames, (list, tuple)):
            f = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(np.array(frames))
            if len(set(sizes)) != 1:
                raise ValueError("a stacked input needs equal camera sizes; pass a per-input list")
            Hi, Wi = sizes[0]
            if f.dim() != 4 or f.shape[1] != n:
                raise ValueError(f"want a stacked uint8 [B, {n}, {Hi * 3 // 2}, {Wi}], got {tuple(f.shape)}")
            frames = f.unbind(1)
        return [f.to(self.device) for f in check_frames(frames, sizes, batched=True)]

    def stitch_batch(self, frames, gains=None):
        """frames: per input (then per overlay input) a uint8
        [B, Hi*3/2, Wi] stack (B divisible by the mesh's data size), or
        one stacked [B, n, Hi*3/2, Wi] when every size is equal; on a
        rank of a global mesh, its data row's frame sets.  ``gains``
        ([B, n] f32) replaces the solved pairwise gains.  Returns (out,
        gains f32 [B, n]) on the mapper's device; out is uint8
        [B, k*obh*3/2, oW] for the process's k bands (per band packed
        YUV420P or NV12 buffers stacked along rows, see
        :meth:`assemble_yuv` and runtime.distributed.local_output_shards),
        or f32 [B, 3, k*obh, oW] for ``out_format="rgb"``; the gains are
        the same on every band of a data row."""
        bufs = self._frames_to_device(frames)
        B = bufs[0].shape[0]
        nd = self.mesh.local_data
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
        """One frame's band stack [S*obh*3/2, oW] -> the packed canvas
        [oh*3/2, ow] in the frame format."""
        if self.out_format != "yuv420p":
            raise ValueError("assemble_yuv needs out_format='yuv420p'")
        ow, oh = self.plan.out_size
        S, obh, oW = self.plan.S, self.plan.obh, self.plan.oW
        y, u, v = split_frame(torch.as_tensor(out_b).reshape(S, obh * 3 // 2, oW), self.plan.frame_format)
        u, v = (c.flatten(0, 1)[: oh // 2, : ow // 2] for c in (u, v))
        return merge_frame(y.flatten(0, 1)[:oh, :ow], u, v, self.plan.frame_format)
