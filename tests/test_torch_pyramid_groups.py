"""The grouped pyramid launches of the multiband blend on the CPU, where
no kernel runs: the host tables (``cuda_pyramid.PyramidGroups``) read as
csrc/pyramid.cu reads them, and the blend composed from the grouped
steps' plain versions.

- the gather's tiles, camera by camera as the kernel walks them, meet
  every band pixel with exactly the cameras whose aligned ROI holds it,
  in ascending order, and its accumulate run so (the up step's f32 sum
  of the banded products, then the kernel's roundings) gives the
  per-camera steps' bytes;
- the tile prefix sums cover each level's grid, and each camera's output
  level, once;
- a rig larger than one launch's table splits in camera order (and a
  pyramid deeper than one launch's levels by level);
- ``_grouped_bands`` over the plain versions equals, byte for byte, the
  per-camera steps' sum: each camera's bands alone added in camera order
  (one camera, three, sixteen with an empty camera, 36, a batch; bf16
  and f32)."""

import numpy as np
import pytest
import torch

from octvr_tpu_torch.ops import cuda_pyramid as cp
from octvr_tpu_torch.ops.pyramid import pyr_up_mm
from octvr_tpu_torch.stitch import blenders as tb

from blend_fixtures import CANVAS, RING_CANVAS, blend_scene, ring_scene

# (scene, channels, lead), as tests/test_torch_on_card.py's GROUP_SCENES
SCENES = {"one": (3, ()), "three": (2, ()), "ring16": (1, ()), "split36": (1, ()), "batch": (3, (2,))}


def _scene(name, dtype="bfloat16", bands=None):
    c, lead = SCENES[name]
    if name in ("ring16", "split36"):
        masks, rois, imgs, b = ring_scene(11, c=c, n=16 if name == "ring16" else 36)
        canvas = RING_CANVAS
    else:
        masks, rois, imgs, b = blend_scene(5, c=c, n=1 if name == "one" else 3)
        canvas = CANVAS
    plan = tb.build_multiband_plan(masks, rois, bands or b, canvas, dtype=dtype).to("cpu")
    ts = [torch.from_numpy(i) for i in imgs]
    if lead:
        ts = [torch.stack([t, 255 - t]) for t in ts]
    return plan, ts


def _down_tables(table):
    """A down launch's table as the kernel reads it: (cams, src_plane,
    dst_plane, [(src_off, dst_off, h, w, tiles_x, tile_end)])."""
    n = int(table[0])
    cams = table[cp._DOWN_HEAD :].reshape(n, cp._DOWN_FIELDS)
    return n, int(table[1]), int(table[2]), [tuple(int(v) for v in row) for row in cams]


def _lap_table(table):
    """A gather launch's table: (accumulate, [level fields], [[camera
    fields] per level])."""
    levels, cams, acc = (int(v) for v in table[: cp._LAP_HEAD])
    lv = table[cp._LAP_HEAD : cp._LAP_HEAD + cp._LEVEL_FIELDS * levels].reshape(levels, cp._LEVEL_FIELDS)
    cm = table[cp._LAP_HEAD + cp._LEVEL_FIELDS * levels :].reshape(levels, cams, cp._CAM_FIELDS)
    assert table.size == cp._LAP_HEAD + cp._LEVEL_FIELDS * levels + cp._CAM_FIELDS * levels * cams
    return bool(acc), [tuple(int(v) for v in r) for r in lv], [[tuple(int(v) for v in c) for c in r] for r in cm]


def _rnd(v, dtype):
    return v.to(dtype).float()


def emulate_gather(groups, gauss, mats, seen):
    """The band levels as pyr_lap_gather_kernel makes them from the
    groups' tables: per launch, per block (level, tile), the cameras
    that meet the tile in ascending index, each one's term added in the
    kernel's order and roundings (the up step's f32 sum from the banded
    products).  ``seen[i]`` collects per band pixel the cameras applied,
    in order, and ``seen["tiles"][i]`` how often a tile covered it."""
    dt = gauss[0].dtype
    lead = gauss[0].shape[:-1]
    R, C = cp.UP_TILE
    bands = {}
    for (levels, cams, acc), table in zip(groups.lap_chunks, groups.lap):
        accumulate, lv, cm = _lap_table(table)
        assert accumulate == acc and [r[0] for r in lv] == list(levels)
        assert len(cm[0]) == len(cams)
        start = 0
        for j, (i, top, bh, bw, fine_plane, coarse_plane, tiles_x, tile_end) in enumerate(lv):
            assert (bh, bw) == groups.band_shapes[i] and bool(top) == (i == groups.num_bands)
            assert fine_plane == groups.arena_sizes[i]
            assert coarse_plane == (0 if top else groups.arena_sizes[i + 1])
            band = bands.setdefault(i, torch.zeros((*lead, bh, bw), dtype=dt))
            out = band.float() if accumulate else torch.zeros((*lead, bh, bw))
            for t in range(start, tile_end):
                ty0, tx0 = (t - start) // tiles_x * R, (t - start) % tiles_x * C
                assert ty0 < bh and tx0 < bw
                rows, cols = min(R, bh - ty0), min(C, bw - tx0)
                seen["tiles"][i][ty0 : ty0 + rows, tx0 : tx0 + cols] += 1
                for kk, (y, x, h, w, off_fine, off_coarse, _) in enumerate(cm[j]):
                    if not (y < ty0 + rows and ty0 < y + h and x < tx0 + cols and tx0 < x + w):
                        continue
                    k = cams[kk]
                    assert (y, x) == groups.origins[i][k] and (h, w) == groups.shapes[i][k]
                    assert off_fine == groups.offsets[i][k]
                    r0, r1 = max(ty0, y), min(ty0 + rows, y + h)
                    c0, c1 = max(tx0, x), min(tx0 + cols, x + w)
                    for r in range(r0, r1):
                        for c in range(c0, c1):
                            seen[i][r][c].append(k)
                    a = groups.level(gauss[i], i, k)[..., r0 - y : r1 - y, c0 - x : c1 - x].float()
                    b = groups.weights[k][i][r0 - y : r1 - y, c0 - x : c1 - x].float()
                    if top:
                        term = _rnd(a * b, dt)
                    else:
                        assert off_coarse == groups.offsets[i + 1][k]
                        x1 = groups.level(gauss[i + 1], i + 1, k)
                        u = pyr_up_mm(x1, mats[x1.shape[-2]], mats[x1.shape[-1]])[..., r0 - y : r1 - y, c0 - x : c1 - x]
                        term = _rnd(_rnd(a - _rnd(u, dt), dt) * b, dt)
                    out[..., r0:r1, c0:c1] = _rnd(out[..., r0:r1, c0:c1] + term, dt)
            band.copy_(out.to(dt))
            start = tile_end
    return [bands[i] for i in range(groups.num_bands + 1)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_gather_tables_meet_each_pixel_with_its_cameras_in_order(scene, dtype):
    """Walking the gather's tables as the kernel does, each band pixel
    lies in one tile per launch and meets exactly the cameras whose
    aligned ROI holds it, in ascending order, and the accumulate so run
    gives the per-camera steps' band levels byte for byte."""
    plan, ts = _scene(scene, dtype)
    groups = tb.pyramid_groups(plan)
    B = plan.num_bands
    dt = tb._DTYPES[plan.compute_dtype]
    gauss = [torch.zeros((*ts[0].shape[:-2], groups.arena_sizes[0]), dtype=dt)]
    for k, (img, (x, y, w, h), (ax, ay, _, _)) in enumerate(zip(ts, plan.rois, plan.align_rois)):
        groups.level(gauss[0], 0, k)[..., y - ay : y - ay + h, x - ax : x - ax + w] = img.to(dt)
    for i in range(B):
        gauss.append(cp.down_group(groups, i, gauss[-1], plan.down_mats))
    seen = {i: [[[] for _ in range(bw)] for _ in range(bh)] for i, (bh, bw) in enumerate(groups.band_shapes)}
    seen["tiles"] = {i: np.zeros(s, dtype=np.int64) for i, s in enumerate(groups.band_shapes)}
    got = emulate_gather(groups, gauss, plan.up_mats, seen)
    want = cp.lap_gather(groups, gauss, plan.up_mats)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(got, tb._grouped_bands(plan, ts)))
    launches = len(groups.cam_chunks)
    for i, (bh, bw) in enumerate(groups.band_shapes):
        assert (seen["tiles"][i] == launches).all(), i
        for r in range(bh):
            for c in range(bw):
                holds = [k for k, ((y, x), (h, w)) in enumerate(zip(groups.origins[i], groups.shapes[i]))
                         if y <= r < y + h and x <= c < x + w]
                assert seen[i][r][c] == holds, (i, r, c)
    if scene in ("ring16", "split36"):
        assert any(not seen[0][r][c] for r in range(groups.band_shapes[0][0]) for c in range(groups.band_shapes[0][1]))


@pytest.mark.parametrize("scene", ["one", "three", "ring16", "split36"])
def test_down_tables_cover_each_camera_level_once(scene):
    """Each grouped down launch's tile prefix sums, read as the kernel
    reads them (a block's camera the first whose tile_end exceeds its
    tile), cover every output pixel of its cameras' next level once."""
    plan, _ = _scene(scene)
    groups = tb.pyramid_groups(plan)
    R, C = cp.DOWN_TILE
    for i in range(plan.num_bands):
        assert len(groups.down[i]) == len(groups.cam_chunks)
        for cams, table in zip(groups.cam_chunks, groups.down[i]):
            n, src_plane, dst_plane, rows = _down_tables(table)
            assert n == len(cams) and (src_plane, dst_plane) == tuple(groups.arena_sizes[i : i + 2])
            cover = {k: np.zeros(groups.shapes[i + 1][k], dtype=np.int64) for k in cams}
            for t in range(rows[-1][5]):
                kk = 0
                while kk + 1 < n and t >= rows[kk][5]:
                    kk += 1
                src_off, dst_off, h, w, tiles_x, _ = rows[kk]
                k = cams[kk]
                assert (src_off, dst_off) == (groups.offsets[i][k], groups.offsets[i + 1][k])
                assert (h, w) == groups.shapes[i][k]
                tc = t - (rows[kk - 1][5] if kk else 0)
                ty0, tx0 = tc // tiles_x * R, tc % tiles_x * C
                assert ty0 < h // 2 and tx0 < w // 2
                cover[k][ty0 : ty0 + R, tx0 : tx0 + C] += 1
            assert all((v == 1).all() for v in cover.values())


def test_tables_split_a_large_rig_in_camera_order():
    """40 cameras (more than one launch's MAX_CAMS) and 9 band levels
    (more than MAX_LEVELS): the down steps split into consecutive camera
    chunks; the gather into level chunks (coarse first), each split by
    camera in order, the later chunks of a level chunk adding to the
    bands the earlier left; the weight pointers are the weight levels'."""
    n, B = 40, 8
    step = 1 << B
    rois = [((k % 8) * step, (k // 8) * step, 2 * step, step) for k in range(n)]
    arr = (0, 0, 9 * step, 6 * step)
    weights = [[torch.zeros((step >> i, (2 * step) >> i)) for i in range(B + 1)] for _ in range(n)]
    groups = cp.PyramidGroups(rois, arr, B, weights)
    assert [list(ch) for ch in groups.cam_chunks] == [list(range(32)), list(range(32, 40))]
    for i in range(B):
        assert [_down_tables(t)[0] for t in groups.down[i]] == [32, 8]
    assert [(list(lv), list(ch), acc) for lv, ch, acc in groups.lap_chunks] == [
        (list(range(8, 0, -1)), list(range(32)), False),
        (list(range(8, 0, -1)), list(range(32, 40)), True),
        ([0], list(range(32)), False),
        ([0], list(range(32, 40)), True),
    ]
    for (levels, cams, acc), table in zip(groups.lap_chunks, groups.lap):
        accumulate, lv, cm = _lap_table(table)
        assert accumulate == acc and [r[0] for r in lv] == list(levels)
        for j, i in enumerate(levels):
            assert [c[6] for c in cm[j]] == [weights[k][i].data_ptr() for k in cams]
            assert [(c[0], c[1]) for c in cm[j]] == [groups.origins[i][k] for k in cams]


def test_tables_refuse_unaligned_rois_and_weights():
    """A level below the top that is not even, a weight level of the
    wrong shape, or weight pyramids that are not one per camera and
    level (a template without seam masks has none), is refused when the
    tables are built."""
    with pytest.raises(ValueError, match="not even"):
        cp.PyramidGroups([(0, 0, 6, 8)], (0, 0, 6, 8), 2)
    with pytest.raises(ValueError, match="weight level"):
        cp.PyramidGroups([(0, 0, 8, 8)], (0, 0, 8, 8), 1, [[torch.zeros(8, 8), torch.zeros(4, 5)]])
    with pytest.raises(ValueError, match="weight pyramids"):
        cp.PyramidGroups([(0, 0, 8, 8)], (0, 0, 8, 8), 1, [])
    with pytest.raises(ValueError, match="weight pyramids"):
        cp.PyramidGroups([(0, 0, 8, 8)], (0, 0, 8, 8), 1, [[torch.zeros(8, 8)]])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_grouped_bands_equal_stepwise_bands(scene, dtype):
    """The grouped composition (one level-0 arena, a grouped down per
    level, the gather) over the plain versions gives, byte for byte, the
    band levels that the per-camera steps sum: each camera's band levels
    alone (from tables of that one camera) added into zeroed bands in
    camera order, each add rounded to the dtype; and the blend's canvas
    is [..., C, H, W]."""
    plan, ts = _scene(scene, dtype)
    B = plan.num_bands
    dt = tb._DTYPES[plan.compute_dtype]
    got = tb._grouped_bands(plan, ts)
    assert len(got) == B + 1
    want = [torch.zeros_like(g) for g in got]
    for img, (x, y, w, h), aroi, wpyr in zip(ts, plan.rois, plan.align_rois, plan.weight_pyrs):
        one = cp.PyramidGroups([aroi], plan.align_result_roi, B, [wpyr])
        gauss = [torch.zeros((*img.shape[:-2], one.arena_sizes[0]), dtype=dt)]
        one.level(gauss[0], 0, 0)[..., y - aroi[1] : y - aroi[1] + h, x - aroi[0] : x - aroi[0] + w] = img.to(dt)
        for i in range(B):
            gauss.append(cp.down_group(one, i, gauss[-1], plan.down_mats))
        for acc, band in zip(want, cp.lap_gather(one, gauss, plan.up_mats)):
            acc += band
    assert all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))
    W, H = RING_CANVAS if scene in ("ring16", "split36") else CANVAS
    assert tb.multiband_blend(plan, ts, (W, H)).shape == (*ts[0].shape[:-2], H, W)
