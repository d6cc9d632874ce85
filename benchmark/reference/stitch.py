"""The reference stitch: one output of a configuration, frame by frame,
in plain PyTorch.

YUV420P in and out, as OwlLive's yuv420 path: per camera the vignette
and a round to uint8, a bilinear gather of Y at full and of U|V at half
resolution (clamp to edge, 0 outside the map), chroma centred on 128,
global pairwise exposure gains (exposure_compensate.cpp's least squares,
solved in f64), a multiband blend of distance-seam weights (5-tap
reflect-101 Gaussian pyramids, zero-stuffed expansion) or a paste, and a
round to uint8.  Everything between the two roundings is float32 unless
``quantize`` names a lower precision: the control rounds every stored
value there, as a program computing in that precision would.  It imports
nothing of the system under test and takes nothing it made: the maps,
masks, seams and vignettes come from ``offline.compile_template``.

An empty input of the template (a camera that covers no pixel of the
output) takes no part in anything: its frame is never read, it has no
gather, vignette, gain norm, row of the gain system, pyramid or paste,
and its gain reads exactly 1.0.  The definition the reference is held
to: an output with camera ``k`` empty stitches, byte for byte, what the
same output compiled over the rig without camera ``k`` stitches from the
frames without frame ``k``; its gains are that output's, with 1.0 put
back at ``k``, so that there is still one gain per camera of the rig.
"""

import math

import numpy as np
import torch

from .offline import resize_bilinear

WORKING_MEGAPIX = 0.1
WEIGHT_EPS = 1e-5
ALPHA, BETA = 0.01, 100.0
_K = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def rounding(name):
    """The store rounding of a precision: None for float32; the control's
    'float8_e4m3fn' saturates at +-448 (the type has no infinity)."""
    if name in (None, "float32"):
        return None
    dtype = getattr(torch, name)
    hi = float(torch.finfo(dtype).max)
    return lambda x: x.clamp(-hi, hi).to(dtype).float()


# --------------------------------------------------------- host geometry


def _quad_mean(arr, roi, valid=None):
    """Mean of each chroma pixel's <= 4 in-ROI luma samples, and their count."""
    x, y, w, h = roi
    cx0, cy0 = x // 2, y // 2
    cw, ch = -(-(x + w) // 2) - cx0, -(-(y + h) // 2) - cy0
    acc = np.zeros((ch, cw))
    cnt = np.zeros((ch, cw), dtype=np.int32)
    for dy in (0, 1):
        for dx in (0, 1):
            rows = 2 * np.arange(cy0, cy0 + ch) + dy - y
            cols = 2 * np.arange(cx0, cx0 + cw) + dx - x
            ok = ((rows >= 0) & (rows < h))[:, None] & ((cols >= 0) & (cols < w))[None, :]
            rr, cc = np.clip(rows, 0, h - 1), np.clip(cols, 0, w - 1)
            if valid is not None:
                ok = ok & valid[np.ix_(rr, cc)]
            acc += np.where(ok, arr[np.ix_(rr, cc)], 0.0)
            cnt += ok
    return np.where(cnt > 0, acc / np.maximum(cnt, 1), 0.0), cnt, (cx0, cy0, cw, ch)


def _taps(map1, map2, in_h, in_w):
    """Flat source indices [4, n] and f32 weights [4, n] of a bilinear
    gather at normalised map coordinates (0 weight where map1 < 0)."""
    px = map1.astype(np.float64) * in_w - 0.5
    py = map2.astype(np.float64) * in_h - 0.5
    x0, y0 = np.floor(px), np.floor(py)
    fx, fy = (px - x0).astype(np.float32), (py - y0).astype(np.float32)
    x0 = np.clip(x0, 0, in_w - 1).astype(np.int64)
    y0 = np.clip(y0, 0, in_h - 1).astype(np.int64)
    x1, y1 = np.minimum(x0 + 1, in_w - 1), np.minimum(y0 + 1, in_h - 1)
    idx = np.stack([y0 * in_w + x0, y0 * in_w + x1, y1 * in_w + x0, y1 * in_w + x1]).reshape(4, -1)
    one = np.float32(1)
    w = np.stack([(one - fx) * (one - fy), fx * (one - fy), (one - fx) * fy, fx * fy]).reshape(4, -1)
    bad = (map1 < 0).reshape(-1)
    w[:, bad] = 0
    idx[:, bad] = 0
    return idx, w


def _pyr_down_np(x):
    from scipy.ndimage import correlate1d

    k = np.array([1, 4, 6, 4, 1], dtype=np.float32) / 16
    return correlate1d(correlate1d(x, k, axis=0, mode="mirror"), k, axis=1, mode="mirror")[::2, ::2]


def _multiband_geometry(seams, rois, bands):
    """Aligned ROIs, weight pyramids and per-level 1/total weight."""
    x0 = min(r[0] for r in rois)
    y0 = min(r[1] for r in rois)
    x1 = max(r[0] + r[2] for r in rois)
    y1 = max(r[1] + r[3] for r in rois)
    step = 1 << bands

    def down(v):
        return (v >> bands) << bands

    def up(v):
        return v + (step - v % step) % step

    ar = (down(x0), down(y0), up(x1) - down(x0), up(y1) - down(y0))
    gap = 5 * step
    aligned, pyrs = [], []
    totals = [np.full((ar[3] >> i, ar[2] >> i), WEIGHT_EPS, dtype=np.float32) for i in range(bands + 1)]
    for (x, y, w, h), seam in zip(rois, seams):
        left, top = max(ar[0], down(x) - gap), max(ar[1], down(y) - gap)
        right, bottom = min(ar[0] + ar[2], up(x + w) + gap), min(ar[1] + ar[3], up(y + h) + gap)
        a = (left, top, right - left, bottom - top)
        w0 = np.zeros((a[3], a[2]), dtype=np.float32)
        w0[y - top : y - top + h, x - left : x - left + w] = seam.astype(np.float32) / 255.0
        pyr = [w0]
        for _ in range(bands):
            pyr.append(_pyr_down_np(pyr[-1]))
        for i, p in enumerate(pyr):
            ox, oy = (left - ar[0]) >> i, (top - ar[1]) >> i
            totals[i][oy : oy + p.shape[0], ox : ox + p.shape[1]] += p
        aligned.append(a)
        pyrs.append(pyr)
    return ar, aligned, pyrs, [1.0 / t for t in totals]


def _every(x, dim, start, count, step):
    """``count`` samples of ``x`` along ``dim`` from ``start`` at ``step``."""
    sl = [slice(None)] * x.dim()
    sl[dim] = slice(start, start + step * (count - 1) + 1, step)
    return x[tuple(sl)]


class ReferenceOutput:
    """One output: its host geometry from a compiled template, and
    :meth:`stitch` for one frame set.  ``live`` lists the rig's cameras
    that cover the output; everything else is built over them alone."""

    def __init__(self, template, cam_size, blend, gain, device):
        self.dev = device
        W, H = template["size"]
        self.size = (W, H)
        self.blend, self.gain = blend, gain
        ch, cw = cam_size
        self.n_rig = len(template["inputs"])
        self.live = [k for k, i in enumerate(template["inputs"]) if not i.get("empty")]
        ins = [template["inputs"][k] for k in self.live]
        self.n = len(ins)
        self.rois = [i["roi"] for i in ins]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        self.taps_y, self.taps_uv, self.rois_uv, self.vig, self.vig_half = [], [], [], [], []
        self.mask, self.mask_half = [], []
        for i in ins:
            idx, w = _taps(i["map1"], i["map2"], ch, cw)
            self.taps_y.append((t(idx), t(w)))
            valid = i["map1"] >= 0
            hm1, cnt, roi_uv = _quad_mean(i["map1"].astype(np.float64), i["roi"], valid)
            hm2, _, _ = _quad_mean(i["map2"].astype(np.float64), i["roi"], valid)
            hm1 = np.where(cnt > 0, hm1, -1.0).astype(np.float32)
            hm2 = np.where(cnt > 0, hm2, -1.0).astype(np.float32)
            idx, w = _taps(hm1, hm2, ch // 2, cw // 2)
            self.taps_uv.append((t(idx), t(w)))
            self.rois_uv.append(roi_uv)
            vig = None if i["vignette"] is None else resize_bilinear(i["vignette"], ch, cw)
            self.vig.append(None if vig is None else t(vig))
            self.vig_half.append(None if vig is None else t(vig.reshape(ch // 2, 2, cw // 2, 2).mean(axis=(1, 3)).astype(np.float32)))
            self.mask.append(t(i["mask"] > 0))
            self.mask_half.append(t(_quad_mean(i["mask"].astype(np.float64), i["roi"])[0] > 0))
        if gain:
            self._gain_geometry(ins)
        if blend > 0:
            bands = int(math.ceil(math.log(blend) / math.log(2.0)) - 1.0)
            seams_uv = [_quad_mean(i["seam"].astype(np.float64), i["roi"])[0].astype(np.float32) for i in ins]
            self.mb = [
                self._mb_device(_multiband_geometry([i["seam"] for i in ins], self.rois, bands), bands),
                self._mb_device(_multiband_geometry(seams_uv, self.rois_uv, max(1, bands - 1)), max(1, bands - 1)),
            ]

    def _mb_device(self, geo, bands):
        ar, aligned, pyrs, inv = geo
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)  # noqa: E731
        return bands, ar, aligned, [[t(p) for p in pyr] for pyr in pyrs], [t(v) for v in inv]

    def _gain_geometry(self, ins):
        W, H = self.size
        scale = min(1.0, math.sqrt(WORKING_MEGAPIX * 1e6 / (W * H)))
        s = max(1, int(round(1.0 / scale)))
        s = 1 << max(0, int(round(math.log2(s))))
        self.stride = s
        self.work, wmasks, wrois = [], [], []
        for i, roi_uv in zip(ins, self.rois_uv):
            rx, ry, rw, rh = i["roi"]
            gx, gy = -(-rx // s), -(-ry // s)
            ox, oy = gx * s - rx, gy * s - ry
            ww, wh = (rw - ox) // s, (rh - oy) // s
            m = (i["mask"] > 0).astype(np.float32)[oy : oy + wh * s, ox : ox + ww * s]
            wmasks.append(m.reshape(wh, s, ww, s).mean(axis=(1, 3)) > 0.999)
            wrois.append((gx, gy, ww, wh))
            if s >= 2:
                uv = ((ry + oy) // 2 - roi_uv[1], (rx + ox) // 2 - roi_uv[0], s // 2)
            else:
                rows = (ry + oy + np.arange(wh)) // 2 - roi_uv[1]
                cols = (rx + ox + np.arange(ww)) // 2 - roi_uv[0]
                uv = (torch.from_numpy(rows).to(self.dev), torch.from_numpy(cols).to(self.dev), 1)
            self.work.append((oy, ox, wh, ww, uv))
        n = self.n
        N = np.zeros((n, n))
        self.pairs = []
        for i in range(n):
            N[i, i] = max(1, int(wmasks[i].sum()))
            for j in range(i + 1, n):
                (ax, ay, aw, ah), (bx, by, bw, bh) = wrois[i], wrois[j]
                x0, y0 = max(ax, bx), max(ay, by)
                x1, y1 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
                N[i, j] = N[j, i] = 1
                if x1 <= x0 or y1 <= y0:
                    continue
                inter = (wmasks[i][y0 - ay : y1 - ay, x0 - ax : x1 - ax]
                         & wmasks[j][y0 - by : y1 - by, x0 - bx : x1 - bx])
                N[i, j] = N[j, i] = max(1, int(inter.sum()))
                if inter.any():
                    sl_i = (slice(y0 - ay, y1 - ay), slice(x0 - ax, x1 - ax))
                    sl_j = (slice(y0 - by, y1 - by), slice(x0 - bx, x1 - bx))
                    self.pairs.append((i, j, sl_i, sl_j, torch.from_numpy(inter.astype(np.float32)).to(self.dev)))
        self.N = N

    # ---------------------------------------------------------- per frame

    def _gather(self, plane, taps, out_shape, q):
        idx, w = taps
        flat = plane.reshape(-1).float()
        acc = torch.zeros(idx.shape[1], dtype=torch.float32, device=self.dev)
        for k in range(4):
            acc = acc + flat[idx[k]] * w[k]
        acc = acc.view(out_shape)
        return acc if q is None else q(acc)

    def _norms(self, ys, uvs):
        s = self.stride
        norms = []
        for y, uv, (oy, ox, wh, ww, uvs_) in zip(ys, uvs, self.work):
            yp = y[oy : oy + wh * s, ox : ox + ww * s].reshape(wh, s, ww, s).mean(dim=(1, 3))
            if isinstance(uvs_[0], torch.Tensor):  # stride 1: nearest chroma rows and columns
                up = uv[:, uvs_[0]][:, :, uvs_[1]]
            else:
                oyu, oxu, su = uvs_
                up = uv[:, oyu : oyu + wh * su, oxu : oxu + ww * su].reshape(2, wh, su, ww, su).mean(dim=(2, 4))
            r = torch.clamp(yp + 1.402 * up[1], 0.0, 255.0)
            g = torch.clamp(yp - 0.344136 * up[0] - 0.714136 * up[1], 0.0, 255.0)
            b = torch.clamp(yp + 1.772 * up[0], 0.0, 255.0)
            norms.append(torch.sqrt(r * r + g * g + b * b))
        return norms

    def _solve(self, norms):
        n = self.n
        I = np.zeros((n, n))
        for i, j, sl_i, sl_j, m in self.pairs:
            I[i, j] = float(torch.sum(norms[i][sl_i] * m)) / self.N[i, j]
            I[j, i] = float(torch.sum(norms[j][sl_j] * m)) / self.N[i, j]
        off = 1.0 - np.eye(n)
        A = np.diag(BETA * self.N.sum(1) + np.sum(2 * ALPHA * I * I * self.N * off, axis=1))
        A -= 2 * ALPHA * I * I.T * self.N * off
        return np.linalg.solve(A, BETA * self.N.sum(1))

    @staticmethod
    def _down(x, q):
        for dim in (1, 2):
            n = x.shape[dim]
            idx = torch.from_numpy(np.pad(np.arange(n), 2, mode="reflect")).to(x.device)
            xp = x.index_select(dim, idx)
            x = sum(w * _every(xp, dim, t, n // 2, 2) for t, w in enumerate(_K))
        return x if q is None else q(x)

    @staticmethod
    def _up(x, q):
        for dim in (1, 2):
            n = x.shape[dim]
            shape = list(x.shape)
            shape[dim] = 2 * n + 4
            z = x.new_zeros(shape).index_copy(dim, torch.arange(2, 2 * n + 1, 2, device=x.device), x)
            x = sum(2.0 * w * _every(z, dim, t, 2 * n, 1) for t, w in enumerate(_K))
        return x if q is None else q(x)

    def _multiband(self, mb, imgs, rois, size, q):
        bands, (arx, ary, arw, arh), aligned, pyrs, inv = mb
        c = imgs[0].shape[0]
        rq = (lambda v: v) if q is None else q
        dst = [torch.zeros((c, arh >> i, arw >> i), device=self.dev) for i in range(bands + 1)]
        for img, (x, y, w, h), (ax, ay, aw, ah), wp in zip(imgs, rois, aligned, pyrs):
            g = [torch.zeros((c, ah, aw), device=self.dev)]
            g[0][:, y - ay : y - ay + h, x - ax : x - ax + w] = img
            for _ in range(bands):
                g.append(self._down(g[-1], q))
            for i in range(bands + 1):
                lap = rq(g[i] - self._up(g[i + 1], q)) if i < bands else g[bands]
                ox, oy = (ax - arx) >> i, (ay - ary) >> i
                sl = dst[i][:, oy : oy + (ah >> i), ox : ox + (aw >> i)]
                sl.copy_(rq(sl + rq(lap * rq(wp[i])[None])))
        acc = rq(dst[bands] * rq(inv[bands])[None])
        for i in range(bands - 1, -1, -1):
            acc = rq(self._up(acc, q) + rq(dst[i] * rq(inv[i])[None]))
        W, H = size
        canvas = torch.zeros((c, H, W), device=self.dev)
        cw, ch = min(arw, W - arx), min(arh, H - ary)
        canvas[:, ary : ary + ch, arx : arx + cw] = acc[:, :ch, :cw]
        return canvas

    def _paste(self, imgs, rois, masks, size):
        W, H = size
        canvas = torch.zeros((imgs[0].shape[0], H, W), device=self.dev)
        for img, (x, y, w, h), m in zip(imgs, rois, masks):
            region = canvas[:, y : y + h, x : x + w]
            region.copy_(torch.where(m[None], img, region))
        return canvas

    def stitch(self, frames, gains=None, quantize=None):
        """frames: per camera of the rig a uint8 [H*3/2, W] YUV420P
        tensor on the reference's device; ``gains``, if given, one per
        camera of the rig.  Returns (uint8 [Ho*3/2, Wo] YUV420P on the
        host, float64 gains [cameras of the rig], 1.0 at an empty input)."""
        q = rounding(quantize)
        rq = (lambda v: v) if q is None else q
        frames = [frames[k] for k in self.live]
        if gains is not None:
            gains = [gains[k] for k in self.live]
        ys, uvs = [], []
        for k, f in enumerate(frames):
            f = f.to(self.dev)
            h = f.shape[0] * 2 // 3
            w = f.shape[1]
            y = f[:h].float()
            uv = torch.stack([f[h:, : w // 2], f[h:, w // 2 :]]).float()
            if self.vig[k] is not None:
                y = torch.clamp(torch.round(torch.clamp(y * self.vig[k], 0.0, 255.0)), 0, 255)
                uv = torch.clamp(torch.round(torch.clamp((uv - 128.0) * self.vig_half[k] + 128.0, 0.0, 255.0)), 0, 255)
            rx, ry, rw, rh = self.rois[k]
            ys.append(self._gather(y, self.taps_y[k], (1, rh, rw), q))
            cx, cy, cw, ch = self.rois_uv[k]
            uvw = torch.stack([self._gather(uv[c], self.taps_uv[k], (ch, cw), q) for c in range(2)])
            uvs.append(rq(uvw - 128.0))
        if self.gain:
            if gains is None:
                gains = self._solve(self._norms([y[0] for y in ys], uvs))
            ys = [rq(y * float(g)) for y, g in zip(ys, gains)]
            uvs = [rq(uv * float(g)) for uv, g in zip(uvs, gains)]
        else:
            gains = np.ones(self.n)
        W, H = self.size
        if self.blend > 0:
            yc = self._multiband(self.mb[0], ys, self.rois, (W, H), q)
            uvc = self._multiband(self.mb[1], uvs, self.rois_uv, (W // 2, H // 2), q)
        else:
            yc = self._paste(ys, self.rois, self.mask, (W, H))
            uvc = self._paste(uvs, self.rois_uv, self.mask_half, (W // 2, H // 2))

        def u8(x):
            return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)

        uvc = uvc + 128.0
        out = torch.cat([u8(yc[0]), torch.cat([u8(uvc[0]), u8(uvc[1])], dim=1)], dim=0)
        rig_gains = np.ones(self.n_rig)
        rig_gains[self.live] = np.asarray(gains, dtype=np.float64)
        return out.cpu(), rig_gains
