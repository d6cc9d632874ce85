"""Kernel 8 of the TPU table: the MXU-taps probe's three bodies
(tools/mxu_taps_probe.py), wrappers of the Hopper kernels in
csrc/mxu_taps.cu and their plain torch versions.

The probe asks whether the remap's bilinear taps can go through the
matrix unit instead of a gather.  Its synthetic workload
(``tools.mxu_taps_probe.make_probe_inputs``): N grid steps, each G
tiles of 8x128 output pixels sampling one int32 window [KH, 128] of its
step, the taps packed like the production plan:

- ``oyl`` int32 [N, G, 16, 128]: rows 0-7 ``oy0 | oy1 << 16`` (read as
  uint32), rows 8-15 ``l0 | l1 << 16``;
- ``fxy`` f32 [N, G, 16, 128]: rows 0-7 ``fx``, rows 8-15 ``fy``;
- ``win`` int32 [N, 1, KH, 128].

Each body returns G tensors f32 [N, 8, 128], one per tile, of

    out = (1-fy) (a0 R[oy0][l0] + a1 R[oy0][l1]) + fy (a0 R[oy1][l0] + a1 R[oy1][l1])

with a0 = 1-fx, a1 = fx, R the window rows.  Every body reads only the
visited rows ``[klo, khi)`` (``visited_rows``: the fan's chunk-aligned
visit range); a tap outside them or outside the 128 lanes adds 0, as a
one-hot or two-hot mask that matches nothing does in the probe's
matrix bodies.  The probe's own KB (``:137``) is ``khi - klo`` whenever
``lo`` is a multiple of 16, as at every setting the probe is run at.

- ``fan`` (A, ``kern_fan`` ``:100``): the 4-tap gather.
- ``mxu_folded`` (B, ``kern_mxu`` ``:140``): per output row the one-hot
  vertical weights ``W[k, pc] = wy0 (oy0 == k) + wy1 (oy1 == k)``, the
  dense f32 product ``V = W^T R``, then the two horizontal taps of V.
- ``mxu_exact2`` (B2, ``kern_mxu2`` ``:197``): two 0/1 selection
  products in bf16 (exact: the rows are integers <= 255), the
  horizontal taps of each, then ``h0 (1-fy) + h1 fy``.

On the card (csrc/mxu_taps.cu) A is a gather: one block per step
stages the step's visited rows once in shared memory (up to
``MAX_STAGED`` of them; a wider window is gathered from global memory by
a second instance of the kernel, chosen by shape), and each thread reads
four adjacent pixels' plan as 16-byte vectors.  B and B2 run on the
tensor cores: each step is one GEMM (the step's pixels x the
visited rows x 128 columns) of ``wgmma.m64n128k16`` bf16 products with
f32 accumulation, the one-hot A operand built in registers and the
window staged once per step in shared memory, the taps read from V
staged per warp.  B splits each f32 weight into three bf16 terms
(hi + mid + lo, each the rounding of what the ones before it left) and
takes three products into one accumulator: f32's accuracy, as the MXU's
HIGHEST does, where TF32 would truncate the weights.  B2's two products
are exact.

A wrapper takes the plain version for CPU tensors and launches its
kernel for CUDA tensors; there is no fallback from one to the other.
``LAUNCHES`` counts kernel launches in all, ``COUNTS`` per body
(``"taps_fan"``, ``"taps_mxu_folded"``, ``"taps_mxu_exact2"``).
"""

import ctypes

import torch

from ..utils.build import load_library
from .launch_counts import Counter
from .pyramid import require_full_f32

__all__ = [
    "COUNTS",
    "LAUNCHES",
    "MAX_STAGED",
    "MAX_VISITED",
    "TH",
    "TW",
    "fan",
    "check_range",
    "fan_reference",
    "mxu_exact2",
    "mxu_exact2_reference",
    "mxu_folded",
    "mxu_folded_reference",
    "reset_counts",
    "visited_rows",
]

TH, TW = 8, 128  # a tile's output rows; lanes (pixels of a row, window columns)
CHUNK = 16  # the fan's visit chunk (window rows)
MAX_VISITED = 112  # visited rows the product kernels take (one instance per 16)
MAX_STAGED = 112  # visited rows the fan's kernel stages in shared memory (kMaxStaged)
_PLAIN_PIXELS = 1 << 19  # output pixels per chunk of the plain products (V: 256 MB)

_COUNTER = Counter()
COUNTS = _COUNTER.counts
reset_counts = _COUNTER.reset  # set every count to 0
__getattr__ = _COUNTER.module_getattr(__name__)  # LAUNCHES: the launches in all


def visited_rows(lo: int, hi: int):
    """(klo, khi): the window rows the fan visits for taps in [lo, hi),
    whole chunks of 16 (tools/mxu_taps_probe.py:132, :138)."""
    return (lo // CHUNK) * CHUNK, -(-hi // CHUNK) * CHUNK


def check_range(kh: int, lo: int, hi: int):
    """Raises ValueError unless 0 <= lo < hi <= kh and the visited rows
    end within the window (kh >= ceil(hi/16)*16)."""
    if not 0 <= lo < hi <= kh:
        raise ValueError(f"need 0 <= lo < hi <= kh, got lo={lo}, hi={hi}, kh={kh}")
    khi = visited_rows(lo, hi)[1]
    if kh < khi:
        raise ValueError(f"kh={kh} is below the visited rows' end ceil(hi/16)*16 = {khi}")


def _check(oyl, fxy, win, lo, hi):
    n, g = oyl.shape[:2]
    if oyl.dtype != torch.int32 or fxy.dtype != torch.float32 or win.dtype != torch.int32:
        raise ValueError(f"want oyl int32, fxy float32, win int32; got {oyl.dtype}, {fxy.dtype}, {win.dtype}")
    if (oyl.dim() != 4 or tuple(oyl.shape[2:]) != (2 * TH, TW) or fxy.shape != oyl.shape
            or win.dim() != 4 or tuple(win.shape[:2]) != (n, 1) or win.shape[3] != TW):
        raise ValueError(
            f"want oyl, fxy [N, G, {2 * TH}, {TW}] and win [N, 1, KH, {TW}]; got "
            f"{tuple(oyl.shape)}, {tuple(fxy.shape)}, {tuple(win.shape)}"
        )
    if not (oyl.device == fxy.device == win.device):
        raise ValueError(f"inputs on {oyl.device}, {fxy.device}, {win.device}")
    if n == 0 or g == 0:
        raise ValueError(f"empty workload: N={n}, G={g}")
    check_range(win.shape[2], lo, hi)


def _unpack(oyl, fxy):
    """oy0, oy1, l0, l1 (int64, the uint32 halves) and fx, fy, each
    [n, G, 8, 128]."""
    u = oyl.to(torch.int64) & 0xFFFFFFFF
    oy, lane = u[:, :, :TH], u[:, :, TH:]
    return oy & 0xFFFF, oy >> 16, lane & 0xFFFF, lane >> 16, fxy[:, :, :TH], fxy[:, :, TH:]


def _lane(v, lane):
    """v[..., lane] per pixel (v [..., 128(pc), 128(c)], lane [..., 128]);
    0 for a lane outside the 128."""
    got = torch.gather(v, -1, lane.clamp(max=TW - 1)[..., None])[..., 0]
    return torch.where(lane < TW, got, 0.0)


def _tiles(out):
    """[N, G, 8, 128] -> G contiguous [N, 8, 128] views of one buffer."""
    return list(out.transpose(0, 1).contiguous().unbind(0))


def fan_reference(oyl, fxy, win, lo: int, hi: int):
    """Plain version of A: the direct 4-tap gather, per pixel
    ``(1-fy) (s00 a0 + s01 a1) + fy (s10 a0 + s11 a1)`` summed in the
    fan's order (the oy0 row, then the oy1 row)."""
    klo, khi = visited_rows(lo, hi)
    oy0, oy1, l0, l1, fx, fy = _unpack(oyl, fxy)
    n, kh = win.shape[0], win.shape[2]
    flat = win[:, 0].reshape(n, kh * TW).float()

    def tap(oy, lane):
        idx = oy.clamp(max=kh - 1) * TW + lane.clamp(max=TW - 1)
        got = torch.gather(flat, 1, idx.reshape(n, -1)).reshape(oy.shape)
        return torch.where((oy >= klo) & (oy < khi) & (lane < TW), got, 0.0)

    a0, a1 = 1.0 - fx, fx
    mix0 = tap(oy0, l0) * a0 + tap(oy0, l1) * a1
    mix1 = tap(oy1, l0) * a0 + tap(oy1, l1) * a1
    return _tiles((1.0 - fy) * mix0 + fy * mix1)


def _products(oyl, fxy, win, lo, hi, row_fn):
    """Runs ``row_fn(oy0, oy1, l0, l1, fx, fy, k, rows)`` over chunks of
    steps (the dense V of all steps would be N*G*8*128*128 f32, 8 GB at
    the probe's size) and gathers its [n, G, 8, 128] results."""
    klo, khi = visited_rows(lo, hi)
    n, g = oyl.shape[:2]
    k = torch.arange(klo, khi, device=oyl.device)
    rows = win[:, 0, klo:khi]
    out = torch.empty((n, g, TH, TW), dtype=torch.float32, device=oyl.device)
    step = max(1, _PLAIN_PIXELS // (g * TH * TW))
    for s in range(0, n, step):
        e = min(n, s + step)
        out[s:e] = row_fn(*_unpack(oyl[s:e], fxy[s:e]), k, rows[s:e])
    return _tiles(out)


def _onehot_t(oy, k):
    """[n, G, 8, 128] tap rows -> [n, G*8*128 (pixel), KB] masks oy == k."""
    n = oy.shape[0]
    return (oy.reshape(n, -1)[:, :, None] == k)


def mxu_folded_reference(oyl, fxy, win, lo: int, hi: int):
    """Plain version of B: the one-hot f32 W over the visited rows, the
    dense product ``V = W^T R``, the two horizontal taps.  The product
    runs in full f32, as the probe's Precision.HIGHEST does on the TPU
    (TF32 would truncate the weights): it raises if the process allows
    TF32 (``ops.pyramid.require_full_f32``), and never changes that
    setting."""
    require_full_f32()

    def rows_fn(oy0, oy1, l0, l1, fx, fy, k, rows):
        n = oy0.shape[0]
        wy0 = (1.0 - fy).reshape(n, -1, 1)
        wy1 = fy.reshape(n, -1, 1)
        w_t = torch.where(_onehot_t(oy0, k), wy0, 0.0) + torch.where(_onehot_t(oy1, k), wy1, 0.0)
        v = torch.bmm(w_t, rows.float()).reshape(*oy0.shape, TW)  # [n, G, 8, 128 (pc), 128 (c)]
        return _lane(v, l0) * (1.0 - fx) + _lane(v, l1) * fx

    return _products(oyl, fxy, win, lo, hi, rows_fn)


def mxu_exact2_reference(oyl, fxy, win, lo: int, hi: int):
    """Plain version of B2: the selection products ``S0^T R`` and
    ``S1^T R`` in bf16 (0/1 masks and integer rows: exact), the
    horizontal taps of each, then ``h0 (1-fy) + h1 fy``."""

    def rows_fn(oy0, oy1, l0, l1, fx, fy, k, rows):
        r16 = rows.to(torch.bfloat16)
        a0, a1 = 1.0 - fx, fx
        h = []
        for oy in (oy0, oy1):
            v = torch.bmm(_onehot_t(oy, k).to(torch.bfloat16), r16).float().reshape(*oy.shape, TW)
            h.append(_lane(v, l0) * a0 + _lane(v, l1) * a1)
        return h[0] * (1.0 - fy) + h[1] * fy

    return _products(oyl, fxy, win, lo, hi, rows_fn)


_ENTRIES = {
    "fan": "octvr_taps_fan",
    "mxu_folded": "octvr_taps_mxu_folded",
    "mxu_exact2": "octvr_taps_mxu_exact2",
}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launch(body, oyl, fxy, win, lo, hi):
    """One launch of ``body``'s kernel on CUDA tensors; G f32 [N, 8, 128]
    views of one [G, N, 8, 128] output."""
    if oyl.device.type != "cuda":
        raise ValueError(f"unsupported device {oyl.device}")
    if not (oyl.is_contiguous() and fxy.is_contiguous() and win.is_contiguous()):
        raise ValueError("oyl, fxy and win must be contiguous")
    klo, khi = visited_rows(lo, hi)
    if body != "fan" and khi - klo > MAX_VISITED:
        raise ValueError(f"{khi - klo} visited rows; the {body} kernel holds at most {MAX_VISITED}")
    if body == "fan" and any(x.data_ptr() % 16 for x in (oyl, fxy, win)):
        raise ValueError("the fan kernel reads oyl, fxy and win in 16-byte vectors: they must be 16-byte aligned")
    n, g, kh = oyl.shape[0], oyl.shape[1], win.shape[2]
    out = torch.empty((g, n, TH, TW), dtype=torch.float32, device=oyl.device)
    fn = getattr(load_library("tools"), _ENTRIES[body])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    with torch.cuda.device(oyl.device):
        err = fn(
            oyl.data_ptr(), fxy.data_ptr(), win.data_ptr(), out.data_ptr(),
            n, g, kh, klo, khi, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"taps_{body} kernel launch failed: CUDA error {err}")
    _COUNTER.add({f"taps_{body}": 1})
    return list(out.unbind(0))


def fan(oyl, fxy, win, lo: int, hi: int):
    """Body A on the tensors' device: the plain version on the CPU, on
    the card the gather kernel: the step's window staged once in shared
    memory (at most ``MAX_STAGED`` visited rows, else gathered from
    global memory), the plan read in 16-byte vectors."""
    _check(oyl, fxy, win, lo, hi)
    if oyl.device.type == "cpu":
        return fan_reference(oyl, fxy, win, lo, hi)
    return _launch("fan", oyl, fxy, win, lo, hi)


def mxu_folded(oyl, fxy, win, lo: int, hi: int):
    """Body B on the tensors' device: the plain version on the CPU, on the
    card the folded-product kernel: three bf16 ``wgmma`` products of the
    weights split into hi + mid + lo terms, f32 accumulation."""
    _check(oyl, fxy, win, lo, hi)
    if oyl.device.type == "cpu":
        return mxu_folded_reference(oyl, fxy, win, lo, hi)
    return _launch("mxu_folded", oyl, fxy, win, lo, hi)


def mxu_exact2(oyl, fxy, win, lo: int, hi: int):
    """Body B2 on the tensors' device: the plain version on the CPU, on
    the card the two exact bf16 selection products on ``wgmma``, f32
    accumulation."""
    _check(oyl, fxy, win, lo, hi)
    if oyl.device.type == "cpu":
        return mxu_exact2_reference(oyl, fxy, win, lo, hi)
    return _launch("mxu_exact2", oyl, fxy, win, lo, hi)
