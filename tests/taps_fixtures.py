"""MXU-taps probe fixtures that import no JAX, for the port's CPU tests
of kernel 8 and its on-card tests."""

from octvr_tpu_torch.ops.mxu_taps import visited_rows
from octvr_tpu_torch.tools.mxu_taps_probe import make_probe_inputs


def edge_probe_inputs(lo=16, hi=64, kh=80):
    """The probe's workload at 2 steps x G=2 with edge taps written in:
    tile 0 row 0 taps rows (lo, lo+1), row 1 (hi-2, hi-1), row 2 the pair
    (lo, hi-1); rows 0-2 sample lanes (126, 127); tile 1 row 0 puts oy1
    on the first row past the visited range and row 1 l1 on lane 128,
    each such tap adding 0."""
    oyl, fxy, win = make_probe_inputs(2, 2, kh, lo, hi)
    oy, lane = oyl[:, :, :8], oyl[:, :, 8:]
    for r, (a, b) in enumerate(((lo, lo + 1), (hi - 2, hi - 1), (lo, hi - 1))):
        oy[:, 0, r] = a | (b << 16)
        lane[:, 0, r] = 126 | (127 << 16)
    khi = visited_rows(lo, hi)[1]
    oy[:, 1, 0] = (khi - 1) | (khi << 16)
    lane[:, 1, 1] = 127 | (128 << 16)
    return oyl, fxy, win
