"""The peaks of one NVIDIA H100 SXM and the remap kernel's least time.

A frozen copy of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``F32_FLOP_PER_S``
and ``_bound``: NVIDIA's data sheet rates at the full 700 W power limit.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def remap_bound(groups, store_bytes, frames=1):
    """(bytes, bound seconds, "bytes" or "operations") of remap launches
    over ``groups`` ((RemapGroup, channels) pairs) on ``frames`` frames:
    each valid output pixel reads 16 B of plan (x0, y0, fx, fy), each
    invalid one 4 B (x0); every pixel stores its channels; the source
    bytes are read once.  The plan is read once for all frames, sources
    and stores once per frame.  4 FMAs per channel per valid pixel (8
    f32 flops).  The bound is the larger of bytes over the HBM rate and
    flops over the f32 rate."""
    nbytes = flops = 0
    for group, nc in groups:
        n = group.starts[-1]
        v = int((group.x0 >= 0).sum().item())
        nbytes += 16 * v + 4 * (n - v) + frames * nc * (store_bytes * n + group.src_rows * group.in_shape[1])
        flops += frames * 8 * nc * v
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return nbytes, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def system_remap_bound(system):
    """The least seconds of one frame set's remap launches over every
    output of a deploy.System: Y groups at NC=1, U|V groups at NC=2."""
    total = 0.0
    for m in system.mappers:
        store = 2 if m._remap_dtype().itemsize == 2 else 4
        groups = [(g, 1) for g in m.plan.remap_groups] + [(g, 2) for g in m.plan.remap_uv_groups]
        total += remap_bound(groups, store)[1]
    return total
