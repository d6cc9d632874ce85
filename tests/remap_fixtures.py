"""Remap map fixtures that import no JAX, for the port's tests and
``chip_smoke.py`` on a machine without JAX.  Both are the fixtures of
tests/test_pallas_remap.py, sampling a 96x256 source."""

import numpy as np

IN_H, IN_W = 96, 256


def arc_maps(rh, rw):
    """test_pallas_remap._arc_maps: rotating arcs, an invalid hole and a
    full-width invalid band."""
    yy, xx = np.meshgrid(np.linspace(0, 1, rh), np.linspace(0, 1, rw), indexing="ij")
    m1 = (0.5 + 0.45 * np.cos(2 * np.pi * xx) * (0.3 + 0.6 * yy)).astype(np.float32)
    m2 = (0.5 + 0.45 * np.sin(2 * np.pi * xx) * (0.3 + 0.6 * yy)).astype(np.float32)
    m1[10:20, 30:60] = m2[10:20, 30:60] = -1
    m1[32:48, :] = m2[32:48, :] = -1
    return m1, m2


def edge_maps():
    """test_pallas_remap edge-clamp maps: the bottom rows and right
    columns sample past the last source row and column, so the clamp
    collapses both taps onto one pixel."""
    yy, xx = np.meshgrid(np.linspace(0, 1, 32), np.linspace(0, 1, 256), indexing="ij")
    m1 = (0.1 + 0.8 * xx).astype(np.float32)
    m2 = (0.6 + 0.3 * yy).astype(np.float32)
    m2[-8:, :] = np.linspace(
        (IN_H - 0.9) / IN_H, (IN_H - 0.01) / IN_H, 8, dtype=np.float32
    )[:, None]
    m1[:, -32:] = np.linspace(
        (IN_W - 0.9) / IN_W, (IN_W - 0.01) / IN_W, 32, dtype=np.float32
    )[None, :]
    return m1, m2
