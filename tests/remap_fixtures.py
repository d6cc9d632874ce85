"""Remap map fixtures that import no JAX, for the port's tests and
``chip_smoke.py`` on a machine without JAX.  Both are the fixtures of
tests/test_pallas_remap.py, sampling a 96x256 source."""

import numpy as np

IN_H, IN_W = 96, 256
LO, H_B = 36, 40  # concat_maps: input B's source-row slice [LO, LO+H_B)


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


def concat_maps():
    """test_pallas_remap::test_pallas_remap_concat_source's maps: input A
    the arc maps over the whole source; input B samples only source rows
    ~[42, 68).  Returns (A, B, B rebased onto the slice [LO, LO+H_B))."""
    m1a, m2a = arc_maps(64, 256)
    yy, xx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 256), indexing="ij")
    m1b = (0.1 + 0.8 * xx).astype(np.float32)
    m2b = ((42 + 26 * yy) / IN_H).astype(np.float32)
    m1b[5:9, 40:80] = -1
    m2b[5:9, 40:80] = -1
    m2b_s = np.where(m2b < 0, -1.0, ((m2b * IN_H) - LO) / H_B).astype(np.float32)
    return (m1a, m2a), (m1b, m2b), (m1b, m2b_s)


def ragged_maps():
    """Maps of four inputs on the 96x256 source whose pixel counts and
    segment starts are no multiple of 2 or 4 (the one-frame kernel's
    pixels per thread): arcs at 53x101, one valid pixel, an all-invalid
    3x7 map, and the edge-clamp maps."""
    one = np.full((1, 1), 0.37, np.float32)
    dead = np.full((3, 7), -1.0, np.float32)
    return [arc_maps(53, 101), (one, one + 0.2), (dead, dead), edge_maps()]
