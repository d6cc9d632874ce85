"""Template serialization.

Two formats:

* ``.dat`` — byte-compatible with the reference's "VRv11" binary
  (template.cpp:206-314: magic, int64-LE fields, raw row-major mats), so
  templates compiled by the reference's octvr_dump load here and vice versa.
* ``.npz`` — the native format (numpy archive), faster and compressed.

The port's copy of octvr_tpu/template/io.py: both formats read and
write the same bytes as the original.
"""

import struct
from typing import BinaryIO

import numpy as np

from .compiler import MapperTemplate, TemplateInput

MAGIC = b"VRv11"

# OpenCV type encoding: type = depth + ((channels - 1) << 3)
_DEPTH_DTYPES = {
    0: np.uint8,
    1: np.int8,
    2: np.uint16,
    3: np.int16,
    4: np.int32,
    5: np.float32,
    6: np.float64,
}
_DTYPE_DEPTH = {np.dtype(v): k for k, v in _DEPTH_DTYPES.items()}

__all__ = ["dump_dat", "load_dat", "save_npz", "load_npz", "MAGIC"]


def _w64(f: BinaryIO, v: int):
    f.write(struct.pack("<q", int(v)))


def _r64(f: BinaryIO) -> int:
    return struct.unpack("<q", f.read(8))[0]


def _wmat(f: BinaryIO, m):
    if m is None:
        m = np.zeros((0, 0), dtype=np.uint8)
    m = np.ascontiguousarray(m)
    channels = 1 if m.ndim == 2 else m.shape[2]
    cvtype = _DTYPE_DEPTH[m.dtype] + ((channels - 1) << 3)
    _w64(f, cvtype)
    _w64(f, m.shape[0])
    _w64(f, m.shape[1])
    if m.size:
        f.write(m.tobytes())


def _rmat(f: BinaryIO):
    cvtype = _r64(f)
    rows = _r64(f)
    cols = _r64(f)
    if rows * cols == 0:
        return None
    depth = cvtype & 7
    channels = (cvtype >> 3) + 1
    dtype = np.dtype(_DEPTH_DTYPES[depth])
    count = rows * cols * channels
    data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
    m = data.reshape(rows, cols, channels)
    return m[..., 0].copy() if channels == 1 else m.copy()


def _winput(f: BinaryIO, inp: TemplateInput):
    for v in inp.roi:
        _w64(f, v)
    _wmat(f, inp.map1)
    _wmat(f, inp.map2)
    _wmat(f, inp.mask)
    _wmat(f, inp.vignette)


def _rinput(f: BinaryIO) -> TemplateInput:
    roi = (_r64(f), _r64(f), _r64(f), _r64(f))
    return TemplateInput(
        roi=roi, map1=_rmat(f), map2=_rmat(f), mask=_rmat(f), vignette=_rmat(f)
    )


def dump_dat(mt: MapperTemplate, f: BinaryIO):
    if not mt.seam_masks:
        mt.create_masks()
    f.write(MAGIC)
    _w64(f, mt.out_size[0])
    _w64(f, mt.out_size[1])
    _w64(f, len(mt.inputs))
    for inp in mt.inputs:
        _winput(f, inp)
    assert len(mt.inputs) == len(mt.seam_masks)
    for m in mt.seam_masks:
        _wmat(f, m)
    _w64(f, len(mt.overlay_inputs))
    for inp in mt.overlay_inputs:
        _winput(f, inp)


def load_dat(f: BinaryIO) -> MapperTemplate:
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise ValueError("invalid template file (version mismatch)")
    width = _r64(f)
    height = _r64(f)
    mt = MapperTemplate(out_size=(width, height))
    n = _r64(f)
    mt.inputs = [_rinput(f) for _ in range(n)]
    mt.seam_masks = [_rmat(f) for _ in range(n)]
    n_overlay = _r64(f)
    mt.overlay_inputs = [_rinput(f) for _ in range(n_overlay)]
    return mt


def save_npz(mt: MapperTemplate, path):
    if not mt.seam_masks:
        mt.create_masks()
    arrays = {
        "out_size": np.array(mt.out_size, dtype=np.int64),
        "n_inputs": np.array(len(mt.inputs)),
        "n_overlays": np.array(len(mt.overlay_inputs)),
    }
    for i, inp in enumerate(mt.inputs + mt.overlay_inputs):
        p = f"in{i}_"
        arrays[p + "roi"] = np.array(inp.roi, dtype=np.int64)
        arrays[p + "map1"] = inp.map1
        arrays[p + "map2"] = inp.map2
        arrays[p + "mask"] = inp.mask
        if inp.vignette is not None:
            arrays[p + "vignette"] = inp.vignette
    for i, m in enumerate(mt.seam_masks):
        arrays[f"seam{i}"] = m
    np.savez_compressed(path, **arrays)


def load_npz(path) -> MapperTemplate:
    z = np.load(path)
    w, h = (int(v) for v in z["out_size"])
    mt = MapperTemplate(out_size=(w, h))
    n = int(z["n_inputs"])
    n_overlay = int(z["n_overlays"])
    for i in range(n + n_overlay):
        p = f"in{i}_"
        inp = TemplateInput(
            roi=tuple(int(v) for v in z[p + "roi"]),
            map1=z[p + "map1"],
            map2=z[p + "map2"],
            mask=z[p + "mask"],
            vignette=z[p + "vignette"] if p + "vignette" in z else None,
        )
        (mt.inputs if i < n else mt.overlay_inputs).append(inp)
    mt.seam_masks = [z[f"seam{i}"] for i in range(n)]
    return mt
