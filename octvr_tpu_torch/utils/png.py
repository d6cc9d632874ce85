"""Minimal dependency-free PNG codec (offline IO only: mask decoding, debug
dumps, golden images).  Supports 8-bit grayscale / RGB / RGBA, non-interlaced.
The port's copy of octvr_tpu/utils/png.py, byte for byte the same codec.
"""

import struct
import zlib

import numpy as np

__all__ = ["decode_png", "encode_png", "read_png", "write_png"]

_SIG = b"\x89PNG\r\n\x1a\n"


def decode_png(data: bytes) -> np.ndarray:
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    meta = None
    palette = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            meta = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, dtype=np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
    w, h, depth, color, _, _, interlace = meta
    if depth != 8 or interlace != 0:
        raise ValueError("only 8-bit non-interlaced PNG supported")
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw, dtype=np.uint8, count=stride, offset=pos + 1).copy()
        pos += 1 + stride
        if ft == 0:
            pass
        elif ft == 1:  # Sub
            for x in range(nch, stride):
                row[x] = (int(row[x]) + int(row[x - nch])) & 0xFF
        elif ft == 2:  # Up
            row += prev
        elif ft == 3:  # Average
            for x in range(stride):
                left = row[x - nch] if x >= nch else 0
                # int() the uint8 operand: the wrap is intended (mod-256
                # reconstruction), the numpy overflow warning is not
                row[x] = (int(row[x]) + ((int(left) + int(prev[x])) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for x in range(stride):
                a = int(row[x - nch]) if x >= nch else 0
                b = int(prev[x])
                c = int(prev[x - nch]) if x >= nch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (int(row[x]) + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ft}")
        out[y] = row
        prev = row
    img = out.reshape(h, w, nch)
    if color == 3:  # palette
        img = palette[img[..., 0]]
    if img.shape[-1] == 1:
        img = img[..., 0]
    return img


def encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nch = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[nch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    rows = np.zeros((h, 1 + w * nch), dtype=np.uint8)
    rows[:, 1:] = img.reshape(h, w * nch)
    idat = zlib.compress(rows.tobytes(), 6)

    def chunk(ctype, payload):
        out = struct.pack(">I", len(payload)) + ctype + payload
        crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
        return out + struct.pack(">I", crc)

    return (
        _SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", idat)
        + chunk(b"IEND", b"")
    )


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path, img: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(img)))
