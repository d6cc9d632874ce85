"""Live preview over a double-buffered memory-mapped file.

The reference publishes the latest stitched frame to the GUI through
three Qt shared-memory segments -- two RGB24 data zones plus a one-byte
meta zone holding the zone index (octvr.hpp:93-101), written by the
copy-out pipeline stage (async.cpp:149-171) and drawn by
``PreviewVideoWidget`` (apps/livestitching/preview_video.cpp:68-96).
The header per zone carries ``{width, height, step, fps}``
(octvr.hpp:97-101).

This is the portable equivalent: ONE mmap-backed file containing a meta
block and two zones, each zone = header + RGB24 frame.  Instead of the
reference's reader-driven index flip under a Qt lock, the writer
alternates zones and publishes the latest index; each zone is guarded
by a seqlock (sequence odd while a write is in progress), so a reader
never needs to take a lock or write to the file -- a torn read is
detected and retried on the other zone.  Any process can attach
read-only and poll at its own rate (the reference GUI polls on a Qt
timer, preview_video.cpp:98).

Layout (little-endian):
  meta:  magic "OVRPREV1" | u8 latest_zone | pad[3] | i32 width | i32 height
  zone k (k=0,1) at META_SIZE + k * zone_size:
         u64 seq | f64 fps | u64 frame_no | raw RGB24 (height*width*3)

The port's copy of octvr_tpu/runtime/preview.py: the layout is the same
byte for byte, so either package's reader reads the other's writer.
"""

import mmap
import os
import struct

import numpy as np

__all__ = ["PreviewWriter", "PreviewReader", "preview_size_bytes"]

MAGIC = b"OVRPREV1"
_META = struct.Struct("<8sB3xii")  # magic, latest zone, width, height
_ZONE = struct.Struct("<QdQ")  # seq, fps, frame_no


def _zone_bytes(width, height):
    return _ZONE.size + width * height * 3


def preview_size_bytes(width, height):
    """Total file size for a WxH preview."""
    return _META.size + 2 * _zone_bytes(width, height)


class PreviewWriter:
    """Creates (truncating) the preview file and publishes frames.

    ``write(rgb, fps, frame_no)`` takes an [H, W, 3] uint8 RGB image;
    it alternates zones and flips the meta index only after the zone's
    seqlock closes, so readers always have one complete frame."""

    def __init__(self, path, width, height):
        self.width, self.height = int(width), int(height)
        self._zone_size = _zone_bytes(self.width, self.height)
        total = preview_size_bytes(self.width, self.height)
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            os.ftruncate(fd, total)
            self._mm = mmap.mmap(fd, total)
        finally:
            os.close(fd)
        self._mm[: _META.size] = _META.pack(MAGIC, 0, self.width, self.height)
        self._zone = 1  # first write lands in zone 0
        self._seq = [0, 0]

    def write(self, rgb, fps=0.0, frame_no=0):
        assert rgb.shape == (self.height, self.width, 3), rgb.shape
        z = 1 - self._zone
        off = _META.size + z * self._zone_size
        seq = self._seq[z] + 1  # odd: write in progress
        self._mm[off : off + _ZONE.size] = _ZONE.pack(seq, float(fps), frame_no)
        body = off + _ZONE.size
        self._mm[body : body + self.width * self.height * 3] = (
            np.ascontiguousarray(rgb, dtype=np.uint8).tobytes()
        )
        seq += 1  # even: complete
        self._mm[off : off + _ZONE.size] = _ZONE.pack(seq, float(fps), frame_no)
        self._seq[z] = seq
        self._zone = z
        self._mm[8:9] = bytes([z])  # publish: latest zone index

    def close(self):
        self._mm.close()


class PreviewReader:
    """Attaches read-only to a preview file written by PreviewWriter.

    ``read()`` returns ``(rgb, fps, frame_no)`` for the latest complete
    frame, or ``None`` when no frame has been published yet.  Lock-free:
    retries on seqlock mismatch (a frame being overwritten mid-read)."""

    def __init__(self, path):
        fd = os.open(path, os.O_RDONLY)
        try:
            total = os.fstat(fd).st_size
            self._mm = mmap.mmap(fd, total, prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        magic, _, w, h = _META.unpack(self._mm[: _META.size])
        if magic != MAGIC:
            raise ValueError(f"not a preview file (magic {magic!r})")
        if total < preview_size_bytes(w, h):
            raise ValueError("preview file truncated")
        self.width, self.height = w, h
        self._zone_size = _zone_bytes(w, h)

    def read(self, retries=8):
        for _ in range(retries):
            z = self._mm[8]
            off = _META.size + (z & 1) * self._zone_size
            seq0, fps, frame_no = _ZONE.unpack(
                self._mm[off : off + _ZONE.size]
            )
            if seq0 == 0 or seq0 % 2 == 1:
                if seq0 == 0:
                    return None  # nothing published yet
                continue  # write in progress, retry
            body = off + _ZONE.size
            buf = bytes(self._mm[body : body + self.width * self.height * 3])
            seq1 = _ZONE.unpack(self._mm[off : off + _ZONE.size])[0]
            if seq1 == seq0:  # untorn
                rgb = np.frombuffer(buf, np.uint8).reshape(
                    self.height, self.width, 3
                )
                return rgb, fps, frame_no
        return None

    def close(self):
        self._mm.close()
