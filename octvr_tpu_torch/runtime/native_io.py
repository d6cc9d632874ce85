"""ctypes bindings for the native IO library (native/octvr_io.cpp):
threaded raw-YUV frame reader/writer with buffer pools and blocking
queues — the host-side plumbing the reference implements in C++
(vr::Queue, pinned HostMem pools, the FFmpeg frame loop).

Falls back to a pure-Python implementation when the shared library has
not been built (``make -C native``); ``native_available()`` says which
path runs.  The port's copy of
octvr_tpu/runtime/native_io.py: the library is the repo's own
``native/liboctvr_io.so``, found from the repo root.
"""

import ctypes
import os
import threading
import queue as _pyqueue

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "liboctvr_io.so",
)

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ovr_reader_open.restype = ctypes.c_void_p
        lib.ovr_reader_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
        ]
        lib.ovr_reader_next.restype = ctypes.c_int64
        lib.ovr_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ovr_reader_close.argtypes = [ctypes.c_void_p]
        lib.ovr_writer_open.restype = ctypes.c_void_p
        lib.ovr_writer_open.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_int,
        ]
        lib.ovr_writer_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ovr_writer_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    else:
        _lib = False
    return _lib


def native_available():
    return bool(_load())


class FrameReader:
    """Reads fixed-size raw frames from a file or pipe on a background
    (native) thread.  fmt: "yuv420p" ([h*3/2, w] uint8) or "uyvy"
    (packed 4:2:2 [h, w*2] uint8, the DeckLink SDI capture layout)."""

    def __init__(self, path, width, height, depth=4, fmt="yuv420p"):
        assert fmt in ("yuv420p", "uyvy")
        self.width = width
        self.height = height
        self.fmt = fmt
        if fmt == "uyvy":
            self.frame_shape = (height, width * 2)
        else:
            self.frame_shape = (height * 3 // 2, width)
        self.frame_size = self.frame_shape[0] * self.frame_shape[1]
        lib = _load()
        self._native = bool(lib)
        if self._native:
            self._h = lib.ovr_reader_open(
                str(path).encode(), self.frame_size, depth
            )
            if not self._h:
                raise IOError(f"cannot open {path}")
        else:
            self._f = open(path, "rb") if path != "-" else os.fdopen(0, "rb")
            self._q = _pyqueue.Queue(maxsize=depth)
            self._t = threading.Thread(target=self._loop, daemon=True)
            self._t.start()

    def _loop(self):
        idx = 0
        while True:
            data = self._f.read(self.frame_size)
            if len(data) != self.frame_size:
                self._q.put(None)
                return
            self._q.put((idx, np.frombuffer(data, np.uint8).reshape(self.frame_shape)))
            idx += 1

    def next(self):
        """Returns (index, frame) or None at EOF."""
        if self._native:
            buf = np.empty(self.frame_shape, dtype=np.uint8)
            idx = _load().ovr_reader_next(
                self._h, buf.ctypes.data_as(ctypes.c_void_p)
            )
            if idx < 0:
                return None
            return int(idx), buf
        return self._q.get()

    def close(self):
        if self._native:
            _load().ovr_reader_close(self._h)
            self._h = None
        else:
            self._f.close()


class FrameWriter:
    def __init__(self, path, width, height, depth=4):
        self.frame_shape = (height * 3 // 2, width)
        self.frame_size = self.frame_shape[0] * width
        lib = _load()
        self._native = bool(lib)
        if self._native:
            self._h = lib.ovr_writer_open(
                str(path).encode(), self.frame_size, depth
            )
            if not self._h:
                raise IOError(f"cannot open {path}")
        else:
            self._f = open(path, "wb") if path != "-" else os.fdopen(1, "wb")

    def push(self, frame):
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        assert frame.shape == self.frame_shape
        if self._native:
            _load().ovr_writer_push(
                self._h, frame.ctypes.data_as(ctypes.c_void_p)
            )
        else:
            self._f.write(frame.tobytes())

    def close(self):
        if self._native:
            _load().ovr_writer_close(self._h)
            self._h = None
        else:
            self._f.close()
