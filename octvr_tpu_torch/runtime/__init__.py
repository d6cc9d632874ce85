"""The streaming runtime: the AsyncMultiMapper pipeline on CUDA streams
and pinned buffers, timers, native frame IO and the mmap preview
(octvr_tpu/runtime)."""

from .pipeline import BUF_SIZE, AsyncMultiMapper
from .timer import FpsMeter, Timer

__all__ = ["AsyncMultiMapper", "BUF_SIZE", "Timer", "FpsMeter"]
