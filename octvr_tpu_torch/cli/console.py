"""Interactive operator status console — the OwlLive GUI's live status
surface as a curses TUI: the runner.cpp:40-95 supervision loop made
visible, fed by the mmap preview channel the reference GUI polls
(preview_video.cpp:68-98 draws the shared-memory frame; its header
carries width/height/fps, octvr.hpp:97-101).

Keys: ``q`` stop (clean exit), ``r`` restart the streaming core.

``ConsoleState`` holds all status logic with no terminal dependency so
tests can drive it headlessly; ``run_console`` wraps it in curses.

The port's copy of octvr_tpu/cli/console.py (standard library,
curses and numpy; the preview is the port's ``runtime.preview``).
"""

import threading
import time

__all__ = ["ConsoleState", "run_console"]


class ConsoleState:
    """Aggregates supervisor + preview-channel status into text lines.

    ``supervisor``: a LiveSupervisor (cli/live.py).  ``preview_path``:
    a runtime/preview.py file written by the streaming core (attached
    lazily — it does not exist until the first frame is published)."""

    def __init__(self, supervisor, preview_path=None):
        self.sup = supervisor
        self.preview_path = preview_path
        self._reader = None
        self.started = time.time()

    def _poll_preview(self):
        if self.preview_path is None:
            return None
        if self._reader is None:
            try:
                from ..runtime.preview import PreviewReader

                self._reader = PreviewReader(self.preview_path)
            except (OSError, ValueError):
                return None  # not published yet
        try:
            return self._reader.read()
        except (OSError, ValueError):
            return None

    def status_lines(self):
        up = time.time() - self.started
        lines = [
            "octvr live console  (q: stop, r: restart)",
            f"state    : {self.sup.state}",
            f"uptime   : {up:7.1f} s",
            f"attempts : {self.sup.attempt + 1}  "
            f"restarts: {self.sup.restart_count}",
        ]
        frame = self._poll_preview()
        if frame is not None:
            rgb, fps, frame_no = frame
            lines.append(
                f"stream   : frame {frame_no}  fps {fps:6.2f}  "
                f"preview {rgb.shape[1]}x{rgb.shape[0]}"
            )
            lines.append("preview  : " + ascii_preview(rgb))
        else:
            lines.append("stream   : (no preview frame yet)")
        return lines

    def handle_key(self, key):
        """Returns True when the console should exit."""
        if key in ("q", "Q"):
            self.sup.stop()
            return True
        if key in ("r", "R"):
            self.sup.restart()
        return False

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None


# 10-level luminance ramp for the one-line ASCII preview strip
_RAMP = " .:-=+*#%@"


def ascii_preview(rgb, width=48):
    """One text row summarizing the preview frame: mean luminance of
    ``width`` vertical strips mapped onto an ASCII ramp (enough to see
    signal/black/garbage at a glance over ssh)."""
    import numpy as np

    y = rgb.astype(np.float32).mean(axis=(0, 2))  # per-column luma
    n = len(y)
    if n == 0:
        return ""
    idx = (np.arange(width) * n) // width
    cols = y[idx]
    chars = (cols / 256.0 * len(_RAMP)).astype(int).clip(0, len(_RAMP) - 1)
    return "".join(_RAMP[c] for c in chars)


def run_console(supervisor, preview_path, interval=0.25):
    """Run the supervisor in a worker thread and the curses status view
    in the calling thread; returns the supervisor's exit code."""
    import curses

    state = ConsoleState(supervisor, preview_path)
    rc = {}

    def work():
        rc["value"] = supervisor.run()

    th = threading.Thread(target=work, daemon=True)
    th.start()

    def ui(stdscr):
        curses.curs_set(0)
        stdscr.nodelay(True)
        while th.is_alive():
            stdscr.erase()
            for i, line in enumerate(state.status_lines()):
                try:
                    stdscr.addnstr(i, 0, line, curses.COLS - 1)
                except curses.error:
                    pass
            stdscr.refresh()
            try:
                ch = stdscr.getkey()
            except curses.error:
                ch = None
            if ch and state.handle_key(ch):
                break
            time.sleep(interval)

    try:
        curses.wrapper(ui)
    finally:
        state.close()
    supervisor.stop()
    th.join(timeout=30)
    return rc.get("value", 0)
