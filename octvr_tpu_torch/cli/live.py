"""Live session runner — the OwlLive console's orchestration role
(apps/livestitching/runner.cpp:40-95 + mainwindow.cpp:18-108): validate
the rig against the inputs, spawn one template-compile process per
output, then launch and SUPERVISE the streaming stitcher, restarting it
on abnormal exit (the reference pops a warning and resets state,
runner.cpp:58-64,92-95; headless supervision restarts instead).

Usage:
  python -m octvr_tpu_torch.cli.live \
      --rig rig.json --inputs in0.yuv,in1.yuv --in_size WxH \
      --out_size 3840x1920 --out pano.yuv \
      [--blend 128] [--frames N] [--preview prefix] [--restarts 2]
      [--workdir DIR]

Exit code 0 when the stream finishes cleanly (EOF or --frames reached);
nonzero when it keeps failing after --restarts attempts.

The port of octvr_tpu/cli/live.py, with the same flags.  Its children
are the port's CLIs (``python -m octvr_tpu_torch.cli.dump`` and
``python -m octvr_tpu_torch.cli.stream``), which inherit OCTVR_PLATFORM:
the stream runs on the card, or on the CPU with OCTVR_PLATFORM=cpu.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

__all__ = ["main", "validate_rig", "LiveSupervisor"]


class LiveSupervisor:
    """The runner.cpp:40-95 supervision loop as an object: launches the
    streaming core (plus an optional FFmpeg delivery process consuming
    its raw output over a named pipe), restarts it on abnormal exit,
    and exposes stop/restart controls for the operator console
    (cli/console.py)."""

    def __init__(self, stream_cmd, restarts=2, delivery_cmd=None):
        self.stream_cmd = list(stream_cmd)
        self.delivery_cmd = list(delivery_cmd) if delivery_cmd else None
        self.restarts = restarts
        self.attempt = 0
        self.restart_count = 0
        self.state = "idle"
        self.returncode = None
        self._proc = None
        self._delivery = None
        self._stop = False
        self._user_restart = False
        self._lock = threading.Lock()

    # ------------------------------------------------------- controls

    def stop(self):
        """Operator stop: terminate the stream; run() returns 0."""
        with self._lock:
            self._stop = True
            if self._proc and self._proc.poll() is None:
                self._proc.terminate()

    def restart(self):
        """Operator restart: terminate the stream; the supervision loop
        relaunches it without consuming a failure attempt."""
        with self._lock:
            self._user_restart = True
            if self._proc and self._proc.poll() is None:
                self._proc.terminate()

    # ------------------------------------------------------------ run

    def _spawn_delivery(self):
        if self.delivery_cmd:
            self._delivery = subprocess.Popen(self.delivery_cmd)

    def _reap_delivery(self):
        if self._delivery is not None:
            try:
                self._delivery.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self._delivery.terminate()
            self._delivery = None

    def run(self):
        """Supervise until clean EOF (0), operator stop (0), or retry
        exhaustion (4)."""
        while True:
            t0 = time.time()
            print(
                f"# starting stream (attempt {self.attempt + 1})",
                file=sys.stderr,
            )
            # delivery first: it opens the read side of the fifo so the
            # stream's writer open does not block
            self._spawn_delivery()
            with self._lock:
                if self._stop:
                    self.state = "stopped"
                    self._reap_delivery()
                    return 0
                self._proc = subprocess.Popen(self.stream_cmd)
                self.state = "running"
            rc = self._proc.wait()
            self.returncode = rc
            self._reap_delivery()
            with self._lock:
                self._proc = None
                if self._stop:
                    self.state = "stopped"
                    return 0
                if self._user_restart:
                    self._user_restart = False
                    self.restart_count += 1
                    print("# operator restart", file=sys.stderr)
                    continue
            if rc == 0:
                print("# stream finished cleanly", file=sys.stderr)
                self.state = "finished"
                return 0
            print(
                f"warning: stream exited abnormally rc={rc} "
                f"after {time.time() - t0:.1f}s",
                file=sys.stderr,
            )
            self.attempt += 1
            self.restart_count += 1
            if self.attempt > self.restarts:
                print("giving up after retries", file=sys.stderr)
                self.state = "failed"
                return 4


def validate_rig(rig, n_inputs, in_size):
    """Template-vs-camera validation (mainwindow.cpp:18-56 behavior):
    input count and declared lens sizes must match the capture setup.
    Returns a list of problems (empty = ok)."""
    problems = []
    inputs = rig.get("inputs", [])
    if len(inputs) != n_inputs:
        problems.append(
            f"rig wants {len(inputs)} inputs, {n_inputs} streams given"
        )
    w, h = in_size
    for k, spec in enumerate(inputs):
        opts = spec.get("options", {})
        rw = opts.get("width")
        rh = opts.get("height")
        if rw is not None and rh is not None and (rw, rh) != (w, h):
            problems.append(
                f"input {k}: lens is {rw}x{rh}, stream is {w}x{h}"
            )
    return problems


def main(argv=None):
    from . import apply_platform_env

    apply_platform_env()
    ap = argparse.ArgumentParser()
    ap.add_argument("--rig", required=True)
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--in_size", required=True)
    ap.add_argument("--out_size", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--blend", type=int, default=128)
    ap.add_argument("--gain", type=int, default=0, help="-1 disables")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--preview", default=None)
    ap.add_argument(
        "--preview_shm",
        default=None,
        help="mmap live-preview file (runtime/preview.py); readable "
        "concurrently by any viewer process, the QSharedMemory preview "
        "role (preview_video.cpp)",
    )
    ap.add_argument("--restarts", type=int, default=2)
    ap.add_argument("--workdir", default=None)
    ap.add_argument(
        "--sink",
        action="append",
        default=[],
        metavar="KIND:TARGET[|k=v...]",
        help="delivery sink (repeatable): hls:out.m3u8, file:out.mp4, "
        "rtmp:rtmp://..., decklink:'DeckLink 4K', pipe:tcp://... — the "
        "stitched raw stream is piped into ONE ffmpeg fan-out command "
        "mirroring the OwlLive output matrix "
        "(mainwindow.cpp:114-165; see cli/sinks.py)",
    )
    ap.add_argument("--fps", type=int, default=30, help="delivery fps")
    ap.add_argument(
        "--encrypt_args",
        action="store_true",
        help="pass the stream child's command line as ONE encrypted "
        "blob (--args_enc), so its paths and options do not appear in "
        "the stream child's process listing — the OwlLive "
        "arg-encryption role (encryptor.cpp:25-59); the ffmpeg "
        "delivery child's command line still holds the --sink "
        "targets; requires OCTVR_ARG_KEY (hex) in the environment "
        "(utils/argcrypt.py)",
    )
    ap.add_argument(
        "--console",
        action="store_true",
        help="curses operator console: live preview-fed status "
        "(frame/fps/restarts) with stop/restart keys (cli/console.py; "
        "the runner.cpp:40-95 loop made visible).  Implies a "
        "--preview_shm file when none is given.",
    )
    args = ap.parse_args(argv)

    with open(args.rig) as f:
        rig = json.load(f)
    in_paths = args.inputs.split(",")
    w_in, h_in = (int(v) for v in args.in_size.lower().split("x"))
    ow, oh = (int(v) for v in args.out_size.lower().split("x"))

    problems = validate_rig(rig, len(in_paths), (w_in, h_in))
    for p in problems:
        print(f"warning: {p}", file=sys.stderr)
    if any("wants" in p for p in problems):
        print("rig/stream mismatch, refusing to start", file=sys.stderr)
        return 2

    workdir = args.workdir or tempfile.mkdtemp(prefix="octvr_live_")
    os.makedirs(workdir, exist_ok=True)
    tmpl = os.path.join(workdir, "out0.npz")

    # stage 1: template compile in a child process (runner.cpp:84-87)
    print(f"# compiling template -> {tmpl}", file=sys.stderr)
    dump_cmd = [
        sys.executable,
        "-m",
        "octvr_tpu_torch.cli.dump",
        "-w",
        str(ow),
        "-h",
        str(oh),
        "-o",
        tmpl,
        args.rig,
    ]
    res = subprocess.run(dump_cmd)
    if res.returncode != 0:
        print(
            f"template compile failed (rc={res.returncode})", file=sys.stderr
        )
        return 3

    # stage 2: streaming core under supervision (runner.cpp:58-72).
    # With --sink the stitched raw stream goes to a named pipe consumed
    # by one ffmpeg fan-out command (the OwlLive output matrix).
    delivery_cmd = None
    out_path = args.out
    preview_shm = args.preview_shm
    if args.console and not preview_shm:
        preview_shm = os.path.join(workdir, "preview.shm")
    if args.sink:
        import shutil

        from .sinks import build_delivery_command, format_command

        fifo = os.path.join(workdir, "stitch.fifo")
        if not os.path.exists(fifo):
            os.mkfifo(fifo)
        delivery_cmd = build_delivery_command(
            ow, oh, args.fps, args.sink, source=fifo
        )
        print(f"# delivery: {format_command(delivery_cmd)}", file=sys.stderr)
        if shutil.which("ffmpeg") is None:
            print(
                "ffmpeg not on PATH; --sink needs it for delivery",
                file=sys.stderr,
            )
            return 5
        out_path = fifo

    stream_cmd = [
        sys.executable,
        "-m",
        "octvr_tpu_torch.cli.stream",
        "--inputs",
        args.inputs,
        "--in_size",
        args.in_size,
        "--outputs",
        f"{tmpl}:{args.blend}:{args.gain}",
        "--out",
        out_path,
        "--timers",
    ]
    if args.frames:
        stream_cmd += ["--frames", str(args.frames)]
    if args.preview:
        stream_cmd += ["--preview", args.preview]
    if preview_shm:
        stream_cmd += ["--preview_shm", preview_shm]

    if args.encrypt_args:
        from ..utils.argcrypt import encrypt_args, load_key

        blob = encrypt_args(stream_cmd[3:], load_key())
        stream_cmd = stream_cmd[:3] + ["--args_enc", blob]
        print("# stream child args encrypted (--args_enc)", file=sys.stderr)

    sup = LiveSupervisor(
        stream_cmd, restarts=args.restarts, delivery_cmd=delivery_cmd
    )
    if args.console:
        from .console import run_console

        return run_console(sup, preview_shm)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
