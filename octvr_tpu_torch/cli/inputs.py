"""Capture-device enumeration + format negotiation — the
InputsSelector role (apps/livestitching/inputs_select.cpp).

The reference enumerates cameras through Qt, lets the user pick
size/fps, and emits the FFmpeg capture arguments that feed OwlLiveCore
(`-f v4l2 -pixel_format uyvy422 -video_size WxH -framerate N -i dev`,
inputs_select.cpp:151-166).  This is the headless equivalent: V4L2
devices are probed directly with raw ioctls (no OpenCV/Qt dependency —
ctypes structs against the stable V4L2 ABI), formats/sizes/rates are
negotiated against what each device reports, and the tool prints either
a JSON inventory or ready-to-run FFmpeg capture args whose output pipes
into ``cli/stream`` (which accepts yuv420p and uyvy raw frames).

Usage:
  python -m octvr_tpu_torch.cli.inputs                    # list devices
  python -m octvr_tpu_torch.cli.inputs --json
  python -m octvr_tpu_torch.cli.inputs --select 1920x1080@30   # ffmpeg args

The port's copy of octvr_tpu/cli/inputs.py (standard library and
``fcntl`` only).
"""

import argparse
import fcntl
import glob
import json
import struct
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = [
    "CameraInfo",
    "enumerate_cameras",
    "negotiate_format",
    "build_capture_args",
]

# ---------------------------------------------------------------- V4L2 ABI

_VIDIOC_QUERYCAP = 0x80685600  # _IOR('V', 0, v4l2_capability[104])
_VIDIOC_ENUM_FMT = 0xC0405602  # _IOWR('V', 2, v4l2_fmtdesc[64])
_VIDIOC_ENUM_FRAMESIZES = 0xC02C564A  # _IOWR('V', 74, v4l2_frmsizeenum[44])
_VIDIOC_ENUM_FRAMEINTERVALS = 0xC034564B  # _IOWR('V', 75, [52])
_CAP_VIDEO_CAPTURE = 0x00000001
_BUF_TYPE_VIDEO_CAPTURE = 1
_FRMSIZE_TYPE_DISCRETE = 1
_FRMIVAL_TYPE_DISCRETE = 1

# V4L2 fourcc -> ffmpeg -pixel_format name; ordered by stitcher
# preference: the reference captures uyvy422 (inputs_select.cpp:151),
# which cli/stream consumes natively (splitUYVY parity)
_FOURCC_TO_FFMPEG = {
    "UYVY": "uyvy422",
    "YUYV": "yuyv422",
    "YU12": "yuv420p",
    "NV12": "nv12",
    "MJPG": "mjpeg",
    "RGB3": "rgb24",
    "BGR3": "bgr24",
}
_PREFERENCE = list(_FOURCC_TO_FFMPEG)


@dataclass
class CameraInfo:
    """One capture device: path, human name, and per-fourcc supported
    (width, height) -> [fps...] tables."""

    device: str
    name: str = ""
    driver: str = ""
    formats: Dict[str, Dict[Tuple[int, int], List[float]]] = field(
        default_factory=dict
    )


def _ioctl(fd, req, buf):
    fcntl.ioctl(fd, req, buf, True)
    return buf


def _probe_device(path):
    """QUERYCAP + ENUM_FMT + ENUM_FRAMESIZES + ENUM_FRAMEINTERVALS over
    one /dev/video* node.  Returns CameraInfo or None (not a capture
    device / probe failed)."""
    try:
        fd = open(path, "rb", buffering=0)
    except OSError:
        return None
    try:
        cap = bytearray(104)
        try:
            _ioctl(fd, _VIDIOC_QUERYCAP, cap)
        except OSError:
            return None
        driver = bytes(cap[0:16]).split(b"\0")[0].decode(errors="replace")
        card = bytes(cap[16:48]).split(b"\0")[0].decode(errors="replace")
        capabilities = struct.unpack_from("<I", cap, 84)[0]
        device_caps = struct.unpack_from("<I", cap, 88)[0]
        effective = device_caps or capabilities
        if not effective & _CAP_VIDEO_CAPTURE:
            return None

        info = CameraInfo(device=path, name=card, driver=driver)
        for fidx in range(64):
            fmt = bytearray(64)
            struct.pack_into("<II", fmt, 0, fidx, _BUF_TYPE_VIDEO_CAPTURE)
            try:
                _ioctl(fd, _VIDIOC_ENUM_FMT, fmt)
            except OSError:
                break
            fourcc = bytes(fmt[44:48]).decode(errors="replace")
            sizes = {}
            for sidx in range(256):
                frm = bytearray(44)
                struct.pack_into("<I4s", frm, 0, sidx, fourcc.encode())
                try:
                    _ioctl(fd, _VIDIOC_ENUM_FRAMESIZES, frm)
                except OSError:
                    break
                ftype = struct.unpack_from("<I", frm, 8)[0]
                if ftype != _FRMSIZE_TYPE_DISCRETE:
                    break  # stepwise: no discrete list to negotiate over
                w, h = struct.unpack_from("<II", frm, 12)
                sizes[(w, h)] = _probe_intervals(fd, fourcc, w, h)
            if sizes:
                info.formats[fourcc] = sizes
        return info if info.formats else None
    finally:
        fd.close()


def _probe_intervals(fd, fourcc, w, h):
    rates = []
    for idx in range(64):
        iv = bytearray(52)
        struct.pack_into("<I4sII", iv, 0, idx, fourcc.encode(), w, h)
        try:
            _ioctl(fd, _VIDIOC_ENUM_FRAMEINTERVALS, iv)
        except OSError:
            break
        itype = struct.unpack_from("<I", iv, 16)[0]
        if itype != _FRMIVAL_TYPE_DISCRETE:
            break
        num, den = struct.unpack_from("<II", iv, 20)
        if num:
            rates.append(round(den / num, 3))
    return rates


def enumerate_cameras():
    """All V4L2 capture devices on this host (the
    QCameraInfo::availableCameras() role).  Empty list when none."""
    cams = []
    for path in sorted(glob.glob("/dev/video*")):
        info = _probe_device(path)
        if info is not None:
            cams.append(info)
    return cams


# ------------------------------------------------------------ negotiation


def negotiate_format(cam: CameraInfo, width, height, fps=30.0):
    """Pick (fourcc, (w, h), fps) for a device: preferred pixel format
    first (UYVY like the reference capture path), then the smallest
    supported size that covers the request (or the largest available),
    then the highest rate <= requested (or the lowest above it).
    Returns None if the device has no usable format."""
    order = [f for f in _PREFERENCE if f in cam.formats] + [
        f for f in cam.formats if f not in _PREFERENCE
    ]
    for fourcc in order:
        sizes = cam.formats[fourcc]
        if not sizes:
            continue
        covering = [s for s in sizes if s[0] >= width and s[1] >= height]
        if covering:
            w, h = min(covering, key=lambda s: s[0] * s[1])
        else:
            w, h = max(sizes, key=lambda s: s[0] * s[1])
        rates = sizes[(w, h)]
        if rates:
            le = [r for r in rates if r <= fps + 1e-6]
            rate = max(le) if le else min(rates)
        else:
            rate = fps  # device did not report rates; ask for the target
        return fourcc, (w, h), rate
    return None


def build_capture_args(cams, width, height, fps=30.0):
    """FFmpeg capture arguments for the selected cameras — the
    getInputArgs role (inputs_select.cpp:136-166), one `-f v4l2 ... -i
    dev` group per camera with the negotiated format."""
    args = []
    for cam in cams:
        neg = negotiate_format(cam, width, height, fps)
        if neg is None:
            raise ValueError(f"{cam.device}: no usable capture format")
        fourcc, (w, h), rate = neg
        pixfmt = _FOURCC_TO_FFMPEG.get(fourcc, fourcc.lower())
        args += [
            "-f", "v4l2",
            "-pixel_format", pixfmt,
            "-video_size", f"{w}x{h}",
            "-framerate", f"{rate:g}",
            "-i", cam.device,
        ]
    return args


# --------------------------------------------------------------------- CLI


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    ap.add_argument(
        "--select",
        default=None,
        metavar="WxH@FPS",
        help="negotiate WxH@FPS on every device and print the ffmpeg "
        "capture args (inputs_select.cpp:136-166 role)",
    )
    args = ap.parse_args(argv)

    cams = enumerate_cameras()
    if args.select:
        size, _, fps = args.select.partition("@")
        w, h = (int(v) for v in size.lower().split("x"))
        fps = float(fps) if fps else 30.0
        if not cams:
            print("no capture devices found", file=sys.stderr)
            return 1
        print(" ".join(build_capture_args(cams, w, h, fps)))
        return 0
    if args.json:
        print(
            json.dumps(
                [
                    {
                        "device": c.device,
                        "name": c.name,
                        "driver": c.driver,
                        "formats": {
                            fc: {
                                f"{w}x{h}": rates
                                for (w, h), rates in sizes.items()
                            }
                            for fc, sizes in c.formats.items()
                        },
                    }
                    for c in cams
                ],
                indent=2,
            )
        )
        return 0
    if not cams:
        print("no capture devices found", file=sys.stderr)
        return 1
    for c in cams:
        print(f"{c.device}  {c.name} [{c.driver}]")
        for fc, sizes in c.formats.items():
            for (w, h), rates in sorted(sizes.items()):
                rr = ",".join(f"{r:g}" for r in rates) or "?"
                print(f"    {fc} {w}x{h} @ {rr} fps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
