"""Output-sink matrix — the OwlLive console's delivery pipelines
(apps/livestitching/mainwindow.cpp:110-176): HLS segmenting, raw-video
pipe, file encode, DeckLink SDI out and RTMP publish, assembled as ONE
FFmpeg command that consumes the stitcher's raw YUV420P stream and
fans it out to every enabled sink (the reference appends one ``-map``
output block per checked sink; with none enabled it falls back to a
null sink, mainwindow.cpp:168-172).

Here the stitched stream arrives over stdin / a named pipe instead of
the vr_map filter graph, so the input side is ``-f rawvideo`` instead
of ``-filter_complex``; the per-sink output argument blocks mirror the
reference's flag for flag.

The port's copy of octvr_tpu/cli/sinks.py (standard library only).
"""

import shlex

__all__ = [
    "SINK_KINDS",
    "parse_sink_spec",
    "sink_output_args",
    "build_delivery_command",
]

SINK_KINDS = ("hls", "pipe", "file", "decklink", "rtmp", "null")

_DEFAULTS = {
    "codec": "libx264",  # hls_codec / file_codec / rtmp_codec combo boxes
    "bitrate": "4",  # Mbit (the reference spin boxes are in M)
    "gop": "30",  # gopsize spin boxes
    "fps": "30",  # decklink_output_fps (inputs default 30 fps)
    "hls_time": "2",  # hls_segment_time
    "hls_list_size": "4",
    "format": "rawvideo",  # rawvideo_format combo (rawvideo|nut|...)
}


def parse_sink_spec(spec):
    """``kind:target[|k=v|k=v...]`` -> (kind, target, options).

    The target may itself contain colons (rtmp://host:port/app), so the
    option separator is ``|`` and only the FIRST colon splits the
    kind."""
    head, *opts = spec.split("|")
    kind, _, target = head.partition(":")
    if kind not in SINK_KINDS:
        raise ValueError(
            f"unknown sink kind {kind!r} (one of {', '.join(SINK_KINDS)})"
        )
    kw = {}
    for o in opts:
        if not o:
            continue
        k, _, v = o.partition("=")
        if k not in _DEFAULTS:
            raise ValueError(f"unknown sink option {k!r} for {kind}")
        kw[k] = v
    return kind, target, kw


def sink_output_args(kind, target, **kw):
    """The output argument block for one sink (mainwindow.cpp:114-165),
    WITHOUT the leading ``-map`` (the caller owns stream selection)."""
    o = dict(_DEFAULTS)
    o.update(kw)
    if kind == "hls":
        return [
            "-c:v", o["codec"],
            "-pix_fmt", "yuv420p",
            "-b:v", f"{o['bitrate']}M",
            "-g", o["gop"],
            "-f", "hls",
            "-hls_time", o["hls_time"],
            "-hls_list_size", o["hls_list_size"],
            "-hls_flags", "delete_segments",
            "-hls_allow_cache", "0",
            "-y", target,
        ]
    if kind == "pipe":
        return [
            "-c:v", "rawvideo",
            "-pix_fmt", "yuv420p",
            "-f", o["format"],
            "-y", target,
        ]
    if kind == "file":
        return [
            "-c:v", o["codec"],
            "-pix_fmt", "yuv420p",
            "-b:v", f"{o['bitrate']}M",
            "-g", o["gop"],
            "-y", target,
        ]
    if kind == "decklink":
        return [
            "-pix_fmt", "uyvy422",
            "-f", "decklink",
            "-r", o["fps"],
            "-vsync", "drop",
            "-preroll", "0.5",
            target,
        ]
    if kind == "rtmp":
        return [
            "-c:v", o["codec"],
            "-pix_fmt", "yuv420p",
            "-b:v", f"{o['bitrate']}M",
            "-g", o["gop"],
            "-f", "flv",
            "-y", target,
        ]
    if kind == "null":
        return ["-c:v", "rawvideo", "-f", "null", "-"]
    raise ValueError(kind)


def build_delivery_command(
    width, height, fps, sink_specs, source="-", ffmpeg="ffmpeg"
):
    """Full FFmpeg delivery command: raw YUV420P frames from ``source``
    (stdin or a named pipe) fanned out to every sink — one ``-map 0:v``
    output block per spec, null sink when none are given
    (mainwindow.cpp:168-172)."""
    cmd = [
        ffmpeg,
        "-hide_banner",
        "-loglevel", "error",
        "-f", "rawvideo",
        "-pix_fmt", "yuv420p",
        "-s", f"{width}x{height}",
        "-r", str(fps),
        "-i", source,
    ]
    specs = list(sink_specs) or ["null:"]
    for spec in specs:
        kind, target, kw = parse_sink_spec(spec)
        cmd += ["-map", "0:v"] + sink_output_args(kind, target, **kw)
    return cmd


def format_command(cmd):
    return " ".join(shlex.quote(c) for c in cmd)
